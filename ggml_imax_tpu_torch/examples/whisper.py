"""Whisper transcription CLI, the whisper example analog (counterpart of
the JAX package's examples/whisper.py; the reference's
examples/whisper/main.cpp):

    python -m ggml_imax_tpu_torch.examples.whisper -m ggml-small.bin -f a.wav

The JAX CLI hands the loaded weights to its pipeline as they are; this one
first fuses the decoder's q/k/v and repacks the weights for the kernels
(models.whisper.prepare_fused, then ops.qmm.params_repack), as the port's
pipeline runs on the card.
"""
from __future__ import annotations

import argparse
import sys

from .common import add_device_flag, cli_device


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Whisper ASR (ggml .bin models)")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-f", "--file", required=True, help="16 kHz WAV file")
    p.add_argument("-l", "--language", default="en",
                   help="language, or 'auto' to detect")
    p.add_argument("--translate", action="store_true")
    p.add_argument("-bs", "--beam_size", type=int, default=5)
    p.add_argument("--no-timestamps", action="store_true", default=True)
    p.add_argument("--dtw", action="store_true",
                   help="DTW token-level timestamps")
    args = add_device_flag(p).parse_args(argv)
    dev = cli_device(args.device)

    from ..audio.wav import read_wav
    from ..models import whisper as W
    from ..ops.qmm import params_repack
    from ..runtime.whisper_pipeline import FullParams, WhisperPipeline

    cfg, params, filters, vocab = W.load_legacy(args.model, device=dev)
    params = params_repack(W.prepare_fused(params))
    pipe = WhisperPipeline(cfg, params, filters, vocab, device=dev)
    samples = read_wav(args.file)
    lang = args.language
    if lang == "auto":
        lang = pipe.detect_language(samples)
        print(f"detected language: {lang}", file=sys.stderr)
    fp = FullParams(language=lang, translate=args.translate,
                    beam_size=args.beam_size, token_timestamps=args.dtw)
    for seg in pipe.transcribe(samples, fp):
        print(f"[{seg.t0:7.2f} -> {seg.t1:7.2f}] {seg.text}")
        if seg.token_times:
            for t, ts in zip(seg.tokens, seg.token_times):
                print(f"    {ts:7.2f}s  {pipe.decode_text([t])!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
