"""Shared CLI parameter handling, the gpt_params analog (counterpart of the
JAX package's examples/common.py; the reference's examples/common.h and
gpt_params_parse). Flags keep the reference's names (-m/-p/-n/-s/--top_k/
--top_p/--temp/-c); -t/--threads and -ngl are accepted and ignored: one
CUDA device runs every layer. --device picks the card (the default) or the
host ("cpu": the plain PyTorch versions); without a card and without
--device cpu the CLI exits with resolve_device's message and never carries
on on the host.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from .._device import resolve_device


def add_device_flag(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--device", default=None,
                   help="cuda (the default: the hand-written kernels) or "
                        "cpu (the plain PyTorch versions on the host)")
    return p


def cli_device(name: str | None) -> torch.device:
    """The --device flag's device; SystemExit with resolve_device's message
    when the card is asked for (or implied) and there is none."""
    try:
        return resolve_device(name)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


def gpt_argparser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("-m", "--model", required=True, help="model file")
    p.add_argument("-p", "--prompt", default="Hello my name is")
    p.add_argument("-n", "--n_predict", type=int, default=64)
    p.add_argument("-s", "--seed", type=int, default=int(time.time()))
    p.add_argument("-c", "--ctx_size", type=int, default=0,
                   help="context size (0 = model default)")
    p.add_argument("--top_k", type=int, default=40)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--temp", type=float, default=0.9)
    p.add_argument("-b", "--batch_size", type=int, default=8)
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="(compat) ignored: one CUDA device runs the model")
    p.add_argument("-ngl", "--n_gpu_layers", type=int, default=0,
                   help="(compat) ignored: every layer is on the one CUDA "
                        "device")
    p.add_argument("--f32", action="store_true",
                   help="compute in f32 instead of bf16")
    p.add_argument("--resident",
                   choices=("as-is", "q4-fused", "q4-stacked", "bf16"),
                   default="q4-fused",
                   help="device weight residency (default: fused and "
                        "repacked for the hand-written kernels)")
    return add_device_flag(p)


def run_generation(model_module, cfg, params, tok, args, eos_id=None):
    """Shared generate-and-stream loop (main-backend.cpp's main loop)."""
    from ..runtime.engine import Engine

    dtype = torch.float32 if args.f32 else torch.bfloat16
    eng = Engine(model_module, cfg, params, compute_dtype=dtype,
                 kv_dtype=dtype, n_ctx=args.ctx_size or None,
                 residency="as-is" if args.f32 else args.resident,
                 device=args.device)
    prompt_ids = tok.encode(args.prompt)
    print(f"prompt: {len(prompt_ids)} tokens | seed {args.seed}",
          file=sys.stderr)
    sys.stdout.write(args.prompt)
    sys.stdout.flush()

    def on_token(t):
        sys.stdout.write(tok.decode([t]))
        sys.stdout.flush()

    eng.generate(prompt_ids, args.n_predict, top_k=args.top_k,
                 top_p=args.top_p, temp=args.temp, seed=args.seed,
                 eos_id=eos_id, callback=on_token)
    print()
    print(eng.perf.report(), file=sys.stderr)
