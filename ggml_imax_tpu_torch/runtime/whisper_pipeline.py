"""The whisper_full pipeline: chunked transcription with beam search and
temperature fallback (counterpart of ggml_imax_tpu/runtime/
whisper_pipeline.py).

- 30 s windows over the audio (the seek loop; a tail under a second is
  dropped), each through the log-mel frontend, the encoder and the cross
  K/V once;
- the prompt [sot, language, task, no-timestamps];
- per temperature of FullParams.temperatures: beam search at 0 (beam_size
  rows), else one sampled row; an attempt whose average token log-prob is
  under logprob_thold, or whose token entropy is over entropy_thold, falls
  back to the next temperature.

The decode step runs on the device with batch = beam width; at temperature
0 the log-softmax, the special-token suppression and each row's top-2b
candidates are computed there, so a step brings back (beam, 2 beam) values
and ids. The beam bookkeeping (ranking, the finished list, the sampling)
stays on the host in numpy, as in the reference, so ties order alike.
DTW token timestamps are not ported yet (FullParams(token_timestamps=True)
raises).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..audio.mel import N_SAMPLES, SAMPLE_RATE, log_mel_spectrogram
from ..models import whisper as W

# openai whisper language ordering: id(lang) = token_sot + 1 + index
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su").split()


@dataclass
class FullParams:
    """whisper_full_params."""
    language: str = "en"
    translate: bool = False
    beam_size: int = 5
    best_of: int = 5
    temperatures: tuple = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    logprob_thold: float = -1.0
    entropy_thold: float = 2.4
    no_timestamps: bool = True
    token_timestamps: bool = False
    max_tokens: int = 0                  # 0 = until eot / ctx limit
    seed: int = 0

    def __post_init__(self):
        if self.token_timestamps:
            raise NotImplementedError(W.TIMESTAMPS_ITEM)


@dataclass
class Segment:
    t0: float
    t1: float
    tokens: list
    text: str
    avg_logprob: float
    temperature: float
    token_times: list | None = None      # DTW token times: not ported yet


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """Log-softmax over the last axis in f32 by jax.nn.log_softmax's
    formula, (x - max) - log(sum(exp(x - max))). torch.log_softmax's host
    kernel strays from it by up to ~2e-5 over Whisper's 51865 entries,
    which the average log-prob of a segment would carry."""
    shifted = x.float() - x.float().amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def top_k_lower_index_first(x: torch.Tensor, k: int):
    """The k largest values of each row of x and their indices, equal
    values with the lower index first (lax.top_k's order; torch.topk
    promises no order among equal values on CUDA): a stable descending
    sort keeps equal values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class WhisperPipeline:
    """Transcribes on `device` (the card unless "cpu"), where `params`
    live. `_encode_window`, `_decode` and `_decode_topk` are the device
    steps the host loop calls; a test may replace them on an instance."""

    def __init__(self, cfg: W.WhisperConfig, params, filters=None,
                 vocab: list[bytes] | None = None, *,
                 compute_dtype=torch.bfloat16, device=None):
        self.cfg = cfg
        self.params = params
        self.filters = filters
        self.vocab = vocab
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)

        def dec(params, toks, pos, cache, cross, n_past):
            return W.decode(cfg, params, toks, pos, cache, cross, n_past,
                            compute_dtype=compute_dtype)
        self._decode = dec

        def dec_topk(params, toks, pos, cache, cross, n_past, k):
            # beam search's step: log-softmax, special-token suppression and
            # each row's top-k on the device. Exact: any global top-k
            # candidate is inside its own row's top-k.
            logits, cache = W.decode(cfg, params, toks, pos, cache, cross,
                                     n_past, compute_dtype=compute_dtype)
            lp = log_softmax(logits[:, -1])
            ids = torch.arange(lp.shape[-1], device=lp.device)
            sup = (ids >= cfg.token_sot) & (ids != cfg.token_eot)
            lp = torch.where(sup[None], float("-inf"), lp)
            vals, idx = top_k_lower_index_first(lp, k)
            return vals, idx, cache
        self._decode_topk = dec_topk

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=self.device)

    # -- prompt ------------------------------------------------------------
    def initial_tokens(self, fp: FullParams) -> list[int]:
        cfg = self.cfg
        toks = [cfg.token_sot]
        if cfg.is_multilingual:
            toks.append(cfg.token_sot + 1 + LANGUAGES.index(fp.language))
            toks.append(cfg.token_translate if fp.translate
                        else cfg.token_transcribe)
        if fp.no_timestamps:
            toks.append(cfg.token_not)
        return toks

    def detect_language(self, samples: np.ndarray) -> str:
        """Encode the first 30 s, decode one step from [sot], pick the most
        likely language token."""
        cfg = self.cfg
        if not cfg.is_multilingual:
            return "en"
        cross = self._encode_window(samples, 0)
        cache = W.init_cache(cfg, batch=1, dtype=self.compute_dtype,
                             device=self.device)
        toks = self._tensor([[cfg.token_sot]])
        pos = self._tensor([[0]])
        logits, _ = self._decode(self.params, toks, pos, cache, cross, 0)
        lang_ids = np.arange(len(LANGUAGES)) + cfg.token_sot + 1
        probs = logits.float().cpu().numpy()[0, 0, lang_ids]
        return LANGUAGES[int(np.argmax(probs))]

    # -- decoding ----------------------------------------------------------
    def _encode_window(self, samples, seek):
        mel = log_mel_spectrogram(samples[seek:seek + N_SAMPLES],
                                  self.filters, device=self.device)
        mel = mel[None, :, :2 * self.cfg.n_audio_ctx]
        enc = W.encode(self.cfg, self.params, mel,
                       compute_dtype=self.compute_dtype)
        return W.precompute_cross_kv(self.cfg, self.params, enc,
                                     compute_dtype=self.compute_dtype)

    def _run_beam(self, cross, prompt, fp: FullParams, temperature: float,
                  rng: np.random.Generator):
        """One decoding attempt at one temperature. Returns
        (tokens, avg_logprob, entropy)."""
        cfg = self.cfg
        beam = fp.beam_size if temperature == 0.0 else 1
        n_ctx = cfg.n_text_ctx
        max_new = fp.max_tokens or (n_ctx // 2 - len(prompt))

        cache = W.init_cache(cfg, batch=beam, dtype=self.compute_dtype,
                             device=self.device)
        xk, xv = cross
        cross_b = (xk.repeat_interleave(beam, dim=1),
                   xv.repeat_interleave(beam, dim=1))

        toks = np.tile(np.asarray(prompt, np.int32)[None], (beam, 1))
        pos = np.tile(np.arange(len(prompt), dtype=np.int32)[None], (beam, 1))
        use_topk = temperature == 0.0
        K2 = 2 * beam
        if use_topk:
            vals, idx, cache = self._decode_topk(
                self.params, self._tensor(toks), self._tensor(pos), cache,
                cross_b, 0, k=K2)
            vals_h, idx_h = vals.cpu().numpy(), idx.cpu().numpy()
        else:
            logits, cache = self._decode(self.params, self._tensor(toks),
                                         self._tensor(pos), cache, cross_b, 0)
            logp = log_softmax(logits[:, -1])

        sum_lp = np.zeros(beam)
        sum_lp[1:] = -1e9                       # beams start identical
        seqs = [list() for _ in range(beam)]
        finished: list[tuple[float, list, float]] = []
        n_past = len(prompt)

        for step in range(max_new):
            if temperature > 0.0:
                lp = logp.cpu().numpy().copy()  # (beam, V)
                # suppress special tokens except EOT mid-sequence
                sup = min(cfg.token_sot, cfg.n_vocab)
                special = np.arange(sup, cfg.n_vocab)
                lp[:, special[special != cfg.token_eot]] = -np.inf
                nxt = []
                for b in range(beam):
                    p = np.exp((lp[b] - lp[b].max()) / temperature)
                    p /= p.sum()
                    nxt.append(int(rng.choice(cfg.n_vocab, p=p)))
                order = list(range(beam))
                new_lp = [sum_lp[b] + lp[b, nxt[b]] for b in range(beam)]
            else:
                # rank the (beam, 2b) candidate grid: the same ranking as
                # over the full (beam, V) matrix, since any global top-2b
                # entry is in its own row's top-2b
                cand = sum_lp[:, None] + vals_h        # (beam, 2b)
                flat = np.argsort(cand.ravel())[::-1][:K2]
                order, nxt, new_lp = [], [], []
                for f in flat:
                    b, j = divmod(int(f), K2)
                    t = int(idx_h[b, j])
                    if t == cfg.token_eot:
                        n_tok = len(seqs[b])
                        if n_tok > 0:
                            finished.append((cand[b, j] / (n_tok + 1),
                                             list(seqs[b]),
                                             cand[b, j]))
                        continue
                    order.append(b)
                    nxt.append(t)
                    new_lp.append(cand[b, j])
                    if len(order) == beam:
                        break
                while len(order) < beam:        # degenerate: pad with best
                    order.append(order[0] if order else 0)
                    nxt.append(int(idx_h[order[-1], 0]))
                    new_lp.append(-1e9)

            seqs = [seqs[b] + [t] for b, t in zip(order, nxt)]
            sum_lp = np.asarray(new_lp)
            if len(finished) >= beam:
                break

            # the KV cache follows the surviving beams (a gather on the device)
            if order != list(range(beam)):
                cache = cache.select_batch(self._tensor(order))
            tok_step = self._tensor(np.asarray(nxt, np.int32)[:, None])
            pos_step = torch.full((beam, 1), n_past, dtype=torch.long,
                                  device=self.device)
            if use_topk:
                vals, idx, cache = self._decode_topk(
                    self.params, tok_step, pos_step, cache, cross_b, n_past,
                    k=K2)
                vals_h, idx_h = vals.cpu().numpy(), idx.cpu().numpy()
            else:
                logits, cache = self._decode(self.params, tok_step, pos_step,
                                             cache, cross_b, n_past)
                logp = log_softmax(logits[:, 0])
            n_past += 1
            if n_past >= n_ctx - 1:
                break

        if not finished:
            b = int(np.argmax(sum_lp))
            finished.append((sum_lp[b] / max(1, len(seqs[b])), seqs[b],
                             sum_lp[b]))
        finished.sort(key=lambda x: -x[0])
        avg_lp, tokens, _ = finished[0]
        return tokens, float(avg_lp), _token_entropy(tokens)

    def transcribe(self, samples: np.ndarray, fp: FullParams | None = None
                   ) -> list[Segment]:
        """whisper_full: the list of segments, one a 30 s window."""
        fp = fp or FullParams()
        rng = np.random.default_rng(fp.seed)
        prompt = self.initial_tokens(fp)
        segments: list[Segment] = []
        n = len(samples)
        seek = 0
        while seek == 0 or seek + SAMPLE_RATE <= n:   # skip sub-second tails
            cross = self._encode_window(samples, seek)
            tokens, avg_lp, ent = [], -1e9, 0.0
            used_t = fp.temperatures[-1]
            for t in fp.temperatures:
                tokens, avg_lp, ent = self._run_beam(cross, prompt, fp, t, rng)
                used_t = t
                if avg_lp >= fp.logprob_thold and ent <= fp.entropy_thold:
                    break
            segments.append(Segment(
                t0=seek / SAMPLE_RATE,
                t1=min(n, seek + N_SAMPLES) / SAMPLE_RATE,
                tokens=tokens, text=self.decode_text(tokens),
                avg_logprob=avg_lp, temperature=used_t))
            seek += N_SAMPLES
        return segments

    def transcribe_parallel(self, samples: np.ndarray,
                            fp: FullParams | None = None,
                            n_processors: int = 2) -> list[Segment]:
        """whisper_full_parallel: the audio cut into n_processors spans on
        whole seconds, each transcribed on its own, the segments merged in
        order with their times offset by the span's start."""
        if n_processors <= 1:
            return self.transcribe(samples, fp)
        n = len(samples)
        per = max(SAMPLE_RATE, (n // n_processors // SAMPLE_RATE) * SAMPLE_RATE)
        spans = []
        start = 0
        while start < n and len(spans) < n_processors - 1:
            spans.append((start, min(n, start + per)))
            start += per
        if start < n:
            spans.append((start, n))
        out: list[Segment] = []
        for s0, s1 in spans:
            off = s0 / SAMPLE_RATE
            for seg in self.transcribe(samples[s0:s1], fp):
                seg.t0 += off
                seg.t1 += off
                out.append(seg)
        return out

    def decode_text(self, tokens) -> str:
        if self.vocab is None:
            return ""
        out = b"".join(self.vocab[t] for t in tokens
                       if t < self.cfg.token_eot)
        return out.decode("utf-8", errors="replace")


def _token_entropy(tokens) -> float:
    """The degenerate-repetition signal: Shannon entropy of the token
    repeat counts (low: the decoder is looping)."""
    if not tokens:
        return 0.0
    _, counts = np.unique(np.asarray(tokens), return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log(p)).sum())
