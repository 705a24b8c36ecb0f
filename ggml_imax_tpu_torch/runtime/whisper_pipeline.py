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

The decode loop runs as CUDA-graph replay (graphs=True, the default): the
reference jits its step into one executable, the port captures it once
per batch width (runtime/engine.CapturedStep: the beam step at B =
beam_size with its top-2b, the sampled step at B 1 with its last row's
logits) and replays it. A graph reads fixed addresses, so the pipeline
owns each width's tensors, allocated once: the KV cache (zeroed for each
attempt and reordered in place, KVCache.reorder_), the cross K/V (each
window's copied in), the token, position and n_past inputs (n_past a 0-d
int64 on the device: a capture would freeze a host int) and the outputs.
The prompt step and detect_language stay eager. graphs=False is the
eager route, which allocates per attempt and reorders by select_batch;
on the CPU a captured step runs eagerly, over the same tensors.

token_timestamps: DTW token-level times from the cross-attention of the
alignment heads (FullParams(token_timestamps=True) fills
Segment.token_times).
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from .._device import resolve_device
from ..audio.mel import N_SAMPLES, SAMPLE_RATE, log_mel_spectrogram
from ..models import whisper as W
from .engine import CapturedStep

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
    token_timestamps: bool = False       # DTW token-level times
    max_tokens: int = 0                  # 0 = until eot / ctx limit
    seed: int = 0


@dataclass
class Segment:
    t0: float
    t1: float
    tokens: list
    text: str
    avg_logprob: float
    temperature: float
    token_times: list | None = None      # per-token seconds (DTW), optional


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
    steps the host loop calls; a test may replace them on an instance.
    graphs: the decode loop through captured steps (the default), or the
    eager route (False). `last_cache`: the KV cache of the latest attempt,
    which the captured route overwrites at the next one."""

    def __init__(self, cfg: W.WhisperConfig, params, filters=None,
                 vocab: list[bytes] | None = None, *,
                 compute_dtype=torch.bfloat16, device=None,
                 graphs: bool = True):
        self.cfg = cfg
        self.params = params
        self.filters = filters
        self.vocab = vocab
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.graphs = graphs
        self.graph_pool = torch.cuda.graph_pool_handle() \
            if graphs and self.device.type == "cuda" else None
        self._static: dict = {}
        self.last_cache = None

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

    # -- the captured decode steps ---------------------------------------
    def _static_step(self, beam: int, k: int):
        """The captured route's tensors and CapturedStep of one batch width:
        the beam step (k > 0: top-k values and ids out) or the sampled step
        (k == 0: the last row's logits out)."""
        key = (beam, k)
        if key not in self._static:
            cfg, dev = self.cfg, self.device
            H = cfg.n_text_head
            xshape = (cfg.n_text_layer, beam, cfg.n_audio_ctx, H,
                      cfg.n_text_state // H)
            z = lambda *shape, dtype=torch.float32: torch.zeros(
                shape, dtype=dtype, device=dev)
            st = SimpleNamespace(
                k=k, cache=W.init_cache(cfg, batch=beam,
                                        dtype=self.compute_dtype, device=dev),
                xk=z(*xshape), xv=z(*xshape),
                tok=z(beam, 1, dtype=torch.long),
                pos=z(beam, 1, dtype=torch.long), n_past=z(dtype=torch.long),
                vals=z(beam, k), idx=z(beam, k, dtype=torch.long),
                logits=z(beam, cfg.n_vocab))
            me = weakref.ref(self)
            st.run = CapturedStep(lambda: me()._captured(st), dev,
                                  self.graph_pool)
            self._static[key] = st
        return self._static[key]

    def _captured(self, st):
        """What a captured step runs: a decode step over st's tensors, its
        results copied into st's outputs."""
        cross = (st.xk, st.xv)
        if st.k:
            vals, idx, _ = self._decode_topk(self.params, st.tok, st.pos,
                                             st.cache, cross, st.n_past,
                                             k=st.k)
            st.vals.copy_(vals)
            st.idx.copy_(idx)
        else:
            logits, _ = self._decode(self.params, st.tok, st.pos, st.cache,
                                     cross, st.n_past)
            st.logits.copy_(logits[:, -1])

    def _fill(self, st, nxt, n_past: int):
        """A captured step's inputs: the tokens just picked, at n_past."""
        st.tok.copy_(self._tensor(np.asarray(nxt, np.int64)[:, None]))
        st.pos.fill_(n_past)
        st.n_past.fill_(n_past)

    @property
    def capture_s(self) -> float:
        """Seconds the captured steps' warm-ups and captures took."""
        return sum(st.run.capture_s for st in self._static.values())

    def _run_beam(self, cross, prompt, fp: FullParams, temperature: float,
                  rng: np.random.Generator):
        """One decoding attempt at one temperature. Returns
        (tokens, avg_logprob, entropy)."""
        cfg = self.cfg
        beam = fp.beam_size if temperature == 0.0 else 1
        n_ctx = cfg.n_text_ctx
        max_new = fp.max_tokens or (n_ctx // 2 - len(prompt))
        use_topk = temperature == 0.0
        K2 = 2 * beam

        xk, xv = cross
        if self.graphs:
            st = self._static_step(beam, K2 if use_topk else 0)
            cache = st.cache
            for t in (cache.k, cache.v, cache.ks, cache.vs):
                if t is not None:
                    t.zero_()
            st.xk.copy_(xk.expand_as(st.xk))
            st.xv.copy_(xv.expand_as(st.xv))
            cross_b = (st.xk, st.xv)
        else:
            cache = W.init_cache(cfg, batch=beam, dtype=self.compute_dtype,
                                 device=self.device)
            cross_b = (xk.repeat_interleave(beam, dim=1),
                       xv.repeat_interleave(beam, dim=1))

        toks = np.tile(np.asarray(prompt, np.int32)[None], (beam, 1))
        pos = np.tile(np.arange(len(prompt), dtype=np.int32)[None], (beam, 1))
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

            # the KV cache follows the surviving beams (a gather on the
            # device; in place where a graph holds the cache's address)
            if order != list(range(beam)):
                if self.graphs:
                    cache.reorder_(self._tensor(order))
                else:
                    cache = cache.select_batch(self._tensor(order))
            if self.graphs:
                self._fill(st, nxt, n_past)
                st.run()
                if use_topk:
                    vals_h, idx_h = st.vals.cpu().numpy(), st.idx.cpu().numpy()
                else:
                    logp = log_softmax(st.logits)
            else:
                tok_step = self._tensor(np.asarray(nxt, np.int32)[:, None])
                pos_step = torch.full((beam, 1), n_past, dtype=torch.long,
                                      device=self.device)
                if use_topk:
                    vals, idx, cache = self._decode_topk(
                        self.params, tok_step, pos_step, cache, cross_b,
                        n_past, k=K2)
                    vals_h, idx_h = vals.cpu().numpy(), idx.cpu().numpy()
                else:
                    logits, cache = self._decode(self.params, tok_step,
                                                 pos_step, cache, cross_b,
                                                 n_past)
                    logp = log_softmax(logits[:, 0])
            n_past += 1
            if n_past >= n_ctx - 1:
                break

        self.last_cache = cache
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
            tt = None
            if fp.token_timestamps and tokens:
                full = token_timestamps(self, cross, prompt + tokens,
                                        t_offset=seek / SAMPLE_RATE)
                tt = list(full[len(prompt):])
            segments.append(Segment(
                t0=seek / SAMPLE_RATE,
                t1=min(n, seek + N_SAMPLES) / SAMPLE_RATE,
                tokens=tokens, text=self.decode_text(tokens),
                avg_logprob=avg_lp, temperature=used_t, token_times=tt))
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
                if seg.token_times is not None:
                    seg.token_times = [t + off for t in seg.token_times]
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


# -- DTW token timestamps --------------------------------------------------

def _median_filter(w: np.ndarray, width: int = 7) -> np.ndarray:
    """Median filter along the last (audio) axis, edge-padded: the
    smoothing applied to the alignment attention before DTW."""
    pad = width // 2
    wp = np.pad(w, [(0, 0)] * (w.ndim - 1) + [(pad, pad)], mode="edge")
    stack = np.stack([wp[..., i:i + w.shape[-1]] for i in range(width)], -1)
    return np.median(stack, axis=-1)


def _dtw_path(cost: np.ndarray) -> np.ndarray:
    """Monotonic DTW over cost (T_text, T_audio); returns for each text row
    the matched audio column (backtraced path, first visit per row)."""
    n, m = cost.shape
    D = np.full((n + 1, m + 1), np.inf, np.float64)
    D[0, 0] = 0.0
    for i in range(1, n + 1):
        row_prev = D[i - 1]
        row = D[i]
        for j in range(1, m + 1):
            row[j] = cost[i - 1, j - 1] + min(row_prev[j - 1], row_prev[j],
                                              row[j - 1])
    # backtrace
    i, j = n, m
    match = np.zeros(n, np.int64)
    while i > 0:
        match[i - 1] = j - 1
        moves = (D[i - 1, j - 1], D[i - 1, j], D[i, j - 1])
        a = int(np.argmin(moves))
        if a == 0:
            i, j = i - 1, j - 1
        elif a == 1:
            i = i - 1
        else:
            j = j - 1
            if j == 0:
                j = 1
    return match


def alignment_weights(pipe: WhisperPipeline, cross, tokens: list,
                      alignment_heads=None) -> np.ndarray:
    """The device part of token_timestamps: one teacher-forced decode pass
    over `tokens` (batch 1, a fresh cache) with return_cross_attn, the
    alignment heads' probabilities selected on the device (by default
    every head of the text layers L/2..L-1, layer-major) and fetched:
    (A, T, T_audio) f32."""
    cfg = pipe.cfg
    cache = W.init_cache(cfg, batch=1, dtype=pipe.compute_dtype,
                         device=pipe.device)
    toks = pipe._tensor(np.asarray(tokens, np.int64)[None])
    pos = pipe._tensor(np.arange(len(tokens), dtype=np.int64)[None])
    _, _, probs = W.decode(cfg, pipe.params, toks, pos, cache, cross, 0,
                           compute_dtype=pipe.compute_dtype,
                           return_cross_attn=True)
    L, _, H, T, TA = probs.shape
    if alignment_heads is None:
        sel = probs[L // 2:, 0].reshape(-1, T, TA)
    else:
        ls, hs = (pipe._tensor([a[i] for a in alignment_heads])
                  for i in (0, 1))
        sel = probs[ls, 0, hs]
    return sel.cpu().numpy()


def token_timestamps(pipe: WhisperPipeline, cross, tokens: list, *,
                     alignment_heads=None, t_offset: float = 0.0):
    """DTW token-level timestamps for one decoded segment.

    cross: the cross K/V of the segment's audio window; tokens: the full
    token sequence (prompt + text). The alignment heads' cross-attention
    (alignment_weights: all heads of the top half of the text layers by
    default, the fallback when no preset names them) is median-filtered,
    normalized over the audio axis, averaged over the heads and
    DTW-aligned on the host. Returns seconds per token (len == len(tokens));
    each audio column is 20 ms (2 mel frames)."""
    w = alignment_weights(pipe, cross, tokens, alignment_heads)
    w = _median_filter(w)
    std = w.std(axis=-1, keepdims=True)
    w = (w - w.mean(axis=-1, keepdims=True)) / np.where(std > 0, std, 1.0)
    cost = -w.mean(axis=0)                    # (T, TA)
    match = _dtw_path(cost)
    return t_offset + match.astype(np.float64) * 0.02
