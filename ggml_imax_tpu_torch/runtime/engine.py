"""Generation engine: bucketed prefill and a decode loop (counterpart of
ggml_imax_tpu/runtime/engine.py).

PyTorch runs eagerly, so a single step calls the model's forward directly,
the KV cache is updated in place, and the host samples from the step's
logits. The reference's on-device k-step loop (generate(chunk > 1): jit of
a lax.scan over decode steps with sampling on the device) becomes a decode
span here: k forwards and k on-device draws written against static tensors
(the token, n_past and the sampling parameters in, the ids out), captured
once into a CUDA graph on the card and replayed, one fetch a span; on the
CPU the same span runs eagerly.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch

from .. import _build
from .._device import resolve_device
from ..ops import qmatmul as _qmatmul
from ..ops.qmm import params_repack
from ..ops.sampling import gumbel, sample_gumbel, sample_greedy, sample_host
from ..quant.device import QTensor, params_to_dense_bf16


def _bucket(n: int, buckets=(8, 16, 32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


@dataclass
class PerfCounters:
    """Per-phase wall times; on the card each phase ends in a fetch or
    torch.cuda.synchronize(), so they are device times plus host overhead.
    load_us is the caller's (model load); report() prints the reference's
    text."""
    load_us: float = 0.0
    prefill_us: float = 0.0
    decode_us: float = 0.0
    n_prefill: int = 0
    n_decode: int = 0

    def report(self) -> str:
        lines = []
        if self.n_prefill:
            lines.append(f"prefill: {self.n_prefill} tok in {self.prefill_us/1e3:.1f} ms "
                         f"({self.prefill_us/max(1,self.n_prefill):.0f} us/tok)")
        if self.n_decode:
            lines.append(f"decode:  {self.n_decode} tok in {self.decode_us/1e3:.1f} ms "
                         f"({self.decode_us/max(1,self.n_decode):.0f} us/tok, "
                         f"{1e6*self.n_decode/max(1.0,self.decode_us):.1f} tok/s)")
        return "\n".join(lines)


class CapturedStep:
    """fn, a function of tensors that outlive it (its inputs filled before
    each run, its results copied by fn into tensors of its owner), run as
    one CUDA graph on the card. On the CPU each run calls fn. On the card
    the first run calls fn eagerly on a side stream, the warm-up, whose
    results stand (it also loads the kernel library and runs each C entry's
    one-time host work), then captures fn into a graph in `pool`; every
    later run replays the graph and adds its launches to `_build.LAUNCHES`
    (`_build.CapturedLaunches`). A failed capture raises, and so does any
    run on the card while an activation observer or sim is set (a replay
    would run none of their Python: ops.qmatmul.refuse_capture). Whatever a
    captured fn reads on the card must stay where it is: the owner
    allocates its inputs, outputs and KV arena once. fn holds its owner by
    a weak reference and is held by no tensor it reads, so dropping the
    owner frees the graph at once: a reference cycle would leave it (and
    the owner's weights) to the cyclic collector, which may run at any
    time, a capture included."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 pool=None):
        self.fn, self.device, self.pool = fn, device, pool
        self.graph = None
        self.launches = _build.CapturedLaunches()
        self.capture_s = 0.0            # the warm-up and the capture, seconds

    def __call__(self):
        if self.device.type != "cuda":
            self.fn()
            return
        _qmatmul.refuse_capture("a captured step")
        if self.graph is not None:
            self.graph.replay()
            self.launches.replayed()
        else:
            t0 = time.perf_counter()
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self.fn()
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with self.launches.capture(), \
                    torch.cuda.graph(graph, pool=self.pool):
                self.fn()
            self.graph = graph
            self.capture_s = time.perf_counter() - t0


def _qtensors(tree):
    if isinstance(tree, dict):
        return [q for v in tree.values() for q in _qtensors(v)]
    if isinstance(tree, list):
        return [q for v in tree for q in _qtensors(v)]
    return [tree] if isinstance(tree, QTensor) else []


def q4_resident(model_module, cfg, params):
    """The "q4-fused" residency's params: model_module.prepare_fused (or
    fuse_qkv where the model has no prepare_fused), then
    ops.qmm.params_repack. Raises ValueError for params already repacked."""
    if any(q.interleaved_bk for q in _qtensors(params)):
        raise ValueError("the q4 residencies prepare unprepared params; these "
                         "are already repacked (pass them with "
                         "residency='as-is')")
    if hasattr(model_module, "prepare_fused"):
        params = model_module.prepare_fused(params, cfg)
    elif hasattr(model_module, "fuse_qkv"):
        params = model_module.fuse_qkv(params)
    return params_repack(params)


class Engine:
    """Single-sequence/batched generation over a model module exposing
    forward(cfg, params, tokens, positions, cache, n_past, ...) and
    init_cache(cfg, batch, n_ctx, dtype, device=...). The params are used
    as given (for the kernels: the model's prepare_fused, then
    ops.qmm.params_repack). device: where tokens and the cache live — the
    card unless "cpu" is passed; it must match the params'.
    fused_kv_update: single-token steps write their K/V row inside the
    attention kernel (the fused kernel's flat mode; a model without that
    route raises).
    residency: "as-is" (the default: the params as given), "q4-fused"
    (the model's prepare_fused, or fuse_qkv where it has none, then
    ops.qmm.params_repack: the decode graph the kernels take, built from
    unprepared params, as the reference's residency builds it), "q4-stacked"
    ("q4-fused" with fused_kv_update on a model that has that route: the
    reference stacks the layers and writes each step's K/V inside its
    attention kernel, and the port's per-layer lists leave only the fused
    write to add; GPT-2, whose head_dim 64 keeps decode attention plain, has
    no such route, so there it equals "q4-fused") or "bf16" (every QTensor
    dequantized once, on its device, into a dense bf16 one:
    quant.device.params_to_dense_bf16). The q4 residencies refuse params
    that are already repacked (ValueError) rather than prepare them twice.

    generate() runs in the engine's own KV arena, allocated once (a
    captured span holds its addresses) and cleared at each call; its decode
    spans are cached per (span, batch, candidate window), as the
    reference's compiled chunk steps are, and share one graph memory pool."""

    def __init__(self, model_module, cfg, params, *,
                 compute_dtype=torch.bfloat16, kv_dtype=torch.bfloat16,
                 n_ctx: int | None = None, batch: int = 1, device=None,
                 fused_kv_update: bool = False, residency: str = "as-is"):
        if residency in ("q4-fused", "q4-stacked"):
            params = q4_resident(model_module, cfg, params)
            if residency == "q4-stacked":
                fused_kv_update = fused_kv_update or getattr(
                    model_module, "FUSED_KV_UPDATE", False)
        elif residency == "bf16":
            params = params_to_dense_bf16(params)
        elif residency != "as-is":
            raise ValueError(residency)
        self.residency = residency
        self.device = resolve_device(device)
        self.fused_kv_update = fused_kv_update
        self.model = model_module
        self.cfg = cfg
        self.params = params
        self.compute_dtype = compute_dtype
        self.kv_dtype = kv_dtype
        self.n_ctx = n_ctx or cfg.n_ctx
        self.batch = batch
        self.perf = PerfCounters()
        self.arena = None               # generate()'s KV cache, made once
        self.graph_pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None   # the spans' graphs
        self._spans: dict = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self, tokens: np.ndarray, positions: np.ndarray, cache, n_past):
        toks = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)
        pos = torch.as_tensor(positions, dtype=torch.int64, device=self.device)
        return self.model.forward(self.cfg, self.params, toks, pos, cache,
                                  n_past, compute_dtype=self.compute_dtype,
                                  fused_kv_update=self.fused_kv_update)

    def new_cache(self):
        return self.model.init_cache(self.cfg, batch=self.batch,
                                     n_ctx=self.n_ctx, dtype=self.kv_dtype,
                                     device=self.device)

    def prefill(self, cache, tokens: np.ndarray, n_past: int = 0):
        """tokens: (B, T). Pads T to a bucket; returns (last_logits, cache)."""
        b, t = tokens.shape
        if t == 0:
            raise ValueError("empty prompt: tokenizer produced 0 tokens")
        tb = min(_bucket(t), self.n_ctx)
        pad = tb - t
        toks = np.pad(tokens, ((0, 0), (0, pad)))
        # padded positions repeat the last real position so their KV rows
        # land in already-valid slots and are overwritten by later steps
        pos = np.pad(np.arange(n_past, n_past + t, dtype=np.int32)[None]
                     .repeat(b, 0), ((0, 0), (0, pad)), mode="edge")
        t0 = time.perf_counter()
        logits, cache = self._step(toks, pos, cache, n_past)
        last = logits[:, t - 1].cpu().numpy()
        self._sync()
        self.perf.prefill_us += (time.perf_counter() - t0) * 1e6
        self.perf.n_prefill += t
        return last, cache

    def decode_step(self, cache, token_ids: np.ndarray, n_past: int):
        """token_ids: (B,) -> (logits (B, V), cache)."""
        b = token_ids.shape[0]
        t0 = time.perf_counter()
        logits, cache = self._step(token_ids.reshape(b, 1),
                                   np.full((b, 1), n_past, np.int32), cache,
                                   n_past)
        out = logits[:, 0].cpu().numpy()
        self._sync()
        self.perf.decode_us += (time.perf_counter() - t0) * 1e6
        self.perf.n_decode += 1
        return out, cache

    # -- decode spans (the reference's _chunk_step) ----------------------------
    def _arena(self):
        if self.arena is None:
            self.arena = self.new_cache()
        return self.arena

    @staticmethod
    def _advance(st, nxt):
        """The span's carry: the token just drawn and n_past + 1 are the
        next step's inputs."""
        st.tok.copy_(nxt)
        st.n_past.add_(1)

    def _run_span(self, st, span: int):
        """`span` decode steps in the arena from st's static inputs: embed,
        every layer, the logits, then greedy where temp <= 0 and a draw on
        st.u's noise otherwise; each step's ids into st.ids, the last
        step's logits into st.logits."""
        b = st.tok.shape[0]
        for i in range(span):
            logits, _ = self.model.forward(
                self.cfg, self.params, st.tok[:, None],
                st.n_past.expand(b, 1), self.arena, st.n_past,
                compute_dtype=self.compute_dtype,
                fused_kv_update=self.fused_kv_update)
            lg = logits[:, 0].float()
            drawn = sample_gumbel(lg, gumbel(st.u[i]), top_k=st.top_k,
                                  top_p=st.top_p, temp=st.temp)
            nxt = torch.where(st.temp <= 0, lg.argmax(-1), drawn)
            st.ids[i].copy_(nxt)
            self._advance(st, nxt)
        st.logits.copy_(lg)

    def _span(self, span: int, b: int, k_max: int):
        """(static tensors, CapturedStep) of a span."""
        key = (span, b, k_max)
        if key not in self._spans:
            z = lambda *shape, dtype=torch.float32: torch.zeros(
                shape, dtype=dtype, device=self.device)
            st = SimpleNamespace(
                tok=z(b, dtype=torch.int64), n_past=z(dtype=torch.int64),
                temp=z(), top_k=z(dtype=torch.int64), top_p=z(),
                u=z(span, b, k_max), ids=z(span, b, dtype=torch.int64),
                logits=z(b, self.cfg.n_vocab))
            me = weakref.ref(self)
            self._spans[key] = (st, CapturedStep(
                lambda: me()._run_span(st, span), self.device,
                self.graph_pool))
        return self._spans[key]

    @property
    def capture_s(self) -> float:
        """Seconds the spans' warm-ups and captures took, all told."""
        return sum(run.capture_s for _, run in self._spans.values())

    def decode_span(self, token_ids, n_past: int, span: int, *,
                    temp: float = 0.0, top_k: int = 40, top_p: float = 0.9,
                    generator: torch.Generator | None = None) -> np.ndarray:
        """`span` decode steps of the batch in the engine's arena, which
        holds rows [0, n_past), from token_ids (B,) at n_past, sampling on
        the device (greedy where temp <= 0; else the draws' uniforms come
        from `generator`, one torch.rand before the run). Returns the
        (span, B) ids, one fetch; the arena then holds n_past + span rows."""
        b = len(token_ids)
        k_max = min(self.cfg.n_vocab, max(64, top_k))
        self._arena()
        st, run = self._span(span, b, k_max)
        for row, tok in enumerate(token_ids):
            st.tok[row].fill_(int(tok))
        st.n_past.fill_(n_past)
        st.temp.fill_(temp)
        st.top_k.fill_(top_k)
        st.top_p.fill_(top_p)
        if temp > 0:
            torch.rand(st.u.shape, generator=generator, device=self.device,
                       out=st.u)
        run()
        return st.ids.cpu().numpy()

    def generate(self, prompt_tokens, n_predict: int, *, top_k: int = 40,
                 top_p: float = 0.9, temp: float = 0.9, seed: int = 0,
                 eos_id: int | None = None,
                 callback: Callable[[int], None] | None = None,
                 chunk: int = 1) -> list[int]:
        """Single-sequence generation (batch 1), reference-CLI semantics:
        temp <= 0 is greedy, otherwise sample_host. The first token is
        picked on the host from the prefill's logits. chunk > 1 decodes in
        spans of min(chunk, tokens left, n_ctx - n_past) steps with
        on-device sampling (decode_span; its draws from a torch.Generator
        seeded with `seed`), one fetch a span, so the callback fires in
        bursts and an eos inside a span cuts the output there (the span's
        later steps ran and are dropped); a span of 1 is a decode_step."""
        rng = np.random.default_rng(seed)
        gen = None

        def pick(lg):
            if temp <= 0:
                return sample_greedy(lg)
            return sample_host(lg, top_k=top_k, top_p=top_p, temp=temp,
                               rng=rng)

        cache = self._arena()
        for t in (cache.k, cache.v, cache.ks, cache.vs):
            if t is not None:
                t.zero_()
        tokens = list(map(int, prompt_tokens))
        logits, cache = self.prefill(cache, np.asarray([tokens], np.int32))
        n_past = len(tokens)
        out = [pick(logits[0])]
        if callback:
            callback(out[-1])
        while len(out) < n_predict and n_past < self.n_ctx:
            if eos_id is not None and out[-1] == eos_id:
                break
            span = min(chunk, n_predict - len(out), self.n_ctx - n_past)
            if span == 1:
                logits, cache = self.decode_step(cache, np.asarray([out[-1]]),
                                                 n_past)
                n_past += 1
                out.append(pick(logits[0]))
                if callback:
                    callback(out[-1])
                continue
            if gen is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed)
            t0 = time.perf_counter()
            ids = self.decode_span([out[-1]], n_past, span, temp=temp,
                                   top_k=top_k, top_p=top_p, generator=gen)
            self.perf.decode_us += (time.perf_counter() - t0) * 1e6
            self.perf.n_decode += span
            n_past += span
            for tok in map(int, ids[:, 0]):
                out.append(tok)
                if callback:
                    callback(tok)
                if eos_id is not None and tok == eos_id:
                    return out
        return out
