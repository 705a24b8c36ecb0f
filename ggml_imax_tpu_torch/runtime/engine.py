"""Generation engine: bucketed prefill and a host-driven decode loop
(counterpart of ggml_imax_tpu/runtime/engine.py).

PyTorch runs eagerly, so there is nothing to compile: each step calls the
model's forward directly, the KV cache is updated in place, and the host
samples from the step's logits. The on-device k-step loop of the reference
(generate(chunk > 1)) is not ported yet; on this card it becomes CUDA-graph
capture of the step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .._device import resolve_device
from ..ops.sampling import sample_greedy, sample_host


def _bucket(n: int, buckets=(8, 16, 32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


@dataclass
class PerfCounters:
    """Per-phase wall times; on the card each phase ends in
    torch.cuda.synchronize(), so they are device times plus host overhead."""
    prefill_us: float = 0.0
    decode_us: float = 0.0
    n_prefill: int = 0
    n_decode: int = 0


class Engine:
    """Single-sequence/batched generation over a model module exposing
    forward(cfg, params, tokens, positions, cache, n_past, ...) and
    init_cache(cfg, batch, n_ctx, dtype, device=...). The params are used
    as given (for the kernels: the model's prepare_fused, then
    ops.qmm.params_repack). device: where tokens and the cache live — the
    card unless "cpu" is passed; it must match the params'.
    fused_kv_update: single-token steps write their K/V row inside the
    attention kernel (the fused kernel's flat mode; a model without that
    route raises)."""

    def __init__(self, model_module, cfg, params, *,
                 compute_dtype=torch.bfloat16, kv_dtype=torch.bfloat16,
                 n_ctx: int | None = None, batch: int = 1, device=None,
                 fused_kv_update: bool = False):
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

    def generate(self, prompt_tokens, n_predict: int, *, top_k: int = 40,
                 top_p: float = 0.9, temp: float = 0.9, seed: int = 0,
                 eos_id: int | None = None,
                 callback: Callable[[int], None] | None = None,
                 chunk: int = 1) -> list[int]:
        """Single-sequence generation (batch 1), reference-CLI semantics:
        temp <= 0 is greedy, otherwise sample_host."""
        if chunk > 1:
            raise NotImplementedError(
                "generate(chunk > 1), the on-device k-step loop, is not "
                "ported yet (CUDA-graph capture of the decode step)")
        rng = np.random.default_rng(seed)

        def pick(lg):
            if temp <= 0:
                return sample_greedy(lg)
            return sample_host(lg, top_k=top_k, top_p=top_p, temp=temp,
                               rng=rng)

        cache = self.new_cache()
        tokens = list(map(int, prompt_tokens))
        logits, cache = self.prefill(cache, np.asarray([tokens], np.int32))
        n_past = len(tokens)
        out = [pick(logits[0])]
        if callback:
            callback(out[-1])
        while len(out) < n_predict and n_past < self.n_ctx:
            if eos_id is not None and out[-1] == eos_id:
                break
            logits, cache = self.decode_step(cache, np.asarray([out[-1]]),
                                             n_past)
            n_past += 1
            out.append(pick(logits[0]))
            if callback:
                callback(out[-1])
        return out
