#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths on one NVIDIA GPU: GPT-J-6B Q4_0
(one stream, and continuous-batching serving), GPT-2 1558M (XL) Q8_0,
GPT-2 117M training steps, and GPT-2 117M in Q3_K and Q2_K (with the
row-pair and u-order int8 layouts).

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):

1. setup: device facts, `nvidia-smi` name and power limit, the kernel build
   from ggml_imax_tpu_torch/csrc (nvcc -Xptxas -v summary);
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the main paths' shapes (GPT-J: natpair W4A8/W4A16 (M 512,
   the serving ubatches M 8 and 128, each with the route and K split
   it took, and its time at other K splits), decode attention, flash;
   serving:
   cells decode attention at 8 rows over a 2048-cell arena, the fused
   KV-update kernel in flat mode at T 512 and in cells mode at 8 rows x
   2048, flash at a mixed ubatch's 128 rows over that q8_0 arena; GPT-2
   XL: nat8 W8A8/W8A16 on fc_w, flash at D = 64; GPT-2 117M training:
   flash with lse and the dQ and dK/dV backward kernels at B 8, T 512, 12
   heads of 64, the backward kernels also at D 256 and on a ragged GQA +
   softcap + ALiBi case with a fully masked row; dx through the W4A16 and
   W8A16 routes against the plain routes; GPT-2 117M K-quants: the
   plane-split W4A16 kernel on Q3_K and Q2_K weights, the row-pair W4A16
   on Q4_0 and the u-order W8A16 on Q8_0, at attn_w 768x2304 and out_w
   3072x768, M 1 and 8 (the GEMV route) and 512 (the tile route), each
   with the route and K split it took, and a 4096x16384 sizing shape that
   is on no path), with its time (CUDA
   events, L2 flushed before each launch), the plain version's time, one
   PyTorch library call computing the same function (a yardstick only: the
   port never calls it) and the least time the card could take (bound);
3. small models: a 2-layer GPT-J with head_dim 256, and a 2-layer GPT-2
   with head_dim 64 in Q8_0 and in Q4_0, and at n_embd 256 in Q3_K, Q2_K,
   row-pair Q4_0 and u-order Q8_0, on the card (kernels) against the
   same model on the CPU (plain versions), prefill + decode; and the small
   GPT-J's BatchedEngine (two requests and a fork, q8_0 KV, both cells
   routes) on the card against the CPU, ubatch by ubatch;
4. GPT-J engine: synthetic GPT-J-6B Q4_0 drawn on the card, prepare_fused +
   natpair repack, Engine(n_ctx=512) serving 3 requests of a 448-token
   prompt + 64 greedy tokens, with the launch counts of that run; then the
   device busy share of a prefill and of decode steps (torch.profiler
   kernel time against the unprofiled TTFT and step time), and W4A16's
   share of the device time;
5. GPT-2 XL engine: synthetic GPT-2 1558M Q8_0 drawn on the card,
   prepare_fused + nat8 repack, Engine(n_ctx=1024), the same 3 requests,
   launch counts and profile, and the device time of the products the
   reference's N % 128 gate leaves to dequantize + matmul (attn_w, proj_w,
   out_w, the tied LM head) against the step's device time;
6. GPT-J serving: synthetic GPT-J-6B Q4_0, BatchedEngine(n_ctx=2048, q8_0
   KV arena, on-device sampling) under the workload of the reference's
   `examples/serve.py --bench` (8 requests arriving every 4 engine steps,
   64-127-token prompts, 32 tokens each at temp 0.8 / top_k 40 / top_p
   0.95, step_chunk(8)), once to warm up and once timed: aggregate tok/s,
   p50 TTFT, ubatch counts, exact launch counts, peak memory, the device
   busy share of a decode-only ubatch and W4A16's share of it; then a
   short greedy serving pass (two mixed ubatches, a fork, decode-only
   ubatches) held to the same pass
   with every kernel's plain version on the card, and the fused KV-update
   routes on that pass and on Engine decode steps held to the default
   routes (equal tokens, logits within ROUTE_TOL); two planted faults of
   the fused kernel must fail that check;
7. GPT-2 117M training: synthetic F32 weights (124.4 M params), batch
   8 x 512 tokens, a fresh f32 KV cache per loss call, the mean NLL of
   log_softmax, AdamW (alpha 1e-4) through optimize.opt: 2 warm-up steps,
   then 10 timed ones through opt_resume (ms/step, train tok/s, the loss
   must fall, exact launch counts: 12 flash forwards and 12 of each
   backward kernel a step, nothing else), the device busy share of one
   profiled step with the flash kernels' and the KV arena's CopySlices
   share; then one step's loss and gradients with the kernels held to the
   same step with every plain version on the card (TRAIN_TOL), and a
   planted fault (dK without its scale) that must fail that check;
8. GPT-2 117M K-quants: synthetic GPT2Config() weights drawn on the host
   in Q3_K (the reference's numpy stream and codecs), params_repack (every
   layer weight to the plane-split layout), Engine(n_ctx=1024) serving the
   3 requests of phases 4-5 with exact launch counts, the device busy
   share of a prefill and of a decode step and the device time of the
   gated LM head (dequantize + matmul, N 50257); Q2_K, and the legacy
   layouts (Q4_0 through repack_rowpair, Q8_0 through repack_int8_rows),
   one request each; then a short greedy pass of each with the kernels
   held to the same with every plain version on the card (KQ_ROUTE_TOL),
   and a planted fault (the plane-split kernel with its low and high
   scale rows swapped) that must fail that check.

Each engine phase, and the timed training steps, sets the launch counters
to 0 just before its run and reads them just after. The line before the
last is the kernels JSON, the last line is {"ok": true, "device": {...}}.
Needs no arguments, no network and one card.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_S = 3.35e12          # H100 SXM data sheet
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
GPTJ_6B = dict(n_vocab=50400, n_ctx=512, n_embd=4096, n_head=16, n_layer=28,
               n_rot=64)
GPT2_XL = dict(n_vocab=50257, n_ctx=1024, n_embd=1600, n_head=25, n_layer=48)
PROMPT, N_PREDICT, N_REQUESTS = 448, 64, 3
# examples/serve.py --bench: n_ctx, requests, arrival every k engine steps,
# prompt lengths [lo, hi), tokens per request, decode steps per chunk
SERVE = dict(n_ctx=2048, n_req=8, arrive=4, plen=(64, 128), n_predict=32,
             chunk=8)
# Two sound greedy runs of GPT-J-6B (the fused KV-update routes against the
# default ones; kernels against plain versions) agree to this share of the
# largest |logit| (phase 6). A run rounds a few terms differently (the fresh
# row's p is not rounded to bf16; sums in another order), which flips bf16
# and int8 activation roundings downstream. Readings of this script on an
# H100 (PERF.md): sound runs at most 1.66% (the Engine's fused route);
# the planted fault the limit alone must catch (the fresh row written one
# row off, Engine, tokens still equal) at least 8.1%. 3.5% lies between.
ROUTE_TOL = 3.5e-2
# GPT-2 117M training (tools/bench_train.py's batch shape, quality_gate.py's
# loss): 2 warm-up AdamW steps through optimize.opt, then `steps` timed ones
# through opt_resume
GPT2_117M = dict(n_vocab=50257, n_ctx=1024, n_embd=768, n_head=12, n_layer=12)
TRAIN = dict(batch=8, seq=512, warmup=2, steps=10, alpha=1e-4)
# A training step's loss and gradients with the kernels against the same
# step with every plain version on the card (phase 7): max |dg| per leaf
# within this share of that leaf's largest |g|. The two round P and dS to
# bf16 at the same points but sum in another order, so a rounding flips
# here and there. Readings of this script on an H100 (PERF.md): sound at
# most 6.0e-4 (the tied wte); the planted fault (dK without its scale)
# 0.53. 1e-2 is 17x the one, a fiftieth of the other.
TRAIN_TOL = 1e-2
# GPT-2 117M K-quants (phase 8): a short greedy pass (the PROMPT-token
# prompt + 8 tokens) with the kernels, and the same pass fed its tokens
# with every plain version on the card, agree to this share of the largest
# |logit|. The two sum each product in another order, which flips bf16
# roundings of the activations downstream. Readings of this script on an
# H100 (PERF.md): sound runs at most 0.49% (Q2_K; Q3_K 0.47%, row-pair
# 0.46%, u-order 0.42%), the planted fault (the low and high scale rows
# swapped) 120%. 2% is 4x the one and a sixtieth of the other. Fed the
# same tokens, the two passes' picks may part only at a near-tie: the
# random weights give top-2 margins under 1e-2 (the first run, fed its own
# picks, parted the u-order Q8_0 pass that way at the second forward).
KQ_ROUTE_TOL = 2e-2
# kernel -> (source under ggml_imax_tpu_torch/csrc, the TPU kernel it replaces)
KERNELS = {
    "w4a8_gemv": ("w4a8_gemv.cu", "ggml_imax_tpu/ops/pallas_qmm.py:960"),
    "w4a16_gemm": ("w4a16_gemm.cu", "ggml_imax_tpu/ops/pallas_qmm.py:1077"),
    "decode_attention": ("decode_attention.cu",
                         "ggml_imax_tpu/ops/decode_attention.py:74"),
    "flash_attention": ("flash_attention.cu",
                        "ggml_imax_tpu/ops/flash_attention.py:44"),
    "nat8_w8a8": ("nat8_gemv.cu", "ggml_imax_tpu/ops/pallas_qmm.py:1181"),
    "nat8_w8a16": ("nat8_gemm.cu", "ggml_imax_tpu/ops/pallas_qmm.py:1212"),
    "decode_attention_cells": ("decode_attention_cells.cu",
                               "ggml_imax_tpu/ops/decode_attention.py:129"),
    "decode_attention_update": ("decode_attention_update.cu",
                                "ggml_imax_tpu/ops/decode_attention.py:376"),
    "flash_backward_dq": ("flash_backward.cu",
                          "ggml_imax_tpu/ops/flash_backward.py:67"),
    "flash_backward_dkv": ("flash_backward.cu",
                           "ggml_imax_tpu/ops/flash_backward.py:97"),
    "planes_w4a16": ("permuted_gemm.cu", "ggml_imax_tpu/ops/pallas_qmm.py:249"),
    "rowpair_w4a16": ("permuted_gemm.cu",
                      "ggml_imax_tpu/ops/pallas_qmm.py:287"),
    "int8_rows_w8a16": ("permuted_gemm.cu",
                        "ggml_imax_tpu/ops/pallas_qmm.py:1388"),
}


def log(*a):
    print(*a, flush=True)


def bound(nbytes: float, ops: float, peak: float):
    t_mem, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


class Timer:
    """Mean ms per call from CUDA events; a 256 MB buffer is rewritten
    before each call so the weights come from device memory, not L2."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        evs = []
        for _ in range(iters):
            self.flush.zero_()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in evs) / iters


def rel_err(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def abs_err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max())


class Checks:
    """Kernel-vs-plain checks: errors, failures, and per kernel the JSON
    entry of its first timed call (its main-path shape)."""

    def __init__(self):
        self.results: dict = {}
        self.errs: dict = {}
        self.failures: list[str] = []

    def record(self, name, label, got, ref, tol, ms=None, plain_ms=None,
               lib_ms=None, nbytes=0, ops=0, peak=PEAK_BF16):
        err = rel_err(got, ref)
        self.errs.setdefault(name, []).append(abs_err(got, ref))
        ok = err <= tol
        line = (f"  {name:16s} {label:30s} rel_err {err:.2e} (tol {tol:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(f"{name} {label}: rel_err {err:.3e} > {tol:.0e}")
        if ms is not None:
            b_ms, b_by = bound(nbytes, ops, peak)
            lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
            line += (f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
                     f"{lib}  bound {b_ms:.4f} ms ({b_by})")
            src, replaces = KERNELS[name]
            self.results.setdefault(name, {
                "name": name, "route": "cuda",
                "source": f"ggml_imax_tpu_torch/csrc/{src}",
                "replaces": replaces, "shape": label, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms})
        log(line)


def random_natpair(K, N, gen):
    from ggml_imax_tpu_torch.quant.device import QTensor
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    q = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8, generator=gen,
                      device="cuda")
    s = torch.randn((K // 32, N), generator=gen, device="cuda").abs_() \
        .mul_(0.02 / 4.6)
    return QTensor("nib4", q, s, None, K, N, GGMLType.Q4_0, zero=8,
                   interleaved_bk=512, q4_layout=3)


def random_nat8(K, N, gen, g=32, scale_dtype=torch.float32, bias=False):
    from ggml_imax_tpu_torch.quant.device import QTensor
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    q = torch.randint(-127, 128, (K, N), dtype=torch.int8, generator=gen,
                      device="cuda")
    s = torch.randn((K // g, N), generator=gen, device="cuda").abs_() \
        .mul_(0.02 / 73.6)
    b = None
    if bias:
        b = (torch.randn((K // g, N), generator=gen, device="cuda") * 0.01) \
            .to(scale_dtype)
    return QTensor("int8", q, s.to(scale_dtype), b, K, N,
                   GGMLType.Q6_K if g == 16 else GGMLType.Q8_0,
                   interleaved_bk=K, q4_layout=4)


def flash_case(ck, timer, gen, label, B, Tq, Tk, Hq, Hkv, Dh, kw, timed,
               q_off=None, kv=None, visible=None):
    """One flash-attention case; causal over positions q_off + i (the last
    Tq keys by default), keys at or past q_off + Tq masked as the engine's
    bucketed prefill masks them. kv: the keys and values (B, Tk, Hkv, Dh)
    instead of random ones; visible: a (B, Tq, Tk) bool visibility instead
    of the causal one."""
    from ggml_imax_tpu_torch.ops import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = torch.randn(B, Tq, Hq, Dh, generator=gen, device="cuda")
    k, v = kv if kv is not None else (
        torch.randn(B, Tk, Hkv, Dh, generator=gen, device="cuda")
        for _ in range(2))
    q_off = Tk - Tq if q_off is None else q_off
    qi = torch.arange(Tq, device="cuda")[:, None] + q_off
    if visible is None:
        visible = torch.arange(Tk, device="cuda")[None, :] <= qi
    visible = visible.expand(B, Tq, Tk)
    if kw.get("max_bias"):
        dist = (torch.arange(Tk, device="cuda")[None, :] - qi).float()
        mask = torch.where(visible, dist, float("-inf"))[:, None]
    else:
        mask = torch.where(visible, 0.0, float("-inf"))[:, None]
    prep = fa._prep(q, k, v, mask, kw.get("max_bias", 0.0))
    args = prep + (1.0 / math.sqrt(Dh), kw.get("logit_softcap", 0.0),
                   kw.get("want_lse", False))
    got, got_lse = fa.flash_attention_kernel(*args)
    ref, ref_lse = fa.flash_attention_plain(*args)
    if got_lse is not None:
        ck.record("flash_attention", label + " (lse)", got_lse, ref_lse, 1e-4)
    timing = {}
    if timed:
        qb, kb, vb = (t.to(torch.bfloat16).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        timing = dict(
            ms=timer(lambda: fa.flash_attention_kernel(*args), iters=50),
            plain_ms=timer(lambda: fa.flash_attention_plain(*args), iters=5),
            lib_ms=timer(lambda: sdpa(qb, kb, vb, attn_mask=visible[:, None]),
                         iters=50),
            nbytes=(B * Tq * Hq + 2 * B * Tk * Hkv) * Dh * 2
            + B * Tq * Tk * 4 + B * Tq * Hq * Dh * 4,
            ops=4 * B * Hq * Tq * Tk * Dh)
    ck.record("flash_attention", label, got, ref, 1e-2, **timing)


def split_times(timer, qmm, x, qt):
    """The W4A16 kernel's time at K splits 1, 2, 4, 5 and 8 in place of its
    plan's (the readings natpair_plan's rule rests on)."""
    plan = qmm.natpair_plan
    route = plan(x.shape[0], qt.k, qt.n)[0]
    units = qt.k // 32 if route == "small" else -(-qt.k // 64)
    try:
        for s in (1, 2, 4, 5, 8):
            if units % s == 0:
                qmm.natpair_plan = lambda *a, s=s: (route, s)
                yield s, timer(lambda: qmm.w4a16_gemm(x, qt))
    finally:
        qmm.natpair_plan = plan


def check_gptj_kernels(ck, timer, gen):
    from ggml_imax_tpu_torch.models.common import init_kv_cache, update_kv
    from ggml_imax_tpu_torch.ops import decode_attention as da
    from ggml_imax_tpu_torch.ops import qmm

    E = GPTJ_6B["n_embd"]
    shapes = {"qkvf_w": (E, 7 * E), "of_w": (5 * E, E), "lm_head": (E, 51200)}
    for label, (K, N) in shapes.items():
        qt = random_natpair(K, N, gen)
        wd = qmm.dequant_bf16(qt)                     # library yardstick only
        sbytes = qt.scale.numel() * qt.scale.element_size()
        # A: W4A8 GEMV at m = 1
        x = torch.randn(1, K, generator=gen, device="cuda")
        x8, dx = qmm.quantize_activations_q8(x)
        x8, dx = x8[:, 0].contiguous(), dx[:, 0].contiguous()
        got = qmm.w4a8_gemv(x8, dx, qt)
        ref = qmm.w4a8_gemv_plain(x8, dx, qt)
        xb = x.to(torch.bfloat16)
        ck.record("w4a8_gemv", f"{label} m=1 K={K} N={N}", got, ref, 1e-4,
                  timer(lambda: qmm.w4a8_gemv(x8, dx, qt)),
                  timer(lambda: qmm.w4a8_gemv_plain(x8, dx, qt), iters=3),
                  timer(lambda: torch.matmul(xb, wd)),
                  K * N // 2 + sbytes + K + K // 32 * 4 + N * 4, 2 * K * N,
                  PEAK_INT8)
        # B: W4A16 GEMM at the prefill bucket M = 512, the serving
        # decode-only ubatch M = 8 and a mixed serving ubatch's bucket 128,
        # each with the route and K split it takes
        for M in (512, 8, 128):
            xm = torch.randn(M, K, generator=gen, device="cuda")
            got = qmm.w4a16_gemm(xm, qt)
            ref = qmm.w4a16_gemm_plain(xm, qt)
            xmb = xm.to(torch.bfloat16)
            route, split = qmm.natpair_plan(M, K, N)
            ck.record("w4a16_gemm", f"{label} M={M} K={K} N={N} {route}/"
                      f"{split}", got, ref,
                      1e-3, timer(lambda: qmm.w4a16_gemm(xm, qt)),
                      timer(lambda: qmm.w4a16_gemm_plain(xm, qt), iters=3),
                      timer(lambda: torch.matmul(xmb, wd)),
                      M * K * 2 + K * N // 2 + sbytes + M * N * 4,
                      2 * M * K * N, PEAK_BF16)
            log(f"  {'':16s} {label} M={M} by K split: " + ", ".join(
                f"{s} {ms:.4f} ms" for s, ms in split_times(timer, qmm, xm, qt)))
        del qt, wd

    # C: decode attention over one layer of a 512-row arena, bf16 and q8_0
    H, D, T, L = 16, 256, 512, 2
    scale = 1.0 / math.sqrt(D)
    for kv in (torch.bfloat16, "q8_0"):
        cache = init_kv_cache(L, 1, T, H, D, kv, device="cuda")
        kk = torch.randn(1, T, H, D, generator=gen, device="cuda")
        vv = torch.randn(1, T, H, D, generator=gen, device="cuda")
        update_kv(cache, 1, kk, vv, 0)
        q = torch.randn(1, H, D, generator=gen, device="cuda")
        mask = torch.zeros(1, T, device="cuda")
        mask[:, 500:] = da.NEG                       # n_past = 499
        args = (q, cache.k[1], cache.v[1],
                None if cache.ks is None else cache.ks[1],
                None if cache.vs is None else cache.vs[1], mask, H, scale)
        got = da.decode_attention_kernel(*args)
        ref = da.decode_attention_plain(*args)
        kvb = lambda t: t.to(torch.bfloat16).permute(0, 2, 1, 3).contiguous()
        kb, vb = kvb(kk), kvb(vv)
        qb = q.to(torch.bfloat16)[:, :, None]
        mb = mask.to(torch.bfloat16)[:, None, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        elt = 2 if cache.ks is None else 1 + 4 / 32
        name = "bf16" if cache.ks is None else "q8_0"
        ck.record("decode_attention", f"{name} B=1 H={H} D={D} T={T}", got, ref,
                  1e-2,
                  timer(lambda: da.decode_attention_kernel(*args), iters=50),
                  timer(lambda: da.decode_attention_plain(*args), iters=5),
                  timer(lambda: sdpa(qb, kb, vb, attn_mask=mb), iters=50),
                  H * D * 4 + 2 * T * H * D * elt + T * 4 + H * D * 4,
                  4 * H * T * D, PEAK_BF16)

    # D: flash forward at the prefill shape, plus the small GQA / ALiBi /
    # softcap / LSE cases the GPT-J path does not use
    cases = [("gptj B=1 T=512 H=16 D=256", 1, 512, 512, 16, 16, 256, {}),
             ("gqa 8:2 D=128", 2, 96, 160, 8, 2, 128, {}),
             ("alibi D=64", 1, 64, 64, 8, 8, 64, {"max_bias": 8.0}),
             ("softcap D=128", 1, 80, 80, 4, 4, 128, {"logit_softcap": 30.0}),
             ("lse D=256", 1, 64, 128, 2, 2, 256, {"want_lse": True})]
    for label, B, Tq, Tk, Hq, Hkv, Dh, kw in cases:
        flash_case(ck, timer, gen, label, B, Tq, Tk, Hq, Hkv, Dh, kw,
                   timed=label.startswith("gptj"))


def check_serving_kernels(ck, timer, gen):
    """The serving path's attention kernels at GPT-J-6B width (16 heads of
    256): read-only cells attention for 8 query rows (one a pad row) over a
    2048-cell arena, bf16 and q8_0; the fused KV-update kernel in flat mode
    at the Engine's B 1 / T 512 (bf16) and in cells mode at 8 rows x 2048
    (q8_0, the serving arena). Each fused launch also writes its rows: the
    kernel's arena must equal the plain version's after the call. Then
    flash at a mixed ubatch's shape: 128 query rows over the 2048-cell q8_0
    arena under a cell mask."""
    from ggml_imax_tpu_torch.models.common import _q8_rows, init_kv_cache, \
        read_kv, update_kv
    from ggml_imax_tpu_torch.ops import decode_attention as da
    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, D = GPTJ_6B["n_head"], GPTJ_6B["n_embd"] // GPTJ_6B["n_head"]
    scale = 1.0 / math.sqrt(D)

    def arena(kv, B, T):
        cache = init_kv_cache(2, B, T, H, D, kv, device="cuda")
        update_kv(cache, 1, torch.randn(B, T, H, D, generator=gen, device="cuda"),
                  torch.randn(B, T, H, D, generator=gen, device="cuda"), 0)
        return cache, (cache.k[1], cache.v[1],
                       None if cache.ks is None else cache.ks[1],
                       None if cache.vs is None else cache.vs[1])

    def library(q3, k, v, ks, vs, visible):
        """SDPA over the dequantized arena with a boolean mask (yardstick)."""
        B = q3.shape[0]
        kd, vd = (da._dense(x, xs, B, H).to(torch.bfloat16)
                  for x, xs in ((k, ks), (v, vs)))
        qb = q3.to(torch.bfloat16)[:, :, None]
        return timer(lambda: sdpa(qb, kd, vd, attn_mask=visible[:, None, None]),
                     iters=50)

    def elt(cache):
        return 2 if cache.ks is None else 1 + 4 / 32

    NB, T = 8, SERVE["n_ctx"]
    seq = torch.randint(0, NB - 1, (T,), generator=gen, device="cuda")
    visible = seq[None] == torch.arange(NB, device="cuda")[:, None]
    visible[NB - 1] = False                          # a pad row: sees nothing
    visible[:, T - 1] = False                        # the trash cell: nobody's
    mask = torch.where(visible, 0.0, da.NEG)
    for kv in ("q8_0", torch.bfloat16):
        cache, ar = arena(kv, 1, T)
        q = torch.randn(NB, H, D, generator=gen, device="cuda")
        args = (q, *ar, mask, H, scale)
        name = "q8_0" if cache.ks is not None else "bf16"
        ck.record("decode_attention_cells", f"{name} NB={NB} H={H} D={D} T={T}",
                  da.decode_attention_cells_kernel(*args),
                  da.decode_attention_plain(*args), 1e-2,
                  timer(lambda: da.decode_attention_cells_kernel(*args), iters=50),
                  timer(lambda: da.decode_attention_plain(*args), iters=5),
                  library(q, *ar, visible),
                  2 * NB * H * D * 4 + 2 * T * H * D * elt(cache) + NB * T * 4,
                  4 * NB * H * T * D, PEAK_BF16)
        del cache, ar

    def fused_case(kv, NB, T, rows, mask, visible, label):
        cache, ar = arena(kv, NB if label == "flat" else 1, T)
        twin = [None if t is None else t.clone() for t in ar]
        q = torch.randn(NB, H, D, generator=gen, device="cuda")
        kn, vn = (torch.randn(NB, 1, H, D, generator=gen, device="cuda")
                  for _ in range(2))
        if cache.ks is not None:
            (k8, kd), (v8, vd) = _q8_rows(kn), _q8_rows(vn)
            fresh = (k8.reshape(NB, -1), v8.reshape(NB, -1),
                     kd.reshape(NB, -1), vd.reshape(NB, -1))
        else:
            fresh = (kn.reshape(NB, -1).bfloat16(), vn.reshape(NB, -1).bfloat16(),
                     None, None)
        tail = (mask, rows, H, scale)
        got = da.decode_attention_update_kernel(q, *ar, *fresh, *tail)
        ref = da.decode_attention_update_plain(q, *twin, *fresh, *tail)
        if not all(a is None or torch.equal(a, b) for a, b in zip(ar, twin)):
            ck.failures.append(f"decode_attention_update {label}: the arena "
                               "differs from the plain version's")
        fbytes = 2 * NB * H * D * elt(cache) * 2   # fresh rows read + written
        name = "q8_0" if cache.ks is not None else "bf16"
        ck.record("decode_attention_update",
                  f"{label} {name} NB={NB} H={H} D={D} T={T}", got, ref, 1e-2,
                  timer(lambda: da.decode_attention_update_kernel(
                      q, *ar, *fresh, *tail), iters=50),
                  timer(lambda: da.decode_attention_update_plain(
                      q, *twin, *fresh, *tail), iters=5),
                  library(q, *ar, visible),
                  2 * NB * H * D * 4 + 2 * T * H * D * elt(cache) + NB * T * 4
                  + fbytes, 4 * NB * H * T * D, PEAK_BF16)

    # flat mode at the Engine's shape: B 1, T 512, n_past 499 (as check C)
    Tf = PROMPT + N_PREDICT
    n_past = Tf - 13
    vis_f = torch.arange(Tf, device="cuda")[None] <= n_past
    fused_case(torch.bfloat16, 1, Tf, torch.tensor([n_past], device="cuda"),
               torch.where(vis_f, 0.0, da.NEG), vis_f, "flat")
    # cells mode at the serving shape: each row's own cell, the pad row's
    # the trash cell
    rows = torch.stack([torch.nonzero(visible[n])[-1, 0] for n in range(NB - 1)]
                       + [torch.tensor(T - 1, device="cuda")])
    fused_case("q8_0", NB, T, rows, mask, visible, "cells")

    # flash as a mixed serving ubatch runs it: the bucket's 128 query rows
    # over the whole q8_0 arena, expanded to f32 as the forward reads it,
    # under the cell mask of that ubatch's registry
    cache, _ = arena("q8_0", 1, T)
    flash_case(ck, timer, gen, f"serving mixed Tq=128 Tk={T} H={H} D={D}",
               1, 128, T, H, H, D, {}, timed=True,
               kv=read_kv(cache, 1, dtype=torch.float32),
               visible=mixed_ubatch_mask(T, 128)[:, 0] == 0)
    del cache


def mixed_ubatch_mask(n_ctx, nb):
    """cells_attention_mask (1, 1, nb, n_ctx) of a mixed serving ubatch,
    registry as BatchedEngine.step leaves it: 7 sequences decoding (prompts
    of 64-127 tokens plus 0-31 generated, each a run of cells, this step's
    cell included), a new request's 100-token prompt chunk, and pad rows up
    to the bucket nb (seq MAX_SEQ - 1, the trash cell, visible to none)."""
    from ggml_imax_tpu_torch.models.common import cells_attention_mask
    from ggml_imax_tpu_torch.runtime.batched import MAX_SEQ
    rng = np.random.default_rng(3)
    cell_pos = np.full(n_ctx, -1, np.int64)
    cell_seq = np.zeros(n_ctx, np.int64)
    tok_pos, tok_seq, head = [], [], 0
    for s, n in enumerate(rng.integers(64, 128, 7) + rng.integers(0, 32, 7)):
        cell_pos[head:head + n + 1] = np.arange(n + 1)
        cell_seq[head:head + n + 1] = 1 << s
        tok_pos.append(n)
        tok_seq.append(s)
        head += n + 1
    cell_pos[head:head + 100] = np.arange(100)
    cell_seq[head:head + 100] = 1 << 7
    tok_pos += range(100)
    tok_seq += [7] * 100
    pad = nb - len(tok_pos)
    tok_pos += [0] * pad
    tok_seq += [MAX_SEQ - 1] * pad
    dev = lambda a: torch.as_tensor(np.asarray(a), device="cuda")[None]
    return cells_attention_mask(dev(tok_pos), dev(tok_seq), dev(cell_pos),
                                dev(cell_seq))


def check_gpt2_kernels(ck, timer, gen):
    """nat8 W8A8 / W8A16 at GPT-2 XL's fc_w (1600 x 6400, per-32 f32 scales:
    Q8_0), then per-16 with bias and bf16 scales (Q6_K/Q5_K-like) and a
    ragged M; flash at the GPT-2 XL prefill (25 heads of 64, 512 queries
    over the 1024-row arena)."""
    from ggml_imax_tpu_torch.ops import qmm

    K, N = GPT2_XL["n_embd"], 4 * GPT2_XL["n_embd"]
    variants = [("fc_w g32 f32", 32, torch.float32, False),
                ("fc_w g16 bias bf16", 16, torch.bfloat16, True)]
    for label, g, sdt, bias in variants:
        qt = random_nat8(K, N, gen, g, sdt, bias)
        wd = qmm.dequant_bf16(qt)                     # library yardstick only
        if bias:
            wd = wd + qt.bias.to(torch.bfloat16).repeat_interleave(g, 0)
        sbytes = qt.scale.numel() * qt.scale.element_size() * (2 if bias else 1)
        # W8A8 at m = 1
        x = torch.randn(1, K, generator=gen, device="cuda")
        x8, dx = qmm.quantize_activations_q8(x, g)
        x8, dx = x8[:, 0].contiguous(), dx[:, 0].contiguous()
        xs = (dx * x8.float().sum(-1)).contiguous() if bias else None
        got = qmm.nat8_w8a8_gemv(x8, dx, qt, xs)
        ref = qmm.nat8_w8a8_gemv_plain(x8, dx, qt, xs)
        xb = x.to(torch.bfloat16)
        ck.record("nat8_w8a8", f"{label} m=1 K={K} N={N}", got, ref, 1e-4,
                  timer(lambda: qmm.nat8_w8a8_gemv(x8, dx, qt, xs), iters=50),
                  timer(lambda: qmm.nat8_w8a8_gemv_plain(x8, dx, qt, xs), iters=5),
                  timer(lambda: torch.matmul(xb, wd), iters=50),
                  K * N + sbytes + K + K // g * 4 * (2 if bias else 1) + N * 4,
                  2 * K * N, PEAK_INT8)
        # W8A16 at the prefill bucket M = 512, and a ragged M
        for M in (512, 5):
            xm = torch.randn(M, K, generator=gen, device="cuda")
            got = qmm.nat8_w8a16_gemm(xm, qt)
            ref = qmm.nat8_w8a16_gemm_plain(xm, qt)
            xmb = xm.to(torch.bfloat16)
            ck.record("nat8_w8a16", f"{label} M={M} K={K} N={N}", got, ref, 1e-3,
                      timer(lambda: qmm.nat8_w8a16_gemm(xm, qt)),
                      timer(lambda: qmm.nat8_w8a16_gemm_plain(xm, qt), iters=3),
                      timer(lambda: torch.matmul(xmb, wd)),
                      M * K * 2 + K * N + sbytes + M * N * 4, 2 * M * K * N,
                      PEAK_BF16)
        del qt, wd
    H, D = GPT2_XL["n_head"], GPT2_XL["n_embd"] // GPT2_XL["n_head"]
    flash_case(ck, timer, gen, f"gpt2 B=1 Tq=512 Tk=1024 H={H} D={D}", 1, 512,
               1024, H, H, D, {}, timed=True, q_off=0)


def backward_case(ck, timer, gen, label, B, Tq, Tk, Hq, Hkv, Dh, kw,
                  masked_row=None, mask=None):
    """The flash backward kernels (dQ; dK/dV) against the plain backward on
    one case, from the forward kernel's out and lse; each timed beside the
    plain backward (one time for both), its bound, and the backward of bf16
    scaled_dot_product_attention with the same additive mask (one time for
    the pair; a yardstick the port never calls). mask: an additive
    (B, 1, Tq, Tk) mask instead of the causal one."""
    from ggml_imax_tpu_torch.ops import flash_attention as fa
    from ggml_imax_tpu_torch.ops import flash_backward as fb
    q = torch.randn(B, Tq, Hq, Dh, generator=gen, device="cuda")
    k, v = (torch.randn(B, Tk, Hkv, Dh, generator=gen, device="cuda")
            for _ in range(2))
    if mask is None:
        qi = torch.arange(Tq, device="cuda")[:, None] + (Tk - Tq)
        kj = torch.arange(Tk, device="cuda")[None]
        fill = (kj - qi).float() if kw.get("max_bias") else \
            torch.zeros(Tq, Tk, device="cuda")
        mask = torch.where(kj <= qi, fill, float("-inf"))[None, None] \
            .expand(B, 1, Tq, Tk).clone()
    if masked_row is not None:
        mask[:, :, masked_row] = float("-inf")
    prep = fa._prep(q, k, v, mask, kw.get("max_bias", 0.0))
    scale, cap = 1.0 / math.sqrt(Dh), kw.get("logit_softcap", 0.0)
    out, lse = fa.flash_attention_kernel(*prep, scale, cap, True)
    do = torch.randn(out.shape, generator=gen, device="cuda")
    di = (do * out).sum(-1).transpose(1, 2).contiguous()
    args = (*prep[:3], do.to(torch.bfloat16), *prep[3:], lse, di, scale, cap)
    dq = fb.flash_backward_dq(*args)
    dk, dv = fb.flash_backward_dkv(*args)
    rq, rk, rv = fb.flash_attention_bwd_plain(*args)
    plain_ms = timer(lambda: fb.flash_attention_bwd_plain(*args), iters=5)
    lib_ms = None
    if not cap:      # SDPA has no softcap
        # (B, H, T, D) bf16, k/v repeated over the GQA group
        rep = Hq // Hkv
        lq, lk, lv = (t.to(torch.bfloat16).transpose(1, 2).repeat_interleave(
            r, dim=1).contiguous().requires_grad_(True)
                      for t, r in ((q, 1), (k, rep), (v, rep)))
        lmask = prep[3][:, None].to(torch.bfloat16)
        if prep[4] is not None:
            lmask = lmask * prep[4].reshape(1, Hq, 1, 1).to(torch.bfloat16)
        lo = torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=lmask, scale=scale)
        ldo = do.to(torch.bfloat16).transpose(1, 2)
        lib_ms = timer(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), ldo, retain_graph=True), iters=10)
    bf, f4 = 2, 4
    ins = (2 * B * Tq * Hq + 2 * B * Tk * Hkv) * Dh * bf \
        + 2 * B * Hq * Tq * f4 + B * Tq * Tk * f4
    flops = 2 * B * Hq * Tq * Tk * Dh
    shape = f"{label} B={B} Tq={Tq} Tk={Tk} H={Hq}:{Hkv} D={Dh}"
    ck.record("flash_backward_dq", shape, dq, rq, 1e-2,
              timer(lambda: fb.flash_backward_dq(*args), iters=20), plain_ms,
              lib_ms, ins + B * Tq * Hq * Dh * f4, 3 * flops, PEAK_BF16)
    ck.record("flash_backward_dkv", shape + " dK", dk, rk, 1e-2,
              timer(lambda: fb.flash_backward_dkv(*args), iters=20), plain_ms,
              lib_ms, ins + 2 * B * Tk * Hkv * Dh * f4, 4 * flops, PEAK_BF16)
    ck.record("flash_backward_dkv", shape + " dV", dv, rv, 1e-2)


def check_train_kernels(ck, timer, gen):
    """The training path's attention kernels: flash forward with lse and the
    two backward kernels at GPT-2 117M training (B 8, T 512, 12 heads of 64,
    the causal mask of gpt2.forward); the backward kernels also at D 256
    (GPT-J width, key tiles of 32) and on a ragged GQA case with softcap,
    ALiBi and a fully masked row. Then dx through the kernel matmul routes
    (W4A16 at M 512, W8A16) against the same routes run plain on the card."""
    from ggml_imax_tpu_torch.models.common import attention_mask
    from ggml_imax_tpu_torch.ops import qmm
    from ggml_imax_tpu_torch.ops.qmatmul import qmatmul
    B, T = TRAIN["batch"], TRAIN["seq"]
    H, D = GPT2_117M["n_head"], GPT2_117M["n_embd"] // GPT2_117M["n_head"]
    flash_case(ck, timer, gen, f"train B={B} T={T} H={H} D={D} (lse)", B, T, T,
               H, H, D, {"want_lse": True}, timed=True)
    pos = torch.arange(T, device="cuda")[None].expand(B, T)
    backward_case(ck, timer, gen, "train", B, T, T, H, H, D, {},
                  mask=attention_mask(pos, T, 0))
    backward_case(ck, timer, gen, "gptj", 1, 512, 512, 16, 16, 256, {})
    backward_case(ck, timer, gen, "gqa+softcap+alibi", 2, 200, 300, 8, 2, 128,
                  {"logit_softcap": 20.0, "max_bias": 8.0}, masked_row=7)

    for label, qt in (("natpair W4A16", random_natpair(4096, 4096, gen)),
                      ("nat8 W8A16", random_nat8(1600, 6400, gen))):
        x = torch.randn(512, qt.k, generator=gen, device="cuda")
        dxs = []
        for patches in ((), [(qmm, "w4a16_gemm", qmm.w4a16_gemm_plain),
                             (qmm, "nat8_w8a16_gemm",
                              qmm.nat8_w8a16_gemm_plain)]):
            with patched(patches):
                xg = x.clone().requires_grad_(True)
                y = qmatmul(xg, qt, out_dtype=torch.float32)
                dxs.append(torch.autograd.grad(torch.sin(y).sum(), xg)[0])
        err = rel_err(*dxs)
        log(f"  dx through {label} M=512 K={qt.k} N={qt.n}: kernel route vs "
            f"plain route rel_err {err:.2e} (tol 1e-02)")
        if not err < 1e-2:
            ck.failures.append(f"dx through {label}: rel_err {err:.3e}")


def random_permuted(layout, K, N, gen):
    """Random bytes in a permuted layout (sizing shapes): planes per-16
    with zero 4 (Q3_K-like), row-pair and u-order int8 per-32."""
    from ggml_imax_tpu_torch.quant.device import QTensor
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    g = 16 if layout == "planes" else 32
    if layout == "int8":
        q = torch.randint(-127, 128, (K, N), dtype=torch.int8, generator=gen,
                          device="cuda")
    else:
        q = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8,
                          generator=gen, device="cuda")
    s = torch.randn((K // g, N), generator=gen, device="cuda").abs_() * 0.005
    kind, q4l, zero, t = {"planes": ("nib4", 0, 4, GGMLType.Q3_K),
                          "rowpair": ("nib4", 1, 8, GGMLType.Q4_0),
                          "int8": ("int8", 2, 0, GGMLType.Q8_0)}[layout]
    return QTensor(kind, q, s, None, K, N, t, zero=zero, interleaved_bk=512,
                   q4_layout=q4l)


PERMUTED_LAYOUT = {"planes_w4a16": "planes", "rowpair_w4a16": "rowpair",
                   "int8_rows_w8a16": "int8"}


def time_permuted(ck, timer, gen, name, label, qt, ms=(1, 8, 512)):
    """One permuted-layout kernel against its plain version at each M (the
    GEMV route at M 1 and 8, the tile route at 512), with its route and
    split, its time, the plain version's, bf16 torch.matmul on the weight
    dequantized beforehand (a yardstick the port never calls) and the
    bound."""
    from ggml_imax_tpu_torch.ops import qmm
    from ggml_imax_tpu_torch.ops.qmatmul import dequantize
    kern, plain = getattr(qmm, name), getattr(qmm, name + "_plain")
    wd = dequantize(qt, torch.bfloat16)
    wbytes = sum(t.numel() * t.element_size()
                 for t in (qt.q, qt.scale, qt.bias) if t is not None)
    for M in ms:
        x = torch.randn(M, qt.k, generator=gen, device="cuda")
        xb = x.to(torch.bfloat16)
        route, split = qmm.permuted_plan(PERMUTED_LAYOUT[name], M, qt.k, qt.n,
                                         qt.interleaved_bk,
                                         qt.k // qt.scale.shape[0])
        log(f"  {name:16s} {label} M={M}: route {route}, split {split}")
        ck.record(name, f"{label} M={M} K={qt.k} N={qt.n}", kern(x, qt),
                  plain(x, qt), 1e-3, timer(lambda: kern(x, qt)),
                  timer(lambda: plain(x, qt), iters=3),
                  timer(lambda: torch.matmul(xb, wd)),
                  M * qt.k * 2 + wbytes + M * qt.n * 4, 2 * M * qt.k * qt.n,
                  PEAK_BF16)
    del wd


def check_kquant_kernels(ck, timer, gen):
    """GPT-2 117M's layer products attn_w (768 x 2304, tag 256) and out_w
    (3072 x 768, tag 512) at M 1 (decode), 8 and 512 (the prefill bucket):
    the plane-split kernel on Q3_K and Q2_K weights (the port's codecs),
    the row-pair kernel on Q4_0 and the u-order kernel on Q8_0. Then each
    kernel at a 4096 x 16384 sizing shape of random bytes, on no path: the
    117M products move 0.2-1.8 MB, so their times are launch-latency
    sized."""
    from ggml_imax_tpu_torch.ops import qmm
    from ggml_imax_tpu_torch.quant.device import quantize_for_device
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    E = GPT2_117M["n_embd"]
    rng = np.random.default_rng(9)
    repack = {"planes": qmm.repack_interleaved, "rowpair": qmm.repack_rowpair,
              "int8": qmm.repack_int8_rows}
    cases = [("planes_w4a16", "planes", GGMLType.Q3_K),
             ("planes_w4a16", "planes", GGMLType.Q2_K),
             ("rowpair_w4a16", "rowpair", GGMLType.Q4_0),
             ("int8_rows_w8a16", "int8", GGMLType.Q8_0)]
    for name, layout, wtype in cases:
        for label, (K, N) in (("attn_w", (E, 3 * E)), ("out_w", (4 * E, E))):
            w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
            qt = repack[layout](quantize_for_device(w, wtype),
                                512 if K % 512 == 0 else 256)
            time_permuted(ck, timer, gen, name, f"{wtype.name} {label}", qt)
    for name, layout in (("planes_w4a16", "planes"),
                         ("rowpair_w4a16", "rowpair"),
                         ("int8_rows_w8a16", "int8")):
        time_permuted(ck, timer, gen, name, f"sizing (on no path) {layout}",
                      random_permuted(layout, 4096, 16384, gen))


def legacy_repack(params, layout):
    """The legacy-layout pass's params: every natural nib4 leaf through
    repack_rowpair ("rowpair"), or every natural int8 leaf through
    repack_int8_rows ("int8"), each with the largest of 512 and 256 that
    divides its K, as params_repack shrinks its tag. A helper of this
    script, not a package feature: the JAX package offers both repacks,
    and its forward, get_rows and dequantize_xla take either layout."""
    from ggml_imax_tpu_torch.ops import qmm
    from ggml_imax_tpu_torch.quant.device import QTensor
    fn, kind = {"rowpair": (qmm.repack_rowpair, "nib4"),
                "int8": (qmm.repack_int8_rows, "int8")}[layout]

    def walk(d):
        if isinstance(d, dict):
            return {k: walk(v) for k, v in d.items()}
        if isinstance(d, list):
            return [walk(v) for v in d]
        if isinstance(d, QTensor) and d.kind == kind and d.interleaved_bk == 0:
            return fn(d, 512 if d.k % 512 == 0 else 256)
        return d
    return walk(params)


def check_small_model(failures, model, cfg, variants, label, n_prompt=40,
                      n_steps=4, tol=5e-2):
    """Kernels on the card against the plain versions on the CPU, through
    the whole forward of a small model; variants: (name, make params on a
    device, cache kwargs)."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.n_vocab, (1, n_prompt))
    feed = rng.integers(0, cfg.n_vocab, n_steps)    # teacher-forced steps
    for name, make, cache_kw in variants:
        runs = {}
        for dev in ("cuda", "cpu"):
            p = make(dev)
            cache = model.init_cache(cfg, device=dev, **cache_kw)
            lg, cache = model.forward(cfg, p, torch.as_tensor(prompt, device=dev),
                                      torch.arange(n_prompt, device=dev)[None],
                                      cache, 0)
            steps = [lg[0, -1].float().cpu()]
            for i, tok in enumerate(feed):
                n_past = n_prompt + i
                lg, cache = model.forward(
                    cfg, p, torch.tensor([[int(tok)]], device=dev),
                    torch.full((1, 1), n_past, device=dev), cache, n_past)
                steps.append(lg[0, -1].float().cpu())
            runs[dev] = steps
        err = max(float((a - b).abs().max())
                  for a, b in zip(runs["cuda"], runs["cpu"]))
        finite = all(bool(torch.isfinite(a).all()) for a in runs["cuda"])
        log(f"  small {label} {name}: max |logit diff| card vs CPU {err:.3e} "
            f"(tol {tol:.0e}), finite={finite}")
        if err > tol or not finite:
            failures.append(f"small {label} {name}: logit diff {err:.3e}")


def check_small_models(failures):
    from ggml_imax_tpu_torch.models import gpt2, gptj
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.formats import GGMLType

    cfg = gptj.GPTJConfig(n_vocab=512, n_ctx=256, n_embd=512, n_head=2,
                          n_layer=2, n_rot=64)
    make = lambda dev: params_repack(gptj.prepare_fused(
        gptj.synthetic_params(cfg, seed=5, device=dev), cfg))
    check_small_model(failures, gptj, cfg,
                      [(f"kv={kv}", make, {"dtype": kv})
                       for kv in (torch.bfloat16, "q8_0")], "GPT-J")
    # the CPU parity tests' GPT-2: only fc_w passes the kernel gate
    cfg2 = gpt2.GPT2Config(n_vocab=1000, n_ctx=64, n_embd=320, n_head=5,
                           n_layer=2)
    variants = []
    for wtype in (GGMLType.Q8_0, GGMLType.Q4_0):
        mk = lambda dev, wtype=wtype: params_repack(gpt2.prepare_fused(
            gpt2.synthetic_params(cfg2, wtype, seed=5, device=dev)))
        variants.append((wtype.name, mk, {}))
    check_small_model(failures, gpt2, cfg2, variants, "GPT-2")
    # the K-quant slice's GPT-2 (K-quants need n_embd % 256 == 0): every
    # layer product on a permuted-layout kernel
    cfg3 = gpt2.GPT2Config(n_vocab=1000, n_ctx=64, n_embd=256, n_head=4,
                           n_layer=2)
    variants = []
    for label, wtype, layout in (("Q3_K", GGMLType.Q3_K, None),
                                 ("Q2_K", GGMLType.Q2_K, None),
                                 ("row-pair Q4_0", GGMLType.Q4_0, "rowpair"),
                                 ("u-order Q8_0", GGMLType.Q8_0, "int8")):
        def mk(dev, wtype=wtype, layout=layout):
            p = gpt2.synthetic_params(cfg3, wtype, seed=5, device=dev)
            return params_repack(p) if layout is None else \
                legacy_repack(p, layout)
        variants.append((label, mk, {}))
    check_small_model(failures, gpt2, cfg3, variants, "GPT-2 n_embd 256")


def recording(model, logs):
    """The model module with a forward that also appends, per call, the f32
    logits of the ubatch's real rows (not the pad rows, whose cell is the
    trash cell) to `logs`, on the host."""
    import functools
    import types

    @functools.wraps(model.forward)
    def forward(cfg, params, tokens, positions, cache, n_past, **kw):
        lg, cache = model.forward(cfg, params, tokens, positions, cache, n_past,
                                  **kw)
        logs.append(lg[0][kw["cells"][0] != cache.n_ctx - 1].float().cpu())
        return lg, cache
    return types.SimpleNamespace(forward=forward, __name__=model.__name__,
                                 init_cache=model.init_cache)


def same_greedy(ref, got, ref_toks, got_toks, tol=5e-2):
    """Two runs of one greedy workload (two devices, two routes, or kernels
    and plain versions): ref/got are their logits, one (rows, V) tensor per
    forward. Holds when the tokens are equal and every forward agrees to
    `tol`. Returns (ok, diffs, note): diffs, the max |logit diff| of each
    forward; where the tokens differ, only up to the first forward whose
    picks part (the later ones are fed other tokens; a row that samples
    nothing, a prompt row, may part at a near-tie without that)."""
    diffs = []
    for i, (a, b) in enumerate(zip(ref, got)):
        if a.shape != b.shape:
            break
        diffs.append(float((a - b).abs().max()))
        if ref_toks != got_toks and (a.argmax(-1) != b.argmax(-1)).any():
            return False, diffs, f"tokens differ, picks part at forward {i}"
    if ref_toks != got_toks or len(ref) != len(got):
        return False, diffs, "tokens differ"
    return max(diffs) <= tol, diffs, "tokens equal"


def logit_scale(logs) -> float:
    return max(float(a.abs().max()) for a in logs)


def check_small_batched(failures):
    """The small GPT-J's BatchedEngine (two requests, then a fork of the
    first, q8_0 KV, greedy with host sampling) on the card and on the CPU,
    both cells routes: the logits of every ubatch agree to 5e-2 and the
    tokens are equal (same_greedy)."""
    from ggml_imax_tpu_torch.models import gptj
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.runtime.batched import BatchedEngine

    cfg = gptj.GPTJConfig(n_vocab=512, n_ctx=256, n_embd=512, n_head=2,
                          n_layer=2, n_rot=64)
    rng = np.random.default_rng(6)
    prompts = [list(rng.integers(0, cfg.n_vocab, n)) for n in (21, 9)]
    for fused in (False, True):
        runs = {}
        for dev in ("cuda", "cpu"):
            logs = []
            p = params_repack(gptj.prepare_fused(
                gptj.synthetic_params(cfg, seed=5, device=dev), cfg))
            be = BatchedEngine(recording(gptj, logs), cfg, p, kv_dtype="q8_0",
                               device=dev, fused_kv_update=fused)
            rids = [be.add_request(pr, 8, temp=0.0) for pr in prompts]
            be.step()
            rids.append(be.fork(rids[0]))
            res = be.run()
            runs[dev] = ([res[r] for r in rids], logs, dict(be.n_ubatches))
        (tok_c, lg_c, nu_c), (tok_h, lg_h, _) = runs["cuda"], runs["cpu"]
        ok, diffs, note = same_greedy(lg_h, lg_c, tok_h, tok_c)
        log(f"  small GPT-J BatchedEngine fused_kv_update={fused}: {nu_c} "
            f"ubatches, max |logit diff| card vs CPU {max(diffs):.3e} (tol "
            f"5e-02), tokens equal {tok_c == tok_h}, {note}")
        if not ok:
            failures.append(f"small batched fused={fused}: err "
                            f"{max(diffs):.3e}, {note}, tokens {tok_c} vs "
                            f"{tok_h}")


def _device_ms(fn, reps):
    """Device time by kernel name, ms per rep (torch.profiler, CUDA)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
    return {ev.key: ev.self_device_time_total / 1e3 / reps
            for ev in prof.key_averages()
            if str(ev.device_type).endswith("CUDA")
            and ev.self_device_time_total > 0}


def w4a16_share(dev, busy, label):
    """Log the device time of csrc/w4a16_gemm.cu's two routes in a profile
    (kernel name -> ms) against the device busy time; None where the
    profile has none."""
    ms = sum(t for k, t in dev.items()
             if "w4a16_small_m" in k or "w4a16_tile" in k)
    if not ms:
        return None
    log(f"  {label}: W4A16 (w4a16_gemm.cu) {ms:.3f} ms of {busy:.3f} ms "
        f"device busy ({100 * ms / busy:.1f}%)")
    return ms


def profile_engine(eng, rng, reqs, steps=8):
    """Device busy share of a prefill and of decode steps: kernel time in a
    torch.profiler trace against the unprofiled TTFT and step time. Returns
    the device busy ms of each (None where the trace has no device time)."""
    prompt = rng.integers(0, eng.cfg.n_vocab, (1, PROMPT))
    box, busy_ms = {}, {}

    def pre(_):
        box["cache"] = eng.new_cache()
        eng.prefill(box["cache"], prompt)

    def dec(i):
        eng.decode_step(box["cache"], np.array([1]), PROMPT + i)

    walls = {"prefill": float(np.median([r["ttft_ms"] for r in reqs])),
             "decode step": 1e3 / float(np.median([r["decode_tok_s"]
                                                   for r in reqs]))}
    for label, fn, reps in (("prefill", pre, 1), ("decode step", dec, steps)):
        dev = _device_ms(fn, reps)
        busy_ms[label] = sum(dev.values()) if dev else None
        if not dev:
            log(f"  profiled {label}: no device time in the trace (not measured)")
            continue
        busy, wall = busy_ms[label], walls[label]
        log(f"  profiled {label}: device busy {busy:.3f} ms of {wall:.3f} ms "
            f"unprofiled -> busy {100 * busy / wall:.1f}%, idle "
            f"{100 * (1 - busy / wall):.1f}%")
        for key, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
            log(f"    {ms:9.4f} ms  {key[:90]}")
        w4a16_share(dev, busy, f"profiled {label}")
    return busy_ms, walls


def serve(model, cfg, params, n_ctx, failures, n_requests=N_REQUESTS):
    """The engine phase: a warm-up, then n_requests requests of a PROMPT-token
    prompt + N_PREDICT greedy tokens with the launch counters set to 0 just
    before and read just after. Returns (engine, rng, per-request numbers,
    launch counts)."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.runtime.engine import Engine

    eng = Engine(model, cfg, params, n_ctx=n_ctx)
    rng = np.random.default_rng(0)
    warm = rng.integers(0, cfg.n_vocab, PROMPT)
    last = eng.prefill(eng.new_cache(), warm[None])[0]   # drops its cache
    if last.shape != (1, cfg.n_vocab) or not np.isfinite(last).all():
        failures.append(f"prefill logits: shape {last.shape}, "
                        f"finite {np.isfinite(last).all()}")
    eng.generate(warm, 2, temp=0)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"  allocated before the requests "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    _build.reset_launches()
    reqs = []
    for r in range(n_requests):
        prompt = rng.integers(0, cfg.n_vocab, PROMPT)
        stamps = []
        t0 = time.perf_counter()
        out = eng.generate(prompt, N_PREDICT, temp=0,
                           callback=lambda tok: stamps.append(time.perf_counter()))
        ttft = (stamps[0] - t0) * 1e3
        tok_s = (len(stamps) - 1) / (stamps[-1] - stamps[0])
        ok = len(out) == N_PREDICT and all(0 <= t < cfg.n_vocab for t in out)
        log(f"  request {r}: TTFT {ttft:.2f} ms, decode {tok_s:.2f} tok/s, "
            f"{len(out)} tokens, first {out[:8]}")
        if not ok:
            failures.append(f"request {r}: bad tokens {out}")
        reqs.append({"ttft_ms": ttft, "decode_tok_s": tok_s})
    counts = dict(_build.LAUNCHES)
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"  launches over {n_requests} requests: {counts}")
    return eng, rng, reqs, counts


def check_counts(counts, expect, failures):
    for k, n in counts.items():
        if n != expect.get(k, 0):
            failures.append(f"{k}: {n} launches, expected {expect.get(k, 0)}")


def gated_products_ms(ws, busy_ms, walls):
    """Device time (torch.profiler kernel sum) of the products ws that the
    N % 128 gate leaves to dequantize + torch.matmul (GPT-2 XL: every
    layer's attn_w, proj_w and out_w, and the tied LM head; 117M: the head),
    for one decode step (m = 1) and one prefill (M = 512); with their share
    of the step's device busy time and of its unprofiled wall time."""
    from ggml_imax_tpu_torch.ops.qmatmul import qmatmul
    if not all(w.n % 128 for w in ws):
        raise SystemExit("chip_smoke FAILED: a gated weight passed the gate")
    out = {}
    for label, m in (("decode step", 1), ("prefill", 512)):
        xs = {k: torch.randn(1, m, k, device="cuda") for k in {w.k for w in ws}}
        run = lambda _: [qmatmul(xs[w.k], w, out_dtype=torch.float32) for w in ws]
        run(0)                                     # warm-up
        dev = _device_ms(run, 2)
        out[label] = sum(dev.values()) if dev else None
        if out[label] is None:
            ev = out[f"{label} (CUDA events)"] = Timer()(lambda: run(0), iters=5)
            log(f"  gated products per {label}: no device time in the trace "
                f"(not measured); CUDA events over the products: {ev:.3f} ms")
            continue
        share = "" if busy_ms.get(label) is None else \
            f" = {100 * out[label] / busy_ms[label]:.1f}% of its device busy time"
        log(f"  gated dequant + matmul products per {label} ({len(ws)} "
            f"products): {out[label]:.3f} ms device{share}, "
            f"{100 * out[label] / walls[label]:.1f}% of its wall time")
    return out


def serving_workload(be, rng):
    """examples/serve.py --bench: SERVE["n_req"] requests, one every
    SERVE["arrive"] engine steps, prompts of rng.integers(*plen) tokens,
    n_predict tokens each at temp 0.8, top_k 40, top_p 0.95; the loop body
    is step_chunk(chunk), and a decode-only iteration advances the arrival
    clock by the chunk. Returns (tokens generated, wall s, sorted TTFTs s,
    request ids)."""
    vocab = be.cfg.n_vocab
    lo, hi = SERVE["plen"]
    queue = [(SERVE["arrive"] * i, int(rng.integers(lo, hi)),
              SERVE["n_predict"]) for i in range(SERVE["n_req"])]
    t_start = time.perf_counter()
    ttft, t_add, step_no = {}, {}, 0
    while queue or any(not be.requests[rid].done for rid in t_add):
        while queue and queue[0][0] <= step_no:
            _, plen, n_pred = queue.pop(0)
            rid = be.add_request(list(rng.integers(0, vocab - 1, plen)), n_pred,
                                 temp=0.8, top_k=40, top_p=0.95, seed=step_no)
            t_add[rid] = time.perf_counter()
        live = [r for r in be.requests.values() if not r.done]
        decode_only = live and all(r.n_prompt_done >= len(r.prompt)
                                   for r in live)
        be.step_chunk(SERVE["chunk"])
        step_no += SERVE["chunk"] if decode_only else 1
        for rid, t_a in t_add.items():
            r = be.requests[rid]
            if rid not in ttft and (r.out or r.next_tok is not None):
                ttft[rid] = time.perf_counter() - t_a
    wall = time.perf_counter() - t_start
    gen = sum(len(be.requests[rid].out) for rid in t_add)
    return gen, wall, sorted(ttft.values()), list(t_add)


@contextlib.contextmanager
def patched(pairs):
    """Set the (module, name, value) attributes for the block, then restore
    them."""
    old = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, val in pairs:
        setattr(m, n, val)
    try:
        yield
    finally:
        for m, n, val in old:
            setattr(m, n, val)


def plain_on_card():
    """Patches pointing every kernel entry of the GPT-J and GPT-2 117M
    K-quant paths at its plain version, so that the wrappers run the plain
    versions on CUDA tensors (a check of the whole path only; the port
    never does this)."""
    from ggml_imax_tpu_torch.ops import decode_attention as da
    from ggml_imax_tpu_torch.ops import flash_attention as fa
    from ggml_imax_tpu_torch.ops import qmm
    return [(qmm, "w4a16_gemm", qmm.w4a16_gemm_plain),
            (qmm, "w4a8_gemv", qmm.w4a8_gemv_plain),
            (qmm, "planes_w4a16", qmm.planes_w4a16_plain),
            (qmm, "rowpair_w4a16", qmm.rowpair_w4a16_plain),
            (qmm, "int8_rows_w8a16", qmm.int8_rows_w8a16_plain),
            (fa, "flash_attention_kernel", fa.flash_attention_plain),
            (da, "decode_attention_kernel", da.decode_attention_plain),
            (da, "decode_attention_cells_kernel", da.decode_attention_plain),
            (da, "decode_attention_update_kernel",
             da.decode_attention_update_plain)]


def planted_faults():
    """Two wrong fused KV-update kernels, the route check's controls: the
    fresh row written one row past its destination (so the next step sees
    a row never written), and the fresh row left out of the softmax (the
    row is written, then the read-only kernel runs with it masked)."""
    from ggml_imax_tpu_torch.ops import decode_attention as da
    real = da.decode_attention_update_kernel

    def one_row_off(q3, k, v, ks, vs, kn, vn, kns, vns, mask2, rows, hkv, sc):
        return real(q3, k, v, ks, vs, kn, vn, kns, vns, mask2,
                    (rows + 1) % k.shape[1], hkv, sc)

    def fresh_left_out(q3, k, v, ks, vs, kn, vn, kns, vns, mask2, rows, hkv,
                       sc):
        real(q3, k, v, ks, vs, kn, vn, kns, vns, mask2, rows, hkv, sc)
        own = torch.arange(k.shape[1], device=rows.device)[None] \
            == rows.long()[:, None]
        read = da.decode_attention_cells_kernel if k.shape[0] == 1 \
            else da.decode_attention_kernel
        return read(q3, k, v, ks, vs, torch.where(own, da.NEG, mask2), hkv, sc)

    entry = lambda fn: [(da, "decode_attention_update_kernel", fn)]
    return {"the fresh row one row off": entry(one_row_off),
            "the fresh row left out": entry(fresh_left_out)}


def short_serving(cfg, params, fused, patches=()):
    """A short greedy serving pass at GPT-J-6B width (q8_0 arena, n_ctx
    2048, host sampling so each ubatch's logits are kept): two requests (40
    and 23 prompt tokens) in a mixed ubatch of bucket 64, then a fork of
    the first and a third request (70 tokens), whose prompt joins the three
    decode rows in a mixed ubatch of bucket 128; 8 tokens each. Returns
    (tokens, logits per ubatch, launch counts)."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.models import gptj
    from ggml_imax_tpu_torch.runtime.batched import BatchedEngine
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, cfg.n_vocab - 1, n)) for n in (40, 23, 70)]
    logs = []
    with patched(patches):
        eng = BatchedEngine(recording(gptj, logs), cfg, params,
                            n_ctx=SERVE["n_ctx"], kv_dtype="q8_0",
                            fused_kv_update=fused)
        _build.reset_launches()
        rids = [eng.add_request(p, 8, temp=0.0) for p in prompts[:2]]
        eng.step()
        rids += [eng.fork(rids[0]), eng.add_request(prompts[2], 8, temp=0.0)]
        res = eng.run()
        counts = dict(_build.LAUNCHES)
    return [res[r] for r in rids], logs, counts


def engine_greedy(cfg, params, fused, patches=(), n=8, model=None,
                  n_prompt=8, n_ctx=512, feed=None):
    """Engine(n_ctx) of `model` (GPT-J by default): an n_prompt-token prompt
    and n greedy tokens (n - 1 decode steps); feed: the tokens to feed the
    decode steps instead of its own picks (a teacher-forced pass). Returns
    (tokens picked, logits per forward, launch counts of the decode steps
    and the prefill)."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.models import gptj
    from ggml_imax_tpu_torch.runtime.engine import Engine
    prompt = list(np.random.default_rng(7).integers(0, cfg.n_vocab - 1,
                                                    n_prompt))
    with patched(patches):
        eng = Engine(model or gptj, cfg, params, n_ctx=n_ctx,
                     fused_kv_update=fused)
        _build.reset_launches()
        lg, cache = eng.prefill(eng.new_cache(), np.asarray([prompt]))
        toks, logs = [int(lg[0].argmax())], [torch.from_numpy(lg)]
        for i in range(n - 1):
            fed = toks[-1] if feed is None else feed[i]
            lg, cache = eng.decode_step(cache, np.asarray([fed]),
                                        len(prompt) + i)
            toks.append(int(lg[0].argmax()))
            logs.append(torch.from_numpy(lg))
        counts = dict(_build.LAUNCHES)
    return toks, logs, counts


def check_forced(label, ref, got, failures, tol, control=False):
    """Hold a teacher-forced pass (fed ref's tokens) to ref: every
    forward's max |logit diff| within tol of ref's largest |logit|, and
    the same pick at every forward except where ref's top-2 margin is
    within twice that forward's diff (a near-tie either pass may break; a
    random-weight model has many). A control (a planted fault) must fail."""
    limit = tol * logit_scale(ref[1])
    diffs = [float((a - b).abs().max()) for a, b in zip(ref[1], got[1])]
    parted = [i for i, (a, b) in enumerate(zip(ref[0], got[0])) if a != b]
    margins = {i: float(ref[1][i][0].topk(2).values.diff().abs()[0])
               for i in parted}
    ties = all(margins[i] <= 2 * diffs[i] for i in parted)
    ok = max(diffs) <= limit and ties
    log(f"  {label}: max |logit diff| per forward "
        f"[{', '.join(f'{d:.3e}' for d in diffs)}] (limit {limit:.3e}, largest "
        f"|logit| {logit_scale(ref[1]):.3f}), picks part at "
        f"{[(i, round(margins[i], 5)) for i in parted]} (forward, top-2 "
        f"margin) -> {'holds' if ok else 'fails'}")
    if ok == control:
        failures.append(f"{label}: the check {'holds' if ok else 'fails'} "
                        f"(max diff {max(diffs):.3e}, limit {limit:.3e}, "
                        f"parted {parted})")


def check_route(label, ref, got, failures, control=False, tol=ROUTE_TOL):
    """Hold one greedy run (tokens, logits, counts) to another at `tol`
    (ROUTE_TOL by default) of ref's largest |logit|; a control run (a
    planted fault) must fail that check."""
    tol = tol * logit_scale(ref[1])
    ok, diffs, note = same_greedy(ref[1], got[1], ref[0], got[0], tol)
    log(f"  {label}: max |logit diff| per forward "
        f"[{', '.join(f'{d:.3e}' for d in diffs)}] (limit {tol:.3e}, largest "
        f"|logit| {logit_scale(ref[1]):.3f}), {note} -> "
        f"{'holds' if ok else 'fails'}")
    if ok == control:
        failures.append(f"{label}: the check {'holds' if ok else 'fails'} "
                        f"({note}, max diff {max(diffs):.3e}, limit {tol:.3e})")


def serve_gptj(failures):
    """Phase 6. Returns (serving summary, launch counts by path)."""
    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch.models import gptj
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.runtime.batched import BatchedEngine

    cfg = gptj.GPTJConfig(**dict(GPTJ_6B, n_ctx=SERVE["n_ctx"]))
    L = cfg.n_layer
    t0 = time.time()
    params = params_repack(gptj.prepare_fused(
        gptj.synthetic_params_device(cfg, seed=0), cfg))
    torch.cuda.synchronize()
    log(f"  weights drawn + prepared in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    be = BatchedEngine(gptj, cfg, params, n_ctx=SERVE["n_ctx"],
                       kv_dtype="q8_0", on_device_sampling=True, seed=1)
    arena = sum(t.numel() * t.element_size()
                for t in (be.cache.k, be.cache.v, be.cache.ks, be.cache.vs))
    log(f"  q8_0 KV arena {arena / 2**30:.3f} GiB")
    rng = np.random.default_rng(0)
    t0 = time.time()
    serving_workload(be, rng)                        # warm-up
    log(f"  warm-up pass {time.time() - t0:.1f} s")
    be.requests.clear()
    be.n_ubatches = {"mixed": 0, "decode": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    gen, wall, ttfts, rids = serving_workload(be, rng)
    counts = dict(_build.LAUNCHES)
    nu = dict(be.n_ubatches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    outs = [be.requests[r].out for r in rids]
    if sorted(map(len, outs)) != [SERVE["n_predict"]] * SERVE["n_req"] or \
            not all(0 <= t < cfg.n_vocab for o in outs for t in o):
        failures.append(f"serving: request lengths {list(map(len, outs))}")
    summary = {"tok_s": gen / wall, "generated": gen, "wall_s": wall,
               "p50_ttft_ms": 1e3 * ttfts[len(ttfts) // 2],
               "ttft_ms": [1e3 * t for t in ttfts], "ubatches": nu,
               "max_memory_allocated_gib": peak}
    log(f"  served {SERVE['n_req']} requests: {gen} tokens in {wall:.3f} s = "
        f"{gen / wall:.2f} tok/s aggregate, p50 TTFT "
        f"{summary['p50_ttft_ms']:.2f} ms (TTFTs "
        f"{', '.join(f'{1e3 * t:.1f}' for t in ttfts)} ms)")
    log(f"  ubatches: {nu['mixed']} mixed, {nu['decode']} decode-only; "
        f"max_memory_allocated {peak:.3f} GiB")
    log(f"  launches: {counts}")
    n_all = nu["mixed"] + nu["decode"]
    check_counts(counts, {"decode_attention_cells": L * nu["decode"],
                          "flash_attention": L * nu["mixed"],
                          "w4a16_gemm": (2 * L + 1) * n_all}, failures)
    launches = {"serving": counts}

    # device busy share of a decode-only ubatch: 8 streams past their prompts
    for _ in range(SERVE["n_req"]):
        be.add_request(list(rng.integers(0, cfg.n_vocab - 1, 64)), 64, temp=0.8)
    while any(r.n_prompt_done < len(r.prompt) for r in be.requests.values()
              if not r.done):
        be.step()
    t0 = time.perf_counter()
    for _ in range(4):
        be.step()
    step_ms = (time.perf_counter() - t0) / 4 * 1e3
    dev = _device_ms(lambda _: be.step(), 4)
    if dev:
        busy = sum(dev.values())
        summary.update(decode_ubatch_ms=step_ms, decode_ubatch_busy_ms=busy)
        log(f"  profiled decode-only ubatch (nb 8): device busy {busy:.3f} ms "
            f"of {step_ms:.3f} ms unprofiled -> busy {100 * busy / step_ms:.1f}%, "
            f"idle {100 * (1 - busy / step_ms):.1f}%")
        for key, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
            log(f"    {ms:9.4f} ms  {key[:90]}")
        summary["decode_ubatch_w4a16_ms"] = w4a16_share(
            dev, busy, "profiled decode-only ubatch")
    else:
        log("  profiled decode-only ubatch: no device time (not measured)")

    del be
    # the route checks at GPT-J-6B depth (see ROUTE_TOL): the default
    # serving route with kernels against the same with the plain versions on
    # the card, and the fused routes (cells and flat mode) against the
    # default ones; then each planted fault, which must fail the check
    ref_s = short_serving(cfg, params, False)
    check_route("serving, kernels vs plain versions on the card", ref_s,
                short_serving(cfg, params, False, plain_on_card()), failures)
    fused_s = short_serving(cfg, params, True)
    launches["serving_fused"] = fused_s[2]
    check_route("serving, fused route (cells mode) vs default", ref_s,
                fused_s, failures)
    if fused_s[2]["decode_attention_update"] == 0:
        failures.append("fused serving pass: no fused KV-update launch")
    ref_e = engine_greedy(cfg, params, False)
    fused_e = engine_greedy(cfg, params, True)
    launches["engine_fused"] = fused_e[2]
    check_route("Engine, fused route (flat mode) vs default", ref_e, fused_e,
                failures)
    check_counts(launches["engine_fused"],
                 {"decode_attention_update": L * 7, "w4a8_gemv": 7 * (2 * L + 1),
                  "w4a16_gemm": 2 * L + 1, "flash_attention": L}, failures)
    for fault, patches in planted_faults().items():
        check_route(f"control: serving, fused route with {fault}", ref_s,
                    short_serving(cfg, params, True, patches), failures,
                    control=True)
        check_route(f"control: Engine, fused route with {fault}", ref_e,
                    engine_greedy(cfg, params, True, patches), failures,
                    control=True)
    return summary, launches


def train_loss(cfg, toks, tgts):
    """tools/quality_gate.py's training loss: a fresh f32 KV cache per call,
    gpt2.forward with compute_dtype f32, the mean NLL of log_softmax."""
    from ggml_imax_tpu_torch.models import gpt2
    B, T = toks.shape
    pos = torch.arange(T, device="cuda")[None].expand(B, T)

    def loss(p):
        cache = gpt2.init_cache(cfg, batch=B, n_ctx=T, dtype=torch.float32)
        logits, _ = gpt2.forward(cfg, p, toks, pos, cache, 0,
                                 compute_dtype=torch.float32)
        lp = torch.log_softmax(logits, dim=-1)
        return -lp.gather(-1, tgts[..., None]).mean()
    return loss


def loss_and_grads(loss_fn, params, patches=()):
    from ggml_imax_tpu_torch.optimize import float_leaves
    with patched(patches):
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, float_leaves(params))
    return float(loss.detach()), grads


def check_train_route(label, ref, got, failures, control=False):
    """Hold one training step's loss and gradients to another's: the loss
    within 1e-3 relative, each leaf's max |dg| within TRAIN_TOL of that
    leaf's largest |g| in ref. A control (a planted fault) must fail."""
    worst, at = 0.0, None
    for i, (a, b) in enumerate(zip(ref[1], got[1])):
        r = rel_err(b, a)
        if r > worst:
            worst, at = r, (i, tuple(a.shape))
    dl = abs(got[0] - ref[0]) / abs(ref[0])
    ok = dl <= 1e-3 and worst <= TRAIN_TOL
    log(f"  {label}: loss {got[0]:.6f} vs {ref[0]:.6f} (rel {dl:.2e}, tol "
        f"1e-03); worst leaf max|dg|/max|g| {worst:.3e} at leaf {at} (limit "
        f"{TRAIN_TOL:.0e}) -> {'holds' if ok else 'fails'}")
    if ok == control:
        failures.append(f"{label}: the check {'holds' if ok else 'fails'} "
                        f"(loss rel {dl:.2e}, worst leaf {worst:.3e})")


def train_gpt2(failures):
    """Phase 7. Returns (training summary, launch counts)."""
    from torch.profiler import ProfilerActivity, profile

    from ggml_imax_tpu_torch import _build
    from ggml_imax_tpu_torch import optimize as opt
    from ggml_imax_tpu_torch.models import gpt2
    from ggml_imax_tpu_torch.ops import flash_attention as fa
    from ggml_imax_tpu_torch.ops import flash_backward as fb
    from ggml_imax_tpu_torch.quant.formats import GGMLType

    cfg = gpt2.GPT2Config(**GPT2_117M)
    B, T, L = TRAIN["batch"], TRAIN["seq"], cfg.n_layer
    t0 = time.time()
    params = gpt2.synthetic_params(cfg, GGMLType.F32, seed=0)
    n_params = sum(t.numel() for t in opt.float_leaves(params))
    rng = np.random.default_rng(0)
    toks, tgts = (torch.as_tensor(rng.integers(0, cfg.n_vocab, (B, T)),
                                  device="cuda") for _ in range(2))
    loss_fn = train_loss(cfg, toks, tgts)
    torch.cuda.synchronize()
    log(f"  {n_params / 1e6:.1f} M f32 params drawn in "
        f"{time.time() - t0:.1f} s")
    po = opt.default_params("adam")
    po.adam = opt.AdamParams(n_iter=TRAIN["warmup"], alpha=TRAIN["alpha"],
                             eps_f=0.0, eps_g=0.0)
    t0 = time.time()
    _, params, ctx = opt.opt(loss_fn, params, po)         # warm-up steps
    log(f"  {TRAIN['warmup']} warm-up steps in {time.time() - t0:.1f} s")
    ctx.params.adam.n_iter = TRAIN["steps"]
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    res, params = opt.opt_resume(ctx, loss_fn, params,
                                 callback=lambda it, f: losses.append(f))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    step_ms = wall / TRAIN["steps"] * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    summary = {"step_ms": step_ms,
               "train_tok_s": TRAIN["steps"] * B * T / wall,
               "loss_first": losses[0], "loss_last": losses[-1],
               "steps": len(losses), "max_memory_allocated_gib": peak}
    log(f"  {len(losses)} timed steps ({res.name}): {step_ms:.2f} ms/step, "
        f"{summary['train_tok_s']:.0f} train tok/s, loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}, max_memory_allocated {peak:.3f} GiB")
    log(f"  launches over {TRAIN['steps']} steps: {counts}")
    n = TRAIN["steps"] * L
    check_counts(counts, {"flash_attention": n, "flash_backward_dq": n,
                          "flash_backward_dkv": n}, failures)
    if not (len(losses) == TRAIN["steps"] and losses[-1] < losses[0]
            and all(math.isfinite(f) for f in losses)):
        failures.append(f"training losses {losses}")

    # one profiled step: device busy share, the flash kernels' share, the
    # KV arena's CopySlices backward (the in-place writes' gradient copies)
    ctx.params.adam.n_iter = 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.opt_resume(ctx, loss_fn, params)
    evs = prof.key_averages()
    dev = {ev.key: ev.self_device_time_total / 1e3 for ev in evs
           if str(ev.device_type).endswith("CUDA")
           and ev.self_device_time_total > 0}
    if dev:
        busy = sum(dev.values())
        flash = sum(ms for k, ms in dev.items() if "flash" in k)
        copies = [(ev.count, getattr(ev, "device_time_total", 0) / 1e3)
                  for ev in evs if ev.key.endswith("CopySlices")]
        n_copy, copy_ms = max(copies, key=lambda c: c[1], default=(0, 0.0))
        summary.update(step_busy_ms=busy, flash_ms=flash,
                       copyslices_ms=copy_ms)
        log(f"  profiled step: device busy {busy:.3f} ms of {step_ms:.3f} ms "
            f"unprofiled -> busy {100 * busy / step_ms:.1f}%, idle "
            f"{100 * (1 - busy / step_ms):.1f}%; flash kernels {flash:.3f} ms "
            f"({100 * flash / busy:.1f}% of busy); CopySlices backward "
            f"{copy_ms:.3f} ms over {n_copy} nodes "
            f"({100 * copy_ms / busy:.1f}%)")
        for key, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:10]:
            log(f"    {ms:9.4f} ms  {key[:90]}")
    else:
        log("  profiled step: no device time in the trace (not measured)")

    # the gradient route check at full width (see TRAIN_TOL), then a planted
    # fault that it must catch: dK returned without its softmax scale
    plain = [(fa, "flash_attention_kernel", fa.flash_attention_plain),
             (fb, "flash_attention_bwd_kernel", fb.flash_attention_bwd_plain)]
    real_dkv = fb.flash_backward_dkv

    def dk_unscaled(*args):
        dk, dv = real_dkv(*args)
        return dk / args[8], dv
    ref = loss_and_grads(loss_fn, params, plain)
    check_train_route("training step, kernels vs plain versions on the card",
                      ref, loss_and_grads(loss_fn, params), failures)
    fault = [(fb, "flash_backward_dkv", dk_unscaled)]
    check_train_route("control: dK without its scale", ref,
                      loss_and_grads(loss_fn, params, fault), failures,
                      control=True)
    return summary, counts


def swapped_planes():
    """The K-quant route check's control: the plane-split kernel with the
    low and high planes' scale (and bias) rows swapped, a fault that still
    gives plausible numbers."""
    from dataclasses import replace

    from ggml_imax_tpu_torch.ops import qmm
    real = qmm.planes_w4a16

    def swap(t):
        return None if t is None else \
            t.reshape(-1, 2, t.shape[1]).flip(1).reshape(t.shape).contiguous()

    def fault(x2, qt):
        return real(x2, replace(qt, scale=swap(qt.scale), bias=swap(qt.bias)))
    return [(qmm, "planes_w4a16", fault)]


def kquant_gpt2(failures):
    """Phase 8. GPT-2 117M at full width in Q3_K (N_REQUESTS requests), Q2_K,
    row-pair Q4_0 and u-order Q8_0 (one request each): weights drawn on the
    host (the reference's numpy stream and codecs), repacked, served by
    Engine(n_ctx=1024) with exact launch counts; the Q3_K run profiled;
    then each run's route check, kernels against plain versions on the
    card, and the planted fault on Q3_K. Returns (summary, launch counts),
    both by run."""
    from ggml_imax_tpu_torch.models import gpt2
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.formats import GGMLType
    cfg = gpt2.GPT2Config(**GPT2_117M)
    L = cfg.n_layer
    products = N_PREDICT * 4 * L          # 64 forwards x 48 layer products
    runs = [("q3_k", "Q3_K", GGMLType.Q3_K, None, N_REQUESTS),
            ("q2_k", "Q2_K", GGMLType.Q2_K, None, 1),
            ("rowpair_q4_0", "row-pair Q4_0", GGMLType.Q4_0, "rowpair", 1),
            ("int8_rows_q8_0", "u-order Q8_0", GGMLType.Q8_0, "int8", 1)]
    kernel_of = {None: "planes_w4a16", "rowpair": "rowpair_w4a16",
                 "int8": "int8_rows_w8a16"}
    summary, launches = {}, {}
    for key, label, wtype, layout, n_req in runs:
        log(f"  -- {label}")
        t0 = time.time()
        raw = gpt2.synthetic_params(cfg, wtype, seed=0)
        params = params_repack(raw) if layout is None else \
            legacy_repack(raw, layout)
        del raw
        torch.cuda.synchronize()
        log(f"  weights drawn and quantized on the host, repacked in "
            f"{time.time() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
        eng, rng, reqs, counts = serve(gpt2, cfg, params, cfg.n_ctx, failures,
                                       n_requests=n_req)
        check_counts(counts, {kernel_of[layout]: n_req * products,
                              "flash_attention": n_req * L}, failures)
        launches[f"gpt2_117m_{key}"] = counts
        entry = {"ttft_ms": [r["ttft_ms"] for r in reqs],
                 "decode_tok_s": [r["decode_tok_s"] for r in reqs],
                 "max_memory_allocated_gib":
                     torch.cuda.max_memory_allocated() / 2**30}
        if key == "q3_k":
            busy, walls = profile_engine(eng, rng, reqs)
            entry.update(busy_ms=busy, wall_ms=walls,
                         gated_head_ms=gated_products_ms([params["wte"]],
                                                         busy, walls))
        summary[key] = entry
        del eng
        greedy = lambda patches=(), feed=None: engine_greedy(
            cfg, params, False, patches, model=gpt2, n_prompt=PROMPT,
            n_ctx=cfg.n_ctx, feed=feed)
        ref = greedy()
        check_forced(f"GPT-2 117M {label}, kernels vs plain versions on the "
                     "card", ref, greedy(plain_on_card(), ref[0]), failures,
                     KQ_ROUTE_TOL)
        if key == "q3_k":
            check_forced("control: GPT-2 117M Q3_K, plane-split kernel with "
                         "its low/high scale rows swapped", ref,
                         greedy(swapped_planes(), ref[0]), failures,
                         KQ_ROUTE_TOL, control=True)
        del params
        torch.cuda.empty_cache()
    return summary, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "ggml_imax_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout holding ggml_imax_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    from ggml_imax_tpu_torch import _build

    # ---- 1. setup
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    log(f"# device {name}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi[0] if smi else "nvidia-smi: n/a")
    t0 = time.time()
    _build.lib()
    log(f"# kernels built in {time.time() - t0:.1f} s")
    for line in _build.BUILD_LOG.splitlines():
        if any(w in line for w in ("==", "registers", "spill", "Compiling entry")):
            log("#   " + line.strip())

    # ---- 2. kernels against their plain versions
    log("# phase 2: kernels vs plain versions (main-path shapes)")
    ck, timer = Checks(), Timer()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    check_gptj_kernels(ck, timer, gen)
    check_serving_kernels(ck, timer, gen)
    check_gpt2_kernels(ck, timer, gen)
    check_train_kernels(ck, timer, gen)
    check_kquant_kernels(ck, timer, gen)
    del timer                                      # the 256 MB flush buffer
    torch.cuda.empty_cache()
    failures = ck.failures
    # ---- 3. small models, card vs CPU
    log("# phase 3: small GPT-J and GPT-2, card kernels vs CPU plain versions")
    check_small_models(failures)
    check_small_batched(failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))

    from ggml_imax_tpu_torch.models import gpt2, gptj
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    n_dec, n_pre = N_REQUESTS * (N_PREDICT - 1), N_REQUESTS
    launches, engines = {}, {}

    # ---- 4. engine at GPT-J-6B width
    log("# phase 4: GPT-J-6B Q4_0 engine (synthetic weights on device)")
    cfg = gptj.GPTJConfig(**GPTJ_6B)
    t0 = time.time()
    params = gptj.synthetic_params_device(cfg, seed=0)
    params = params_repack(gptj.prepare_fused(params, cfg))
    torch.cuda.synchronize()
    log(f"  weights drawn + prepared in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    eng, rng, reqs, counts = serve(gptj, cfg, params, 512, failures)
    L = cfg.n_layer
    check_counts(counts, {"w4a8_gemv": n_dec * (2 * L + 1),
                          "decode_attention": n_dec * L,
                          "w4a16_gemm": n_pre * (2 * L + 1),
                          "flash_attention": n_pre * L}, failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    profile_engine(eng, rng, reqs)
    launches["gptj"], engines["gptj"] = counts, reqs
    del eng, params
    torch.cuda.empty_cache()

    # ---- 5. engine at GPT-2 XL width
    log("# phase 5: GPT-2 1558M Q8_0 engine (synthetic weights on device)")
    cfg = gpt2.GPT2Config(**GPT2_XL)
    t0 = time.time()
    params = gpt2.synthetic_params_device(cfg, seed=0)
    params = params_repack(gpt2.prepare_fused(params, cfg))
    torch.cuda.synchronize()
    log(f"  weights drawn + prepared in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    eng, rng, reqs, counts = serve(gpt2, cfg, params, 1024, failures)
    L = cfg.n_layer
    check_counts(counts, {"nat8_w8a8": n_dec * L, "nat8_w8a16": n_pre * L,
                          "flash_attention": n_pre * L}, failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    gated = gated_products_ms(
        [w for lp in params["layers"]
         for w in (lp["attn_w"], lp["proj_w"], lp["out_w"])] + [params["wte"]],
        *profile_engine(eng, rng, reqs))
    launches["gpt2"], engines["gpt2"] = counts, reqs
    del eng, params
    torch.cuda.empty_cache()

    # ---- 6. continuous-batching serving at GPT-J-6B width
    log("# phase 6: GPT-J-6B Q4_0 serving (BatchedEngine, q8_0 KV, n_ctx "
        f"{SERVE['n_ctx']})")
    engines["serving"], by_path = serve_gptj(failures)
    launches.update(by_path)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    torch.cuda.empty_cache()

    # ---- 7. GPT-2 117M training steps
    log(f"# phase 7: GPT-2 117M training (F32, B {TRAIN['batch']}, T "
        f"{TRAIN['seq']}, AdamW)")
    engines["train"], launches["train"] = train_gpt2(failures)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))
    torch.cuda.empty_cache()

    # ---- 8. GPT-2 117M K-quants and the legacy layouts
    log("# phase 8: GPT-2 117M Q3_K / Q2_K engine, row-pair Q4_0 and u-order "
        "Q8_0 (synthetic weights quantized on the host)")
    engines["gpt2_117m"], by_run = kquant_gpt2(failures)
    launches.update(by_run)
    if failures:
        raise SystemExit("chip_smoke FAILED:\n  " + "\n  ".join(failures))

    kernels = []
    for k in KERNELS:
        entry = dict(ck.results[k])
        by_path = {p: c[k] for p, c in launches.items() if c[k]}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        entry["max_abs_err"] = max(ck.errs[k])
        if entry["launches"] == 0:
            raise SystemExit(f"chip_smoke FAILED: {k} never ran on a main path")
        kernels.append(entry)
    log(json.dumps({"engine": engines, "gated_products_ms": gated}))
    log(smi[0] if smi else "nvidia-smi: n/a")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
