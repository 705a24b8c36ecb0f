#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main paths on one NVIDIA GPU: GPT-J-6B Q4_0
and GPT-2 1558M (XL) Q8_0.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):

1. setup: device facts, `nvidia-smi` name and power limit, the kernel build
   from ggml_imax_tpu_torch/csrc (nvcc -Xptxas -v summary);
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card at the main paths' shapes (GPT-J: natpair W4A8/W4A16, decode
   attention, flash; GPT-2 XL: nat8 W8A8/W8A16 on fc_w, flash at D = 64),
   with its time (CUDA events, L2 flushed before each launch), the plain
   version's time, one PyTorch library call computing the same function (a
   yardstick only: the port never calls it) and the least time the card
   could take (bound);
3. small models: a 2-layer GPT-J with head_dim 256, and a 2-layer GPT-2
   with head_dim 64 in Q8_0 and in Q4_0, on the card (kernels) against the
   same model on the CPU (plain versions), prefill + decode;
4. GPT-J engine: synthetic GPT-J-6B Q4_0 drawn on the card, prepare_fused +
   natpair repack, Engine(n_ctx=512) serving 3 requests of a 448-token
   prompt + 64 greedy tokens, with the launch counts of that run; then the
   device busy share of a prefill and of decode steps (torch.profiler
   kernel time against the unprofiled TTFT and step time);
5. GPT-2 XL engine: synthetic GPT-2 1558M Q8_0 drawn on the card,
   prepare_fused + nat8 repack, Engine(n_ctx=1024), the same 3 requests,
   launch counts and profile, and the device time of the products the
   reference's N % 128 gate leaves to dequantize + matmul (attn_w, proj_w,
   out_w, the tied LM head) against the step's device time.

Each engine phase sets the launch counters to 0 just before its requests
and reads them just after. The line before the last is the kernels JSON,
the last line is {"ok": true, "device": {...}}. Needs no arguments, no
network and one card.
"""
from __future__ import annotations

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
            line += (f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
                     f"{lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
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
               q_off=None):
    """One flash-attention case; causal over positions q_off + i (the last
    Tq keys by default), keys at or past q_off + Tq masked as the engine's
    bucketed prefill masks them."""
    from ggml_imax_tpu_torch.ops import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q = torch.randn(B, Tq, Hq, Dh, generator=gen, device="cuda")
    k = torch.randn(B, Tk, Hkv, Dh, generator=gen, device="cuda")
    v = torch.randn(B, Tk, Hkv, Dh, generator=gen, device="cuda")
    q_off = Tk - Tq if q_off is None else q_off
    qi = torch.arange(Tq, device="cuda")[:, None] + q_off
    visible = torch.arange(Tk, device="cuda")[None, :] <= qi
    if kw.get("max_bias"):
        dist = (torch.arange(Tk, device="cuda")[None, :] - qi).float()
        mask = torch.where(visible, dist, float("-inf"))[None, None]
    else:
        mask = torch.where(visible, 0.0, float("-inf"))[None, None]
    mask = mask.expand(B, 1, Tq, Tk)
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
            lib_ms=timer(lambda: sdpa(qb, kb, vb, attn_mask=visible), iters=50),
            nbytes=(B * Tq * Hq + 2 * B * Tk * Hkv) * Dh * 2
            + B * Tq * Tk * 4 + B * Tq * Hq * Dh * 4,
            ops=4 * B * Hq * Tq * Tk * Dh)
    ck.record("flash_attention", label, got, ref, 1e-2, **timing)


def check_gptj_kernels(ck, timer, gen):
    from ggml_imax_tpu_torch.models.common import init_kv_cache, update_kv
    from ggml_imax_tpu_torch.ops import decode_attention as da
    from ggml_imax_tpu_torch.ops import qmm

    E = GPTJ_6B["n_embd"]
    shapes = {"qkvf_w": (E, 7 * E), "of_w": (5 * E, E), "lm_head": (E, 51200)}
    for label, (K, N) in shapes.items():
        qt = random_natpair(K, N, gen)
        wd = qmm.dequant_natpair_bf16(qt)            # library yardstick only
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
        # B: W4A16 GEMM at the prefill bucket M = 512
        M = 512
        xm = torch.randn(M, K, generator=gen, device="cuda")
        got = qmm.w4a16_gemm(xm, qt)
        ref = qmm.w4a16_gemm_plain(xm, qt)
        xmb = xm.to(torch.bfloat16)
        ck.record("w4a16_gemm", f"{label} M={M} K={K} N={N}", got, ref, 1e-3,
                  timer(lambda: qmm.w4a16_gemm(xm, qt)),
                  timer(lambda: qmm.w4a16_gemm_plain(xm, qt), iters=3),
                  timer(lambda: torch.matmul(xmb, wd)),
                  M * K * 2 + K * N // 2 + sbytes + M * N * 4, 2 * M * K * N,
                  PEAK_BF16)
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
        wd = qmm.dequant_nat8_bf16(qt)               # library yardstick only
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
    return busy_ms, walls


def serve(model, cfg, params, n_ctx, failures):
    """The engine phase: a warm-up, then N_REQUESTS requests of a PROMPT-token
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
    for r in range(N_REQUESTS):
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
    log(f"  launches over {N_REQUESTS} requests: {counts}")
    return eng, rng, reqs, counts


def check_counts(counts, expect, failures):
    for k, n in counts.items():
        if n != expect.get(k, 0):
            failures.append(f"{k}: {n} launches, expected {expect.get(k, 0)}")


def gated_products_ms(cfg, params, busy_ms, walls):
    """Device time (torch.profiler kernel sum) of the products the N % 128
    gate leaves to dequantize + torch.matmul, for one decode step (m = 1)
    and one prefill (M = 512): every layer's attn_w, proj_w and out_w, and
    the tied LM head; with their share of the step's device busy time and
    of its unprofiled wall time."""
    from ggml_imax_tpu_torch.ops.qmatmul import qmatmul
    ws = [w for lp in params["layers"]
          for w in (lp["attn_w"], lp["proj_w"], lp["out_w"])] + [params["wte"]]
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
            log(f"  gated products per {label}: no device time (not measured)")
            continue
        share = "" if busy_ms.get(label) is None else \
            f" = {100 * out[label] / busy_ms[label]:.1f}% of its device busy time"
        log(f"  gated dequant + matmul products per {label} ({len(ws)} "
            f"products): {out[label]:.3f} ms device{share}, "
            f"{100 * out[label] / walls[label]:.1f}% of its wall time")
    return out


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
    check_gpt2_kernels(ck, timer, gen)
    del timer                                      # the 256 MB flush buffer
    torch.cuda.empty_cache()
    failures = ck.failures
    # ---- 3. small models, card vs CPU
    log("# phase 3: small GPT-J and GPT-2, card kernels vs CPU plain versions")
    check_small_models(failures)
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
    gated = gated_products_ms(cfg, params, *profile_engine(eng, rng, reqs))
    launches["gpt2"], engines["gpt2"] = counts, reqs
    del eng, params

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
