"""Quantized matmul kernels over the natpair int4 and nat8 int8 layouts
(counterpart of ggml_imax_tpu/ops/pallas_qmm.py, natpair and nat8 branches).

natpair (``q4_layout`` 3): byte row i of the (K/2, N) weight packs natural
elements 2i (low nibble) and 2i+1 (high nibble), each stored XOR 8 so that
a signed nibble read gives q - 8. Each 32-element quant block is 16
consecutive byte rows, so a block's weights are contiguous along K.

nat8 (``q4_layout`` 4): the (K, N) int8 weight in natural row order, one
scale (and optional bias) per g = 32 or 16 rows (Q8_0, Q5_0/1, Q5_K, Q6_K,
IQ4_*). The repack only tags it.

Four kernels, each with a plain PyTorch version beside it:

- `w4a8_gemv` (natpair, m == 1, decode): Q8_0 activations, per-block int32
  dots, f32 scale epilogue — csrc/w4a8_gemv.cu.
- `w4a16_gemm` (natpair, m > 1, prefill): bf16 activations times
  bf16-rounded dequantized weights, f32 accumulation — csrc/w4a16_gemm.cu.
- `nat8_w8a8_gemv` (nat8, m == 1): the same W8A8 math per g-row group —
  csrc/nat8_gemv.cu.
- `nat8_w8a16_gemm` (nat8, m > 1): as w4a16_gemm, weight bf16(q) * bf16(s)
  — csrc/nat8_gemm.cu.

A wrapper launches its kernel for a CUDA tensor (or raises) and runs the
plain version only for a tensor on the CPU.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from .. import _build
from ..quant.device import QTensor

DEFAULT_BK = 512
# W4A8 only at a true GEMV, as the reference dispatches
# (ggml_imax_tpu/ops/pallas_qmm.py _W4A8_MAX_M)
_W4A8_MAX_M = 1


def repack_natpair(qt: QTensor, bk: int = DEFAULT_BK,
                   scale_dtype: torch.dtype | None = None) -> QTensor:
    """Plane-split nib4 -> natpair, byte-identical to the reference's
    repack_natpair_device. ``bk`` is only the layout tag. scale_dtype
    (e.g. torch.bfloat16) stores scales (and any affine bias) half-width;
    None keeps them as they are (f32)."""
    if not (qt.kind == "nib4" and qt.interleaved_bk == 0 and qt.zero in (0, 8)
            and qt.lut is None):
        raise ValueError("repack_natpair takes natural nib4 with zero 0 or 8")
    if qt.k % bk or qt.scale.shape[0] != qt.k // 32:
        raise ValueError("natpair layout needs per-32 scales and K % bk == 0")
    g = qt.q.reshape(qt.k // 32, 16, qt.n)
    vals = torch.cat([g & 0x0F, g >> 4], dim=1).reshape(qt.k, qt.n) ^ 8
    q = (vals[0::2] | (vals[1::2] << 4)).contiguous()
    scale, bias = qt.scale, qt.bias
    if qt.zero == 0:
        bias = 8.0 * scale if bias is None else bias + 8.0 * scale
    if scale_dtype is not None:
        scale = scale.to(scale_dtype)
        bias = None if bias is None else bias.to(scale_dtype)
    return replace(qt, q=q, scale=scale, bias=bias, zero=8, interleaved_bk=bk,
                   q4_layout=3)


def repack_nat8(qt: QTensor, bk: int = DEFAULT_BK,
                scale_dtype: torch.dtype | None = None) -> QTensor:
    """Tag a natural int8 QTensor as nat8 (the counterpart of
    repack_nat8_device): the bytes stay as they are, ``bk`` is only the
    layout tag. scale_dtype stores scales and bias half-width."""
    if not (qt.kind == "int8" and qt.interleaved_bk == 0):
        raise ValueError("repack_nat8 takes natural int8 weights")
    if qt.k % bk:
        raise ValueError(f"nat8 tag bk={bk} does not divide K={qt.k}")
    if qt.k // qt.scale.shape[0] not in (16, 32):
        raise ValueError("nat8 layout needs per-16 or per-32 scales")
    scale, bias = qt.scale, qt.bias
    if scale_dtype is not None:
        scale = scale.to(scale_dtype)
        bias = None if bias is None else bias.to(scale_dtype)
    return replace(qt, scale=scale, bias=bias, interleaved_bk=bk, q4_layout=4)


def params_repack(params, bk: int = DEFAULT_BK,
                  scale_dtype: torch.dtype | None = None):
    """Repack the QTensors of a params tree for the kernels (the
    counterpart of params_repack_device): natural per-32 nib4 -> natpair,
    natural per-16/32 int8 -> nat8. Repacked, dense and codebook tensors
    and int8 of other groups pass through; other nib4 raises (its
    plane-split kernel is not ported)."""
    def conv(x):
        if not isinstance(x, QTensor):
            return x
        if x.interleaved_bk != 0 or x.kind not in ("nib4", "int8") \
                or x.lut is not None:
            return replace(x)
        # the tag has to divide K: shrink it per tensor
        bk_t = bk
        while bk_t >= 64 and x.k % bk_t:
            bk_t //= 2
        if x.k % bk_t:
            return replace(x)
        g = x.k // x.scale.shape[0] if x.kind == "int8" else 32
        if (bk_t // g) % 8:
            bk_t = x.k          # the reference's full-K tag (GPT-2's K=1600)
        if x.kind == "int8":
            if g in (16, 32):
                return repack_nat8(x, bk_t, scale_dtype=scale_dtype)
            return replace(x)
        if x.scale.shape[0] == x.k // 32 and x.zero in (0, 8):
            return repack_natpair(x, bk_t, scale_dtype=scale_dtype)
        raise NotImplementedError(
            "plane-split nib4 (per-16 scales or zero point "
            f"{x.zero}) needs the W4A16 noround kernel, not ported yet")

    def walk(d):
        if isinstance(d, dict):
            return {k: walk(v) for k, v in d.items()}
        if isinstance(d, list):
            return [walk(v) for v in d]
        return conv(d)

    return walk(params)


def quantize_activations_q8(x2: torch.Tensor, g: int = 32):
    """quantize_row_q8_0 value semantics over groups of g (32, or 16 for
    the per-16 nat8 formats), bit-exact with the reference's
    _quantize_activations_q8: d = amax/127, inv = 1/d (0 where d == 0),
    x8 = round_half_even(x * inv). x2 (m, K) -> x8 (K/g, m, g) int8,
    d (K/g, m) f32."""
    m, k = x2.shape
    xr = x2.float().reshape(m, k // g, g)
    amax = xr.abs().amax(dim=-1)
    d = amax / 127.0
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)),
                      torch.zeros_like(d))
    x8 = torch.round(xr * inv[..., None]).to(torch.int8)
    return x8.transpose(0, 1).contiguous(), d.T.contiguous()


def unpack_natpair(q: torch.Tensor) -> torch.Tensor:
    """(K/2, N) natpair bytes -> (K, N) int8 values q - 8."""
    lo = ((q & 0x0F) ^ 8).to(torch.int8) - 8
    hi = ((q >> 4) ^ 8).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=1).reshape(2 * q.shape[0], q.shape[1])


def _check_layout(qt: QTensor, kind: str, q4_layout: int):
    """What every matmul kernel takes: the layout, contiguous tensors, f32
    or bf16 scales and a bias of the scales' dtype."""
    if qt.kind != kind or qt.q4_layout != q4_layout:
        raise ValueError(f"these kernels take q4_layout {q4_layout} {kind} "
                         "weights")
    for t in (qt.q, qt.scale, qt.bias):
        if t is not None and not t.is_contiguous():
            raise ValueError("the matmul kernels take contiguous tensors")
    if qt.scale.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scale dtype {qt.scale.dtype}")
    if qt.bias is not None and qt.bias.dtype != qt.scale.dtype:
        raise ValueError("bias and scale must share a dtype")


def w4a8_gemv_plain(x8, dx, qt: QTensor, xs=None) -> torch.Tensor:
    """Plain version of the W4A8 kernel: x8 (K/32, 32) int8, dx (K/32) f32
    -> (N,) f32. The per-block integer dots are exact in f32 (|z| < 2^24)."""
    nb = qt.k // 32
    w = unpack_natpair(qt.q).reshape(nb, 32, qt.n).float()
    z = torch.bmm(x8.reshape(nb, 1, 32).float(), w).reshape(nb, qt.n)
    out = (z * (dx[:, None] * qt.scale.float())).sum(0)
    if qt.bias is not None:
        out = out + (xs[:, None] * qt.bias.float()).sum(0)
    return out


def w4a8_gemv(x8, dx, qt: QTensor, xs=None) -> torch.Tensor:
    """W4A8 GEMV: Q8_0 activations x8 (K/32, 32) int8 with d_x dx (K/32) f32
    (and per-block sums xs = dx * sum(x8) when the weight has a bias) times
    natpair weights -> (N,) f32."""
    _check_layout(qt, "nib4", 3)
    if x8.shape != (qt.k // 32, 32) or dx.shape != (qt.k // 32,):
        raise ValueError(f"w4a8_gemv: x8 {tuple(x8.shape)} for K={qt.k}")
    if x8.device.type == "cpu":
        return w4a8_gemv_plain(x8, dx, qt, xs)
    if qt.n % 4 or x8.dtype != torch.int8 or dx.dtype != torch.float32:
        raise ValueError("w4a8_gemv: N % 4, int8 x8 and f32 dx required")
    x8, dx = x8.contiguous(), dx.contiguous()
    xs = None if qt.bias is None else xs.float().contiguous()
    out = torch.empty(qt.n, dtype=torch.float32, device=x8.device)
    rc = _build.lib().ggml_w4a8_gemv(
        x8.data_ptr(), dx.data_ptr(), qt.q.data_ptr(), qt.scale.data_ptr(),
        _build.ptr(qt.bias), _build.ptr(xs), out.data_ptr(), qt.k, qt.n,
        int(qt.scale.dtype == torch.bfloat16), _build.stream_ptr(x8))
    _build.check(rc, "w4a8_gemv")
    _build.LAUNCHES["w4a8_gemv"] += 1
    return out


def dequant_natpair_bf16(qt: QTensor) -> torch.Tensor:
    """(K, N) bf16 weight rounded as the reference's W4A16 kernel rounds it:
    bf16(q - 8) * bf16(s), the product rounded to bf16."""
    s = qt.scale.to(torch.bfloat16).repeat_interleave(32, dim=0)
    return unpack_natpair(qt.q).to(torch.bfloat16) * s


def _a16_plain(x2, w_bf16, qt: QTensor) -> torch.Tensor:
    """bf16(x) @ w with f32 sums, + (per-group sums of bf16(x)) @ bias."""
    xb = x2.to(torch.bfloat16).float()
    out = xb @ w_bf16.float()
    if qt.bias is not None:
        nb = qt.bias.shape[0]
        xs = xb.reshape(x2.shape[0], nb, qt.k // nb).sum(-1)
        out = out + xs @ qt.bias.float()
    return out


def w4a16_gemm_plain(x2, qt: QTensor) -> torch.Tensor:
    """Plain version of the W4A16 kernel: x2 (M, K) -> (M, N) f32."""
    return _a16_plain(x2, dequant_natpair_bf16(qt), qt)


def w4a16_gemm(x2, qt: QTensor) -> torch.Tensor:
    """W4A16 matmul: x2 (M, K), cast to bf16, times natpair weights ->
    (M, N) f32."""
    _check_layout(qt, "nib4", 3)
    if x2.dim() != 2 or x2.shape[1] != qt.k:
        raise ValueError(f"w4a16_gemm: x {tuple(x2.shape)} for K={qt.k}")
    if x2.device.type == "cpu":
        return w4a16_gemm_plain(x2, qt)
    if qt.n % 8:
        raise ValueError("w4a16_gemm: N % 8 required")
    xb = x2.to(torch.bfloat16).contiguous()
    xs = None
    if qt.bias is not None:
        xs = xb.float().reshape(x2.shape[0], qt.k // 32, 32).sum(-1).contiguous()
    out = torch.empty(x2.shape[0], qt.n, dtype=torch.float32, device=x2.device)
    rc = _build.lib().ggml_w4a16_gemm(
        xb.data_ptr(), qt.q.data_ptr(), qt.scale.data_ptr(),
        _build.ptr(qt.bias), _build.ptr(xs), out.data_ptr(), x2.shape[0],
        qt.k, qt.n, int(qt.scale.dtype == torch.bfloat16),
        _build.stream_ptr(x2))
    _build.check(rc, "w4a16_gemm")
    _build.LAUNCHES["w4a16_gemm"] += 1
    return out


def qmatmul_natpair(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (..., K) @ natpair W -> (..., N) f32: W4A8 at m == 1, W4A16 above
    (the reference's _qmatmul_natpair / qmatmul_stacked dispatch)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, qt.k)
    if x2.shape[0] <= _W4A8_MAX_M:
        x8, dx = quantize_activations_q8(x2)
        xs = None
        if qt.bias is not None:
            xs = dx[:, 0] * x8[:, 0].float().sum(-1)
        out = w4a8_gemv(x8[:, 0], dx[:, 0], qt, xs)[None]
    else:
        out = w4a16_gemm(x2, qt)
    return out.reshape(*lead, qt.n)


def _check_nat8(qt: QTensor):
    _check_layout(qt, "int8", 4)
    if qt.k // qt.scale.shape[0] not in (16, 32) or qt.k % qt.scale.shape[0]:
        raise ValueError("nat8 kernels take per-16 or per-32 scales")


def nat8_group(qt: QTensor) -> int:
    return qt.k // qt.scale.shape[0]


def nat8_w8a8_gemv_plain(x8, dx, qt: QTensor, xs=None) -> torch.Tensor:
    """Plain version of the W8A8 kernel: x8 (K/g, g) int8, dx (K/g) f32 ->
    (N,) f32. Per group b: z = int dot of x8[b] and q[bg:(b+1)g] (exact in
    f32, |z| < 2^24), out += z * (dx[b] * s[b]); with a bias also
    xs[b] * bias[b]."""
    g = nat8_group(qt)
    nb = qt.k // g
    z = torch.bmm(x8.reshape(nb, 1, g).float(),
                  qt.q.reshape(nb, g, qt.n).float()).reshape(nb, qt.n)
    out = (z * (dx[:, None] * qt.scale.float())).sum(0)
    if qt.bias is not None:
        out = out + (xs[:, None] * qt.bias.float()).sum(0)
    return out


def nat8_w8a8_gemv(x8, dx, qt: QTensor, xs=None) -> torch.Tensor:
    """W8A8 GEMV: activations quantized per group of g = K / scale rows
    (x8 (K/g, g) int8, d_x dx (K/g) f32, and xs = dx * sum(x8) per group when
    the weight has a bias) times nat8 weights -> (N,) f32."""
    _check_nat8(qt)
    g = nat8_group(qt)
    if x8.shape != (qt.k // g, g) or dx.shape != (qt.k // g,):
        raise ValueError(f"nat8_w8a8_gemv: x8 {tuple(x8.shape)} for K={qt.k}, "
                         f"g={g}")
    if x8.device.type == "cpu":
        return nat8_w8a8_gemv_plain(x8, dx, qt, xs)
    if qt.n % 16 or x8.dtype != torch.int8 or dx.dtype != torch.float32:
        raise ValueError("nat8_w8a8_gemv: N % 16, int8 x8 and f32 dx required")
    if qt.q.data_ptr() % 16:
        raise ValueError("nat8_w8a8_gemv: the weight must be 16-byte aligned")
    x8, dx = x8.contiguous(), dx.contiguous()
    xs = None if qt.bias is None else xs.float().contiguous()
    out = torch.empty(qt.n, dtype=torch.float32, device=x8.device)
    rc = _build.lib().ggml_nat8_gemv(
        x8.data_ptr(), dx.data_ptr(), qt.q.data_ptr(), qt.scale.data_ptr(),
        _build.ptr(qt.bias), _build.ptr(xs), out.data_ptr(), qt.k, qt.n, g,
        int(qt.scale.dtype == torch.bfloat16), _build.stream_ptr(x8))
    _build.check(rc, "nat8_w8a8")
    _build.LAUNCHES["nat8_w8a8"] += 1
    return out


def dequant_nat8_bf16(qt: QTensor) -> torch.Tensor:
    """(K, N) bf16 weight rounded as the reference's W8A16 kernel rounds it:
    bf16(q) * bf16(s), the product rounded to bf16 (the scale is cast to
    bf16 even when it is stored f32)."""
    s = qt.scale.to(torch.bfloat16).repeat_interleave(nat8_group(qt), dim=0)
    return qt.q.to(torch.bfloat16) * s


def nat8_w8a16_gemm_plain(x2, qt: QTensor) -> torch.Tensor:
    """Plain version of the W8A16 kernel: x2 (M, K) -> (M, N) f32."""
    return _a16_plain(x2, dequant_nat8_bf16(qt), qt)


def nat8_w8a16_gemm(x2, qt: QTensor) -> torch.Tensor:
    """W8A16 matmul: x2 (M, K), cast to bf16, times nat8 weights -> (M, N)
    f32."""
    _check_nat8(qt)
    if x2.dim() != 2 or x2.shape[1] != qt.k:
        raise ValueError(f"nat8_w8a16_gemm: x {tuple(x2.shape)} for K={qt.k}")
    if x2.device.type == "cpu":
        return nat8_w8a16_gemm_plain(x2, qt)
    if qt.k % 32:
        raise ValueError("nat8_w8a16_gemm: K % 32 required")
    g = nat8_group(qt)
    xb = x2.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        raise ValueError("nat8_w8a16_gemm: x must be 16-byte aligned in bf16")
    xs = None
    if qt.bias is not None:
        xs = xb.float().reshape(x2.shape[0], qt.k // g, g).sum(-1).contiguous()
    out = torch.empty(x2.shape[0], qt.n, dtype=torch.float32, device=x2.device)
    rc = _build.lib().ggml_nat8_gemm(
        xb.data_ptr(), qt.q.data_ptr(), qt.scale.data_ptr(),
        _build.ptr(qt.bias), _build.ptr(xs), out.data_ptr(), x2.shape[0],
        qt.k, qt.n, g, int(qt.scale.dtype == torch.bfloat16),
        _build.stream_ptr(x2))
    _build.check(rc, "nat8_w8a16")
    _build.LAUNCHES["nat8_w8a16"] += 1
    return out


def qmatmul_nat8(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (..., K) @ nat8 W -> (..., N) f32: W8A8 with activations quantized
    per group g at m <= _W4A8_MAX_M, W8A16 above (the reference's
    _qmatmul_nat8 dispatch)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, qt.k)
    if x2.shape[0] <= _W4A8_MAX_M:
        g = nat8_group(qt)
        x8, dx = quantize_activations_q8(x2, g)
        xs = None
        if qt.bias is not None:
            xs = dx[:, 0] * x8[:, 0].float().sum(-1)
        out = nat8_w8a8_gemv(x8[:, 0], dx[:, 0], qt, xs)[None]
    else:
        out = nat8_w8a16_gemm(x2, qt)
    return out.reshape(*lead, qt.n)
