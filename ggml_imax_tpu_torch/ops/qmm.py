"""Quantized matmul kernels over the repacked weight layouts (counterpart of
ggml_imax_tpu/ops/pallas_qmm.py).

natpair (``q4_layout`` 3): byte row i of the (K/2, N) weight packs natural
elements 2i (low nibble) and 2i+1 (high nibble), each stored XOR 8 so that
a signed nibble read gives q - 8. Each 32-element quant block is 16
consecutive byte rows, so a block's weights are contiguous along K.

nat8 (``q4_layout`` 4): the (K, N) int8 weight in natural row order, one
scale (and optional bias) per g = 32 or 16 rows (Q8_0, Q5_0/1, Q5_K, Q6_K,
IQ4_*). The repack only tags it.

The three permuted layouts cut K into tiles of bk = ``interleaved_bk``
rows and reorder the rows inside each tile (NB = bk / group):

- planes (``q4_layout`` 0, ``repack_interleaved``): the plane-split nib4
  of any zero point and per-16 or per-32 scales (Q2_K, Q3_K). Byte row
  r = j * NB + b of a tile holds element 32b + j of the tile in the low
  nibble and 32b + 16 + j in the high one.
- row-pair (``q4_layout`` 1, ``repack_rowpair``): per-32 nib4, row
  u = e * NB + b holds element 32b + e; byte row i packs rows 2i (low) and
  2i + 1 (high), XOR 8.
- u-order int8 (``q4_layout`` 2, ``repack_int8_rows``): row u = e * NB + b
  holds element g b + e.

Seven kernels, each with a plain PyTorch version beside it:

- `w4a8_gemv` (natpair, m == 1, decode): Q8_0 activations, per-block int32
  dots, f32 scale epilogue, K cut across blocks as `w4a8_plan` says —
  csrc/w4a8_gemv.cu.
- `w4a16_gemm` (natpair, m > 1): bf16 activations times bf16-rounded
  dequantized weights, f32 accumulation, a small-M route up to m = 8 and a
  tile route above, K cut across blocks as `natpair_plan` says —
  csrc/w4a16_gemm.cu.
- `nat8_w8a8_gemv` (nat8, m == 1): the same W8A8 math per g-row group,
  K cut across blocks as `nat8_gemv_plan` says — csrc/nat8_gemv.cu.
- `nat8_w8a16_gemm` (nat8, m > 1): as w4a16_gemm, weight bf16(q) * bf16(s),
  the two routes and the K split as `nat8_plan` says — csrc/nat8_gemm.cu.
- `planes_w4a16`, `rowpair_w4a16`, `int8_rows_w8a16` (every m: these
  layouts have no W8A8 path): bf16 activations times the weight read in
  its stored layout, a GEMV route up to m = 8 and a tile route above,
  K cut across blocks as `permuted_plan` says — csrc/permuted_gemm.cu.

A wrapper launches its kernel for a CUDA tensor (or raises) and runs the
plain version only for a tensor on the CPU.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from .. import _build
from ..quant.device import QTensor

DEFAULT_BK = 512
# streaming multiprocessors of the H100, which the K splits fill
_SMS = 132
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


def _check_tile(qt: QTensor, bk: int, kind: str):
    if not (qt.kind == kind and qt.interleaved_bk == 0 and qt.lut is None):
        raise ValueError(f"this repack takes natural {kind} weights")
    if bk <= 0 or qt.k % bk:
        raise ValueError(f"tag bk={bk} does not divide K={qt.k}")


def repack_interleaved(qt: QTensor, bk: int = DEFAULT_BK) -> QTensor:
    """Natural plane-split nib4 -> block-interleaved tiles of bk rows,
    byte-identical to the reference's repack_interleaved_device: byte row
    16b + j of a tile moves to j * NB + b. Scales and bias stay as they
    are (per-16 or per-32, natural rows)."""
    _check_tile(qt, bk, "nib4")
    nb = bk // 32
    q = qt.q.reshape(qt.k // bk, nb, 16, qt.n).transpose(1, 2) \
        .reshape(qt.k // 2, qt.n).contiguous()
    return replace(qt, q=q, interleaved_bk=bk)


def repack_rowpair(qt: QTensor, bk: int = DEFAULT_BK) -> QTensor:
    """Natural per-32 nib4 with zero 0 or 8 -> the row-pair layout,
    byte-identical to the reference's repack_rowpair_device. Stored values
    are q - 8 (XOR 8); with zero 0 the bias takes 8 * scale back."""
    _check_tile(qt, bk, "nib4")
    if qt.zero not in (0, 8) or qt.scale.shape[0] != qt.k // 32:
        raise ValueError("the row-pair layout needs per-32 scales and zero "
                         "0 or 8")
    nb = bk // 32
    g = qt.q.reshape(qt.k // 32, 16, qt.n)
    vals = torch.cat([g & 0x0F, g >> 4], dim=1).reshape(qt.k, qt.n) ^ 8
    # rows to u-order: (tile, b, e) -> u = e * NB + b
    vt = vals.reshape(qt.k // bk, nb, 32, qt.n).transpose(1, 2) \
        .reshape(qt.k // bk, bk, qt.n)
    q = (vt[:, 0::2] | (vt[:, 1::2] << 4)).reshape(qt.k // 2, qt.n) \
        .contiguous()
    bias = qt.bias
    if qt.zero == 0:
        bias = 8.0 * qt.scale if bias is None else bias + 8.0 * qt.scale
    return replace(qt, q=q, bias=bias, zero=8, interleaved_bk=bk,
                   q4_layout=1)


def repack_int8_rows(qt: QTensor, bk: int = DEFAULT_BK) -> QTensor:
    """Natural int8 with per-16 or per-32 scales -> u-order rows, byte-
    identical to the reference's repack_int8_rows_device."""
    _check_tile(qt, bk, "int8")
    g = qt.k // qt.scale.shape[0]
    if g not in (16, 32) or bk % g:
        raise ValueError(f"u-order int8 needs g 16 or 32 dividing bk, g={g}")
    q = qt.q.reshape(qt.k // bk, bk // g, g, qt.n).transpose(1, 2) \
        .reshape(qt.k, qt.n).contiguous()
    return replace(qt, q=q, interleaved_bk=bk, q4_layout=2)


def params_repack(params, bk: int = DEFAULT_BK,
                  scale_dtype: torch.dtype | None = None):
    """Repack the QTensors of a params tree for the kernels (the
    counterpart of params_repack_device): natural per-32 nib4 with zero 0
    or 8 -> natpair, other nib4 (per-16 scales, other zero points) ->
    block-interleaved planes, natural per-16/32 int8 -> nat8. Repacked,
    dense and codebook tensors and int8 of other groups pass through.
    scale_dtype applies to natpair and nat8, as in the reference."""
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
        return repack_interleaved(x, bk_t)

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


# csrc/w4a8_gemv.cu's blocks own 128 columns each (kCols); K is cut across
# blocks into pieces of whole quant blocks, the pieces of a column block one
# thread-block cluster
_W4A8_COLS = 128


def w4a8_plan(k: int, n: int) -> int:
    """K split of the W4A8 GEMV (csrc/w4a8_gemv.cu): the least divisor of
    K/32 (at most 8) whose 128-column blocks give the 132 SMs one each, as
    `_fill_split` says."""
    return _fill_split(-(-n // _W4A8_COLS), k // 32)


def w4a8_gemv(x8, dx, qt: QTensor, xs=None) -> torch.Tensor:
    """W4A8 GEMV: Q8_0 activations x8 (K/32, 32) int8 with d_x dx (K/32) f32
    (and per-block sums xs = dx * sum(x8) when the weight has a bias) times
    natpair weights -> (N,) f32, K cut as `w4a8_plan` says."""
    _check_layout(qt, "nib4", 3)
    if x8.shape != (qt.k // 32, 32) or dx.shape != (qt.k // 32,):
        raise ValueError(f"w4a8_gemv: x8 {tuple(x8.shape)} for K={qt.k}")
    if qt.bias is not None and (xs is None or xs.shape != dx.shape):
        raise ValueError("w4a8_gemv: a weight with a bias needs xs (K/32)")
    if x8.device.type == "cpu":
        return w4a8_gemv_plain(x8, dx, qt, xs)
    if qt.n % _W4A8_COLS or qt.k % 32 or x8.dtype != torch.int8 \
            or dx.dtype != torch.float32:
        raise ValueError("w4a8_gemv: N % 128, K % 32, int8 x8 and f32 dx "
                         "required")
    x8, dx = x8.contiguous(), dx.contiguous()
    if any(t.data_ptr() % 16 for t in (x8, qt.q, qt.scale, qt.bias)
           if t is not None):
        raise ValueError("w4a8_gemv: a 16-byte aligned x8, weight, scale and "
                         "bias required")
    xs = None if qt.bias is None else xs.float().contiguous()
    out = torch.empty(qt.n, dtype=torch.float32, device=x8.device)
    rc = _build.lib().ggml_w4a8_gemv(
        x8.data_ptr(), dx.data_ptr(), qt.q.data_ptr(), qt.scale.data_ptr(),
        _build.ptr(qt.bias), _build.ptr(xs), out.data_ptr(), qt.k, qt.n,
        w4a8_plan(qt.k, qt.n), int(qt.scale.dtype == torch.bfloat16),
        _build.stream_ptr(x8))
    _build.check(rc, "w4a8_gemv")
    _build.LAUNCHES["w4a8_gemv"] += 1
    return out


def _expand(t: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """(K/g, N) scale or bias rows -> (K, N) bf16, natural row order."""
    return t.to(torch.bfloat16).repeat_interleave(qt.k // t.shape[0], dim=0)


def dequant_bf16(qt: QTensor) -> torch.Tensor:
    """(K, N) bf16 weight in natural row order as the reference's A16
    kernels round it before the matrix unit: bf16(q) * bf16(s), the product
    rounded to bf16 (q the stored integer, q - 8 for natpair and row-pair;
    the scale is cast to bf16 even when it is stored f32). No bias."""
    return natural_q(qt).to(torch.bfloat16) * _expand(qt.scale, qt)


def a16_gemm_plain(x2, qt: QTensor) -> torch.Tensor:
    """Plain version of the natpair W4A16, nat8 W8A16, row-pair W4A16 and
    u-order W8A16 kernels: x2 (M, K) -> (M, N) f32, bf16(x) @ dequant_bf16
    with f32 sums, + the exact f32 term (per-group sums of bf16(x)) @ bias."""
    xb = x2.to(torch.bfloat16).float()
    out = xb @ dequant_bf16(qt).float()
    if qt.bias is not None:
        nb = qt.bias.shape[0]
        xs = xb.reshape(x2.shape[0], nb, qt.k // nb).sum(-1)
        out = out + xs @ qt.bias.float()
    return out


w4a16_gemm_plain = a16_gemm_plain


# The launch shapes of csrc/w4a16_gemm.cu and csrc/nat8_gemm.cu (kept equal
# to their constants): the small-M route up to M 8, in blocks of 128
# columns, deals K out in pieces of 32 rows; the tile route above, in
# 128 x 256 tiles, walks K in steps of 64, one block filling an SM. Either
# cuts K across blocks into at most 8 pieces: the pieces of an output tile
# form one thread-block cluster.
_A16_SMALL_MAX_M = 8
_A16_COLS = 128
_A16_TILE_M, _A16_TILE_N, _A16_TILE_K = 128, 256, 64
_A16_MAX_SPLIT = 8
# The tile routes (H100 readings of chip_smoke-style timings of W4A16):
# clusters of more than 5 such blocks co-schedule in two waves, and a
# cluster's sum of its partial tiles costs about as much as 4 K steps
# (GPT-J's qkvf_w at M 512 is 3-4% faster cut in 2, its LM head 2-3%
# slower).
_A16_TILE_MAX_SPLIT = 5
_A16_TILE_SUM_STEPS = 4


def _k_splits(units: int, most: int) -> list[int]:
    return [s for s in range(1, min(units, most) + 1) if units % s == 0]


def _fill_split(blocks: int, units: int) -> int:
    """K split of a GEMV-shaped launch of `blocks` column blocks over K's
    `units` pieces: the least divisor of units (at most 8, a cluster's
    blocks) that gives the 132 SMs a block each, 1 when the column blocks
    alone fill them, the largest when none does."""
    if blocks >= _SMS:
        return 1
    splits = _k_splits(units, _A16_MAX_SPLIT)
    return next((s for s in splits if blocks * s >= _SMS), splits[-1])


def _tile_split(m: int, k: int, n: int) -> int:
    """K split of an A16 tile route with the launch shapes above (one block
    an SM): the least waves x (steps a block + the cluster sum's cost in
    steps), at most 5 pieces, the least such split on a tie."""
    blocks = -(-n // _A16_TILE_N) * -(-m // _A16_TILE_M)
    units = -(-k // _A16_TILE_K)
    return min(_k_splits(units, _A16_TILE_MAX_SPLIT), key=lambda s: (
        -(-blocks * s // _SMS)
        * (units // s + (_A16_TILE_SUM_STEPS if s > 1 else 0)), s))


def natpair_plan(m: int, k: int, n: int) -> tuple[str, int]:
    """(route, split) of a natpair W4A16 product (csrc/w4a16_gemm.cu):
    "small" for m <= 8, "tile" above (the C entry takes the route from m by
    the same rule), and the number of pieces K is cut into across blocks, a
    divisor of K's pieces. The small-M route (two blocks an SM, bound by
    bytes) takes the least split that gives the 132 SMs a block each, or
    the largest when none does; the tile route as `_tile_split` says."""
    if m <= _A16_SMALL_MAX_M:
        return "small", _fill_split(-(-n // _A16_COLS), k // 32)
    return "tile", _tile_split(m, k, n)


# csrc/nat8_gemm.cu's small-M blocks (8 warps, over 128 registers a thread)
# fill an SM each, so a split past one wave of them costs a second wave.


def nat8_plan(m: int, k: int, n: int) -> tuple[str, int]:
    """(route, split) of a nat8 W8A16 product (csrc/nat8_gemm.cu): "small"
    for m <= 8, "tile" above (the C entry takes the route from m by the
    same rule), and the number of pieces K is cut into across blocks, a
    divisor of K's pieces (32 rows on the small-M route, each one or two
    groups). The small-M route (one block an SM, bound by bytes) takes the
    largest split whose blocks fit one wave, 1 when the column blocks
    alone fill it; the tile route as `_tile_split` says."""
    if m <= _A16_SMALL_MAX_M:
        blocks = -(-n // _A16_COLS)
        fit = [s for s in _k_splits(k // 32, _A16_MAX_SPLIT)
               if blocks * s <= _SMS]
        return "small", fit[-1] if fit else 1
    return "tile", _tile_split(m, k, n)


def w4a16_gemm(x2, qt: QTensor) -> torch.Tensor:
    """W4A16 matmul: x2 (M, K), rounded to bf16, times natpair weights ->
    (M, N) f32, cut as `natpair_plan` says."""
    _check_layout(qt, "nib4", 3)
    if x2.dim() != 2 or x2.shape[1] != qt.k:
        raise ValueError(f"w4a16_gemm: x {tuple(x2.shape)} for K={qt.k}")
    if x2.device.type == "cpu":
        return w4a16_gemm_plain(x2, qt)
    if qt.n % _A16_COLS or qt.k % 32 or any(
            t.data_ptr() % 16 for t in (qt.q, qt.scale, qt.bias)
            if t is not None):
        raise ValueError("w4a16_gemm: N % 128, K % 32 and a 16-byte aligned "
                         "weight, scale and bias required")
    m = x2.shape[0]
    route, split = natpair_plan(m, qt.k, qt.n)
    xs = None
    if route == "small":
        # the small-M route rounds x to bf16 as it loads it, and sums its
        # groups for the bias term itself
        xin = x2.float().contiguous()
    else:
        xin = x2.to(torch.bfloat16).contiguous()
        if qt.bias is not None:
            xs = xin.float().reshape(m, qt.k // 32, 32).sum(-1).contiguous()
    if xin.data_ptr() % 16:
        raise ValueError(f"w4a16_gemm: x must be 16-byte aligned in "
                         f"{str(xin.dtype)[6:]}")
    out = torch.empty(m, qt.n, dtype=torch.float32, device=x2.device)
    rc = _build.lib().ggml_w4a16_gemm(
        xin.data_ptr(), qt.q.data_ptr(), qt.scale.data_ptr(),
        _build.ptr(qt.bias), _build.ptr(xs), out.data_ptr(), m, qt.k, qt.n,
        split, int(qt.scale.dtype == torch.bfloat16), _build.stream_ptr(x2))
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


# csrc/nat8_gemv.cu's blocks own 128 columns each (kCols) and run two an SM;
# K is cut across blocks into pieces of whole 32-row units (one g-32 group or
# two g-16 ones), the pieces of a column block one thread-block cluster
_NAT8_GEMV_COLS = 128
_NAT8_GEMV_UNIT = 32
# the clusters of s such blocks the H100 runs at once
# (cudaOccupancyMaxActiveClusters, s = 2 .. 8; chip_smoke.py logs the card's
# own): a cluster stays inside one GPC, so clusters of 5 or more leave many
# of the 264 block slots empty
_NAT8_GEMV_CLUSTERS = {2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30}


def nat8_gemv_plan(k: int, n: int, g: int) -> int:
    """K split of the W8A8 GEMV (csrc/nat8_gemv.cu) over a weight of g-row
    groups (16 or 32; a unit is 32 rows at either): 1 when the 128-column
    blocks alone give each of the 132 SMs one, else the largest split (at
    most 8 and K/32) whose clusters the card runs in one wave. More pieces
    put more of the weight in flight at once; a second wave costs a whole
    one. The pieces differ by at most one unit."""
    if g not in (16, 32):
        raise ValueError(f"nat8_gemv_plan: g {g}")
    blocks, units = -(-n // _NAT8_GEMV_COLS), k // _NAT8_GEMV_UNIT
    if blocks >= _SMS:
        return 1
    fit = [s for s in range(2, min(_A16_MAX_SPLIT, units) + 1)
           if blocks <= _NAT8_GEMV_CLUSTERS[s]]
    return fit[-1] if fit else 1


def nat8_w8a8_gemv(x8, dx, qt: QTensor, xs=None) -> torch.Tensor:
    """W8A8 GEMV: activations quantized per group of g = K / scale rows
    (x8 (K/g, g) int8, d_x dx (K/g) f32, and xs = dx * sum(x8) per group when
    the weight has a bias) times nat8 weights -> (N,) f32, K cut as
    `nat8_gemv_plan` says."""
    _check_nat8(qt)
    g = nat8_group(qt)
    if x8.shape != (qt.k // g, g) or dx.shape != (qt.k // g,):
        raise ValueError(f"nat8_w8a8_gemv: x8 {tuple(x8.shape)} for K={qt.k}, "
                         f"g={g}")
    if qt.bias is not None and (xs is None or xs.shape != dx.shape):
        raise ValueError("nat8_w8a8_gemv: a weight with a bias needs xs (K/g)")
    if x8.device.type == "cpu":
        return nat8_w8a8_gemv_plain(x8, dx, qt, xs)
    if qt.n % _NAT8_GEMV_COLS or qt.k % _NAT8_GEMV_UNIT \
            or x8.dtype != torch.int8 or dx.dtype != torch.float32:
        raise ValueError("nat8_w8a8_gemv: N % 128, K % 32, int8 x8 and f32 dx "
                         "required")
    x8, dx = x8.contiguous(), dx.contiguous()
    if any(t.data_ptr() % 16 for t in (x8, qt.q, qt.scale, qt.bias)
           if t is not None):
        raise ValueError("nat8_w8a8_gemv: a 16-byte aligned x8, weight, scale "
                         "and bias required")
    xs = None if qt.bias is None else xs.float().contiguous()
    out = torch.empty(qt.n, dtype=torch.float32, device=x8.device)
    rc = _build.lib().ggml_nat8_gemv(
        x8.data_ptr(), dx.data_ptr(), qt.q.data_ptr(), qt.scale.data_ptr(),
        _build.ptr(qt.bias), _build.ptr(xs), out.data_ptr(), qt.k, qt.n, g,
        nat8_gemv_plan(qt.k, qt.n, g), int(qt.scale.dtype == torch.bfloat16),
        _build.stream_ptr(x8))
    _build.check(rc, "nat8_w8a8")
    _build.LAUNCHES["nat8_w8a8"] += 1
    return out


nat8_w8a16_gemm_plain = a16_gemm_plain


def nat8_w8a16_gemm(x2, qt: QTensor) -> torch.Tensor:
    """W8A16 matmul: x2 (M, K), rounded to bf16, times nat8 weights ->
    (M, N) f32, cut as `nat8_plan` says."""
    _check_nat8(qt)
    if x2.dim() != 2 or x2.shape[1] != qt.k:
        raise ValueError(f"nat8_w8a16_gemm: x {tuple(x2.shape)} for K={qt.k}")
    if x2.device.type == "cpu":
        return nat8_w8a16_gemm_plain(x2, qt)
    if qt.k % 32:
        raise ValueError("nat8_w8a16_gemm: K % 32 required")
    if x2.data_ptr() % 16:
        raise ValueError("nat8_w8a16_gemm: x must be 16-byte aligned")
    g, m = nat8_group(qt), x2.shape[0]
    route, split = nat8_plan(m, qt.k, qt.n)
    xs = None
    if route == "small":
        # the small-M route rounds x to bf16 as it loads it, and sums its
        # groups for the bias term itself
        xin = x2.float().contiguous()
    else:
        xin = x2.to(torch.bfloat16).contiguous()
        if qt.bias is not None:
            xs = xin.float().reshape(m, qt.k // g, g).sum(-1).contiguous()
    out = torch.empty(m, qt.n, dtype=torch.float32, device=x2.device)
    rc = _build.lib().ggml_nat8_gemm(
        xin.data_ptr(), qt.q.data_ptr(), qt.scale.data_ptr(),
        _build.ptr(qt.bias), _build.ptr(xs), out.data_ptr(), m, qt.k, qt.n,
        g, split, int(qt.scale.dtype == torch.bfloat16), _build.stream_ptr(x2))
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


# ---- the permuted layouts: planes, row-pair, u-order int8 ----

def unpack_planes(q: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """(K/2, C) plane-split bytes of qt's layout (natural, or block-
    interleaved by qt.interleaved_bk) -> (K, C) int8 values nib - zero in
    natural row order. C may be any number of qt's columns."""
    c, bk = q.shape[1], qt.interleaved_bk
    if bk:
        q = q.reshape(qt.k // bk, 16, bk // 32, c).transpose(1, 2)
    g = q.reshape(qt.k // 32, 16, c)
    return torch.cat([(g & 0x0F).to(torch.int8) - qt.zero,
                      (g >> 4).to(torch.int8) - qt.zero], dim=1) \
        .reshape(qt.k, c)


def unpack_rowpair(q: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """(K/2, C) row-pair bytes -> (K, C) int8 values q - 8 in natural row
    order: interleave each byte's two rows, then undo u = e * NB + b per
    tile (the reference's _unpack_rowpair)."""
    c, bk = q.shape[1], qt.interleaved_bk
    u = unpack_natpair(q)                               # u-order rows
    return u.reshape(qt.k // bk, 32, bk // 32, c).transpose(1, 2) \
        .reshape(qt.k, c)


def unorder_int8_rows(q: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """(K, C) u-order int8 rows -> natural row order."""
    c, bk = q.shape[1], qt.interleaved_bk
    g = qt.k // qt.scale.shape[0]
    return q.reshape(qt.k // bk, g, bk // g, c).transpose(1, 2) \
        .reshape(qt.k, c)


def natural_q(qt: QTensor, q: torch.Tensor | None = None) -> torch.Tensor:
    """The integer values of a nib4 or int8 QTensor in natural row order,
    (K, C) int8 (nib4: nib - zero; natpair and row-pair: q - 8). q: the
    stored bytes of some of qt's columns (default all): every layout
    permutes rows within K tiles, never columns. A codebook layout (nib2,
    nib4 with a lut) has no integer levels: it raises, and
    ops.qmatmul.dequantize (quant.device.codebook_q) expands it."""
    q = qt.q if q is None else q
    if qt.lut is not None or qt.kind not in ("nib4", "int8"):
        raise NotImplementedError(
            f"natural_q: {qt.ggml_type.name} ({qt.kind} with a codebook) has "
            "no integer levels; ops.qmatmul.dequantize expands it")
    if qt.kind == "int8":
        if qt.q4_layout == 2:
            return unorder_int8_rows(q, qt)
        if qt.q4_layout in (0, 4):                 # nat8 rows are natural
            return q
    elif qt.q4_layout == 3:
        return unpack_natpair(q)
    elif qt.q4_layout == 1:
        return unpack_rowpair(q, qt)
    elif qt.q4_layout == 0:
        return unpack_planes(q, qt)
    raise NotImplementedError(f"{qt.kind} layout {qt.q4_layout}")


def _check_permuted(qt: QTensor, kind: str, q4_layout: int, groups):
    _check_layout(qt, kind, q4_layout)
    bk = qt.interleaved_bk
    if qt.lut is not None or bk <= 0 or qt.k % bk or bk % 32:
        raise ValueError(f"K={qt.k} in tiles of bk={bk}: bk a multiple of "
                         "32 dividing K, no codebook")
    if qt.k // qt.scale.shape[0] not in groups or qt.k % qt.scale.shape[0]:
        raise ValueError(f"scale rows {qt.scale.shape[0]} for K={qt.k}")


def dequant_planes_bf16(qt: QTensor) -> torch.Tensor:
    """(K, N) bf16 weight rounded as the reference's plane-split kernel
    (_kernel_noround) rounds it: bf16(bf16(nib - zero) * bf16(s)), then
    + bf16(bias) rounded to bf16 again. The bias is part of the weight
    here, not an exact f32 term."""
    w = dequant_bf16(qt)
    return w if qt.bias is None else w + _expand(qt.bias, qt)


def planes_w4a16_plain(x2, qt: QTensor) -> torch.Tensor:
    """Plain version of the plane-split W4A16 kernel: x2 (M, K) -> (M, N)
    f32, bf16(x) @ w with f32 sums."""
    return x2.to(torch.bfloat16).float() @ dequant_planes_bf16(qt).float()


rowpair_w4a16_plain = int8_rows_w8a16_plain = a16_gemm_plain

# The launch shapes of csrc/permuted_gemm.cu (kept equal to its constants):
# the GEMV route up to M 8 in blocks of 64 columns, the tile route above in
# 128 x 64 output tiles walking K in steps of 64. A product whose grid has
# fewer blocks than the H100 has SMs cuts K across blocks, into at most 8
# pieces: the pieces of an output tile form one thread-block cluster, and 8
# is the portable cluster size (larger clusters co-schedule poorly when one
# block fills an SM, as the GEMV at M 8 does).
_PERMUTED_GEMV_MAX_M = 8
_PERMUTED_COLS = 64
_PERMUTED_TILE_M, _PERMUTED_TILE_K = 128, 64
_PERMUTED_MAX_SPLIT = 8


def permuted_units(layout: str, k: int, bk: int, g: int) -> int:
    """The pieces of K the GEMV route deals out: a quant block of 32 rows
    (planes), two blocks sharing their byte rows (row-pair with an even
    NB = bk / 32; one block when NB is odd), one group of g rows (int8)."""
    if layout == "planes":
        return k // 32
    if layout == "rowpair":
        return k // 64 if (bk // 32) % 2 == 0 else k // 32
    return k // g


def permuted_plan(layout: str, m: int, k: int, n: int, bk: int,
                  g: int) -> tuple[str, int]:
    """(route, split) of a permuted-layout product: "gemv" for m <= 8,
    "tile" above (the C entry takes the route from m by the same rule), and
    the number of pieces K is cut into across blocks. A grid that already
    has a block per SM is not split; a smaller one is split by the least
    divisor of its K pieces (at most 8) that gives it one, or by the
    largest such divisor."""
    cols = -(-n // _PERMUTED_COLS)
    if m <= _PERMUTED_GEMV_MAX_M:
        route, blocks = "gemv", cols
        units = permuted_units(layout, k, bk, g)
    else:
        route = "tile"
        blocks = cols * -(-m // _PERMUTED_TILE_M)
        units = -(-k // _PERMUTED_TILE_K)
    if blocks >= _SMS:
        return route, 1
    splits = [s for s in range(1, min(units, _PERMUTED_MAX_SPLIT) + 1)
              if units % s == 0]
    return route, next((s for s in splits if blocks * s >= _SMS), splits[-1])


def _permuted_gemm(name: str, layout: str, x2, qt: QTensor, plain,
                   has_xs: bool, *args):
    """Checks shared by the three permuted-layout wrappers, then the plain
    version on the CPU or the kernel's C entry `ggml_<name>` on the card,
    cut as `permuted_plan` says. args: the entry's ints between bk and
    split."""
    if x2.dim() != 2 or x2.shape[1] != qt.k:
        raise ValueError(f"{name}: x {tuple(x2.shape)} for K={qt.k}")
    if x2.device.type == "cpu":
        return plain(x2, qt)
    if qt.n % 16 or any(t.data_ptr() % 16 for t in (qt.q, qt.scale, qt.bias)
                        if t is not None):
        raise ValueError(f"{name}: N % 16 and a 16-byte aligned weight, "
                         "scale and bias required")
    m = x2.shape[0]
    g = qt.k // qt.scale.shape[0]
    route, split = permuted_plan(layout, m, qt.k, qt.n, qt.interleaved_bk, g)
    xs = None
    if route == "gemv":
        # the GEMV rounds x to bf16 as it stages it, and sums its groups
        xin = x2.float().contiguous()
    else:
        xin = x2.to(torch.bfloat16).contiguous()
        if has_xs and qt.bias is not None:
            xs = xin.float().reshape(m, qt.k // g, g).sum(-1).contiguous()
    if xin.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned in "
                         f"{str(xin.dtype)[6:]}")
    out = torch.empty(m, qt.n, dtype=torch.float32, device=x2.device)
    head = [xin.data_ptr(), qt.q.data_ptr(), qt.scale.data_ptr(),
            _build.ptr(qt.bias)] + ([_build.ptr(xs)] if has_xs else [])
    rc = getattr(_build.lib(), f"ggml_{name}")(
        *head, out.data_ptr(), m, qt.k, qt.n, qt.interleaved_bk, *args, split,
        int(qt.scale.dtype == torch.bfloat16), _build.stream_ptr(x2))
    _build.check(rc, name)
    _build.LAUNCHES[name] += 1
    return out


def planes_w4a16(x2, qt: QTensor) -> torch.Tensor:
    """W4A16 over block-interleaved plane-split nib4 (per-16 or per-32
    scales, any zero point, bias inside the bf16 weight): x2 (M, K), cast
    to bf16 -> (M, N) f32."""
    _check_permuted(qt, "nib4", 0, (16, 32))
    return _permuted_gemm("planes_w4a16", "planes", x2, qt,
                          planes_w4a16_plain, False,
                          qt.k // qt.scale.shape[0], qt.zero)


def rowpair_w4a16(x2, qt: QTensor) -> torch.Tensor:
    """W4A16 over row-pair nib4 (per-32 scales, exact f32 bias term)."""
    _check_permuted(qt, "nib4", 1, (32,))
    return _permuted_gemm("rowpair_w4a16", "rowpair", x2, qt,
                          rowpair_w4a16_plain, True)


def int8_rows_w8a16(x2, qt: QTensor) -> torch.Tensor:
    """W8A16 over u-order int8 rows (g 16 or 32, exact f32 bias term)."""
    _check_permuted(qt, "int8", 2, (16, 32))
    return _permuted_gemm("int8_rows_w8a16", "int8", x2, qt,
                          int8_rows_w8a16_plain, True,
                          qt.k // qt.scale.shape[0])


def qmatmul_permuted(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (..., K) @ a permuted-layout W -> (..., N) f32: the wrapper of its
    q4_layout at every m (the reference's qmatmul_pallas dispatch)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, qt.k)
    if qt.kind == "nib4" and qt.q4_layout == 0:
        out = planes_w4a16(x2, qt)
    elif qt.kind == "nib4" and qt.q4_layout == 1:
        out = rowpair_w4a16(x2, qt)
    elif qt.kind == "int8" and qt.q4_layout == 2:
        out = int8_rows_w8a16(x2, qt)
    else:
        raise ValueError(f"no permuted-layout kernel for {qt.kind} layout "
                         f"{qt.q4_layout}")
    return out.reshape(*lead, qt.n)
