"""Bit-exact numpy codecs for the ggml block formats the port loads (its own
copy of ggml_imax_tpu/quant/codecs.py's numpy twins: Q4_0, Q4_1, Q5_0,
Q5_1, Q8_0, Q8_1, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K and Q8_K, the F16 and
BF16 float formats, IQ4_NL and IQ4_XS, and the decoders of the codebook
formats IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S, IQ1_S and IQ1_M, whose
grids are the port's own copy of iq_grids.npz). `quantize` and
`dequantize` run the basic and K-quant block formats through the C++
loops of native/codecs.cpp; the numpy versions stay in _QUANTIZERS and
_DEQUANTIZERS as their plain versions.

The encoded bytes match ggml-common.h's block layouts, so blocks round-trip
bit for bit with GGUF files. Rounding, as in ggml's scalar C code:

- Q4_0, Q4_1, Q5_0, Q5_1: ``(int8_t)(x * id + 8.5f)`` and its kin
  truncate a non-negative operand, so they are a floor;
- Q8_0, Q8_1: C ``roundf``, round half away from zero;
- IQ4_NL, IQ4_XS: the nearest entry of the nonlinear table (ties to the
  lower index), the 6-bit sub-scales by ``nearest_int``;
- the K-quants: ggml's ``nearest_int``, round half to even;
- block scales are IEEE fp16 (round to nearest even).

All arithmetic is float32, as in the C reference; the K-quant scale
searches sum in element order (`_seqsum`), as the C loops do. Host-side
only: the results are numpy arrays that quant/device.py lays out for the
card.
"""
from __future__ import annotations

import numpy as np

from .formats import FORMATS, QK, QK_K, GGMLType

f32 = np.float32


def _roundf(x: np.ndarray) -> np.ndarray:
    """C roundf: round half away from zero."""
    return np.sign(x) * np.floor(np.abs(x) + f32(0.5))


def _nearest_int(x: np.ndarray) -> np.ndarray:
    """ggml's nearest_int: round half to even."""
    return np.rint(x).astype(np.int32)


def _fp16(x: np.ndarray) -> np.ndarray:
    """Round f32 -> fp16, the storage precision of block scales."""
    return x.astype(np.float16)


def _fp16_f32(x: np.ndarray) -> np.ndarray:
    """A scale as the decoder reads it: rounded to fp16, back in f32."""
    return x.astype(np.float16).astype(f32)


def _signed_absmax(x: np.ndarray) -> np.ndarray:
    """Per-row value with the largest magnitude (first one on ties): ggml's
    ``if (amax < fabsf(v)) { amax = |v|; max = v; }`` scan."""
    idx = np.argmax(np.abs(x), axis=-1)
    return np.take_along_axis(x, idx[..., None], axis=-1)[..., 0]


def _safe_inv(d: np.ndarray) -> np.ndarray:
    """1/d, and 0 where d == 0 (ggml's ``id = d ? 1/d : 0``)."""
    with np.errstate(divide="ignore"):
        inv = np.where(d != 0, f32(1.0) / d, f32(0.0))
    return inv.astype(f32)


# on-disk block layouts (ggml-common.h)
BLOCK_DTYPES: dict[GGMLType, np.dtype] = {
    GGMLType.Q4_0: np.dtype([("d", "<f2"), ("qs", "u1", (QK // 2,))]),
    GGMLType.Q4_1: np.dtype([("d", "<f2"), ("m", "<f2"),
                             ("qs", "u1", (QK // 2,))]),
    GGMLType.Q5_0: np.dtype([("d", "<f2"), ("qh", "<u4"),
                             ("qs", "u1", (QK // 2,))]),
    GGMLType.Q5_1: np.dtype([("d", "<f2"), ("m", "<f2"), ("qh", "<u4"),
                             ("qs", "u1", (QK // 2,))]),
    GGMLType.Q8_0: np.dtype([("d", "<f2"), ("qs", "i1", (QK,))]),
    GGMLType.Q8_1: np.dtype([("d", "<f2"), ("s", "<f2"), ("qs", "i1", (QK,))]),
    GGMLType.Q2_K: np.dtype([("scales", "u1", (QK_K // 16,)),
                             ("qs", "u1", (QK_K // 4,)),
                             ("d", "<f2"), ("dmin", "<f2")]),
    GGMLType.Q3_K: np.dtype([("hmask", "u1", (QK_K // 8,)),
                             ("qs", "u1", (QK_K // 4,)),
                             ("scales", "u1", (12,)), ("d", "<f2")]),
    GGMLType.Q4_K: np.dtype([("d", "<f2"), ("dmin", "<f2"),
                             ("scales", "u1", (12,)),
                             ("qs", "u1", (QK_K // 2,))]),
    GGMLType.Q5_K: np.dtype([("d", "<f2"), ("dmin", "<f2"),
                             ("scales", "u1", (12,)),
                             ("qh", "u1", (QK_K // 8,)),
                             ("qs", "u1", (QK_K // 2,))]),
    GGMLType.Q6_K: np.dtype([("ql", "u1", (QK_K // 2,)),
                             ("qh", "u1", (QK_K // 4,)),
                             ("scales", "i1", (QK_K // 16,)), ("d", "<f2")]),
    GGMLType.Q8_K: np.dtype([("d", "<f4"), ("qs", "i1", (QK_K,)),
                             ("bsums", "<i2", (QK_K // 16,))]),
}

def _blocks_in(x: np.ndarray, block: int) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=f32)
    if x.size % block:
        raise ValueError(f"{x.shape} is not a whole number of {block}-blocks")
    return x.reshape(-1, block)


def blocks_view(raw: np.ndarray, t: GGMLType) -> np.ndarray:
    """Encoded bytes as a structured array of blocks."""
    raw = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
    return raw.view(BLOCK_DTYPES[t])


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    xb = _blocks_in(x, QK)
    mx = _signed_absmax(xb)
    d = (mx / f32(-8.0)).astype(f32)
    idv = _safe_inv(d)
    xi = np.minimum(15, np.floor(xb * idv[:, None] + f32(8.5))
                    .astype(np.int32)).astype(np.uint8)
    out = np.zeros(len(xb), dtype=BLOCK_DTYPES[GGMLType.Q4_0])
    out["d"] = _fp16(d)
    out["qs"] = xi[:, :QK // 2] | (xi[:, QK // 2:] << 4)
    return out.view(np.uint8)


def dequantize_q4_0(raw: np.ndarray) -> np.ndarray:
    b = blocks_view(raw, GGMLType.Q4_0)
    d = b["d"].astype(f32)[:, None]
    lo = (b["qs"] & 0x0F).astype(np.int8) - 8
    hi = (b["qs"] >> 4).astype(np.int8) - 8
    return (np.concatenate([lo, hi], axis=1).astype(f32) * d).reshape(-1)


def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    """Q4_1: an fp16 scale d = (max - min) / 15 and min m a block, 4-bit
    quants floor((x - min) / d + 0.5); w = d q + m."""
    xb = _blocks_in(x, QK)
    mn = xb.min(axis=1)
    mxv = xb.max(axis=1)
    d = ((mxv - mn) / f32(15.0)).astype(f32)
    idv = _safe_inv(d)
    xi = np.minimum(15, np.floor((xb - mn[:, None]) * idv[:, None]
                                 + f32(0.5)).astype(np.int32)).astype(np.uint8)
    out = np.zeros(len(xb), dtype=BLOCK_DTYPES[GGMLType.Q4_1])
    out["d"] = _fp16(d)
    out["m"] = _fp16(mn)
    out["qs"] = xi[:, :QK // 2] | (xi[:, QK // 2:] << 4)
    return out.view(np.uint8)


def dequantize_q4_1(raw: np.ndarray) -> np.ndarray:
    b = blocks_view(raw, GGMLType.Q4_1)
    d = b["d"].astype(f32)[:, None]
    m = b["m"].astype(f32)[:, None]
    lo = (b["qs"] & 0x0F).astype(f32)
    hi = (b["qs"] >> 4).astype(f32)
    return (np.concatenate([lo, hi], axis=1) * d + m).reshape(-1)


def _pack_q5(xi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(nb, 32) values in [0, 31] -> (qs, the low four bits of elements j
    and j + 16 in byte j; qh, bit 4 of element e at bit e of a u32)."""
    lo = xi[:, :QK // 2]
    hi = xi[:, QK // 2:]
    qs = (lo & 0x0F).astype(np.uint8) | ((hi & 0x0F).astype(np.uint8) << 4)
    j = np.arange(QK // 2, dtype=np.uint32)
    qh = (((lo.astype(np.uint32) & 0x10) >> 4) << j).sum(axis=1,
                                                         dtype=np.uint32) \
        | (((hi.astype(np.uint32) & 0x10) >> 4) << (j + QK // 2)) \
        .sum(axis=1, dtype=np.uint32)
    return qs, qh


def _unpack_q5(qs: np.ndarray, qh: np.ndarray) -> np.ndarray:
    """(qs (nb, 16), qh (nb,)) -> (nb, 32) unsigned 5-bit values."""
    j = np.arange(QK // 2, dtype=np.uint32)
    xh0 = (((qh[:, None] >> j) << 4) & 0x10).astype(np.uint8)
    xh1 = ((qh[:, None] >> (j + 12)) & 0x10).astype(np.uint8)
    return np.concatenate([(qs & 0x0F) | xh0, (qs >> 4) | xh1], axis=1)


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    """Q5_0: as Q4_0 with 5-bit quants, d = max / -16."""
    xb = _blocks_in(x, QK)
    mx = _signed_absmax(xb)
    d = (mx / f32(-16.0)).astype(f32)
    idv = _safe_inv(d)
    xi = np.minimum(31, np.floor(xb * idv[:, None] + f32(16.5))
                    .astype(np.int32)).astype(np.uint8)
    qs, qh = _pack_q5(xi)
    out = np.zeros(len(xb), dtype=BLOCK_DTYPES[GGMLType.Q5_0])
    out["d"] = _fp16(d)
    out["qs"] = qs
    out["qh"] = qh
    return out.view(np.uint8)


def dequantize_q5_0(raw: np.ndarray) -> np.ndarray:
    b = blocks_view(raw, GGMLType.Q5_0)
    d = b["d"].astype(f32)[:, None]
    q = _unpack_q5(b["qs"], b["qh"]).astype(np.int32) - 16
    return (q.astype(f32) * d).reshape(-1)


def quantize_q5_1(x: np.ndarray) -> np.ndarray:
    """Q5_1: as Q4_1 with 5-bit quants, d = (max - min) / 31."""
    xb = _blocks_in(x, QK)
    mn = xb.min(axis=1)
    mxv = xb.max(axis=1)
    d = ((mxv - mn) / f32(31.0)).astype(f32)
    idv = _safe_inv(d)
    xi = np.floor((xb - mn[:, None]) * idv[:, None] + f32(0.5)) \
        .astype(np.int32).astype(np.uint8)
    qs, qh = _pack_q5(xi)
    out = np.zeros(len(xb), dtype=BLOCK_DTYPES[GGMLType.Q5_1])
    out["d"] = _fp16(d)
    out["m"] = _fp16(mn)
    out["qs"] = qs
    out["qh"] = qh
    return out.view(np.uint8)


def dequantize_q5_1(raw: np.ndarray) -> np.ndarray:
    b = blocks_view(raw, GGMLType.Q5_1)
    d = b["d"].astype(f32)[:, None]
    m = b["m"].astype(f32)[:, None]
    q = _unpack_q5(b["qs"], b["qh"]).astype(f32)
    return (q * d + m).reshape(-1)


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    xb = _blocks_in(x, QK)
    amax = np.abs(xb).max(axis=1)
    d = (amax / f32(127.0)).astype(f32)
    idv = _safe_inv(d)
    q = _roundf(xb * idv[:, None]).astype(np.int8)
    out = np.zeros(len(xb), dtype=BLOCK_DTYPES[GGMLType.Q8_0])
    out["d"] = _fp16(d)
    out["qs"] = q
    return out.view(np.uint8)


def dequantize_q8_0(raw: np.ndarray) -> np.ndarray:
    b = blocks_view(raw, GGMLType.Q8_0)
    return (b["qs"].astype(f32) * b["d"].astype(f32)[:, None]).reshape(-1)


def quantize_q8_1(x: np.ndarray) -> np.ndarray:
    """Q8_1: Q8_0's quants and scale, and s = d * sum(q) in fp16."""
    xb = _blocks_in(x, QK)
    amax = np.abs(xb).max(axis=1)
    d = (amax / f32(127.0)).astype(f32)
    idv = _safe_inv(d)
    q = _roundf(xb * idv[:, None]).astype(np.int8)
    out = np.zeros(len(xb), dtype=BLOCK_DTYPES[GGMLType.Q8_1])
    out["d"] = _fp16(d)
    out["s"] = _fp16(d * q.sum(axis=1, dtype=np.int32).astype(f32))
    out["qs"] = q
    return out.view(np.uint8)


def dequantize_q8_1(raw: np.ndarray) -> np.ndarray:
    b = blocks_view(raw, GGMLType.Q8_1)
    return (b["qs"].astype(f32) * b["d"].astype(f32)[:, None]).reshape(-1)


# ---- K-quant scale searches (ggml-quants.c make_qkx2_quants and
# make_q3_quants), vectorized over sub-blocks, element-sequential inside one

def _seqsum(a: np.ndarray) -> np.ndarray:
    """Sum over the last axis in element order, in f32: the C loops'
    sequential accumulation (numpy's pairwise sum rounds differently)."""
    out = np.zeros(a.shape[:-1], dtype=f32)
    for i in range(a.shape[-1]):
        out += a[..., i]
    return out


def _make_qkx2_quants(x, weights, nmax: int, rmin: float, rdelta: float,
                      nstep: int, use_mad: bool):
    """Weighted affine [0, nmax] quantizer with a search over the min.
    x, weights (nb, n) -> (scale, the_min, L int32)."""
    mn = np.minimum(x.min(axis=1), f32(0.0))
    mx = x.max(axis=1)
    sum_w = _seqsum(weights)
    sum_x = _seqsum(weights * x)
    flat = mx == mn
    span = np.where(flat, f32(1.0), mx - mn)         # flat rows: masked below

    iscale = (f32(nmax) / span).astype(f32)
    scale = _safe_inv(iscale)
    L = np.clip(_nearest_int(iscale[:, None] * (x - mn[:, None])), 0, nmax)
    diff = scale[:, None] * L.astype(f32) + mn[:, None] - x
    diff = np.abs(diff) if use_mad else diff * diff
    best_mad = _seqsum(weights * diff)

    cur_min = mn.copy()
    for step in range(nstep + 1):
        # each trial starts from the best min so far, as the C loop does
        cur_span = np.where(flat, f32(1.0), mx - cur_min)
        isc = (f32(rmin + rdelta * step + nmax) / cur_span).astype(f32)
        laux = np.clip(_nearest_int(isc[:, None] * (x - cur_min[:, None])),
                       0, nmax)
        lf = laux.astype(f32)
        wl = weights * lf
        sum_l = _seqsum(wl)
        sum_l2 = _seqsum(wl * lf)
        sum_xl = _seqsum(wl * x)
        D = sum_w * sum_l2 - sum_l * sum_l
        with np.errstate(divide="ignore", invalid="ignore"):
            this_scale = ((sum_w * sum_xl - sum_x * sum_l) / D).astype(f32)
            this_min = ((sum_l2 * sum_x - sum_l * sum_xl) / D).astype(f32)
            alt_scale = (sum_xl / sum_l2).astype(f32)
        pos_min = this_min > 0
        this_min = np.where(pos_min, f32(0.0), this_min)
        this_scale = np.where(pos_min, alt_scale, this_scale)
        diff = this_scale[:, None] * lf + this_min[:, None] - x
        diff = np.abs(diff) if use_mad else diff * diff
        mad = _seqsum(weights * diff)
        better = (D > 0) & (mad < best_mad)
        L = np.where(better[:, None], laux, L)
        best_mad = np.where(better, mad, best_mad)
        scale = np.where(better, this_scale, scale).astype(f32)
        cur_min = np.where(better, this_min, cur_min).astype(f32)

    scale = np.where(flat, f32(0.0), scale).astype(f32)
    L = np.where(flat[:, None], 0, L)
    the_min = np.where(flat, -mn, -cur_min).astype(f32)
    return scale, the_min, L.astype(np.int32)


def _make_qx_quants(x, nmax: int, qw=None):
    """Symmetric quantizer with a search over 19 trial scales (ggml's
    make_qx_quants, rmse_type 1). The weights are x^2, or qw (nb, n) where
    given (the imatrix quantizers). x (nb, n) -> (scale, L in
    [0, 2 nmax - 1])."""
    mx = np.take_along_axis(x, np.argmax(np.abs(x), axis=1)[:, None],
                            axis=1)[:, 0]
    dead = np.abs(mx) < f32(1e-30)
    mx_safe = np.where(dead, f32(1.0), mx)
    w = x * x if qw is None else qw

    def trial(iscale):
        l = np.clip(_nearest_int(iscale[:, None] * x), -nmax, nmax - 1)
        lf = l.astype(f32)
        return l, _seqsum(w * x * lf), _seqsum(w * lf * lf)

    L, sumlx, suml2 = trial((f32(-nmax) / mx_safe).astype(f32))
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = (sumlx / suml2).astype(f32)        # unguarded, as in C
    best = scale * sumlx
    for step in range(-9, 10):
        if step == 0:
            continue
        l, slx, sl2 = trial(-(f32(nmax) + f32(0.1) * f32(step)) / mx_safe)
        better = (sl2 > 0) & (slx * slx > best * sl2)
        L = np.where(better[:, None], l, L)
        with np.errstate(divide="ignore", invalid="ignore"):
            scale = np.where(better, slx / sl2, scale).astype(f32)
        best = np.where(better, scale * slx, best)

    scale = np.where(dead, f32(0.0), scale).astype(f32)
    L = np.where(dead[:, None], 0, L + nmax)
    return scale, L.astype(np.int32)


def _make_qp_quants(x, nmax: int, qw):
    """Non-negative [0, nmax] quantizer (ggml's make_qp_quants, the
    imatrix K-quants' super-scales): the scale with the least qw-weighted
    squared error among nmax / max and 8 trials around it, then up to 5
    passes over the elements in order, each moving one level when that
    raises sum(qw x l)^2 / sum(qw l^2). x, qw (nb, n), x >= 0 -> (scale,
    L int32)."""
    nb, n = x.shape
    mx = x.max(axis=1)
    dead = mx == 0
    mx_safe = np.where(dead, f32(1.0), mx)

    iscale = (f32(nmax) / mx_safe).astype(f32)
    L0 = _nearest_int(iscale[:, None] * x)          # the first trial: no clip
    diff = x - _safe_inv(iscale)[:, None] * L0.astype(f32)
    best_mse = _seqsum(qw * diff * diff)
    best_iscale = iscale
    for step in range(-4, 5):
        if step == 0:
            continue
        isc = ((f32(0.1) * f32(step) + f32(nmax)) / mx_safe).astype(f32)
        l = np.minimum(nmax, _nearest_int(isc[:, None] * x)).astype(f32)
        diff = x - _safe_inv(isc)[:, None] * l
        mse = _seqsum(qw * diff * diff)
        better = mse < best_mse
        best_mse = np.where(better, mse, best_mse)
        best_iscale = np.where(better, isc, best_iscale).astype(f32)

    L = np.minimum(nmax, _nearest_int(best_iscale[:, None] * x)) \
        .astype(np.int32)
    lf = L.astype(f32)
    sumlx = _seqsum(qw * x * lf)
    suml2 = _seqsum(qw * lf * lf)

    stopped = dead.copy()
    for _ in range(5):
        changed = np.zeros(nb, dtype=bool)
        for i in range(n):
            wi, xi, li = qw[:, i], x[:, i], L[:, i].astype(f32)
            slx = sumlx - wi * xi * li
            sl2 = suml2 - wi * li * li
            cond = (slx > 0) & (sl2 > 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                new_l = np.minimum(nmax, _nearest_int(
                    np.where(cond, xi * sl2 / np.where(cond, slx, 1), li)))
            nlf = new_l.astype(f32)
            slx2 = slx + wi * xi * nlf
            sl22 = sl2 + wi * nlf * nlf
            apply = (~stopped) & cond & (new_l != L[:, i]) \
                & (slx2 * slx2 * suml2 > sumlx * sumlx * sl22)
            L[:, i] = np.where(apply, new_l, L[:, i])
            sumlx = np.where(apply, slx2, sumlx)
            suml2 = np.where(apply, sl22, suml2)
            changed |= apply
        stopped |= ~changed
        if stopped.all():
            break

    with np.errstate(divide="ignore", invalid="ignore"):
        scale = (sumlx / suml2).astype(f32)
    scale = np.where(dead, f32(0.0), scale).astype(f32)
    return scale, np.where(dead[:, None], 0, L)


def _make_q3_quants(x, nmax: int):
    """Symmetric quantizer with ggml's rmse refinement (do_rmse): up to 5
    passes over the elements in order, each moving one level when that
    improves sum(w x l)^2 / sum(w l^2). x (nb, n) -> (scale, L in
    [0, 2 nmax - 1])."""
    nb, n = x.shape
    mx = np.take_along_axis(x, np.argmax(np.abs(x), axis=1)[:, None],
                            axis=1)[:, 0]
    dead = mx == 0
    iscale = (f32(-nmax) / np.where(dead, f32(1.0), mx)).astype(f32)
    L = np.clip(_nearest_int(iscale[:, None] * x), -nmax, nmax - 1) \
        .astype(np.int32)
    w = x * x
    sumlx = _seqsum(w * x * L.astype(f32))
    suml2 = _seqsum(w * L.astype(f32) * L.astype(f32))

    stopped = np.zeros(nb, dtype=bool)
    for _ in range(5):
        changed = np.zeros(nb, dtype=bool)
        for i in range(n):
            wi, xi, li = w[:, i], x[:, i], L[:, i].astype(f32)
            slx = sumlx - wi * xi * li
            sl2 = suml2 - wi * li * li
            with np.errstate(divide="ignore", invalid="ignore"):
                new_l = np.clip(_nearest_int(np.where(slx > 0, xi * sl2 / slx,
                                                      li)), -nmax, nmax - 1)
            nlf = new_l.astype(f32)
            slx2 = slx + wi * xi * nlf
            sl22 = sl2 + wi * nlf * nlf
            # compared in f32 as the C floats are: where both sides overflow
            # to inf the test is false there too
            with np.errstate(over="ignore"):
                better = slx2 * slx2 * suml2 > sumlx * sumlx * sl22
            apply = (~stopped) & (slx > 0) & (new_l != L[:, i]) \
                & (sl22 > 0) & better
            L[:, i] = np.where(apply, new_l, L[:, i])
            sumlx = np.where(apply, slx2, sumlx)
            suml2 = np.where(apply, sl22, suml2)
            changed |= apply
        stopped |= ~changed
        if stopped.all():
            break

    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(suml2 > 0, sumlx / suml2, f32(0.0)).astype(f32)
    scale = np.where(dead, f32(0.0), scale).astype(f32)
    L = np.where(dead[:, None], 0, L + nmax)
    return scale, L.astype(np.int32)


def _pack_q3k_scales(l6: np.ndarray) -> np.ndarray:
    """16 six-bit scales (nb, 16) in [0, 64) -> the 12-byte q3_K field: low
    nibbles of scales j and j + 8 in byte j, the top two bits of scale j at
    bit 2 (j // 4) of byte 8 + j % 4."""
    sc = np.zeros((len(l6), 12), dtype=np.uint8)
    lo = (l6 & 0xF).astype(np.uint8)
    hi = (l6 >> 4).astype(np.uint8)
    sc[:, 0:8] = lo[:, 0:8] | (lo[:, 8:16] << 4)
    for j in range(16):
        sc[:, 8 + j % 4] |= hi[:, j] << (2 * (j // 4))
    return sc


def _unpack_q3k_scales(sc: np.ndarray) -> np.ndarray:
    """The 12-byte q3_K field -> (nb, 16) int32 scales in [-32, 31]."""
    lo = np.concatenate([sc[:, 0:8] & 0xF, sc[:, 0:8] >> 4],
                        axis=1).astype(np.int32)
    j = np.arange(16)
    hi = ((sc[:, 8 + j % 4] >> (2 * (j // 4))[None, :]) & 3).astype(np.int32)
    return (lo | (hi << 4)) - 32


# element e of a 256-super-block -> its byte and shift in the 2-bit quants
# (q2_K and q3_K: 32 bytes per 128-half, four 2-bit planes each) and its
# byte and bit in the q3_K high-bit mask
_E = np.arange(QK_K)
_Q2_BYTE = (_E % 32) + 32 * (_E // 128)
_Q2_SHIFT = 2 * ((_E % 128) // 32)
_Q3_HBYTE = _E % 32
_Q3_HBIT = _E // 32
# q4_K: 32 bytes per 64-element chunk, the chunk's first 32 elements in the
# low nibbles, the next 32 in the high ones
_Q4K_BYTE = (_E % 32) + 32 * (_E // 64)
_Q4K_SHIFT = 4 * ((_E % 64) // 32)
# q5_K: the fifth bit of element e at bit e // 32 of byte e % 32 of qh
_Q5K_HBIT = _E // 32
# q6_K: per 128-half, the low nibbles of four 32-element groups in 64
# bytes (groups 0, 1 low, 2, 3 high) and their top two bits in 32 bytes
_Q6_H = _E // 128
_Q6_L = _E % 128
_Q6_G = _Q6_L // 32
_Q6_QL_BYTE = 64 * _Q6_H + (_Q6_L % 32) + 32 * (_Q6_G % 2)
_Q6_QL_SHIFT = 4 * (_Q6_G // 2)
_Q6_QH_BYTE = 32 * _Q6_H + (_Q6_L % 32)
_Q6_QH_SHIFT = 2 * _Q6_G


def _pack_2bit_fast(L: np.ndarray) -> np.ndarray:
    """(nb, 256) values in [0, 3] -> (nb, 64) bytes, one plane per shift."""
    Lu = L.astype(np.uint8)
    qs = np.zeros((len(L), QK_K // 4), dtype=np.uint8)
    for shift in (0, 2, 4, 6):
        sel = _Q2_SHIFT == shift
        qs[:, _Q2_BYTE[sel]] |= Lu[:, sel] << shift
    return qs


def quantize_q2_K(x: np.ndarray) -> np.ndarray:
    """Q2_K: 16 sub-blocks of 16 with a 4-bit scale and a 4-bit min each,
    under fp16 super-scales d and dmin; 2-bit quants, w = d sc q - dmin m."""
    xb = _blocks_in(x, QK_K)
    nb = len(xb)
    sub = xb.reshape(nb * 16, 16)
    scales, mins, L = _make_qkx2_quants(sub, np.abs(sub), 3, -0.5, 0.1, 15,
                                        True)
    scales, mins = scales.reshape(nb, 16), mins.reshape(nb, 16)
    L = L.reshape(nb, QK_K)

    q4scale = f32(15.0)
    max_scale, max_min = scales.max(axis=1), mins.max(axis=1)
    pos = max_scale > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        isc = np.where(pos, q4scale / max_scale, f32(0.0)).astype(f32)
    sc4 = np.where(pos[:, None], _nearest_int(isc[:, None] * scales), 0) \
        .astype(np.uint8)
    d = np.where(pos, max_scale / q4scale, f32(0.0)).astype(f32)
    posm = max_min > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        iscm = np.where(posm, q4scale / max_min, f32(0.0)).astype(f32)
    mn4 = np.where(posm[:, None], _nearest_int(iscm[:, None] * mins), 0) \
        .astype(np.uint8)
    dmin = np.where(posm, max_min / q4scale, f32(0.0)).astype(f32)

    # quantize again against the stored (fp16-rounded) scales
    dl_e = np.repeat(_fp16_f32(d)[:, None] * sc4.astype(f32), 16, axis=1)
    ml_e = np.repeat(_fp16_f32(dmin)[:, None] * mn4.astype(f32), 16, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        l_new = np.clip(_nearest_int((xb + ml_e) / dl_e), 0, 3)
    L = np.where(dl_e != 0, l_new, L)

    out = np.zeros(nb, dtype=BLOCK_DTYPES[GGMLType.Q2_K])
    out["scales"] = sc4 | (mn4 << 4)
    out["qs"] = _pack_2bit_fast(L)
    out["d"] = _fp16(d)
    out["dmin"] = _fp16(dmin)
    return out.view(np.uint8)


def dequantize_q2_K(raw: np.ndarray) -> np.ndarray:
    b = blocks_view(raw, GGMLType.Q2_K)
    d = b["d"].astype(f32)[:, None]
    dmin = b["dmin"].astype(f32)[:, None]
    sc = b["scales"][:, _E // 16]                     # (nb, 256)
    q = ((b["qs"][:, _Q2_BYTE] >> _Q2_SHIFT) & 3).astype(f32)
    return (d * (sc & 0xF).astype(f32) * q
            - dmin * (sc >> 4).astype(f32)).reshape(-1)


def quantize_q3_K(x: np.ndarray) -> np.ndarray:
    """Q3_K: 16 sub-blocks of 16 with a signed 6-bit scale each under an
    fp16 super-scale d; 3-bit quants q - 4 split into 2-bit planes and a
    high-bit mask (bit set: no -4)."""
    xb = _blocks_in(x, QK_K)
    nb = len(xb)
    scales, L = _make_q3_quants(xb.reshape(nb * 16, 16), 4)
    scales = scales.reshape(nb, 16)
    L = L.reshape(nb, QK_K)                           # in [0, 7]

    max_scale = np.take_along_axis(
        scales, np.argmax(np.abs(scales), axis=1)[:, None], axis=1)[:, 0]
    nonzero = max_scale != 0
    iscale = f32(-32.0) / np.where(nonzero, max_scale, f32(1.0))
    l6 = np.clip(_nearest_int(iscale[:, None] * scales), -32, 31) + 32
    l6 = np.where(nonzero[:, None], l6, 0)
    packed = _pack_q3k_scales(l6)
    d = np.where(nonzero, _safe_inv(iscale), f32(0.0)).astype(f32)

    # quantize again against the stored 6-bit scales
    dl_e = np.repeat(_fp16_f32(d)[:, None]
                     * _unpack_q3k_scales(packed).astype(f32), 16, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        l_new = np.clip(_nearest_int(xb / dl_e), -4, 3) + 4
    L = np.where(dl_e != 0, l_new, L)

    hibit = L > 3
    hmask = np.zeros((nb, QK_K // 8), dtype=np.uint8)
    for bit in range(8):
        sel = _Q3_HBIT == bit
        hmask[:, _Q3_HBYTE[sel]] |= hibit[:, sel].astype(np.uint8) << bit

    out = np.zeros(nb, dtype=BLOCK_DTYPES[GGMLType.Q3_K])
    out["hmask"] = hmask
    out["qs"] = _pack_2bit_fast(np.where(hibit, L - 4, L))
    out["scales"] = packed
    out["d"] = _fp16(d)
    return out.view(np.uint8)


def q3k_levels(b: np.ndarray) -> np.ndarray:
    """Structured Q3_K blocks -> (..., 256) int32 levels in [-4, 3]."""
    q = ((b["qs"][..., _Q2_BYTE] >> _Q2_SHIFT) & 3).astype(np.int32)
    hset = (b["hmask"][..., _Q3_HBYTE] >> _Q3_HBIT) & 1
    return q - np.where(hset == 1, 0, 4)


def dequantize_q3_K(raw: np.ndarray) -> np.ndarray:
    b = blocks_view(raw, GGMLType.Q3_K)
    d = b["d"].astype(f32)[:, None]
    dl = (d * _unpack_q3k_scales(b["scales"]).astype(f32))[:, _E // 16]
    return (dl * q3k_levels(b).astype(f32)).reshape(-1)


def _pack_scale_min_k4(ls: np.ndarray, lm: np.ndarray) -> np.ndarray:
    """8 six-bit (scale, min) pairs (nb, 8) -> the 12-byte q4_K field:
    bytes 0-3 scales 0-3, bytes 4-7 mins 0-3 (each with the top two bits of
    scale or min j + 4 in bits 6-7), bytes 8-11 the low nibbles of scale
    and min j + 4 (ggml-quants.c get_scale_min_k4, inverted)."""
    sc = np.zeros((len(ls), 12), dtype=np.uint8)
    sc[:, 0:4] = ls[:, 0:4] | ((ls[:, 4:8] >> 4) << 6)
    sc[:, 4:8] = lm[:, 0:4] | ((lm[:, 4:8] >> 4) << 6)
    sc[:, 8:12] = (ls[:, 4:8] & 0xF) | ((lm[:, 4:8] & 0xF) << 4)
    return sc


def _unpack_scale_min_k4(sc: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The 12-byte q4_K field (..., 12) -> (scales, mins), (..., 8) uint8
    in [0, 64)."""
    d6 = np.empty(sc.shape[:-1] + (8,), dtype=np.uint8)
    m6 = np.empty_like(d6)
    d6[..., 0:4] = sc[..., 0:4] & 63
    m6[..., 0:4] = sc[..., 4:8] & 63
    d6[..., 4:8] = (sc[..., 8:12] & 0xF) | ((sc[..., 0:4] >> 6) << 4)
    m6[..., 4:8] = (sc[..., 8:12] >> 4) | ((sc[..., 4:8] >> 6) << 4)
    return d6, m6


def _pack_4bit_k(L: np.ndarray) -> np.ndarray:
    """(nb, 256) values in [0, 15] -> (nb, 128) bytes of the q4_K layout."""
    Lu = L.astype(np.uint8)
    qs = np.zeros((len(L), QK_K // 2), dtype=np.uint8)
    for shift in (0, 4):
        sel = _Q4K_SHIFT == shift
        qs[:, _Q4K_BYTE[sel]] |= Lu[:, sel] << shift
    return qs


def _qkx_scales_for_k45(xb: np.ndarray, nmax: int, rmin: float, nstep: int):
    """The affine search of each 32-element sub-block, weighted by
    sqrt(mean x^2) + |x| (ggml-quants.c quantize_row_q4_K_ref). xb (nb, 256)
    -> scales (nb, 8), mins (nb, 8) and levels (nb, 256)."""
    nb = len(xb)
    xs = xb.reshape(nb * 8, 32)
    # numpy's own sum, as the JAX package's numpy twin computes it
    av_x = np.sqrt((xs * xs).sum(axis=1) / f32(32.0)).astype(f32)
    weights = av_x[:, None] + np.abs(xs)
    scales, mins, L = _make_qkx2_quants(xs, weights, nmax, rmin, 0.1, nstep,
                                        False)
    return scales.reshape(nb, 8), mins.reshape(nb, 8), L.reshape(nb, QK_K)


def _k45_store_scales(scales, mins):
    """6-bit sub-block scales and mins against super-scales d = max/63 and
    dmin = max/63. The + 0.0 turns a -0.0 maximum into +0.0, as the C scan
    (``if (v > max)`` from 0.0f) never adopts -0.0. Returns (the 12-byte
    field, d, dmin)."""
    max_scale = scales.max(axis=1) + f32(0.0)
    max_min = mins.max(axis=1) + f32(0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_scale = np.where(max_scale > 0, f32(63.0) / max_scale,
                             f32(0.0)).astype(f32)
        inv_min = np.where(max_min > 0, f32(63.0) / max_min,
                           f32(0.0)).astype(f32)
    ls = np.minimum(63, _nearest_int(inv_scale[:, None] * scales)) \
        .astype(np.uint8)
    lm = np.minimum(63, _nearest_int(inv_min[:, None] * mins)) \
        .astype(np.uint8)
    return (_pack_scale_min_k4(ls, lm), (max_scale / f32(63.0)).astype(f32),
            (max_min / f32(63.0)).astype(f32))


def quantize_q4_K(x: np.ndarray) -> np.ndarray:
    """Q4_K: 8 sub-blocks of 32 with a 6-bit scale and a 6-bit min each,
    under fp16 super-scales d and dmin; 4-bit quants, w = d sc q - dmin m."""
    xb = _blocks_in(x, QK_K)
    nb = len(xb)
    scales, mins, L = _qkx_scales_for_k45(xb, 15, -1.0, 20)
    packed, d, dmin = _k45_store_scales(scales, mins)

    # quantize again against the stored scales and mins
    d6, m6 = _unpack_scale_min_k4(packed)
    dl = np.repeat(_fp16_f32(d)[:, None] * d6.astype(f32), 32, axis=1)
    ml = np.repeat(_fp16_f32(dmin)[:, None] * m6.astype(f32), 32, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        l_new = np.clip(_nearest_int((xb + ml) / dl), 0, 15)
    L = np.where(dl != 0, l_new, L)

    out = np.zeros(nb, dtype=BLOCK_DTYPES[GGMLType.Q4_K])
    out["d"] = _fp16(d)
    out["dmin"] = _fp16(dmin)
    out["scales"] = packed
    out["qs"] = _pack_4bit_k(L)
    return out.view(np.uint8)


def q4k_levels(b: np.ndarray) -> np.ndarray:
    """Structured Q4_K blocks -> (..., 256) uint8 levels in [0, 15]."""
    return (b["qs"][..., _Q4K_BYTE] >> _Q4K_SHIFT) & 0xF


def dequantize_q4_K(raw: np.ndarray) -> np.ndarray:
    b = blocks_view(raw, GGMLType.Q4_K)
    d6, m6 = _unpack_scale_min_k4(b["scales"])
    dl = (b["d"].astype(f32)[:, None] * d6.astype(f32))[:, _E // 32]
    ml = (b["dmin"].astype(f32)[:, None] * m6.astype(f32))[:, _E // 32]
    return (dl * q4k_levels(b).astype(f32) - ml).reshape(-1)


def quantize_q5_K(x: np.ndarray) -> np.ndarray:
    """Q5_K: Q4_K's sub-blocks, scales and mins with 5-bit quants, the fifth
    bit in qh."""
    xb = _blocks_in(x, QK_K)
    nb = len(xb)
    scales, mins, L = _qkx_scales_for_k45(xb, 31, -0.5, 15)
    packed, d, dmin = _k45_store_scales(scales, mins)

    # quantize again against the stored scales and mins
    d6, m6 = _unpack_scale_min_k4(packed)
    dl = np.repeat(_fp16_f32(d)[:, None] * d6.astype(f32), 32, axis=1)
    ml = np.repeat(_fp16_f32(dmin)[:, None] * m6.astype(f32), 32, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        l_new = np.clip(_nearest_int((xb + ml) / dl), 0, 31)
    L = np.where(dl != 0, l_new, L)

    hibit = L > 15
    qh = np.zeros((nb, QK_K // 8), dtype=np.uint8)
    for bit in range(8):
        sel = _Q5K_HBIT == bit
        qh[:, (_E % 32)[sel]] |= hibit[:, sel].astype(np.uint8) << bit

    out = np.zeros(nb, dtype=BLOCK_DTYPES[GGMLType.Q5_K])
    out["d"] = _fp16(d)
    out["dmin"] = _fp16(dmin)
    out["scales"] = packed
    out["qh"] = qh
    out["qs"] = _pack_4bit_k(np.where(hibit, L - 16, L))
    return out.view(np.uint8)


def q5k_levels(b: np.ndarray) -> np.ndarray:
    """Structured Q5_K blocks -> (..., 256) int16 levels in [0, 31]."""
    hb = (b["qh"][..., _E % 32] >> _Q5K_HBIT) & 1
    return q4k_levels(b).astype(np.int16) + 16 * hb.astype(np.int16)


def dequantize_q5_K(raw: np.ndarray) -> np.ndarray:
    b = blocks_view(raw, GGMLType.Q5_K)
    d6, m6 = _unpack_scale_min_k4(b["scales"])
    dl = (b["d"].astype(f32)[:, None] * d6.astype(f32))[:, _E // 32]
    ml = (b["dmin"].astype(f32)[:, None] * m6.astype(f32))[:, _E // 32]
    return (dl * q5k_levels(b).astype(f32) - ml).reshape(-1)


def quantize_q6_K(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """Q6_K: 16 sub-blocks of 16 with an int8 scale each under an fp16
    super-scale d; 6-bit quants q + 32 split into low nibbles and high
    2-bit pairs, w = d sc q. qw (as many entries as x) makes the
    sub-block search imatrix-weighted: quantize_row_q6_K_impl takes the
    importance entries as the weights themselves (no sigma2 mixing)."""
    xb = _blocks_in(x, QK_K)
    nb = len(xb)
    scales, L = _make_qx_quants(
        xb.reshape(nb * 16, 16), 32,
        None if qw is None else np.ascontiguousarray(qw, f32)
        .reshape(nb * 16, 16))
    scales = scales.reshape(nb, 16)
    L = L.reshape(nb, QK_K)                           # in [0, 63]

    # the C scan (``if (fabsf(scale) > max_abs_scale)``) skips NaN scales
    # (0 / 0 from sub-block sums that underflow); an all-NaN block is zero
    scan = np.where(np.isnan(scales), f32(0.0), scales)
    max_scale = np.take_along_axis(
        scan, np.argmax(np.abs(scan), axis=1)[:, None], axis=1)[:, 0]
    nonzero = np.abs(scan).max(axis=1) != 0
    iscale = f32(-128.0) / np.where(nonzero, max_scale, f32(1.0))
    d = np.where(nonzero, _safe_inv(iscale), f32(0.0)).astype(f32)
    sc8 = np.minimum(127, _nearest_int(iscale[:, None] * scales)) \
        .astype(np.int8)
    sc8 = np.where(nonzero[:, None], sc8, 0)

    # quantize again against the stored scales
    dl_e = np.repeat(_fp16_f32(d)[:, None] * sc8.astype(f32), 16, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        l_new = np.clip(_nearest_int(xb / dl_e), -32, 31) + 32
    L = np.where(dl_e != 0, l_new, L)
    L = np.where(nonzero[:, None], L, 0)

    ql = np.zeros((nb, QK_K // 2), dtype=np.uint8)
    qh = np.zeros((nb, QK_K // 4), dtype=np.uint8)
    lo, hi = (L & 0xF).astype(np.uint8), (L >> 4).astype(np.uint8)
    for shift in (0, 4):
        sel = _Q6_QL_SHIFT == shift
        ql[:, _Q6_QL_BYTE[sel]] |= lo[:, sel] << shift
    for shift in (0, 2, 4, 6):
        sel = _Q6_QH_SHIFT == shift
        qh[:, _Q6_QH_BYTE[sel]] |= hi[:, sel] << shift

    out = np.zeros(nb, dtype=BLOCK_DTYPES[GGMLType.Q6_K])
    out["ql"] = ql
    out["qh"] = qh
    out["scales"] = sc8
    out["d"] = _fp16(d)
    return out.view(np.uint8)


def q6k_levels(b: np.ndarray) -> np.ndarray:
    """Structured Q6_K blocks -> (..., 256) int16 levels in [-32, 31]."""
    lo = (b["ql"][..., _Q6_QL_BYTE] >> _Q6_QL_SHIFT) & 0xF
    hi = (b["qh"][..., _Q6_QH_BYTE] >> _Q6_QH_SHIFT) & 3
    return (lo.astype(np.int16) | (hi.astype(np.int16) << 4)) - 32


def dequantize_q6_K(raw: np.ndarray) -> np.ndarray:
    b = blocks_view(raw, GGMLType.Q6_K)
    d = b["d"].astype(f32)[:, None]
    sc = b["scales"].astype(f32)[:, _E // 16]
    return (d * sc * q6k_levels(b).astype(f32)).reshape(-1)


def quantize_q8_K(x: np.ndarray) -> np.ndarray:
    """Q8_K, the K-quants' activation format: an f32 scale d = max / -127 a
    256-block, int8 quants and their sums over each 16."""
    xb = _blocks_in(x, QK_K)
    nb = len(xb)
    mx = _signed_absmax(xb)
    dead = np.abs(mx) == 0
    iscale = f32(-127.0) / np.where(dead, f32(1.0), mx)
    q = np.minimum(127, _nearest_int(iscale[:, None] * xb)).astype(np.int8)
    q = np.where(dead[:, None], 0, q)
    out = np.zeros(nb, dtype=BLOCK_DTYPES[GGMLType.Q8_K])
    out["d"] = np.where(dead, f32(0.0), _safe_inv(iscale))
    out["qs"] = q
    out["bsums"] = q.reshape(nb, 16, 16).sum(axis=2, dtype=np.int32) \
        .astype(np.int16)
    return out.view(np.uint8)


def dequantize_q8_K(raw: np.ndarray) -> np.ndarray:
    b = blocks_view(raw, GGMLType.Q8_K)
    return (b["qs"].astype(f32) * b["d"][:, None]).reshape(-1)


_QUANTIZERS = {GGMLType.Q4_0: quantize_q4_0, GGMLType.Q4_1: quantize_q4_1,
               GGMLType.Q5_0: quantize_q5_0, GGMLType.Q5_1: quantize_q5_1,
               GGMLType.Q8_0: quantize_q8_0, GGMLType.Q8_1: quantize_q8_1,
               GGMLType.Q2_K: quantize_q2_K, GGMLType.Q3_K: quantize_q3_K,
               GGMLType.Q4_K: quantize_q4_K, GGMLType.Q5_K: quantize_q5_K,
               GGMLType.Q6_K: quantize_q6_K, GGMLType.Q8_K: quantize_q8_K}
_DEQUANTIZERS = {GGMLType.Q4_0: dequantize_q4_0,
                 GGMLType.Q4_1: dequantize_q4_1,
                 GGMLType.Q5_0: dequantize_q5_0,
                 GGMLType.Q5_1: dequantize_q5_1,
                 GGMLType.Q8_0: dequantize_q8_0,
                 GGMLType.Q8_1: dequantize_q8_1,
                 GGMLType.Q2_K: dequantize_q2_K,
                 GGMLType.Q3_K: dequantize_q3_K,
                 GGMLType.Q4_K: dequantize_q4_K,
                 GGMLType.Q5_K: dequantize_q5_K,
                 GGMLType.Q6_K: dequantize_q6_K,
                 GGMLType.Q8_K: dequantize_q8_K}


# ---------------------------------------------------------------------------
# IQ4_NL: ggml's nonlinear 4-bit table in blocks of 32 (ggml-common.h
# block_iq4_nl; quantize_row_iq4_nl_impl with ntry 7, the path model files
# are written by)
# ---------------------------------------------------------------------------

KVALUES_IQ4NL = np.asarray([-127, -104, -83, -65, -49, -35, -22, -10,
                            1, 13, 25, 38, 53, 69, 89, 113], dtype=np.int8)

BLOCK_DTYPES[GGMLType.IQ4_NL] = np.dtype([("d", "<f2"),
                                          ("qs", "u1", (QK // 2,))])
BLOCK_DTYPES[GGMLType.IQ4_XS] = np.dtype(
    [("d", "<f2"), ("scales_h", "<u2"), ("scales_l", "u1", (QK_K // 64,)),
     ("qs", "u1", (QK_K // 2,))])


def _best_index_iq4nl(x: np.ndarray) -> np.ndarray:
    """ggml's best_index_int8: the nearest entry of the sorted table, ties
    to the lower index."""
    vals = KVALUES_IQ4NL.astype(f32)
    mu = np.clip(np.searchsorted(vals, x, side="left").astype(np.int32),
                 1, 15)
    idx = np.where((x - vals[mu - 1]) < (vals[mu] - x), mu - 1, mu)
    idx = np.where(x <= vals[0], 0, idx)
    return np.where(x >= vals[15], 15, idx).astype(np.uint8)


def _iq4_block_scale(xb: np.ndarray, ntry: int = 7,
                     w: np.ndarray | None = None) -> np.ndarray:
    """The per-32 scale search of quantize_row_iq4_nl_impl over blocks xb
    (nb, 32), weights x^2 or w (nb, 32) where given (the imatrix path): the
    first guess -max / -127, then 2 ntry + 1 trial inverse scales, each
    kept when it raises sumqx^2 / sumq2. Dead (all-zero) blocks get 0."""
    vals = KVALUES_IQ4NL.astype(f32)
    if w is None:
        w = xb * xb
    mx = _signed_absmax(xb)
    dead = mx == 0
    mx_safe = np.where(dead, f32(1.0), mx)

    def score(idv):
        q = vals[_best_index_iq4nl(idv[:, None] * xb)]
        return _seqsum(w * q * xb), _seqsum(w * q * q)

    sumqx, sumq2 = score((f32(1.0) / (-mx_safe / vals[0]).astype(f32))
                         .astype(f32))
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.where(sumq2 > 0, sumqx / sumq2, f32(0.0)).astype(f32)
    best = d * sumqx
    for itry in range(-ntry, ntry + 1):
        sqx, sq2 = score(((f32(itry) + vals[0]) / mx_safe).astype(f32))
        better = (sq2 > 0) & (sqx * sqx > best * sq2)
        with np.errstate(divide="ignore", invalid="ignore"):
            d = np.where(better, sqx / sq2, d).astype(f32)
        best = np.where(better, d * sqx, best)
    return np.where(dead, f32(0.0), d)


def quantize_iq4_nl(x: np.ndarray, ntry: int = 7,
                    qw: np.ndarray | None = None) -> np.ndarray:
    """ntry 7, the path model files are written by (quantize_iq4_nl): one
    scale per 32 (the search above), then every element re-indexed against
    the chosen f32 scale. ntry <= 0: quantize_row_iq4_nl_reference, the
    first guess alone and no re-index; as in the C code an all-zero block
    stores d = 0 and the previous block's indices (its stale scratch), the
    first block zeros. qw (as many entries as x) weights the search by
    qw sqrt(sigma2 + x^2), sigma2 = 2 mean(x^2) over the block (the
    imatrix path of quantize_row_iq4_nl_impl)."""
    xb = _blocks_in(x, QK)
    nb = len(xb)
    w = None
    if qw is not None:
        qwb = np.ascontiguousarray(qw, f32).reshape(nb, QK)
        sigma2 = (f32(2.0) / f32(QK) * _seqsum(xb * xb)).astype(f32)
        w = (qwb * np.sqrt(sigma2[:, None] + xb * xb)).astype(f32)
    if ntry > 0:
        d = _iq4_block_scale(xb, ntry, w)
        L = _best_index_iq4nl(_safe_inv(d)[:, None] * xb)
    else:
        vals = KVALUES_IQ4NL.astype(f32)
        w = xb * xb if w is None else w
        mx = _signed_absmax(xb)
        dead = mx == 0
        d0 = (np.where(dead, f32(1.0), mx) / vals[0]).astype(f32)
        L = _best_index_iq4nl((f32(1.0) / d0).astype(f32)[:, None] * xb)
        q = vals[L]
        sumqx, sumq2 = _seqsum(w * q * xb), _seqsum(w * q * q)
        with np.errstate(divide="ignore", invalid="ignore"):
            d = np.where(sumq2 > 0, sumqx / sumq2, f32(0.0)).astype(f32)
        d = np.where(dead, f32(0.0), d)
        for i in np.nonzero(dead)[0]:
            L[i] = L[i - 1] if i > 0 else 0
    out = np.zeros(nb, dtype=BLOCK_DTYPES[GGMLType.IQ4_NL])
    out["d"] = _fp16(d)
    out["qs"] = L[:, :QK // 2] | (L[:, QK // 2:] << 4)
    return out.view(np.uint8)


def dequantize_iq4_nl(raw: np.ndarray) -> np.ndarray:
    b = blocks_view(raw, GGMLType.IQ4_NL)
    vals = KVALUES_IQ4NL.astype(f32)
    q = np.concatenate([vals[(b["qs"] & 0x0F).astype(np.int32)],
                        vals[(b["qs"] >> 4).astype(np.int32)]], axis=1)
    return (q * b["d"].astype(f32)[:, None]).reshape(-1)


def iq4xs_scales(b: np.ndarray) -> np.ndarray:
    """IQ4_XS blocks (..., ) -> the signed 6-bit sub-scales (..., 8) int32:
    the low nibbles of scales_l are the even sub-blocks' and the high
    nibbles the odd ones', so they interleave back to block order; two
    bits each of scales_h are the high parts; minus 32."""
    sl = b["scales_l"]
    lo6 = np.concatenate([sl & 0xF, sl >> 4], axis=-1)
    lo6 = lo6.reshape(*sl.shape[:-1], 2, 4)
    lo6 = np.swapaxes(lo6, -1, -2).reshape(*sl.shape[:-1], 8)
    hi6 = (b["scales_h"][..., None].astype(np.uint32)
           >> (2 * np.arange(8, dtype=np.uint32))) & 3
    return (lo6.astype(np.int32) | (hi6.astype(np.int32) << 4)) - 32


def quantize_iq4_xs(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """Per-32 scales by the IQ4_NL search, a super-block scale d = -max /
    32 over the 8 of them, 6-bit sub-scales nearest_int(s / d) in [-32,
    31], then every element re-indexed against d * l6 in f32 (the
    reference uses the f32 d there, not its fp16 rounding). qw (as many
    entries as x) weights the search by qw sqrt(sigma2 + x^2), sigma2 =
    2 mean(x^2) over the 256-super-block (the imatrix path)."""
    xb = _blocks_in(x, QK_K)
    nb = len(xb)
    w = None
    if qw is not None:
        qwb = np.ascontiguousarray(qw, f32).reshape(nb, QK_K)
        sigma2 = (f32(2.0) / f32(QK_K) * _seqsum(xb * xb)).astype(f32)
        w = (qwb * np.sqrt(sigma2[:, None] + xb * xb)).astype(f32) \
            .reshape(nb * 8, 32)
    scales = _iq4_block_scale(xb.reshape(nb * 8, 32), w=w).reshape(nb, 8)
    max_scale = _signed_absmax(scales)
    d = (-max_scale / f32(32.0)).astype(f32)
    l6 = np.clip(_nearest_int(_safe_inv(d)[:, None] * scales), -32, 31)
    dl = d[:, None] * l6.astype(f32)
    with np.errstate(divide="ignore"):
        idl = np.where(dl != 0, f32(1.0) / dl, f32(0.0)).astype(f32)
    L = _best_index_iq4nl(np.repeat(idl, 32, axis=1) * xb)
    l6s = (l6 + 32).astype(np.uint32)
    lo, hi = (l6s & 0xF).astype(np.uint8), l6s >> 4
    out = np.zeros(nb, dtype=BLOCK_DTYPES[GGMLType.IQ4_XS])
    out["d"] = _fp16(d)
    out["scales_h"] = (hi << (2 * np.arange(8, dtype=np.uint32))) \
        .sum(axis=1, dtype=np.uint32).astype(np.uint16)
    out["scales_l"] = lo[:, 0::2] | (lo[:, 1::2] << 4)
    Lg = L.reshape(nb, 8, 2, 16)
    out["qs"] = (Lg[:, :, 0] | (Lg[:, :, 1] << 4)).reshape(nb, QK_K // 2)
    return out.view(np.uint8)


def dequantize_iq4_xs(raw: np.ndarray) -> np.ndarray:
    b = blocks_view(raw, GGMLType.IQ4_XS)
    vals = KVALUES_IQ4NL.astype(f32)
    dl = b["d"].astype(f32)[:, None] * iq4xs_scales(b).astype(f32)
    g = b["qs"].reshape(-1, 8, 16)
    q = np.concatenate([vals[(g & 0xF).astype(np.int32)],
                        vals[(g >> 4).astype(np.int32)]], axis=2)
    return (dl[:, :, None] * q).reshape(-1)


_QUANTIZERS[GGMLType.IQ4_NL] = quantize_iq4_nl
_QUANTIZERS[GGMLType.IQ4_XS] = quantize_iq4_xs
_DEQUANTIZERS[GGMLType.IQ4_NL] = dequantize_iq4_nl
_DEQUANTIZERS[GGMLType.IQ4_XS] = dequantize_iq4_xs


# ---------------------------------------------------------------------------
# The codebook formats' decoders: IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS, IQ3_S,
# IQ1_S and IQ1_M (ggml-common.h's blocks; the reference's dequantize_row_*
# loops; their encoders are quant/iq_encode.py's, not codecs.quantize's). The grids are the formats' constant tables, shipped as
# iq_grids.npz beside this module; the signs of IQ2_XXS, IQ2_XS and IQ3_XXS
# come from ksigns_iq2xs (7 sign bits and an odd-parity bit).
# ---------------------------------------------------------------------------

BLOCK_DTYPES[GGMLType.IQ2_XXS] = np.dtype([("d", "<f2"),
                                           ("qs", "<u2", (QK_K // 8,))])
BLOCK_DTYPES[GGMLType.IQ2_XS] = np.dtype(
    [("d", "<f2"), ("qs", "<u2", (QK_K // 8,)),
     ("scales", "u1", (QK_K // 32,))])
BLOCK_DTYPES[GGMLType.IQ2_S] = np.dtype(
    [("d", "<f2"), ("qs", "u1", (QK_K // 4,)), ("qh", "u1", (QK_K // 32,)),
     ("scales", "u1", (QK_K // 32,))])
BLOCK_DTYPES[GGMLType.IQ3_XXS] = np.dtype([("d", "<f2"),
                                           ("qs", "u1", (3 * QK_K // 8,))])
BLOCK_DTYPES[GGMLType.IQ3_S] = np.dtype(
    [("d", "<f2"), ("qs", "u1", (QK_K // 4,)), ("qh", "u1", (QK_K // 32,)),
     ("signs", "u1", (QK_K // 8,)), ("scales", "u1", (QK_K // 64,))])
BLOCK_DTYPES[GGMLType.IQ1_S] = np.dtype(
    [("d", "<f2"), ("qs", "u1", (QK_K // 8,)),
     ("qh", "<u2", (QK_K // 32,))])
BLOCK_DTYPES[GGMLType.IQ1_M] = np.dtype(
    [("qs", "u1", (QK_K // 8,)), ("qh", "u1", (QK_K // 16,)),
     ("scales", "u1", (QK_K // 32,))])

for _t, _dt in BLOCK_DTYPES.items():
    assert _dt.itemsize == FORMATS[_t].type_size, (_t, _dt.itemsize)

DECODE_ONLY = (GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S,
               GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ1_S,
               GGMLType.IQ1_M)

IQ1_DELTA = f32(0.125)

_GRIDS: dict = {}


def iq_grid(name: str) -> np.ndarray:
    """A grid of iq_grids.npz (loaded once) as its bytes per entry: uint8
    (entries, 8) for the IQ2 grids, (entries, 4) for the IQ3 grids, int8
    (2048, 8) for iq1s_grid."""
    if not _GRIDS:
        import pathlib
        with np.load(pathlib.Path(__file__).parent / "iq_grids.npz") as z:
            _GRIDS.update({k: z[k] for k in z.files})
    g = _GRIDS[name]
    return g.view(np.int8 if name == "iq1s_grid" else np.uint8) \
        .reshape(len(g), g.itemsize)


def _ksigns() -> np.ndarray:
    """ksigns_iq2xs expanded to (128, 8) of +-1: bit j of i | parity << 7
    is the sign of element j."""
    i = np.arange(128, dtype=np.uint8)
    par = i ^ (i >> 4)
    par ^= par >> 2
    par ^= par >> 1
    ks = i | ((par & 1) << 7).astype(np.uint8)
    bits = (ks[:, None] >> np.arange(8)) & 1
    return np.where(bits == 1, f32(-1.0), f32(1.0))


KSIGNS8 = _ksigns()


def sign_bits(bytes_: np.ndarray) -> np.ndarray:
    """uint8 (..., n) raw sign bytes -> +-1 f32 (..., n, 8)."""
    bits = (bytes_[..., None] >> np.arange(8)) & 1
    return np.where(bits == 1, f32(-1.0), f32(1.0))


def _u32_words(a: np.ndarray) -> np.ndarray:
    """(..., 2k) uint16 -> (..., k) little-endian uint32."""
    return np.ascontiguousarray(a).view("<u4")


def iq2xxs_fields(b: np.ndarray):
    """IQ2_XXS blocks (...) -> grid indices and sign-table indices (..., 8,
    4), and the per-32 scales d (0.5 + s4) / 4 (..., 8) f32."""
    q = b["qs"].reshape(*b.shape, 8, 4)              # (..., ib32, 4 u16)
    aux0, aux1 = _u32_words(q[..., :2])[..., 0], _u32_words(q[..., 2:])[..., 0]
    db = b["d"].astype(f32)[..., None] \
        * (f32(0.5) + (aux1 >> 28).astype(f32)) * f32(0.25)
    idx = np.stack([(aux0 >> (8 * l)) & 0xFF for l in range(4)], axis=-1)
    sidx = np.stack([(aux1 >> (7 * l)) & 127 for l in range(4)], axis=-1)
    return idx, sidx, db


def dequantize_iq2_xxs(raw: np.ndarray) -> np.ndarray:
    grid = iq_grid("iq2xxs_grid").astype(f32)
    idx, sidx, db = iq2xxs_fields(blocks_view(raw, GGMLType.IQ2_XXS))
    vals = grid[idx] * KSIGNS8[sidx]                 # (nb, 8, 4, 8)
    return (db[:, :, None, None] * vals).reshape(-1)


def iq2_db(b: np.ndarray) -> np.ndarray:
    """IQ2_XS / IQ2_S sub-scales (..., 8, 4): d (0.5 + s4) / 4, the low
    nibble for l 0-1 of a sub-block of 32, the high one for l 2-3."""
    d, sc = b["d"].astype(f32)[..., None], b["scales"]
    db0 = d * (f32(0.5) + (sc & 0xF).astype(f32)) * f32(0.25)
    db1 = d * (f32(0.5) + (sc >> 4).astype(f32)) * f32(0.25)
    return np.stack([db0, db0, db1, db1], axis=-1)


def dequantize_iq2_xs(raw: np.ndarray) -> np.ndarray:
    grid = iq_grid("iq2xs_grid").astype(f32)
    b = blocks_view(raw, GGMLType.IQ2_XS)
    q = b["qs"].reshape(-1, 8, 4).astype(np.uint32)
    vals = grid[q & 511] * KSIGNS8[q >> 9]           # (nb, 8, 4, 8)
    return (iq2_db(b)[..., None] * vals).reshape(-1)


def iq2s_index(b: np.ndarray) -> np.ndarray:
    """IQ2_S grid indices (..., 8, 4): qs | two bits of qh as bits 8-9."""
    qs = b["qs"][..., :QK_K // 8].reshape(*b.shape, 8, 4).astype(np.uint32)
    qh = b["qh"].astype(np.uint32)[..., None]
    return qs | ((qh << (8 - 2 * np.arange(4, dtype=np.uint32))) & 0x300)


def dequantize_iq2_s(raw: np.ndarray) -> np.ndarray:
    grid = iq_grid("iq2s_grid").astype(f32)
    b = blocks_view(raw, GGMLType.IQ2_S)
    signs = b["qs"][:, QK_K // 8:].reshape(-1, 8, 4)
    vals = grid[iq2s_index(b)] * sign_bits(signs)    # (nb, 8, 4, 8)
    return (iq2_db(b)[..., None] * vals).reshape(-1)


def iq3xxs_fields(b: np.ndarray):
    """IQ3_XXS blocks (...) -> the grid indices of the first and last 4
    elements of each group of 8 and the sign-table indices (..., 8, 4)
    each, and the per-32 scales d (0.5 + s4) / 2 (..., 8) f32."""
    qs = b["qs"][..., :QK_K // 4].reshape(*b.shape, 8, 8)   # grid bytes
    aux = np.ascontiguousarray(b["qs"][..., QK_K // 4:]).view("<u4") \
        .reshape(*b.shape, 8)
    db = b["d"].astype(f32)[..., None] \
        * (f32(0.5) + (aux >> 28).astype(f32)) * f32(0.5)
    sidx = np.stack([(aux >> (7 * l)) & 127 for l in range(4)], axis=-1)
    return qs[..., 0::2], qs[..., 1::2], sidx, db


def dequantize_iq3_xxs(raw: np.ndarray) -> np.ndarray:
    grid = iq_grid("iq3xxs_grid").astype(f32)
    idx1, idx2, sidx, db = iq3xxs_fields(blocks_view(raw, GGMLType.IQ3_XXS))
    vals = np.concatenate([grid[idx1], grid[idx2]], axis=-1)  # (nb, 8, 4, 8)
    return (db[:, :, None, None] * vals * KSIGNS8[sidx]).reshape(-1)


def iq3s_index(b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """IQ3_S grid indices of the first and last 4 elements of each group
    of 8, (..., 8, 4) each: qs | one bit of qh as bit 8."""
    qs = b["qs"].reshape(*b.shape, 8, 8).astype(np.uint32)
    qh = b["qh"].astype(np.uint32)[..., None]
    l = np.arange(4, dtype=np.uint32)
    return (qs[..., 0::2] | ((qh << (8 - 2 * l)) & 256),
            qs[..., 1::2] | ((qh << (7 - 2 * l)) & 256))


def iq3s_db(b: np.ndarray) -> np.ndarray:
    """IQ3_S per-32 scales (..., 8): d (1 + 2 s4), the low nibble for an
    even sub-block, the high one for an odd one."""
    d, sc = b["d"].astype(f32)[..., None], b["scales"]
    dbl = d * (1 + 2 * (sc & 0xF).astype(f32))
    dbh = d * (1 + 2 * (sc >> 4).astype(f32))
    return np.stack([dbl, dbh], axis=-1).reshape(*b.shape, 8)


def dequantize_iq3_s(raw: np.ndarray) -> np.ndarray:
    grid = iq_grid("iq3s_grid").astype(f32)
    b = blocks_view(raw, GGMLType.IQ3_S)
    idx1, idx2 = iq3s_index(b)
    g = np.concatenate([grid[idx1], grid[idx2]], axis=-1)   # (nb, 8, 4, 8)
    vals = g * sign_bits(b["signs"].reshape(-1, 8, 4))
    return (iq3s_db(b)[:, :, None, None] * vals).reshape(-1)


def dequantize_iq1_s(raw: np.ndarray) -> np.ndarray:
    grid = iq_grid("iq1s_grid").astype(f32)
    b = blocks_view(raw, GGMLType.IQ1_S)
    qs = b["qs"].reshape(-1, 8, 4).astype(np.uint32)
    qh = b["qh"].astype(np.uint32)                   # (nb, 8)
    dl = b["d"].astype(f32)[:, None] * (2 * ((qh >> 12) & 7).astype(f32) + 1)
    delta = np.where((qh & 0x8000) != 0, -IQ1_DELTA, IQ1_DELTA)
    idx = qs | (((qh[:, :, None] >> (3 * np.arange(4))) & 7) << 8)
    vals = grid[idx] + delta[:, :, None, None]
    return (dl[:, :, None, None] * vals).reshape(-1)


def dequantize_iq1_m(raw: np.ndarray) -> np.ndarray:
    grid = iq_grid("iq1s_grid").astype(f32)
    b = blocks_view(raw, GGMLType.IQ1_M)
    sc = np.ascontiguousarray(b["scales"]).view("<u2")   # (nb, 4)
    du16 = ((sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0)
            | ((sc[:, 2] >> 4) & 0x0F00) | (sc[:, 3] & 0xF000)) \
        .astype(np.uint16)
    d = du16.view(np.float16).astype(f32)            # the fp16 super-scale
    qs = b["qs"].reshape(-1, 8, 4).astype(np.uint32)
    qh = b["qh"].reshape(-1, 8, 2).astype(np.uint32)
    ib = np.arange(8)
    s3 = sc[:, ib // 2 % 4] >> (6 * (ib % 2))[None, :]
    dl1 = d[:, None] * (2 * (s3 & 7).astype(f32) + 1)
    dl2 = d[:, None] * (2 * ((s3 >> 3) & 7).astype(f32) + 1)
    dl = np.stack([dl1, dl1, dl2, dl2], axis=-1)     # (nb, 8, 4)
    idx = np.stack([qs[:, :, 0] | ((qh[:, :, 0] << 8) & 0x700),
                    qs[:, :, 1] | ((qh[:, :, 0] << 4) & 0x700),
                    qs[:, :, 2] | ((qh[:, :, 1] << 8) & 0x700),
                    qs[:, :, 3] | ((qh[:, :, 1] << 4) & 0x700)], axis=-1)
    sgn = lambda bits: np.where(bits != 0, -IQ1_DELTA, IQ1_DELTA)
    delta = np.stack([sgn(qh[:, :, 0] & 0x08), sgn(qh[:, :, 0] & 0x80),
                      sgn(qh[:, :, 1] & 0x08), sgn(qh[:, :, 1] & 0x80)],
                     axis=-1)
    vals = grid[idx] + delta[..., None]
    return (dl[..., None] * vals).reshape(-1)


def random_blocks(t: GGMLType, n_blocks: int, rng: np.random.Generator,
                  d: float) -> np.ndarray:
    """n_blocks blocks of a decode-only codebook format t with uniform
    random bytes (every grid index, sign pattern and sub-scale is valid),
    their fp16 super-scale set to d: weights for runs and tests of these
    formats without their grid-search encoders (quant.iq_encode). Flat
    uint8."""
    raw = rng.integers(0, 256, n_blocks * FORMATS[t].type_size,
                       dtype=np.uint8)
    b = blocks_view(raw, t)
    bits = np.array(d, np.float16).view(np.uint16)
    if t == GGMLType.IQ1_M:      # d's 16 bits in the scales' top nibbles
        sc = np.ascontiguousarray(b["scales"]).view("<u2")
        sc[:] = (sc & 0x0FFF) | ((bits >> (4 * np.arange(4))) & 0xF) << 12
        b["scales"] = sc.view(np.uint8).reshape(b["scales"].shape)
    else:
        b["d"] = np.float16(d)
    return raw


_DEQUANTIZERS.update({GGMLType.IQ2_XXS: dequantize_iq2_xxs,
                      GGMLType.IQ2_XS: dequantize_iq2_xs,
                      GGMLType.IQ2_S: dequantize_iq2_s,
                      GGMLType.IQ3_XXS: dequantize_iq3_xxs,
                      GGMLType.IQ3_S: dequantize_iq3_s,
                      GGMLType.IQ1_S: dequantize_iq1_s,
                      GGMLType.IQ1_M: dequantize_iq1_m})


# the block formats whose loops native/codecs.cpp holds (bit-exact copies
# of the JAX package's, as its codecs.quantize and dequantize route them);
# the numpy versions above stay in _QUANTIZERS and _DEQUANTIZERS as the
# plain versions
_NATIVE_QUANT = {GGMLType.Q4_0: "q4_0", GGMLType.Q4_1: "q4_1",
                 GGMLType.Q5_0: "q5_0", GGMLType.Q5_1: "q5_1",
                 GGMLType.Q8_0: "q8_0", GGMLType.Q8_1: "q8_1",
                 GGMLType.Q2_K: "q2_K", GGMLType.Q3_K: "q3_K",
                 GGMLType.Q4_K: "q4_K", GGMLType.Q5_K: "q5_K",
                 GGMLType.Q6_K: "q6_K", GGMLType.Q8_K: "q8_K"}
_NATIVE_DEQUANT = dict(_NATIVE_QUANT)


def _native_quantize(x: np.ndarray, t: GGMLType) -> np.ndarray:
    """codecs.cpp's <t>_quantize over x's blocks (built at first use; a
    failed build raises)."""
    from ..native import lib
    info = FORMATS[t]
    xc = np.ascontiguousarray(x, dtype=f32)
    if xc.size % info.block_size:
        raise ValueError(f"{x.shape} is not a whole number of "
                         f"{info.block_size}-blocks")
    nb = xc.size // info.block_size
    out = np.empty(nb * info.type_size, np.uint8)
    getattr(lib(), f"{_NATIVE_QUANT[t]}_quantize")(xc.ctypes.data,
                                                  out.ctypes.data, nb)
    return out


def _native_dequantize(raw: np.ndarray, t: GGMLType) -> np.ndarray:
    """codecs.cpp's <t>_dequantize over raw's blocks -> flat f32."""
    from ..native import lib
    info = FORMATS[t]
    rc = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
    if rc.size % info.type_size:
        raise ValueError(f"{rc.size} bytes are not a whole number of "
                         f"{t.name} blocks")
    nb = rc.size // info.type_size
    out = np.empty(nb * info.block_size, f32)
    getattr(lib(), f"{_NATIVE_DEQUANT[t]}_dequantize")(rc.ctypes.data,
                                                      out.ctypes.data, nb)
    return out


def quantize(x: np.ndarray, t: GGMLType) -> np.ndarray:
    """Float array (rows along the last axis, a whole number of blocks) ->
    flat uint8 buffer of encoded blocks: F32, F16, BF16 (round to nearest
    even), the block formats of _NATIVE_QUANT through native/codecs.cpp,
    IQ4_NL and IQ4_XS through their numpy versions; the codebook formats
    raise NotImplementedError (their encoders are quant.iq_encode, reached
    through quant.imatrix.quantize_rows)."""
    if t == GGMLType.F32:
        return np.ascontiguousarray(x, dtype=f32).view(np.uint8).reshape(-1)
    if t == GGMLType.F16:
        return np.ascontiguousarray(x, dtype=f32).astype(np.float16) \
            .view(np.uint8).reshape(-1)
    if t == GGMLType.BF16:
        u32 = np.ascontiguousarray(x, dtype=f32).view(np.uint32)
        rounded = ((u32 + 0x7FFF + ((u32 >> 16) & 1)) >> 16).astype(np.uint16)
        return rounded.view(np.uint8).reshape(-1)
    if t in DECODE_ONLY:
        raise NotImplementedError(
            f"quantize to {t.name}: codecs.quantize has no codebook encoder; "
            "use quant.imatrix.quantize_rows, which takes the grid-search "
            "encoders of quant.iq_encode (native/iq_encoders.cpp)")
    if t in _NATIVE_QUANT:
        return _native_quantize(x, t)
    if t not in _QUANTIZERS:
        raise NotImplementedError(f"quantize to {t.name}")
    return _QUANTIZERS[t](x).reshape(-1)


def dequantize(raw: np.ndarray, t: GGMLType,
               shape: tuple[int, ...] | None = None) -> np.ndarray:
    """Flat uint8 buffer of blocks -> float32 array (flat or shaped)."""
    if t == GGMLType.F32:
        out = np.ascontiguousarray(raw).view(np.uint8).view(f32).copy()
    elif t == GGMLType.F16:
        out = np.ascontiguousarray(raw).view(np.uint8).view(np.float16) \
            .astype(f32)
    elif t == GGMLType.BF16:
        u16 = np.ascontiguousarray(raw).view(np.uint8).view(np.uint16)
        out = (u16.astype(np.uint32) << 16).view(f32).copy()
    elif t in _NATIVE_DEQUANT:
        out = _native_dequantize(raw, t)
    elif t in _DEQUANTIZERS:
        out = _DEQUANTIZERS[t](raw)
    else:
        raise NotImplementedError(f"dequantize from {t.name}")
    return out.reshape(shape) if shape is not None else out
