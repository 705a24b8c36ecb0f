"""Bit-exact numpy codecs for the ggml block formats the port loads (its own
copy of ggml_imax_tpu/quant/codecs.py: Q4_0, Q8_0, Q2_K, Q3_K and Q4_K).

The encoded bytes match ggml-common.h's block layouts, so blocks round-trip
bit for bit with GGUF files. Rounding, as in ggml's scalar C code:

- Q4_0: ``(int8_t)(x * id + 8.5f)`` truncates a non-negative operand, so
  it is a floor;
- Q8_0: C ``roundf``, round half away from zero;
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
    GGMLType.Q8_0: np.dtype([("d", "<f2"), ("qs", "i1", (QK,))]),
    GGMLType.Q2_K: np.dtype([("scales", "u1", (QK_K // 16,)),
                             ("qs", "u1", (QK_K // 4,)),
                             ("d", "<f2"), ("dmin", "<f2")]),
    GGMLType.Q3_K: np.dtype([("hmask", "u1", (QK_K // 8,)),
                             ("qs", "u1", (QK_K // 4,)),
                             ("scales", "u1", (12,)), ("d", "<f2")]),
    GGMLType.Q4_K: np.dtype([("d", "<f2"), ("dmin", "<f2"),
                             ("scales", "u1", (12,)),
                             ("qs", "u1", (QK_K // 2,))]),
}

for _t, _dt in BLOCK_DTYPES.items():
    assert _dt.itemsize == FORMATS[_t].type_size, (_t, _dt.itemsize)


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


_QUANTIZERS = {GGMLType.Q4_0: quantize_q4_0, GGMLType.Q8_0: quantize_q8_0,
               GGMLType.Q2_K: quantize_q2_K, GGMLType.Q3_K: quantize_q3_K,
               GGMLType.Q4_K: quantize_q4_K}
_DEQUANTIZERS = {GGMLType.Q4_0: dequantize_q4_0,
                 GGMLType.Q8_0: dequantize_q8_0,
                 GGMLType.Q2_K: dequantize_q2_K,
                 GGMLType.Q3_K: dequantize_q3_K,
                 GGMLType.Q4_K: dequantize_q4_K}


def quantize(x: np.ndarray, t: GGMLType) -> np.ndarray:
    """Float array (rows along the last axis, a whole number of blocks) ->
    flat uint8 buffer of encoded blocks. F32, Q4_0, Q8_0, Q2_K, Q3_K and
    Q4_K."""
    if t == GGMLType.F32:
        return np.ascontiguousarray(x, dtype=f32).view(np.uint8).reshape(-1)
    if t not in _QUANTIZERS:
        raise NotImplementedError(f"quantize to {t.name}")
    return _QUANTIZERS[t](x).reshape(-1)


def dequantize(raw: np.ndarray, t: GGMLType,
               shape: tuple[int, ...] | None = None) -> np.ndarray:
    """Flat uint8 buffer of blocks -> float32 array (flat or shaped)."""
    if t == GGMLType.F32:
        out = np.ascontiguousarray(raw).view(np.uint8).view(f32).copy()
    elif t in _DEQUANTIZERS:
        out = _DEQUANTIZERS[t](raw)
    else:
        raise NotImplementedError(f"dequantize from {t.name}")
    return out.reshape(shape) if shape is not None else out
