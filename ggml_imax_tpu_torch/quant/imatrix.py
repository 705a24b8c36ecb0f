"""Importance-matrix (imatrix) support: the port's copy of
ggml_imax_tpu/quant/imatrix.py.

ggml_quantize_chunk takes an optional importance matrix, which the
imatrix-aware quantizers weigh their error by (quantize_row_q4_0_impl and
its siblings: per-element weights qw[j] sqrt(sigma2 + x[j]^2) feeding the
weighted scale searches). The imatrix itself is collected here by an
activation observer in ops.qmatmul: for each quantized weight it
accumulates the mean square of the activation entries that multiply each
contraction row, the "importance" the quantizers take.

The collector sums on the activation's own device, one reduction a call
and no host copy, and reads the sums back only in `matrix` / `matrices`.
A captured CUDA graph would run no observer, so ops.qmatmul refuses one
(collect through eager forwards, as tools.perplexity runs them).

The quantizers are numpy, as in the JAX package (the host C++ codecs
have no imatrix path); the codebook formats go to quant.iq_encode.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..ops import qmatmul as qmm
from . import codecs
from .device import QTensor
from .formats import QK, QK_K, GGMLType

f32 = np.float32


def name_params(params, prefix: str = ""):
    """Give every unnamed QTensor leaf of a params tree (dicts and lists, the
    loaders' shape) its path as its name ("layers[0].attn_w"): the
    collector keys on names, as llama.cpp's imatrix tool keys on tensor
    names."""
    def walk(d, path):
        if isinstance(d, dict):
            return {k: walk(v, f"{path}.{k}" if path else k)
                    for k, v in d.items()}
        if isinstance(d, list):
            return [walk(v, f"{path}[{i}]") for i, v in enumerate(d)]
        if isinstance(d, QTensor) and not d.name:
            return replace(d, name=path)
        return d

    return walk(params, prefix)


class ImatrixCollector:
    """Accumulate each weight's per-contraction-row activation second
    moments over the products run inside the block:

        with ImatrixCollector() as col:
            model.forward(...)                     # eager calls
        imx = col.matrix(params["layers"][0]["q_w"])   # (K,) float32

    Keys are QTensor names (`name_params`), or the object's id for an
    unnamed tensor."""

    def __init__(self):
        self._sums: dict[object, torch.Tensor] = {}
        self._counts: dict[object, int] = {}
        self._active = False

    def __enter__(self):
        self._active = True
        qmm.set_activation_observer(self._observe)
        return self

    def __exit__(self, *exc):
        self._active = False
        qmm.set_activation_observer(None)

    def _observe(self, qt: QTensor, x: torch.Tensor):
        if not self._active:
            return
        key = qt.name or id(qt)
        xs = x.detach().reshape(-1, qt.k)
        acc = xs.float().square().sum(0)
        if key in self._sums:
            self._sums[key] += acc
            self._counts[key] += xs.shape[0]
        else:
            self._sums[key] = acc
            self._counts[key] = xs.shape[0]

    def count(self, qt: QTensor) -> int:
        """How many activation rows reached qt's products."""
        key = qt.name or id(qt)
        if key not in self._counts and qt.name:
            key = id(qt)
        return self._counts.get(key, 0)

    def matrix(self, qt: QTensor) -> np.ndarray | None:
        """qt's imatrix row (K,) float32, or None if no product saw it."""
        key = qt.name or id(qt)
        if key not in self._sums and qt.name:
            key = id(qt)
        if key not in self._sums:
            return None
        return (self._sums[key] / max(1, self._counts[key])).cpu().numpy() \
            .astype(f32)

    def matrices(self) -> dict:
        """Every collected row, keyed as collected."""
        return {k: (s / max(1, self._counts[k])).cpu().numpy().astype(f32)
                for k, s in self._sums.items()}


def quantize_q4_0_imatrix(x2d: np.ndarray, qw: np.ndarray) -> np.ndarray:
    """quantize_row_q4_0_impl with quant_weights. x2d (n_rows, n_per_row),
    qw (n_per_row,) -> the encoded bytes."""
    nr, n = x2d.shape
    if n % QK or qw.shape != (n,):
        raise ValueError(f"rows {x2d.shape}, importance row {qw.shape}")
    xb = np.ascontiguousarray(x2d, f32)
    sigma2 = (xb * xb).mean(axis=1)                       # per row
    blocks = xb.reshape(nr, n // QK, QK)
    weight = qw.reshape(1, n // QK, QK) * np.sqrt(
        sigma2[:, None, None] + blocks * blocks)
    d, L = codecs._make_qx_quants(blocks.reshape(-1, QK), 8,
                                  weight.reshape(-1, QK).astype(f32))
    out = np.zeros(len(d), dtype=codecs.BLOCK_DTYPES[GGMLType.Q4_0])
    out["d"] = codecs._fp16(d)
    Lu = L.astype(np.uint8)                               # in [0, 15]
    out["qs"] = Lu[:, :QK // 2] | (Lu[:, QK // 2:] << 4)
    return out.view(np.uint8).reshape(-1)


def _row_weighted(x2d: np.ndarray, qw: np.ndarray, group: int):
    """weight = qw sqrt(sigma2 + x^2) with sigma2 = mean(x^2) per ROW (the
    basic formats' imatrix weighting). -> (x, weight), each
    (rows * blocks, group)."""
    nr, n = x2d.shape
    xb = np.ascontiguousarray(x2d, f32)
    sigma2 = (codecs._seqsum(xb * xb) / f32(n)).astype(f32)
    blocks = xb.reshape(nr, n // group, group)
    weight = (qw.reshape(1, n // group, group)
              * np.sqrt(sigma2[:, None, None] + blocks * blocks)).astype(f32)
    return blocks.reshape(-1, group), weight.reshape(-1, group)


def quantize_q4_1_imatrix(x2d: np.ndarray, qw: np.ndarray) -> np.ndarray:
    """quantize_row_q4_1_impl: the weighted affine search of
    make_qkx3_quants (make_qkx2_quants with weights)."""
    flat_x, flat_w = _row_weighted(x2d, np.ascontiguousarray(qw, f32), QK)
    d, mins, L = codecs._make_qkx2_quants(flat_x, flat_w, 15, -0.9, 0.05, 36,
                                          False)
    out = np.zeros(len(flat_x), dtype=codecs.BLOCK_DTYPES[GGMLType.Q4_1])
    out["d"] = codecs._fp16(d)
    out["m"] = codecs._fp16(-mins)    # the search's the_min is -min
    Lu = L.astype(np.uint8)
    out["qs"] = Lu[:, :QK // 2] | (Lu[:, QK // 2:] << 4)
    return out.view(np.uint8).reshape(-1)


def quantize_q5_0_imatrix(x2d: np.ndarray, qw: np.ndarray) -> np.ndarray:
    """quantize_row_q5_0_impl."""
    flat_x, flat_w = _row_weighted(x2d, np.ascontiguousarray(qw, f32), QK)
    d, L = codecs._make_qx_quants(flat_x, 16, flat_w)     # L in [0, 31]
    out = np.zeros(len(flat_x), dtype=codecs.BLOCK_DTYPES[GGMLType.Q5_0])
    out["d"] = codecs._fp16(d)
    out["qs"], out["qh"] = codecs._pack_q5(L)
    return out.view(np.uint8).reshape(-1)


def quantize_q5_1_imatrix(x2d: np.ndarray, qw: np.ndarray) -> np.ndarray:
    """quantize_row_q5_1_impl."""
    flat_x, flat_w = _row_weighted(x2d, np.ascontiguousarray(qw, f32), QK)
    d, mins, L = codecs._make_qkx2_quants(flat_x, flat_w, 31, -0.9, 0.05, 36,
                                          False)
    out = np.zeros(len(flat_x), dtype=codecs.BLOCK_DTYPES[GGMLType.Q5_1])
    out["d"] = codecs._fp16(d)
    out["m"] = codecs._fp16(-mins)
    out["qs"], out["qh"] = codecs._pack_q5(L)
    return out.view(np.uint8).reshape(-1)


def _superblock_weighted(x2d: np.ndarray, qw: np.ndarray, group: int,
                         sigma_mul: float):
    """The K-quants' imatrix weighting: sigma2 = sigma_mul mean(x^2) per
    256-super-block, weight = qw sqrt(sigma2 + x^2), cut into `group`-wide
    sub-blocks. -> (xb (nblk, 256), sub_x, sub_w (nblk * nsub, group), the
    sub-blocks' weight sums sw (nblk, nsub))."""
    nr, n = x2d.shape
    nblk = nr * (n // QK_K)
    xb = np.ascontiguousarray(x2d, f32).reshape(nblk, QK_K)
    qwb = np.tile(np.ascontiguousarray(qw, f32).reshape(n // QK_K, QK_K),
                  (nr, 1))
    sigma2 = (f32(sigma_mul) * codecs._seqsum(xb * xb) / f32(QK_K)) \
        .astype(f32)
    weights = (qwb * np.sqrt(sigma2[:, None] + xb * xb)).astype(f32)
    nsub = QK_K // group
    sub_w = weights.reshape(nblk * nsub, group)
    sw = codecs._seqsum(sub_w).reshape(nblk, nsub)
    return xb, xb.reshape(nblk * nsub, group), sub_w, sw


def quantize_q2_K_imatrix(x2d: np.ndarray, qw: np.ndarray) -> np.ndarray:
    """quantize_row_q2_K_impl: make_qkx3_quants per 16-sub-block,
    make_qp_quants super-scales, then every element again against the
    stored fp16 scales."""
    xb, sub_x, sub_w, sw = _superblock_weighted(x2d, qw, 16, 1.0)
    nblk = len(xb)
    scales, mins, L = codecs._make_qkx2_quants(sub_x, sub_w, 3, -0.9, 0.05,
                                               36, False)
    scales, mins = scales.reshape(nblk, 16), mins.reshape(nblk, 16)
    L = L.reshape(nblk, QK_K)

    dm, Ls = codecs._make_qp_quants(scales, 15, sw)
    mm, Lm = codecs._make_qp_quants(mins, 15, sw)
    dl_e = np.repeat(codecs._fp16_f32(dm)[:, None] * Ls.astype(f32), 16,
                     axis=1)
    ml_e = np.repeat(codecs._fp16_f32(mm)[:, None] * Lm.astype(f32), 16,
                     axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        l_new = np.clip(codecs._nearest_int((xb + ml_e) / dl_e), 0, 3)
    L = np.where(dl_e != 0, l_new, L)

    out = np.zeros(nblk, dtype=codecs.BLOCK_DTYPES[GGMLType.Q2_K])
    out["scales"] = Ls.astype(np.uint8) | (Lm.astype(np.uint8) << 4)
    out["qs"] = codecs._pack_2bit_fast(L)
    out["d"] = codecs._fp16(dm)
    out["dmin"] = codecs._fp16(mm)
    return out.view(np.uint8).reshape(-1)


def quantize_q3_K_imatrix(x2d: np.ndarray, qw: np.ndarray) -> np.ndarray:
    """quantize_row_q3_K_impl: weighted make_qx_quants per 16-sub-block and
    for the 6-bit super-scales (weighted by the sub-blocks' weight sums)."""
    xb, sub_x, sub_w, sw = _superblock_weighted(x2d, qw, 16, 2.0)
    nblk = len(xb)
    scales, L = codecs._make_qx_quants(sub_x, 4, sub_w)
    scales = scales.reshape(nblk, 16)
    L = L.reshape(nblk, QK_K)                               # in [0, 7]

    d, Ls6 = codecs._make_qx_quants(scales, 32, sw)         # in [0, 63]
    packed_scales = codecs._pack_q3k_scales(Ls6)
    sc = codecs._unpack_q3k_scales(packed_scales).astype(f32)
    dl_e = np.repeat(codecs._fp16_f32(d)[:, None] * sc, 16, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        l_new = np.clip(codecs._nearest_int(xb / dl_e), -4, 3) + 4
    L = np.where(dl_e != 0, l_new, L)

    hibit = L > 3
    hmask = np.zeros((nblk, QK_K // 8), dtype=np.uint8)
    for bit in range(8):
        sel = codecs._Q3_HBIT == bit
        hmask[:, codecs._Q3_HBYTE[sel]] |= \
            hibit[:, sel].astype(np.uint8) << bit
    out = np.zeros(nblk, dtype=codecs.BLOCK_DTYPES[GGMLType.Q3_K])
    out["hmask"] = hmask
    out["qs"] = codecs._pack_2bit_fast(np.where(hibit, L - 4, L))
    out["scales"] = packed_scales
    out["d"] = codecs._fp16(d)
    return out.view(np.uint8).reshape(-1)


def _quantize_q45_K_imatrix(x2d: np.ndarray, qw: np.ndarray, nmax: int):
    """The q4_K / q5_K imatrix body (quantize_row_q4_K_impl, q5_K's):
    make_qkx3_quants per 32-sub-block, weights qw sqrt(sigma2 + x^2) with
    sigma2 = 2 mean(x^2) per super-block; super-scales by make_qp_quants
    weighted by the sub-blocks' weight sums."""
    xb, sub_x, sub_w, sw = _superblock_weighted(x2d, qw, 32, 2.0)
    nblk = len(xb)
    scales, mins, L = codecs._make_qkx2_quants(sub_x, sub_w, nmax, -0.9,
                                               0.05, 36, False)
    scales, mins = scales.reshape(nblk, 8), mins.reshape(nblk, 8)
    L = L.reshape(nblk, QK_K)

    d, Ls = codecs._make_qp_quants(scales, 63, sw)
    dmin, Lm = codecs._make_qp_quants(mins, 63, sw)
    packed = codecs._pack_scale_min_k4(Ls.astype(np.uint8),
                                       Lm.astype(np.uint8))
    d6, m6 = codecs._unpack_scale_min_k4(packed)
    dl = np.repeat(codecs._fp16_f32(d)[:, None] * d6.astype(f32), 32, axis=1)
    ml = np.repeat(codecs._fp16_f32(dmin)[:, None] * m6.astype(f32), 32,
                   axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        l_new = np.clip(codecs._nearest_int((xb + ml) / dl), 0, nmax)
    return nblk, d, dmin, packed, np.where(dl != 0, l_new, L)


def quantize_q4_K_imatrix(x2d: np.ndarray, qw: np.ndarray) -> np.ndarray:
    nblk, d, dmin, packed, L = _quantize_q45_K_imatrix(x2d, qw, 15)
    out = np.zeros(nblk, dtype=codecs.BLOCK_DTYPES[GGMLType.Q4_K])
    out["d"] = codecs._fp16(d)
    out["dmin"] = codecs._fp16(dmin)
    out["scales"] = packed
    out["qs"] = codecs._pack_4bit_k(L)
    return out.view(np.uint8).reshape(-1)


def quantize_q5_K_imatrix(x2d: np.ndarray, qw: np.ndarray) -> np.ndarray:
    nblk, d, dmin, packed, L = _quantize_q45_K_imatrix(x2d, qw, 31)
    hibit = L > 15
    qh = np.zeros((nblk, QK_K // 8), dtype=np.uint8)
    for bit in range(8):
        sel = codecs._Q5K_HBIT == bit
        qh[:, (codecs._E % 32)[sel]] |= hibit[:, sel].astype(np.uint8) << bit
    out = np.zeros(nblk, dtype=codecs.BLOCK_DTYPES[GGMLType.Q5_K])
    out["d"] = codecs._fp16(d)
    out["dmin"] = codecs._fp16(dmin)
    out["scales"] = packed
    out["qh"] = qh
    out["qs"] = codecs._pack_4bit_k(np.where(hibit, L - 16, L))
    return out.view(np.uint8).reshape(-1)


def _tiled(x2d: np.ndarray, qw: np.ndarray):
    """x2d flat, and qw repeated for each row."""
    nr, n = x2d.shape
    qwb = np.tile(np.ascontiguousarray(qw, f32).reshape(1, n), (nr, 1))
    return np.ascontiguousarray(x2d, f32).reshape(-1), qwb.reshape(-1)


def quantize_q6_K_imatrix(x2d: np.ndarray, qw: np.ndarray) -> np.ndarray:
    """quantize_row_q6_K_impl: the imatrix entries are the make_qx_quants
    weights themselves (no sigma2 mixing)."""
    return codecs.quantize_q6_K(*_tiled(x2d, qw))


def quantize_iq4_nl_imatrix(x2d: np.ndarray, qw: np.ndarray) -> np.ndarray:
    x, w = _tiled(x2d, qw)
    return codecs.quantize_iq4_nl(x, qw=w)


def quantize_iq4_xs_imatrix(x2d: np.ndarray, qw: np.ndarray) -> np.ndarray:
    x, w = _tiled(x2d, qw)
    return codecs.quantize_iq4_xs(x, qw=w)


_IMATRIX_QUANTIZERS = {
    GGMLType.Q4_0: quantize_q4_0_imatrix,
    GGMLType.Q4_1: quantize_q4_1_imatrix,
    GGMLType.Q5_0: quantize_q5_0_imatrix,
    GGMLType.Q5_1: quantize_q5_1_imatrix,
    GGMLType.Q2_K: quantize_q2_K_imatrix,
    GGMLType.Q3_K: quantize_q3_K_imatrix,
    GGMLType.Q4_K: quantize_q4_K_imatrix,
    GGMLType.Q5_K: quantize_q5_K_imatrix,
    GGMLType.Q6_K: quantize_q6_K_imatrix,
    GGMLType.IQ4_NL: quantize_iq4_nl_imatrix,
    GGMLType.IQ4_XS: quantize_iq4_xs_imatrix,
}

_IQ_CODEBOOK_TYPES = (GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S,
                      GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ1_S,
                      GGMLType.IQ1_M)


def quantize_rows(x2d: np.ndarray, t: GGMLType,
                  imatrix: np.ndarray | None = None) -> np.ndarray:
    """The ggml_quantize_chunk analog: rows of x2d (n_rows, n_per_row) with
    an optional importance row -> flat encoded bytes. Formats without an
    imatrix path (Q8_0 and its kin) take the plain codec, as in the
    reference; the codebook formats take the grid-search encoders
    (quant.iq_encode)."""
    if t in _IQ_CODEBOOK_TYPES:
        from .iq_encode import quantize_iq
        return quantize_iq(
            x2d, t, None if imatrix is None
            else np.ascontiguousarray(imatrix, f32)).reshape(-1)
    if imatrix is not None:
        fn = _IMATRIX_QUANTIZERS.get(t)
        if fn is not None:
            return fn(x2d, np.ascontiguousarray(imatrix, f32))
    return codecs.quantize(x2d, t)


def quantize_requires_imatrix(t: GGMLType) -> bool:
    """ggml_quantize_requires_imatrix: IQ2_XXS, IQ2_XS and IQ1_S (their
    encoders have no usable weighting without importance data)."""
    return t in (GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ1_S)
