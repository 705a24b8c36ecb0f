"""Bit-exact numpy codecs for the ggml block formats the port loads (its own
copy of ggml_imax_tpu/quant/codecs.py, Q4_0 and Q8_0 only).

The encoded bytes match ggml-common.h's block layouts, so blocks round-trip
bit for bit with GGUF files. Rounding, as in ggml's scalar C code:

- Q4_0: ``(int8_t)(x * id + 8.5f)`` truncates a non-negative operand, so
  it is a floor;
- Q8_0: C ``roundf``, round half away from zero;
- block scales are IEEE fp16 (round to nearest even).

All arithmetic is float32, as in the C reference. Host-side only: the
results are numpy arrays that quant/device.py lays out for the card.
"""
from __future__ import annotations

import numpy as np

from .formats import FORMATS, QK, GGMLType

f32 = np.float32


def _roundf(x: np.ndarray) -> np.ndarray:
    """C roundf: round half away from zero."""
    return np.sign(x) * np.floor(np.abs(x) + f32(0.5))


def _fp16(x: np.ndarray) -> np.ndarray:
    """Round f32 -> fp16, the storage precision of block scales."""
    return x.astype(np.float16)


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


_QUANTIZERS = {GGMLType.Q4_0: quantize_q4_0, GGMLType.Q8_0: quantize_q8_0}
_DEQUANTIZERS = {GGMLType.Q4_0: dequantize_q4_0,
                 GGMLType.Q8_0: dequantize_q8_0}


def quantize(x: np.ndarray, t: GGMLType) -> np.ndarray:
    """Float array (rows along the last axis, a whole number of blocks) ->
    flat uint8 buffer of encoded blocks. F32, Q4_0 and Q8_0."""
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
