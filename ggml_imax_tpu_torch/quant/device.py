"""Device representation of quantized weights (counterpart of
ggml_imax_tpu/quant/device.py), holding torch tensors.

Layouts (K = contraction dim, N = output dim):

- ``nib4``: (K/2, N) uint8. Natural layout (``q4_layout`` 0,
  ``interleaved_bk`` 0) is the intra-block plane split: byte row 16b+j
  holds element 32b+j in the low nibble and 32b+16+j in the high nibble.
  w[k, n] = (nib - zero) * scale[k // g, n] + bias[k // g, n], with
  g = K / scale rows (32, or 16 for Q2_K and Q3_K). The repacks of
  ops/qmm.py: the block-interleaved plane split (``q4_layout`` 0 with
  ``interleaved_bk`` set), the row-pair u-order layout (``q4_layout`` 1)
  and natpair (``q4_layout`` 3), which packs elements (2i, 2i+1) of byte
  row i, XOR 8, so a signed nibble read is q - 8.
- ``int8``: (K, N) int8, w = q * scale[k // g, n] + bias[k // g, n], with
  g = K / scale rows (32, or 16 for the per-16 formats). Rows are in
  natural order; the nat8 layout (``q4_layout`` 4, ops/qmm.repack_nat8) is
  the same bytes with a tag, the u-order layout (``q4_layout`` 2) permutes
  the rows of each K tile.
- ``dense``: (K, N) float.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from . import codecs
from .formats import FORMATS, GGMLType


@dataclass
class QTensor:
    """Quantized weight in device layout; the same fields as the JAX
    package's QTensor. ``n_stack`` is always 0 here: the port keeps
    per-layer weights in a Python list instead of the TPU's stacked
    layout."""
    kind: str                 # "nib4" | "int8" | "dense"
    q: torch.Tensor
    scale: Optional[torch.Tensor]   # (K/group, N) f32 or bf16
    bias: Optional[torch.Tensor]    # (K/group, N) or None
    k: int
    n: int
    ggml_type: GGMLType
    zero: int = 0             # nib4 zero-point
    interleaved_bk: int = 0   # 0 = natural layout; else the repack's K tile
    q4_layout: int = 0        # 0 = plane split (natural, or block-
                              # interleaved when interleaved_bk is set),
                              # 1 = row-pair, 2 = u-order int8, 3 = natpair,
                              # 4 = nat8
    name: str = ""
    n_stack: int = 0
    lut: Optional[torch.Tensor] = None
    signs: Optional[torch.Tensor] = None


def dequantize_qtensor(qt: QTensor) -> torch.Tensor:
    """Reference dequantization of the natural device layout (and of nat8,
    whose rows are natural) -> (K, N) f32 (counterpart of
    quant/device.dequantize_qtensor)."""
    if qt.kind == "dense":
        return qt.q.float()
    if qt.lut is not None or qt.kind not in ("nib4", "int8"):
        raise NotImplementedError(f"dequantize_qtensor: {qt.kind} with lut")
    scale = qt.scale.float()
    group = qt.k // scale.shape[0]
    if qt.kind == "nib4":
        if qt.interleaved_bk or qt.q4_layout:
            raise ValueError("dequantize_qtensor takes the natural layout")
        g = qt.q.reshape(qt.k // 32, 16, qt.n)
        idx = torch.cat([g & 0x0F, g >> 4], dim=1).reshape(qt.k, qt.n)
        q = idx.float() - float(qt.zero)
    else:
        if qt.q4_layout not in (0, 4):
            raise ValueError(f"dequantize_qtensor: int8 layout {qt.q4_layout}")
        q = qt.q.float()
    w = q.reshape(-1, group, qt.n) * scale[:, None, :]
    if qt.bias is not None:
        w = w + qt.bias.float()[:, None, :]
    return w.reshape(qt.k, qt.n)


def _nib4_from_u8(vals: np.ndarray) -> np.ndarray:
    """(N, K) unsigned 4-bit values in natural order -> packed (K/2, N)
    uint8 with the intra-block plane split."""
    n, k = vals.shape
    v = vals.reshape(n, k // 32, 2, 16)
    packed = (v[:, :, 0, :] | (v[:, :, 1, :] << 4)).astype(np.uint8)
    return np.ascontiguousarray(packed.reshape(n, k // 2).T)


# the block formats with a device layout (Q8_K, the K-quants' activation
# format, has none, as in the JAX package)
LAID_OUT = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1,
             GGMLType.Q8_0, GGMLType.Q8_1, GGMLType.Q2_K, GGMLType.Q3_K,
             GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K)


def to_device_format(raw: np.ndarray, t: GGMLType, shape_ne: tuple[int, ...],
                     *, device=None) -> QTensor:
    """Decode a ggml-encoded 2-D weight into the device layout (counterpart
    of quant/device.to_device_format for the float and non-codebook block
    formats): F32, F16 and BF16 dense f32; Q4_0 nib4 with zero 8, Q4_1 nib4
    with zero 0 and a per-32 bias m; Q2_K and Q3_K per-16 nib4, Q4_K per-32
    nib4 with a bias -min; Q8_0, Q8_1 and Q5_0 (q - 16) int8, Q5_1 (raw
    [0, 31], bias m) and Q5_K (raw [0, 31], bias -min) per-32 int8 and Q6_K
    per-16 int8. shape_ne is the ggml shape, row length K first; the
    tensors land on `device` (the card unless "cpu" is passed)."""
    dev = resolve_device(device)
    k, n = shape_ne[0], int(np.prod(shape_ne[1:]))
    put = lambda a: torch.from_numpy(a).to(dev)
    if t in (GGMLType.F32, GGMLType.F16, GGMLType.BF16):
        w = codecs.dequantize(raw, t, shape=(n, k)).T
        return QTensor("dense", put(np.ascontiguousarray(w)), None, None, k,
                       n, t)
    if t not in LAID_OUT:
        raise NotImplementedError(f"no device layout for {t.name} yet")
    if k % FORMATS[t].block_size:
        raise ValueError(f"{t.name}: K={k} is not a whole number of blocks")
    b = codecs.blocks_view(raw, t).reshape(n, k // FORMATS[t].block_size)
    f32 = np.float32
    per32 = lambda a: put(np.ascontiguousarray(a.T.astype(f32)))
    int8 = lambda q: put(np.ascontiguousarray(q.reshape(n, k).astype(np.int8)
                                              .T))
    if t == GGMLType.Q2_K:
        # per-16 scale d*sc and bias -dmin*m, rows (K/16, N); levels [0, 3]
        # with zero 0: the bias carries only the format's own minimum
        scale = b["d"].astype(f32)[..., None] * (b["scales"] & 0xF).astype(f32)
        mn = b["dmin"].astype(f32)[..., None] * (b["scales"] >> 4).astype(f32)
        q = (b["qs"][:, :, codecs._Q2_BYTE] >> codecs._Q2_SHIFT) & 3
        return QTensor("nib4", put(_nib4_from_u8(q.reshape(n, k))),
                       put(np.ascontiguousarray(scale.reshape(n, -1).T)),
                       put(np.ascontiguousarray(-mn.reshape(n, -1).T)), k, n,
                       t, zero=0)
    if t == GGMLType.Q3_K:
        # per-16 scale d*sc6, no bias; levels q + 4 in [0, 7] with zero 4
        sc6 = codecs._unpack_q3k_scales(b["scales"].reshape(-1, 12))
        scale = b["d"].astype(f32)[..., None] \
            * sc6.reshape(n, -1, 16).astype(f32)
        q = (codecs.q3k_levels(b) + 4).astype(np.uint8)
        return QTensor("nib4", put(_nib4_from_u8(q.reshape(n, k))),
                       put(np.ascontiguousarray(scale.reshape(n, -1).T)), None,
                       k, n, t, zero=4)
    if t == GGMLType.Q4_K:
        # per-32 scale d*sc and bias -dmin*m (rows (K/32, N)); levels
        # [0, 15] with zero 0
        d6, m6 = codecs._unpack_scale_min_k4(b["scales"])
        scale = b["d"].astype(f32)[..., None] * d6.astype(f32)
        mn = b["dmin"].astype(f32)[..., None] * m6.astype(f32)
        q = codecs.q4k_levels(b)
        return QTensor("nib4", put(_nib4_from_u8(q.reshape(n, k))),
                       put(np.ascontiguousarray(scale.reshape(n, -1).T)),
                       put(np.ascontiguousarray(-mn.reshape(n, -1).T)), k, n,
                       t, zero=0)
    if t == GGMLType.Q5_K:
        # per-32 scale d*sc and bias -dmin*m; raw levels [0, 31]
        d6, m6 = codecs._unpack_scale_min_k4(b["scales"])
        scale = b["d"].astype(f32)[..., None] * d6.astype(f32)
        mn = b["dmin"].astype(f32)[..., None] * m6.astype(f32)
        return QTensor("int8", int8(codecs.q5k_levels(b)),
                       per32(scale.reshape(n, -1)), per32(-mn.reshape(n, -1)),
                       k, n, t)
    if t == GGMLType.Q6_K:
        # per-16 scale d*sc, no bias; levels [-32, 31]
        scale = b["d"].astype(f32)[..., None] * b["scales"].astype(f32)
        return QTensor("int8", int8(codecs.q6k_levels(b)),
                       per32(scale.reshape(n, -1)), None, k, n, t)
    d = per32(b["d"])                                 # (K/32, N)
    bias = per32(b["m"]) if t in (GGMLType.Q4_1, GGMLType.Q5_1) else None
    if t in (GGMLType.Q4_0, GGMLType.Q4_1):
        qs = b["qs"]                                  # (N, K/32, 16)
        vals = np.concatenate([qs & 0x0F, qs >> 4], axis=2).reshape(n, k)
        return QTensor("nib4", put(_nib4_from_u8(vals)), d, bias, k, n, t,
                       zero=8 if t == GGMLType.Q4_0 else 0)
    if t in (GGMLType.Q5_0, GGMLType.Q5_1):
        # Q5_0 q5 - 16 in [-16, 15]; Q5_1 raw [0, 31] with the bias m
        q5 = codecs._unpack_q5(b["qs"].reshape(-1, 16), b["qh"].reshape(-1))
        q5 = q5.astype(np.int16) - (16 if t == GGMLType.Q5_0 else 0)
        return QTensor("int8", int8(q5), d, bias, k, n, t)
    return QTensor("int8", int8(b["qs"]), d, None, k, n, t)   # Q8_0, Q8_1


def quantize_for_device(w: np.ndarray, t: GGMLType, *, device=None) -> QTensor:
    """Quantize a float (K, N) weight through the bit-exact codec, then lay
    it out for the device: exactly what a GGUF round trip gives."""
    k, n = w.shape
    raw = codecs.quantize(np.ascontiguousarray(w.T), t)
    return to_device_format(raw, t, (k, n), device=device)


def _same_layout(a: QTensor, b: QTensor, *extra) -> bool:
    keys = ("kind", "ggml_type", "zero", "interleaved_bk", "q4_layout") + extra
    return all(getattr(a, f) == getattr(b, f) for f in keys)


def concat_qtensors(qts: list) -> QTensor:
    """Concatenate along the output (N) dim — fuses projections that read
    the same input into one GEMV."""
    a = qts[0]
    if not all(_same_layout(a, b, "k") for b in qts[1:]):
        raise ValueError("concat_qtensors: mismatched layouts")
    cat = lambda attr: None if getattr(a, attr) is None else \
        torch.cat([getattr(t, attr) for t in qts], dim=1)
    return QTensor(a.kind, cat("q"), cat("scale"), cat("bias"), a.k,
                   sum(t.n for t in qts), a.ggml_type, a.zero,
                   a.interleaved_bk, a.q4_layout, lut=a.lut,
                   signs=cat("signs"))


def concat_qtensors_k(qts: list) -> QTensor:
    """Concatenate along the contraction (K) dim — fuses projections whose
    outputs are summed (GPT-J's out_proj + fc_out). Natural layouts only;
    every K is a multiple of the scale group so no block straddles a
    seam."""
    a = qts[0]
    if not all(_same_layout(a, b, "n") for b in qts[1:]):
        raise ValueError("concat_qtensors_k: mismatched layouts")
    if a.interleaved_bk != 0:
        raise ValueError("concat_qtensors_k needs the natural layout")
    group = a.k // a.scale.shape[0] if a.scale is not None else 32
    if any(t.k % max(group, 32) for t in qts):
        raise ValueError("concat_qtensors_k: K not a multiple of the group")
    cat = lambda attr: None if getattr(a, attr) is None else \
        torch.cat([getattr(t, attr) for t in qts], dim=0)
    return QTensor(a.kind, cat("q"), cat("scale"), cat("bias"),
                   sum(t.k for t in qts), a.n, a.ggml_type, a.zero,
                   a.interleaved_bk, a.q4_layout, lut=a.lut,
                   signs=cat("signs"))


def permute_qtensor_cols(qt: QTensor, perm) -> QTensor:
    """Reorder output columns: out column t = old column perm[t]. Exact for
    every format — quant blocks run along K."""
    if qt.interleaved_bk != 0 or qt.n_stack != 0:
        raise ValueError("permute before repacking")
    perm = torch.as_tensor(np.asarray(perm), dtype=torch.long,
                           device=qt.q.device)
    if perm.shape != (qt.n,):
        raise ValueError(f"permutation of length {perm.shape} for n={qt.n}")
    take = lambda a: None if a is None else a[..., perm].contiguous()
    return replace(qt, q=take(qt.q), scale=take(qt.scale),
                   bias=take(qt.bias), signs=take(qt.signs))


def pad_qtensor_cols(qt: QTensor, multiple: int = 128) -> tuple[QTensor, int]:
    """Zero-pad the output (N) dim up to a multiple. Scale 0 makes every
    padded column decode to exactly 0. Returns (padded_qt, n_pad)."""
    if qt.interleaved_bk != 0 or qt.n_stack != 0:
        raise ValueError("pad before repacking")
    npad = (-qt.n) % multiple
    if npad == 0:
        return qt, 0
    pad = lambda a: None if a is None else \
        torch.nn.functional.pad(a, (0, npad))
    return (QTensor(qt.kind, pad(qt.q), pad(qt.scale), pad(qt.bias), qt.k,
                    qt.n + npad, qt.ggml_type, qt.zero, 0, qt.q4_layout,
                    qt.name, lut=qt.lut, signs=pad(qt.signs)), npad)


def pad_qtensor_rows(qt: QTensor, multiple: int = 1024) -> tuple[QTensor, int]:
    """Zero-pad the contraction (K) dim up to a multiple, in whole 32-row
    quant blocks (LLaMA's down projection: 11008 -> 11264). Padded rows
    carry scale 0 and bias 0, so they decode to exactly 0 whatever the
    activations; the caller feeds activations widened to the padded K.
    Returns (padded_qt, k_pad)."""
    if qt.interleaved_bk != 0 or qt.n_stack != 0:
        raise ValueError("pad before repacking")
    if multiple % 32:
        raise ValueError("K pads in whole 32-row quant blocks")
    kpad = (-qt.k) % multiple
    if kpad == 0:
        return qt, 0
    rows = lambda a, r: torch.nn.functional.pad(a, (0, 0, 0, r))
    if qt.kind not in ("nib4", "int8") or qt.signs is not None:
        raise NotImplementedError(f"pad_qtensor_rows: {qt.kind}")
    group = qt.k // qt.scale.shape[0]
    q = rows(qt.q, kpad // 2 if qt.kind == "nib4" else kpad)
    opt = lambda a: None if a is None else rows(a, kpad // group)
    return (QTensor(qt.kind, q, opt(qt.scale), opt(qt.bias), qt.k + kpad,
                    qt.n, qt.ggml_type, qt.zero, 0, qt.q4_layout, qt.name,
                    lut=qt.lut), kpad)
