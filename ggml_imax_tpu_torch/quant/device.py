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
- the codebook layouts of the IQ formats (exact, and compressed on the
  card): ``nib4`` with ``lut`` set stores a 4-bit sign + magnitude code,
  w = lut[nib] * scale[k // 32, n] (IQ3_XXS and IQ3_S, whose grids hold 8
  magnitudes each); ``nib2`` stores a 2-bit magnitude code, (K/4, N) uint8
  with element k in byte k // 4 at shift 2 (k % 4), and ``signs`` a (K/8,
  N) uint8 bitplane (bit k % 8 of byte row k // 8 set: negative), w =
  +-lut[code] * scale (IQ2_XXS per 32, IQ2_XS and IQ2_S per 16; every IQ2
  grid holds the magnitudes 8, 25 and 43). IQ4_NL and IQ4_XS become int8
  (their table's values, per-32 scales, no bias), IQ1_S and IQ1_M dense.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from . import codecs
from .formats import FORMATS, QK_K, GGMLType


@dataclass
class QTensor:
    """Quantized weight in device layout; the same fields as the JAX
    package's QTensor. ``n_stack`` is always 0 here: the port keeps
    per-layer weights in a Python list instead of the TPU's stacked
    layout."""
    kind: str                 # "nib4" | "nib2" | "int8" | "dense"
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
    lut: Optional[torch.Tensor] = None     # codebook values (f32): 16
                                           # for nib4, 4 for nib2
    signs: Optional[torch.Tensor] = None   # nib2's (K/8, N) sign bitplane


def codebook_q(qt: QTensor, q: torch.Tensor | None = None,
               signs: torch.Tensor | None = None) -> torch.Tensor:
    """The values lut[code] (with nib2's signs) of a codebook QTensor in
    natural row order, (K, C) f32. q and signs: the packed bytes and sign
    bytes of some of qt's columns (default all); the codes are gathered
    with int32 indices."""
    q = qt.q if q is None else q
    c, lut = q.shape[1], qt.lut.float()
    if qt.kind == "nib4":
        g = q.reshape(qt.k // 32, 16, c)
        idx = torch.cat([g & 0x0F, g >> 4], dim=1).reshape(-1)
        return lut.index_select(0, idx.int()).reshape(qt.k, c)
    if qt.kind != "nib2":
        raise ValueError(f"codebook_q: {qt.kind} has no codebook")
    signs = qt.signs if signs is None else signs
    shift = lambda n, step: torch.arange(0, n, step, dtype=torch.uint8,
                                         device=q.device)[:, None]
    code = (q[:, None, :] >> shift(8, 2)) & 3          # (K/4, 4, C)
    mag = lut.index_select(0, code.reshape(-1).int()).reshape(qt.k, c)
    neg = ((signs[:, None, :] >> shift(8, 1)) & 1).reshape(qt.k, c)
    return torch.where(neg.bool(), -mag, mag)


def dequantize_qtensor(qt: QTensor) -> torch.Tensor:
    """Reference dequantization of the natural device layout (and of nat8,
    whose rows are natural) -> (K, N) f32 (counterpart of
    quant/device.dequantize_qtensor)."""
    if qt.kind == "dense":
        return qt.q.float()
    scale = qt.scale.float()
    group = qt.k // scale.shape[0]
    if qt.lut is not None or qt.kind == "nib2":
        q = codebook_q(qt)
    elif qt.kind == "nib4":
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


def _nib2_from_codes(codes: np.ndarray) -> np.ndarray:
    """(N, K) codes in [0, 3], natural order -> packed (K/4, N) uint8
    (element k in byte k // 4 at shift 2 (k % 4))."""
    n, k = codes.shape
    v = codes.reshape(n, k // 4, 4).astype(np.uint16)
    packed = (v[:, :, 0] | (v[:, :, 1] << 2) | (v[:, :, 2] << 4)
              | (v[:, :, 3] << 6)).astype(np.uint8)
    return np.ascontiguousarray(packed.T)


def _bitplane(bits: np.ndarray) -> np.ndarray:
    """(N, K) 0/1, natural order -> (K/8, N) uint8 (element k is bit k % 8
    of byte row k // 8)."""
    n, k = bits.shape
    v = bits.reshape(n, k // 8, 8).astype(np.uint16)
    packed = (v << np.arange(8, dtype=np.uint16)).sum(-1).astype(np.uint8)
    return np.ascontiguousarray(packed.T)


def _iq3_decompose(b, t: GGMLType, n: int, k: int):
    """IQ3_XXS / IQ3_S blocks (n, K/256) -> (grid magnitudes (n, k) uint8,
    signs (n, k) 0/1 (1: negative), per-32 scales (n, k/32) f32) in
    natural element order, as the codecs' decoders compute them."""
    if t == GGMLType.IQ3_S:
        grid = codecs.iq_grid("iq3s_grid")
        idx1, idx2 = codecs.iq3s_index(b)
        neg = codecs.sign_bits(b["signs"].reshape(n, -1, 8, 4)) < 0
        db = codecs.iq3s_db(b)
    else:
        grid = codecs.iq_grid("iq3xxs_grid")
        idx1, idx2, sidx, db = codecs.iq3xxs_fields(b)
        neg = codecs.KSIGNS8[sidx] < 0
    mag = np.concatenate([grid[idx1], grid[idx2]], axis=-1)
    return (mag.reshape(n, k), neg.reshape(n, k).astype(np.uint8),
            db.reshape(n, -1))


def _iq2_decompose(b, t: GGMLType, n: int, k: int):
    """IQ2_XXS / IQ2_XS / IQ2_S blocks -> (magnitudes, signs, scales,
    scale group): natural-order grid magnitudes and signs as
    _iq3_decompose, per-32 scales for IQ2_XXS, per-16 for the others."""
    if t == GGMLType.IQ2_XXS:
        idx, sidx, db = codecs.iq2xxs_fields(b)
        return (codecs.iq_grid("iq2xxs_grid")[idx].reshape(n, k),
                (codecs.KSIGNS8[sidx] < 0).reshape(n, k).astype(np.uint8),
                db.reshape(n, -1), 32)
    if t == GGMLType.IQ2_XS:
        q = b["qs"].reshape(n, -1, 8, 4).astype(np.uint32)
        mag = codecs.iq_grid("iq2xs_grid")[q & 511]
        neg = codecs.KSIGNS8[q >> 9] < 0
    else:
        mag = codecs.iq_grid("iq2s_grid")[codecs.iq2s_index(b)]
        neg = codecs.sign_bits(b["qs"][:, :, QK_K // 8:]
                               .reshape(n, -1, 8, 4)) < 0
    # the scales of l 0-1 cover elements 0-15 of a sub-block, l 2-3 16-31
    return (mag.reshape(n, k), neg.reshape(n, k).astype(np.uint8),
            codecs.iq2_db(b)[..., 0::2].reshape(n, -1), 16)


def _iq_layout(b, t: GGMLType, n: int, k: int, put) -> QTensor:
    """The codebook layouts (the module docstring): IQ3 nib4 + 16-entry
    lut, IQ2 nib2 + 4-entry lut + sign bitplane, IQ4 int8."""
    f32 = np.float32
    if t in (GGMLType.IQ3_XXS, GGMLType.IQ3_S):
        mag, neg, db = _iq3_decompose(b, t, n, k)
        mags = np.array([1, 3, 5, 7, 9, 11, 13, 15] if t == GGMLType.IQ3_S
                        else [4, 12, 20, 28, 36, 44, 52, 62], np.uint8)
        idx = np.searchsorted(mags, mag).astype(np.uint8)
        if not (mags[np.minimum(idx, 7)] == mag).all():
            raise ValueError(f"{t.name}: a grid magnitude outside {mags}")
        lut = np.concatenate([mags, -mags.astype(np.int16)]).astype(f32)
        return QTensor("nib4", put(_nib4_from_u8(idx + 8 * neg)),
                       put(np.ascontiguousarray(db.T)), None, k, n, t,
                       zero=0, lut=put(lut))
    if t in (GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S):
        mag, neg, db, group = _iq2_decompose(b, t, n, k)
        mags = np.array([8, 25, 43], np.uint8)
        idx = np.searchsorted(mags, mag).astype(np.uint8)
        if not (mags[np.minimum(idx, 2)] == mag).all():
            raise ValueError(f"{t.name}: a grid magnitude outside {mags}")
        return QTensor("nib2", put(_nib2_from_codes(idx)),
                       put(np.ascontiguousarray(db.T)), None, k, n, t,
                       zero=0, lut=put(np.array([8.0, 25.0, 43.0, 0.0], f32)),
                       signs=put(_bitplane(neg)))
    lut = codecs.KVALUES_IQ4NL
    if t == GGMLType.IQ4_XS:
        scale = b["d"].astype(f32)[..., None] \
            * codecs.iq4xs_scales(b).astype(f32)
        g = b["qs"].reshape(n, -1, 8, 16)
    else:
        scale, g = b["d"].astype(f32), b["qs"]
    q = np.concatenate([lut[(g & 0xF).astype(np.int32)],
                        lut[(g >> 4).astype(np.int32)]], axis=-1)
    return QTensor("int8", put(np.ascontiguousarray(q.reshape(n, k).T)),
                   put(np.ascontiguousarray(scale.reshape(n, k // 32).T)),
                   None, k, n, t)


# the block formats with a device layout (Q8_K, the K-quants' activation
# format, has none, as in the JAX package)
LAID_OUT = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1,
             GGMLType.Q8_0, GGMLType.Q8_1, GGMLType.Q2_K, GGMLType.Q3_K,
             GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.IQ4_NL,
             GGMLType.IQ4_XS)


def _raw_blocks(raw: np.ndarray, t: GGMLType, n: int, k: int,
                dev: torch.device) -> torch.Tensor:
    """The encoded blocks of an (N rows of K) weight on dev as an (N,
    K / block_size, type_size) uint8 tensor: one host copy (raw may be a
    read-only view into a mapped file), one upload."""
    info = FORMATS[t]
    host = np.array(np.asarray(raw).view(np.uint8).reshape(-1))
    return torch.from_numpy(host).to(dev).reshape(
        n, k // info.block_size, info.type_size)


def _f16(bt: torch.Tensor, off: int) -> torch.Tensor:
    """The f16 field at byte `off` of every block, as f32 (N, blocks)."""
    return bt[..., off:off + 2].contiguous().view(torch.float16)[..., 0] \
        .float()


def _kn(x: torch.Tensor) -> torch.Tensor:
    """Per-row values (N, ...) -> the device layout's (rows, N)."""
    return x.reshape(x.shape[0], -1).t().contiguous()


def _basic_blocks(bt, t, n, k) -> QTensor:
    """Q4_0 / Q4_1 (nib4: a block's 16 bytes are already the plane split,
    element j low and j + 16 high), Q5_0 / Q5_1 (int8, q - 16 or raw with
    the bias m) and Q8_0 / Q8_1 (int8); per-32 f32 scale d."""
    affine = t in (GGMLType.Q4_1, GGMLType.Q5_1)
    off = 4 if affine or t == GGMLType.Q8_1 else 2
    d = _kn(_f16(bt, 0))
    bias = _kn(_f16(bt, 2)) if affine else None
    if t in (GGMLType.Q4_0, GGMLType.Q4_1):
        return QTensor("nib4", _kn(bt[..., off:off + 16]), d, bias, k, n, t,
                       zero=0 if affine else 8)
    if t in (GGMLType.Q8_0, GGMLType.Q8_1):
        return QTensor("int8", _kn(bt[..., off:off + 32].view(torch.int8)), d,
                       None, k, n, t)
    # Q5: bit j of the u32 qh is bit 4 of element j
    qh = bt[..., off:off + 4].contiguous().view(torch.int32)
    qs = bt[..., off + 4:off + 20]
    j = torch.arange(16, dtype=torch.int32, device=bt.device)
    hi = lambda s: (((qh >> (j + s)) & 1) << 4).to(torch.uint8)
    q5 = torch.cat([(qs & 0x0F) | hi(0), (qs >> 4) | hi(16)], dim=-1)
    q = q5.to(torch.int8) - (0 if affine else 16)
    return QTensor("int8", _kn(q), d, bias, k, n, t)


def _q4_k_blocks(bt, t, n, k) -> QTensor:
    """Q4_K: per-32 scale d * sc and bias -dmin * m (rows (K/32, N));
    levels [0, 15] with zero 0. A 64-element chunk keeps its first 32 in
    the low nibbles of its 32 bytes and the next 32 in the high ones."""
    sc = bt[..., 4:16]
    d6 = torch.cat([sc[..., 0:4] & 63,
                    (sc[..., 8:12] & 0xF) | ((sc[..., 0:4] >> 6) << 4)], -1)
    m6 = torch.cat([sc[..., 4:8] & 63,
                    (sc[..., 8:12] >> 4) | ((sc[..., 4:8] >> 6) << 4)], -1)
    scale = _f16(bt, 0)[..., None] * d6.float()
    mn = _f16(bt, 2)[..., None] * m6.float()
    qs = bt[..., 16:144].reshape(n, -1, 4, 2, 16)
    q0, q1 = qs[..., 0, :], qs[..., 1, :]
    packed = torch.stack([(q0 & 0xF) | ((q1 & 0xF) << 4),
                          (q0 >> 4) | (q1 & 0xF0)], dim=-2)
    return QTensor("nib4", _kn(packed), _kn(scale), _kn(-mn), k, n, t, zero=0)


def _q6_k_blocks(bt, t, n, k) -> QTensor:
    """Q6_K: per-16 scale d * sc, no bias; levels [-32, 31]. Each
    128-element half keeps the low nibbles of its four 32-element groups in
    64 bytes (groups 0, 1 low, 2, 3 high) and their top two bits in 32."""
    ql = bt[..., 0:128].reshape(n, -1, 2, 2, 32)
    qh = bt[..., 128:192].reshape(n, -1, 2, 32)
    lv = torch.stack([((ql[:, :, :, g % 2] >> (4 * (g // 2))) & 0xF)
                      | (((qh >> (2 * g)) & 3) << 4) for g in range(4)], 3)
    scale = _f16(bt, 208)[..., None] * bt[..., 192:208].view(torch.int8) \
        .float()
    return QTensor("int8", _kn(lv.to(torch.int8) - 32), _kn(scale), None, k,
                   n, t)


# the block formats laid out by torch ops on the target device (byte
# slices and shifts, no per-element gathers on the host)
_BLOCKS_ON_DEVICE = {GGMLType.Q4_0: _basic_blocks, GGMLType.Q4_1: _basic_blocks,
                     GGMLType.Q5_0: _basic_blocks, GGMLType.Q5_1: _basic_blocks,
                     GGMLType.Q8_0: _basic_blocks, GGMLType.Q8_1: _basic_blocks,
                     GGMLType.Q4_K: _q4_k_blocks, GGMLType.Q6_K: _q6_k_blocks}


def to_device_format(raw: np.ndarray, t: GGMLType, shape_ne: tuple[int, ...],
                     *, device=None) -> QTensor:
    """Decode a ggml-encoded 2-D weight into the device layout (counterpart
    of quant/device.to_device_format for the float and non-codebook block
    formats): F32, F16 and BF16 dense f32; Q4_0 nib4 with zero 8, Q4_1 nib4
    with zero 0 and a per-32 bias m; Q2_K and Q3_K per-16 nib4, Q4_K per-32
    nib4 with a bias -min; Q8_0, Q8_1 and Q5_0 (q - 16) int8, Q5_1 (raw
    [0, 31], bias m) and Q5_K (raw [0, 31], bias -min) per-32 int8 and Q6_K
    per-16 int8; IQ4_NL and IQ4_XS int8 (the table's values) with per-32
    scales and no bias; IQ3_XXS and IQ3_S nib4 with a lut, IQ2_XXS, IQ2_XS
    and IQ2_S nib2 with a lut and a sign bitplane (the module docstring);
    IQ1_S and IQ1_M dense f32. shape_ne is the ggml shape, row length K
    first; the tensors land on `device` (the card unless "cpu" is
    passed)."""
    dev = resolve_device(device)
    k, n = shape_ne[0], int(np.prod(shape_ne[1:]))
    put = lambda a: torch.from_numpy(a).to(dev)
    if t in (GGMLType.F32, GGMLType.F16, GGMLType.BF16, GGMLType.IQ1_S,
             GGMLType.IQ1_M):
        # IQ1's per-8 deltas have no exact factored layout within twice
        # the packed bytes: dense at load, as in the JAX package
        w = codecs.dequantize(raw, t, shape=(n, k)).T
        return QTensor("dense", put(np.ascontiguousarray(w)), None, None, k,
                       n, t)
    if t not in LAID_OUT + codecs.DECODE_ONLY:
        raise NotImplementedError(f"no device layout for {t.name} yet")
    if k % FORMATS[t].block_size:
        raise ValueError(f"{t.name}: K={k} is not a whole number of blocks")
    if t in _BLOCKS_ON_DEVICE:
        return _BLOCKS_ON_DEVICE[t](_raw_blocks(raw, t, n, k, dev), t, n, k)
    b = codecs.blocks_view(raw, t).reshape(n, k // FORMATS[t].block_size)
    if t.name.startswith("IQ"):
        return _iq_layout(b, t, n, k, put)
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
    if t == GGMLType.Q5_K:
        # per-32 scale d*sc and bias -dmin*m; raw levels [0, 31]
        d6, m6 = codecs._unpack_scale_min_k4(b["scales"])
        scale = b["d"].astype(f32)[..., None] * d6.astype(f32)
        mn = b["dmin"].astype(f32)[..., None] * m6.astype(f32)
        return QTensor("int8", int8(codecs.q5k_levels(b)),
                       per32(scale.reshape(n, -1)), per32(-mn.reshape(n, -1)),
                       k, n, t)


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
    carry scale 0 and bias 0 (a codebook's rows code 0 and no sign), so
    they decode to exactly 0 whatever the activations; the caller feeds
    activations widened to the padded K. Returns (padded_qt, k_pad)."""
    if qt.interleaved_bk != 0 or qt.n_stack != 0:
        raise ValueError("pad before repacking")
    if multiple % 32:
        raise ValueError("K pads in whole 32-row quant blocks")
    kpad = (-qt.k) % multiple
    if kpad == 0:
        return qt, 0
    if qt.kind == "dense":
        raise NotImplementedError("pad_qtensor_rows: dense")
    rows = lambda a, r: torch.nn.functional.pad(a, (0, 0, 0, r))
    group = qt.k // qt.scale.shape[0]
    q = rows(qt.q, kpad // {"nib4": 2, "nib2": 4, "int8": 1}[qt.kind])
    opt = lambda a, per: None if a is None else rows(a, kpad // per)
    return (QTensor(qt.kind, q, opt(qt.scale, group), opt(qt.bias, group),
                    qt.k + kpad, qt.n, qt.ggml_type, qt.zero, 0, qt.q4_layout,
                    qt.name, lut=qt.lut, signs=opt(qt.signs, 8)), kpad)


def to_dense_bf16(qt: QTensor) -> QTensor:
    """Dequantize a QTensor once, on its own device, into a dense bf16
    QTensor (ops.qmatmul.dequantize, as the JAX package's dequantize_xla);
    a dense one is returned as it is. The bf16 residency of
    runtime/engine.Engine: twice the bytes of a 4-bit weight, no expansion
    in the products."""
    if qt.kind == "dense":
        return qt
    from ..ops.qmatmul import dequantize
    return QTensor("dense", dequantize(qt, torch.bfloat16), None, None, qt.k,
                   qt.n, qt.ggml_type, name=qt.name)


def params_to_dense_bf16(params):
    """Map to_dense_bf16 over every QTensor leaf of a params tree, one leaf
    at a time, so no more than one leaf's temporaries are alive at once;
    the new tree holds no quantized tensor, and those of `params` are
    released when the caller drops it."""
    def walk(d):
        if isinstance(d, dict):
            return {k: walk(v) for k, v in d.items()}
        if isinstance(d, list):
            return [walk(v) for v in d]
        return to_dense_bf16(d) if isinstance(d, QTensor) else d

    return walk(params)
