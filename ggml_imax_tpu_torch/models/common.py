"""KV cache, masks, the params carry-over and the loaders' tensor helpers
shared by the models (counterpart of ggml_imax_tpu/models/common.py).

The cache is the flat arena the decode kernel reads: k/v are
(n_layer, B, n_ctx, H*D), bf16 (or another float dtype) or q8_0 — int8 with
one f32 scale per 32 elements along head_dim in ks/vs (quantize_row_q8_0
value semantics). Where the JAX package donates the cache so XLA updates it
in place, `update_kv` here writes into the tensors in place and returns the
same cache object.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..quant import codecs
from ..quant.device import QTensor, quantize_for_device
from ..quant.formats import GGMLType

KV_GROUP = 32


def _kv_group(head_dim: int) -> int:
    """Largest block length <= 32 dividing head_dim."""
    g = min(KV_GROUP, head_dim)
    while head_dim % g:
        g //= 2
    return g


@dataclass
class KVCache:
    k: torch.Tensor             # (L, B, n_ctx, H*D)
    v: torch.Tensor
    ks: Optional[torch.Tensor] = None   # (L, B, n_ctx, H*D/g) f32 for q8_0
    vs: Optional[torch.Tensor] = None
    heads: int = 1

    @property
    def n_ctx(self):
        return self.k.shape[2]

    @property
    def quantized(self):
        return self.ks is not None

    def select_batch(self, idx) -> "KVCache":
        """Reorder or duplicate batch rows (the beam reorder of
        runtime/whisper_pipeline.py): idx (B',) int on the cache's device.
        Every tensor of the new cache is a fresh copy gathered by
        index_select, never a view into this one, so the next in-place
        update_kv writes the tensors the new cache holds."""
        pick = lambda t: None if t is None else t.index_select(1, idx)
        return KVCache(pick(self.k), pick(self.v), pick(self.ks),
                       pick(self.vs), heads=self.heads)

    def reorder_(self, idx) -> "KVCache":
        """select_batch in place, for a cache whose addresses a captured
        step holds: idx (B,) int on the cache's device. Each tensor's rows
        are gathered into a scratch, then copied back, so an order that
        repeats a row ([0, 0, 2, 1, 1]) never reads a row it has already
        overwritten. The bytes equal select_batch's."""
        for t in (self.k, self.v, self.ks, self.vs):
            if t is not None:
                t.copy_(t.index_select(1, idx))
        return self


def init_kv_cache(n_layer: int, batch: int, n_ctx: int, n_kv_head: int,
                  head_dim: int, dtype=torch.bfloat16, *, device) -> KVCache:
    """dtype: a torch float dtype or the string "q8_0"."""
    shape = (n_layer, batch, n_ctx, n_kv_head * head_dim)
    if isinstance(dtype, str):
        if dtype != "q8_0":
            raise ValueError(f"KV dtype {dtype!r}")
        sshape = shape[:-1] + (n_kv_head * (head_dim // _kv_group(head_dim)),)
        z8 = lambda: torch.zeros(shape, dtype=torch.int8, device=device)
        zs = lambda: torch.zeros(sshape, dtype=torch.float32, device=device)
        return KVCache(z8(), z8(), zs(), zs(), heads=n_kv_head)
    z = lambda: torch.zeros(shape, dtype=dtype, device=device)
    return KVCache(z(), z(), heads=n_kv_head)


def _q8_rows(x):
    """(..., D) -> (int8 (..., D), f32 scales (..., D/g))."""
    xr = x.float().reshape(*x.shape[:-1], -1, _kv_group(x.shape[-1]))
    d = xr.abs().amax(dim=-1) / 127.0
    inv = torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)),
                      torch.zeros_like(d))
    q = torch.round(xr * inv[..., None]).to(torch.int8)
    return q.reshape(x.shape), d


def _deq8(q, s, dtype):
    """int8 (..., D) + f32 (..., D/g) -> dense (..., D) in dtype."""
    qr = q.reshape(*q.shape[:-1], -1, q.shape[-1] // s.shape[-1]).to(dtype)
    return (qr * s[..., None].to(dtype)).reshape(q.shape)


def read_kv(cache: KVCache, layer: int, dtype=torch.bfloat16):
    """-> (k, v) dense (B, n_ctx, H, D). A float arena is returned as a
    view in its own dtype; a q8_0 arena is expanded into `dtype`."""
    if cache.quantized:
        k = _deq8(cache.k[layer], cache.ks[layer], dtype)
        v = _deq8(cache.v[layer], cache.vs[layer], dtype)
    else:
        k, v = cache.k[layer], cache.v[layer]
    b, t, hd = k.shape
    h = cache.heads
    return k.reshape(b, t, h, hd // h), v.reshape(b, t, h, hd // h)


def update_kv(cache: KVCache, layer: int, k_new, v_new, n_past) -> KVCache:
    """Write k_new/v_new (B, T, H, D) at rows [n_past, n_past + T) of the
    layer, in place. Like the reference's dynamic_update_slice, a start
    past n_ctx - T is clamped to n_ctx - T. n_past: an int, or a 0-d int64
    tensor on the cache's device (a captured decode step reads it there;
    the rows are then written by index_copy_)."""
    B, T = k_new.shape[:2]
    if isinstance(n_past, torch.Tensor):
        start = torch.clamp(n_past, 0, cache.n_ctx - T)
        rows = start + torch.arange(T, device=n_past.device)
        put = lambda arena, new: arena[layer].index_copy_(1, rows, new)
    else:
        start = max(0, min(int(n_past), cache.n_ctx - T))
        rows = slice(start, start + T)
        put = lambda arena, new: arena[layer, :, rows].copy_(new)
    if cache.quantized:
        k8, kd = _q8_rows(k_new)
        v8, vd = _q8_rows(v_new)
        put(cache.k, k8.reshape(B, T, -1))
        put(cache.v, v8.reshape(B, T, -1))
        put(cache.ks, kd.reshape(B, T, -1))
        put(cache.vs, vd.reshape(B, T, -1))
    else:
        put(cache.k, k_new.reshape(B, T, -1).to(cache.k.dtype))
        put(cache.v, v_new.reshape(B, T, -1).to(cache.v.dtype))
    return cache


def update_kv_cells(cache: KVCache, layer: int, k_new, v_new, cells) -> KVCache:
    """Write k_new/v_new (B, T, H, D) into arbitrary cells (B, T) of the
    layer, in place: the batched KV writes at cells[head + i] of the
    reference's continuous batching. Unlike update_kv the destination rows
    need not be contiguous."""
    B, T = k_new.shape[:2]
    b = torch.arange(B, device=cells.device)[:, None]
    if cache.quantized:
        k8, kd = _q8_rows(k_new)
        v8, vd = _q8_rows(v_new)
        cache.k[layer, b, cells] = k8.reshape(B, T, -1)
        cache.v[layer, b, cells] = v8.reshape(B, T, -1)
        cache.ks[layer, b, cells] = kd.reshape(B, T, -1)
        cache.vs[layer, b, cells] = vd.reshape(B, T, -1)
    else:
        cache.k[layer, b, cells] = k_new.reshape(B, T, -1).to(cache.k.dtype)
        cache.v[layer, b, cells] = v_new.reshape(B, T, -1).to(cache.v.dtype)
    return cache


def cells_attention_mask(tok_pos, tok_seq, cell_pos, cell_seq):
    """Per-(token, cell) additive mask over a celled arena: a cell is visible
    iff it belongs to the token's sequence and cell.pos <= token.pos.
    tok_pos/tok_seq (B, T); cell_pos (B, n_ctx), -1 = empty; cell_seq
    (B, n_ctx) the bitmask of owning sequence ids, kept as int32 (bit 31 is
    the sign bit: ``(x >> s) & 1`` reads it for a negative value too).
    Returns (B, 1, T, n_ctx) f32, 0 or -inf."""
    same_seq = (cell_seq[:, None, :] >> tok_seq[:, :, None]) & 1
    cp = cell_pos[:, None, :]
    visible = (same_seq == 1) & (cp >= 0) & (cp <= tok_pos[:, :, None])
    mask = torch.where(visible, 0.0, float("-inf")).to(torch.float32)
    return mask[:, None]


def attention_mask(positions, n_ctx: int, n_past):
    """(B, T) query positions -> (B, 1, T, n_ctx) additive mask: visible iff
    k_pos <= q_pos and k_pos < n_past + T. n_past: an int or a 0-d int64
    tensor on the positions' device."""
    b, t = positions.shape
    k_pos = torch.arange(n_ctx, device=positions.device)[None, None, :]
    end = n_past + t if isinstance(n_past, torch.Tensor) else int(n_past) + t
    visible = (k_pos <= positions[:, :, None]) & (k_pos < end)
    mask = torch.where(visible, 0.0, float("-inf")).to(torch.float32)
    return mask[:, None]


_QT_FIELDS = ("kind", "q", "scale", "bias", "k", "n", "ggml_type", "zero",
              "interleaved_bk", "q4_layout")


def params_from_jax(params, *, device=None):
    """Carry a JAX-package params tree (raw or prepared, unstacked) over to
    the port, byte-identical. QTensor leaves are read by attribute and
    arrays through np.asarray, so nothing of JAX is imported here."""
    dev = resolve_device(device)

    def arr(a):
        a = np.array(a)                       # an owned, writable copy
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
                .to(dev)
        return torch.from_numpy(a).to(dev)

    def leaf(x):
        if x is None:
            return None
        if all(hasattr(x, f) for f in _QT_FIELDS):
            if getattr(x, "n_stack", 0):
                raise ValueError("stacked QTensors are not carried over")
            opt = lambda a: None if a is None else arr(a)
            return QTensor(str(x.kind), arr(x.q), opt(x.scale), opt(x.bias),
                           int(x.k), int(x.n), GGMLType(int(x.ggml_type)),
                           int(x.zero), int(x.interleaved_bk),
                           int(x.q4_layout), str(getattr(x, "name", "")),
                           lut=opt(getattr(x, "lut", None)),
                           signs=opt(getattr(x, "signs", None)))
        return arr(x)

    def walk(d):
        if isinstance(d, dict):
            if "stack" in d or "dec_stack" in d:
                raise ValueError("params_from_jax takes unstacked params "
                                 "(before stack_model or "
                                 "whisper.stack_decoder)")
            return {k: walk(v) for k, v in d.items()}
        if isinstance(d, list):
            return [walk(v) for v in d]
        return leaf(d)

    return walk(params)


def file_vector(raw: np.ndarray, t: GGMLType, ne: tuple[int, ...], *,
                device=None) -> torch.Tensor:
    """A model-file tensor kept as floats (a norm, a bias, a positional
    table, a conv kernel): dequantized to f32 in numpy order (ne
    reversed)."""
    w = codecs.dequantize(raw, t, shape=tuple(reversed(ne)))
    return torch.from_numpy(w).to(resolve_device(device))


def host_f32(x) -> np.ndarray:
    """A state-dict entry (a numpy array or a CPU torch tensor) as an owned
    f32 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.array(x, np.float32)


def hf_weight(w_kn, wtype: GGMLType, *, device=None) -> QTensor:
    """A float (K, N) weight of a HuggingFace state dict, quantized through
    the codec and laid out (quant.device.quantize_for_device: F32, F16 and
    BF16 become dense f32, as the JAX package's converters give them)."""
    return quantize_for_device(host_f32(w_kn), wtype, device=device)


def hf_vector(x, *, device=None) -> torch.Tensor:
    """A state-dict entry kept as floats, f32 on `device`."""
    return torch.from_numpy(host_f32(x)).to(resolve_device(device))
