"""Flash-attention forward (counterpart of
ggml_imax_tpu/ops/flash_attention.py `flash_attention` and the `attention`
dispatcher; kernel in csrc/flash_attention.cu).

Masks use the finite NEG = -0.7 * f32max instead of -inf, so fully masked
(padding) rows give 0, not NaN; q, k and v enter the kernel as bf16 and the
softmax and sums are f32.

Padded keys. The reference pads the keys to `padded_keys(Tk)` (its tk at
its default block_k of 512) with k = v = 0 and mask NEG, so each padded key
scores NEG * slope (NEG without ALiBi) and both forwards here add
(padded_keys(Tk) - Tk) * exp(score_pad - m) to l: 0 in a row with a visible
key, while a row with no visible key gets the reference's uniform average
over tk keys and lse = m + log(tk). On the main paths (Tk 512, 1024, 2048)
padded_keys(Tk) == Tk.

The kernel skips the all-NEG tiles of the mask's tile map
(ops/flash_backward.backward_tile_map, one launch a forward) where
NEG * slope < -1e32 (`skipped_tiles_plain`), and brings a row with no
visible key back with the V of its skipped tiles (csrc/flash_attention.cu).

Differentiable (the counterpart of the reference's `_fa` custom VJP): when
q, k or v requires grad, the forward also writes lse and the backward runs
ops/flash_backward.py. Otherwise the forward launches exactly what an
inference call launches.
"""
from __future__ import annotations

import math

import torch

from .. import _build
from .attention import attention_xla
from .decode_attention import NEG
from .softmax import alibi_slopes


def padded_keys(Tk: int, block_k: int = 512) -> int:
    """The reference's padded key count tk at block_k:
    round_up(Tk, min(block_k, round_up(Tk, 128)))."""
    bk = min(block_k, -(-Tk // 128) * 128)
    return -(-Tk // bk) * bk


def _prep(q, k, v, mask, max_bias):
    B, Tq, Hq, D = q.shape
    Tk = k.shape[1]
    if Hq % k.shape[2] or k.shape != v.shape or k.shape[0] != B:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    qb, kb, vb = (t.to(torch.bfloat16).contiguous() for t in (q, k, v))
    m3 = None
    if mask is not None:
        m = mask.squeeze(1) if mask.dim() == 4 else mask
        m3 = torch.clamp(torch.broadcast_to(m.float(), (B, Tq, Tk)),
                         min=NEG).contiguous()
    slopes = None
    if max_bias > 0.0:
        slopes = torch.as_tensor(alibi_slopes(Hq, max_bias), device=q.device)
    return qb, kb, vb, m3, slopes


def masked_score(slopes, Hq):
    """The score of a key masked NEG, and of a padded one: max(NEG * slope,
    NEG) per head (Hq, 1, 1) f32, or NEG without slopes."""
    if slopes is None:
        return NEG
    neg = torch.tensor(NEG, dtype=torch.float32, device=slopes.device)
    return torch.clamp(neg * slopes, min=NEG).reshape(Hq, 1, 1)


def flash_attention_plain(qb, kb, vb, m3, slopes, scale, softcap, want_lse):
    """Plain version on the prepared inputs: bf16 q/k/v (B, T, H, D), m3
    (B, Tq, Tk) f32 >= NEG or None, slopes (Hq) or None. Returns out
    (B, Tq, Hq, D) f32 and lse (B, Hq, Tq) f32 (or None)."""
    Hq, Hkv, Tk = qb.shape[2], kb.shape[2], kb.shape[1]
    rep = Hq // Hkv
    qf = qb.float().transpose(1, 2)                        # (B, Hq, Tq, D)
    kf = kb.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    vf = vb.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    s = (qf @ kf.transpose(-1, -2)) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    if m3 is not None:
        mb = m3[:, None]
        if slopes is not None:
            mb = mb * slopes.reshape(1, Hq, 1, 1)
        s = torch.clamp(s + mb, min=NEG)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pad = padded_keys(Tk) - Tk
    if pad:
        l = l + pad * torch.exp(masked_score(slopes, Hq) - m)
    l = torch.clamp(l, min=1e-30)
    out = (p.to(torch.bfloat16).float() @ vf) / l
    lse = (m + torch.log(l))[..., 0] if want_lse else None
    return out.transpose(1, 2), lse


def skipped_tiles_plain(tiles, slopes, Hq):
    """(B, Hq, nq, nk) bool: the tiles of the map the kernel does not score,
    the all-NEG ones of each head whose NEG * slope < -1e32."""
    from .flash_backward import TILE_NEG
    skip = (tiles == TILE_NEG)[:, None].expand(-1, Hq, -1, -1)
    if slopes is not None:
        skip = skip & (slopes * NEG < -1e32).reshape(1, Hq, 1, 1)
    return skip


def flash_attention_kernel(qb, kb, vb, m3, slopes, scale, softcap, want_lse,
                           tiles=None):
    """Launch csrc/flash_attention.cu on the prepared inputs. tiles: the map
    of `flash_backward.backward_tile_map(m3)`, given with a mask and only
    then."""
    from .flash_backward import TILE
    B, Tq, Hq, D = qb.shape
    Tk, Hkv = kb.shape[1], kb.shape[2]
    if D % 16 or D > 256:
        raise ValueError(f"flash_attention kernel: head dim {D}")
    if any(not t.is_contiguous() or t.dtype != torch.bfloat16
           or t.data_ptr() % 16 for t in (qb, kb, vb)) or m3 is not None and (
               not m3.is_contiguous() or m3.dtype != torch.float32
               or m3.data_ptr() % 16):
        raise ValueError("the flash kernel takes contiguous, 16-byte aligned "
                         "bf16 q/k/v and f32 mask")
    if (tiles is None) != (m3 is None) or tiles is not None and (
            tiles.dtype != torch.uint8
            or tuple(tiles.shape) != (B, -(-Tq // TILE), -(-Tk // TILE))):
        raise ValueError("tiles: the uint8 map of backward_tile_map(m3), "
                         "given with a mask and only then")
    out = torch.empty(B, Tq, Hq, D, dtype=torch.float32, device=qb.device)
    lse = torch.empty(B, Hq, Tq, dtype=torch.float32, device=qb.device) \
        if want_lse else None
    rc = _build.lib().ggml_flash_attention(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), _build.ptr(m3),
        _build.ptr(slopes), _build.ptr(tiles), out.data_ptr(), _build.ptr(lse),
        B, Tq, Tk, Hq, Hkv, D, float(scale), float(softcap),
        _build.stream_ptr(qb))
    _build.check(rc, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out, lse


def _forward(q, k, v, mask, scale, max_bias, softcap, want_lse):
    """-> (the prepared inputs, the tile map or None, (out f32, lse or
    None)): on a CUDA tensor the map of a mask, then the kernel; the plain
    version on a CPU one."""
    prep = _prep(q, k, v, mask, max_bias)
    if q.device.type == "cpu":
        return prep, None, flash_attention_plain(*prep, scale, softcap,
                                                 want_lse)
    from .flash_backward import backward_tile_map
    tiles = None if prep[3] is None else backward_tile_map(prep[3])
    return prep, tiles, flash_attention_kernel(*prep, scale, softcap,
                                               want_lse, tiles=tiles)


class _FlashAttention(torch.autograd.Function):
    """flash_attention with lse, differentiable in q, k and v (no gradient
    for the mask). The backward reuses the forward's tile map."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, max_bias, softcap, out_dtype):
        prep, tiles, (out, lse) = _forward(q, k, v, mask, scale, max_bias,
                                           softcap, True)
        out = out.to(out_dtype)
        # a bf16 arena's read_kv view passes _prep as itself: keep an owned
        # copy, or the next layer's in-place KV write would change it
        qb, kb, vb = (t.clone() if t is src else t
                      for t, src in zip(prep[:3], (q, k, v)))
        ctx.save_for_backward(qb, kb, vb, *prep[3:], out, lse, tiles)
        ctx.cfg = (scale, softcap, q.dtype, k.dtype, v.dtype)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        from .flash_backward import backward_prepared
        scale, softcap, *dtypes = ctx.cfg
        qb, kb, vb, m3, slopes, out, lse, tiles = ctx.saved_tensors
        grads = backward_prepared(qb, kb, vb, m3, slopes, out, lse, do,
                                  scale, softcap, tiles)
        return (*(g.to(dt) for g, dt in zip(grads, dtypes)), None, None,
                None, None, None)


def flash_attention(q, k, v, mask=None, *, scale: float | None = None,
                    max_bias: float = 0.0, logit_softcap: float = 0.0,
                    out_dtype=None, want_lse: bool = False):
    """q (B, Tq, Hq, D), k/v (B, Tk, Hkv, D), mask additive, one of
    (B, 1, Tq, Tk), (B, Tq, Tk), (Tq, Tk); heads share it. Returns
    (B, Tq, Hq, D), and with want_lse also lse (B, Hq, Tq) = m + log(l)."""
    out_dtype = out_dtype or q.dtype
    scale = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, mask, scale,
                                         float(max_bias), float(logit_softcap),
                                         out_dtype)
    else:
        _, _, (out, lse) = _forward(q, k, v, mask, scale, max_bias,
                                    float(logit_softcap), want_lse)
        out = out.to(out_dtype)
    return (out, lse) if want_lse else out


def attention(q, k, v, mask=None, **kw):
    """Multi-token queries (prefill) take flash attention; a single-token
    query takes attention_xla, as the reference dispatches."""
    if q.shape[1] > 1:
        return flash_attention(q, k, v, mask, **kw)
    return attention_xla(q, k, v, mask, **kw)
