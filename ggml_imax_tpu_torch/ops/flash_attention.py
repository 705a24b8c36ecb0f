"""Flash-attention forward (counterpart of
ggml_imax_tpu/ops/flash_attention.py `flash_attention` and the `attention`
dispatcher; kernel in csrc/flash_attention.cu).

Masks use the finite NEG = -0.7 * f32max instead of -inf, so fully masked
(padding) rows give 0, not NaN; q, k and v enter the kernel as bf16 and the
softmax and sums are f32.

Differentiable (the counterpart of the reference's `_fa` custom VJP): when
q, k or v requires grad, the forward also writes lse and the backward runs
ops/flash_backward.py. Otherwise the forward launches exactly what an
inference call launches.
"""
from __future__ import annotations

import math

import torch

from .. import _build
from .attention import alibi_slopes, attention_xla
from .decode_attention import NEG


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


def flash_attention_plain(qb, kb, vb, m3, slopes, scale, softcap, want_lse):
    """Plain version on the prepared inputs: bf16 q/k/v (B, T, H, D), m3
    (B, Tq, Tk) f32 >= NEG or None, slopes (Hq) or None. Returns out
    (B, Tq, Hq, D) f32 and lse (B, Hq, Tq) f32 (or None)."""
    Hq, Hkv = qb.shape[2], kb.shape[2]
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
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = (p.to(torch.bfloat16).float() @ vf) / l
    lse = (m + torch.log(l))[..., 0] if want_lse else None
    return out.transpose(1, 2), lse


def flash_attention_kernel(qb, kb, vb, m3, slopes, scale, softcap, want_lse):
    """Launch csrc/flash_attention.cu on the prepared inputs."""
    B, Tq, Hq, D = qb.shape
    Tk, Hkv = kb.shape[1], kb.shape[2]
    if D % 16 or D > 256:
        raise ValueError(f"flash_attention kernel: head dim {D}")
    out = torch.empty(B, Tq, Hq, D, dtype=torch.float32, device=qb.device)
    lse = torch.empty(B, Hq, Tq, dtype=torch.float32, device=qb.device) \
        if want_lse else None
    rc = _build.lib().ggml_flash_attention(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), _build.ptr(m3),
        _build.ptr(slopes), out.data_ptr(), _build.ptr(lse), B, Tq, Tk, Hq,
        Hkv, D, float(scale), float(softcap), _build.stream_ptr(qb))
    _build.check(rc, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out, lse


def _forward(q, k, v, mask, scale, max_bias, softcap, want_lse):
    """-> (the prepared inputs, (out f32, lse or None)): the kernel on a
    CUDA tensor, the plain version on a CPU one."""
    prep = _prep(q, k, v, mask, max_bias)
    fn = flash_attention_plain if q.device.type == "cpu" \
        else flash_attention_kernel
    return prep, fn(*prep, scale, softcap, want_lse)


class _FlashAttention(torch.autograd.Function):
    """flash_attention with lse, differentiable in q, k and v (no gradient
    for the mask)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, max_bias, softcap, out_dtype):
        prep, (out, lse) = _forward(q, k, v, mask, scale, max_bias, softcap,
                                    True)
        out = out.to(out_dtype)
        # a bf16 arena's read_kv view passes _prep as itself: keep an owned
        # copy, or the next layer's in-place KV write would change it
        qb, kb, vb = (t.clone() if t is src else t
                      for t, src in zip(prep[:3], (q, k, v)))
        ctx.save_for_backward(qb, kb, vb, *prep[3:], out, lse)
        ctx.cfg = (scale, softcap, q.dtype, k.dtype, v.dtype)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        from .flash_backward import backward_prepared
        scale, softcap, *dtypes = ctx.cfg
        qb, kb, vb, m3, slopes, out, lse = ctx.saved_tensors
        grads = backward_prepared(qb, kb, vb, m3, slopes, out, lse, do,
                                  scale, softcap)
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
        _, (out, lse) = _forward(q, k, v, mask, scale, max_bias,
                                 float(logit_softcap), want_lse)
        out = out.to(out_dtype)
    return (out, lse) if want_lse else out


def attention(q, k, v, mask=None, **kw):
    """Multi-token queries (prefill) take flash attention; a single-token
    query takes attention_xla, as the reference dispatches."""
    if q.shape[1] > 1:
        return flash_attention(q, k, v, mask, **kw)
    return attention_xla(q, k, v, mask, **kw)
