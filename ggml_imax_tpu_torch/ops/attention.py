"""Reference attention (counterpart of ggml_imax_tpu/ops/attention.py
`attention_xla` and `causal_mask`): QK^T -> masked softmax -> V with GQA
broadcast, additive mask, ALiBi and logit soft-capping. Plain PyTorch; it
is also the decode (Tq == 1) branch of ops/flash_attention.attention."""
from __future__ import annotations

import math

import torch

from .._device import resolve_device
from .softmax import alibi_slopes


def attention_xla(q, k, v, mask=None, *, scale: float | None = None,
                  max_bias: float = 0.0, logit_softcap: float = 0.0,
                  out_dtype=None):
    """q (B, Tq, Hq, D), k/v (B, Tk, Hkv, D), mask additive and
    broadcastable to (B, Hq, Tq, Tk). Operands stay in q's dtype, sums are
    f32. Fully masked rows give 0, not NaN. Returns (B, Tq, Hq, D)."""
    B, Tq, Hq, D = q.shape
    Hkv = k.shape[2]
    out_dtype = out_dtype or q.dtype
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    rep = Hq // Hkv
    qf = q.transpose(1, 2).float()                      # (B, Hq, Tq, D)
    kf = k.to(q.dtype).transpose(1, 2)
    vf = v.to(q.dtype).transpose(1, 2)
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=1)
        vf = vf.repeat_interleave(rep, dim=1)
    s = (qf @ kf.float().transpose(-1, -2)) * scale
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    if mask is not None:
        m = mask.float()
        if max_bias > 0.0:
            slopes = torch.as_tensor(alibi_slopes(Hq, max_bias),
                                     device=q.device).reshape(1, Hq, 1, 1)
            m = slopes * m
        s = s + m
    mx = torch.clamp(s.amax(dim=-1, keepdim=True), min=-0.7e38)
    e = torch.exp(s - mx)
    e = torch.where(torch.isneginf(s), torch.zeros_like(e), e)
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    o = p.to(vf.dtype).float() @ vf.float()
    return o.transpose(1, 2).to(out_dtype)


def causal_mask(t_q: int, t_k: int, n_past: int, dtype=torch.float32,
                device=None):
    """Additive causal mask for a query block starting at position n_past
    attending over t_k cached keys: (t_q, t_k), 0 where visible, -inf
    elsewhere, on `device` (the card unless "cpu")."""
    dev = resolve_device(device)
    q_pos = torch.arange(t_q, device=dev)[:, None] + n_past
    k_pos = torch.arange(t_k, device=dev)[None, :]
    return torch.where(k_pos <= q_pos, 0.0, float("-inf")).to(dtype)
