"""soft_max_ext (counterpart of ggml_imax_tpu/ops/softmax.py): ggml's fused
scale + mask + ALiBi softmax, out = softmax(x * scale + slope(head) *
mask), computed in f32; -inf lanes give exact zeros and a fully masked row
gives zeros, not NaN. `alibi_slopes` lives here and nowhere else."""
from __future__ import annotations

import numpy as np
import torch


def alibi_slopes(n_head: int, max_bias: float) -> np.ndarray:
    """Per-head ALiBi slopes (ggml's formula)."""
    if max_bias <= 0.0:
        return np.ones(n_head, dtype=np.float32)
    n_head_log2 = 1 << int(np.floor(np.log2(n_head)))
    m0 = 2.0 ** (-max_bias / n_head_log2)
    m1 = 2.0 ** (-max_bias / 2.0 / n_head_log2)
    h = np.arange(n_head)
    return np.where(h < n_head_log2, m0 ** (h + 1),
                    m1 ** (2 * (h - n_head_log2) + 1)).astype(np.float32)


def soft_max_ext(x, mask=None, scale: float = 1.0, max_bias: float = 0.0,
                 head_axis: int = -3):
    """x: (..., H, Tq, Tk) scores; mask of rank x.ndim - 1 (..., Tq, Tk),
    or broadcastable to x at full rank. The result has x's dtype."""
    xf = x.float() * scale
    if mask is not None:
        m = mask.float()
        if max_bias > 0.0:
            n_head = x.shape[head_axis]
            shape = [1] * x.ndim
            shape[head_axis] = n_head
            slopes = torch.from_numpy(alibi_slopes(n_head, max_bias)).to(
                x.device).reshape(shape)
            m = slopes * (m[..., None, :, :] if m.ndim == x.ndim - 1 else m)
        xf = xf + m
    mx = xf.amax(dim=-1, keepdim=True)
    e = torch.exp(xf - mx)
    e = torch.where(torch.isneginf(xf), torch.zeros_like(e), e)
    s = e.sum(dim=-1, keepdim=True)
    return (e / torch.clamp(s, min=1e-30)).to(x.dtype)
