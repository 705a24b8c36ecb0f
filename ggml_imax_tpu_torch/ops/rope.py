"""Rotary position embeddings in ggml's normal mode (counterpart of
ggml_imax_tpu/ops/rope.py `rope(mode=0)`, `rope_split` and
`split_rope_permutation`, at the defaults GPT-J uses: no YaRN, no xPos).

Both applications rotate ALL D/2 pairs with theta_scale =
freq_base^(-2/n_dims), also the pairs past n_dims: the reference ggml's
own behaviour (its rope cache fills theta over the whole row).

x: (..., T, H, D); pos: int (..., T).
"""
from __future__ import annotations

import numpy as np
import torch


def _tables(x, pos, n_dims, freq_base):
    D = x.shape[-1]
    n_dims = n_dims or D
    if n_dims % 2:
        raise ValueError("n_dims must be even")
    # torch.full, not torch.tensor: no copy from the host, which a captured
    # decode step could not hold
    theta_scale = torch.full((), freq_base ** (-2.0 / n_dims),
                             dtype=torch.float32, device=x.device)
    i = torch.arange(D // 2, dtype=torch.float32, device=x.device)
    p = pos.float()[..., None, None]                 # (..., T, 1, 1)
    theta = p * theta_scale ** i
    return torch.cos(theta), torch.sin(theta)


def rope(x, pos, n_dims: int | None = None, *, freq_base: float = 10000.0):
    """Normal (interleaved) mode: pairs (2i, 2i+1)."""
    cos_t, sin_t = _tables(x, pos, n_dims, freq_base)
    xf = x.float()
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x0 * cos_t - x1 * sin_t, x0 * sin_t + x1 * cos_t],
                      dim=-1).reshape(xf.shape)
    return out.to(x.dtype)


def rope_split(x, pos, n_dims: int | None = None, *,
               freq_base: float = 10000.0):
    """Normal mode on split-half data: pair i lives at lanes (i, D/2 + i).
    Equal to `rope` under split_rope_permutation."""
    cos_t, sin_t = _tables(x, pos, n_dims, freq_base)
    xf = x.float()
    D = x.shape[-1]
    x0, x1 = xf[..., : D // 2], xf[..., D // 2:]
    out = torch.cat([x0 * cos_t - x1 * sin_t, x0 * sin_t + x1 * cos_t], dim=-1)
    return out.to(x.dtype)


def split_rope_permutation(D: int) -> np.ndarray:
    """Column permutation taking interleaved pairs to split halves within
    one head: source column for target t is 2t (t < D/2) or 2(t-D/2)+1."""
    t = np.arange(D)
    return np.where(t < D // 2, 2 * t, 2 * (t - D // 2) + 1)
