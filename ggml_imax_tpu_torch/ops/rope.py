"""Rotary position embeddings (counterpart of ggml_imax_tpu/ops/rope.py
`rope`, `rope_split` and `split_rope_permutation`) in ggml's normal mode
(GPT-J) and NeoX mode (LLaMA's half-split pairing), with linear scaling
(freq_scale). YaRN (ext_factor), xPos and GLM mode are not ported: they
raise.

Normal mode rotates ALL D/2 pairs (2i, 2i+1) with theta_scale =
freq_base^(-2/n_dims), also the pairs past n_dims: the reference ggml's own
behaviour (its rope cache fills theta over the whole row). NeoX mode
rotates pairs (i, i + n_dims/2) for i < n_dims/2 and passes the dims past
n_dims through; it applies freq_scale twice, once to the position and once
more to theta, the ggml quirk the reference reproduces.

x: (..., T, H, D); pos: int (..., T).
"""
from __future__ import annotations

import numpy as np
import torch

ROPE_MODE_NORMAL = 0
ROPE_MODE_NEOX = 2


def _tables(x, pos, n_pairs, n_dims, freq_base, freq_scale, pos_scale=1.0):
    # torch.full, not torch.tensor: no copy from the host, which a captured
    # decode step could not hold
    theta_scale = torch.full((), freq_base ** (-2.0 / n_dims),
                             dtype=torch.float32, device=x.device)
    i = torch.arange(n_pairs, dtype=torch.float32, device=x.device)
    p = pos.float()[..., None, None]                 # (..., T, 1, 1)
    if pos_scale != 1.0:
        p = p * pos_scale
    theta = p * theta_scale ** i
    if freq_scale != 1.0:
        theta = freq_scale * theta
    return torch.cos(theta), torch.sin(theta)


def _n_dims(x, n_dims):
    n_dims = n_dims or x.shape[-1]
    if n_dims % 2:
        raise ValueError("n_dims must be even")
    return n_dims


def rope(x, pos, n_dims: int | None = None, mode: int = ROPE_MODE_NORMAL, *,
         freq_base: float = 10000.0, freq_scale: float = 1.0,
         ext_factor: float = 0.0, xpos_base: float = 0.0):
    """Normal mode (0): pairs (2i, 2i+1) over the whole head. NeoX mode
    (2): pairs (i, i + n_dims/2), dims past n_dims unchanged."""
    if mode not in (ROPE_MODE_NORMAL, ROPE_MODE_NEOX):
        raise NotImplementedError(f"rope mode {mode} (GLM) is not ported")
    if ext_factor != 0.0 or xpos_base != 0.0:
        raise NotImplementedError("rope: YaRN and xPos are not ported")
    n_dims = _n_dims(x, n_dims)
    D = x.shape[-1]
    xf = x.float()
    if mode == ROPE_MODE_NEOX:
        h = n_dims // 2
        cos_t, sin_t = _tables(x, pos, h, n_dims, freq_base, freq_scale,
                               pos_scale=freq_scale)
        x0, x1 = xf[..., :h], xf[..., h:n_dims]
        out = torch.cat([x0 * cos_t - x1 * sin_t, x0 * sin_t + x1 * cos_t,
                         xf[..., n_dims:]], dim=-1)
        return out.to(x.dtype)
    cos_t, sin_t = _tables(x, pos, D // 2, n_dims, freq_base, freq_scale)
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x0 * cos_t - x1 * sin_t, x0 * sin_t + x1 * cos_t],
                      dim=-1).reshape(xf.shape)
    return out.to(x.dtype)


def rope_split(x, pos, n_dims: int | None = None, *,
               freq_base: float = 10000.0):
    """Normal mode on split-half data: pair i lives at lanes (i, D/2 + i).
    Equal to `rope` under split_rope_permutation."""
    D = x.shape[-1]
    cos_t, sin_t = _tables(x, pos, D // 2, _n_dims(x, n_dims), freq_base,
                           1.0)
    xf = x.float()
    x0, x1 = xf[..., : D // 2], xf[..., D // 2:]
    out = torch.cat([x0 * cos_t - x1 * sin_t, x0 * sin_t + x1 * cos_t], dim=-1)
    return out.to(x.dtype)


def split_rope_permutation(D: int) -> np.ndarray:
    """Column permutation taking interleaved pairs to split halves within
    one head: source column for target t is 2t (t < D/2) or 2(t-D/2)+1."""
    t = np.arange(D)
    return np.where(t < D // 2, 2 * t, 2 * (t - D // 2) + 1)
