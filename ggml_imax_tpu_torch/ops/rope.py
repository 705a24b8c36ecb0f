"""Rotary position embeddings (counterpart of ggml_imax_tpu/ops/rope.py
`rope`, `rope_split` and `split_rope_permutation`) with the reference's
whole parameter surface: ggml's normal mode (GPT-J), NeoX mode (LLaMA's
half-split pairing) and GLM mode, linear scaling (freq_scale), YaRN
(ext_factor, attn_factor, beta_fast/slow, n_orig_ctx), xPos (xpos_base,
xpos_down) and the backward rotation (forward=False).

Normal mode rotates ALL D/2 pairs (2i, 2i+1) with theta_scale =
freq_base^(-2/n_dims), also the pairs past n_dims: the reference ggml's own
behaviour (its rope cache fills theta over the whole row), with YaRN ramp
index 2i. NeoX mode rotates pairs (i, i + n_dims/2) for i < n_dims/2 and
passes the dims past n_dims through; it applies freq_scale twice, once to
the position and once more to theta, and its YaRN ramp index is -2i/n_dims:
the ggml quirks the reference reproduces. GLM mode rotates the four
quarters of the head as two pairs of halves, the first by min(p, n_ctx - 2)
and the second by the block position max(p - (n_ctx - 2), 0).

A factor that is exactly 1 (freq_scale, attn_factor, xPos's zeta) is not
multiplied in: x * 1.0 is x, so the result is the same bit for bit, and a
decode step launches no kernel for it.

x: (..., T, H, D); pos: int (..., T).
"""
from __future__ import annotations

import math

import numpy as np
import torch

ROPE_MODE_NORMAL = 0
ROPE_MODE_NEOX = 2
ROPE_MODE_GLM = 4


def yarn_corr_dims(n_dims: int, n_orig_ctx: int, freq_base: float,
                   beta_fast: float, beta_slow: float) -> tuple[float, float]:
    def corr_dim(n_rot):
        return n_dims * math.log(n_orig_ctx / (n_rot * 2 * math.pi)) / (
            2 * math.log(freq_base))
    start = math.floor(corr_dim(beta_fast))
    end = math.ceil(corr_dim(beta_slow))
    return max(0.0, start), min(n_dims - 1.0, end)


def _rope_yarn(theta_extrap, freq_scale, corr_lo, corr_hi, ramp_idx,
               ext_factor, mscale):
    """(cos, sin) with YaRN's mix of interpolated and extrapolated theta."""
    theta_interp = theta_extrap if freq_scale == 1.0 \
        else freq_scale * theta_extrap
    if ext_factor != 0.0:
        y = (ramp_idx / 2.0 - corr_lo) / max(0.001, corr_hi - corr_lo)
        ramp = (1.0 - torch.clamp(y, 0.0, 1.0)) * ext_factor
        theta = theta_interp * (1 - ramp) + theta_extrap * ramp
        mscale = mscale * (1.0 + 0.1 * math.log(1.0 / freq_scale))
    else:
        theta = theta_interp
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    if mscale != 1.0:
        cos_t, sin_t = cos_t * mscale, sin_t * mscale
    return cos_t, sin_t


def _theta_scale(x, n_dims, freq_base):
    # torch.full, not torch.tensor: no copy from the host, which a captured
    # decode step could not hold
    return torch.full((), freq_base ** (-2.0 / n_dims), dtype=torch.float32,
                      device=x.device)


def _setup(x, pos, n_dims, n_orig_ctx, n_ctx):
    n_dims = n_dims or x.shape[-1]
    if n_dims % 2:
        raise ValueError("n_dims must be even")
    n_orig_ctx = n_orig_ctx or n_ctx or 2048
    return n_dims, n_orig_ctx, x.float(), pos.float()[..., None, None]


def _normal_mode_setup(x, pos, n_dims, *, freq_base, freq_scale, ext_factor,
                       attn_factor, beta_fast, beta_slow, n_orig_ctx, n_ctx,
                       xpos_base, xpos_down, forward):
    """The one normal-mode preamble of rope() and rope_split(), so
    P(rope(x)) == rope_split(P(x)) cannot drift: (x in f32, and cos, sin
    and zeta (None for 1) of pair i over the whole head, YaRN ramp index
    2i)."""
    n_dims, n_orig_ctx, xf, p = _setup(x, pos, n_dims, n_orig_ctx, n_ctx)
    corr_lo, corr_hi = yarn_corr_dims(n_dims, n_orig_ctx, freq_base,
                                      beta_fast, beta_slow)
    D = x.shape[-1]
    i = torch.arange(D // 2, dtype=torch.float32, device=x.device)
    theta_extrap = p * _theta_scale(x, n_dims, freq_base) ** i
    cos_t, sin_t = _rope_yarn(theta_extrap, freq_scale, corr_lo, corr_hi,
                              2.0 * i, ext_factor, attn_factor)
    if not forward:
        sin_t = -sin_t
    zeta = None
    if xpos_base != 0.0:
        zeta = ((2.0 * i + 0.4 * D) / (1.4 * D)) ** (p / xpos_base)
        if xpos_down:
            zeta = 1.0 / zeta
    return xf, cos_t, sin_t, zeta


def _rotate(x0, x1, cos_t, sin_t, zeta):
    """(x0 cos - x1 sin, x0 sin + x1 cos), each product times zeta as the
    reference associates it."""
    if zeta is None:
        return x0 * cos_t - x1 * sin_t, x0 * sin_t + x1 * cos_t
    return (x0 * cos_t * zeta - x1 * sin_t * zeta,
            x0 * sin_t * zeta + x1 * cos_t * zeta)


def rope(x, pos, n_dims: int | None = None, mode: int = ROPE_MODE_NORMAL, *,
         freq_base: float = 10000.0, freq_scale: float = 1.0,
         ext_factor: float = 0.0, attn_factor: float = 1.0,
         beta_fast: float = 32.0, beta_slow: float = 1.0,
         n_orig_ctx: int = 0, n_ctx: int = 0,
         xpos_base: float = 0.0, xpos_down: bool = False,
         forward: bool = True):
    """Apply RoPE. n_dims defaults to the head dim; NeoX mode passes the
    dims past n_dims through unchanged."""
    D = x.shape[-1]
    if mode & ROPE_MODE_GLM:
        n_dims, _, xf, p = _setup(x, pos, n_dims, n_orig_ctx, n_ctx)
        theta_b = torch.clamp(p, max=n_ctx - 2)
        block_theta = torch.clamp(p - (n_ctx - 2), min=0.0)
        i = torch.arange(D // 4, dtype=torch.float32, device=x.device)
        scales = _theta_scale(x, n_dims, freq_base) ** i
        th, bth = theta_b * scales, block_theta * scales
        sign = 1.0 if forward else -1.0
        cos_t, sin_t = torch.cos(th), torch.sin(th) * sign
        cos_b, sin_b = torch.cos(bth), torch.sin(bth) * sign
        q = D // 4
        x0, x1 = xf[..., 0:q], xf[..., q:2 * q]
        x2, x3 = xf[..., 2 * q:3 * q], xf[..., 3 * q:]
        out = torch.cat([x0 * cos_t - x1 * sin_t, x0 * sin_t + x1 * cos_t,
                         x2 * cos_b - x3 * sin_b, x2 * sin_b + x3 * cos_b],
                        dim=-1)
        return out.to(x.dtype)
    if mode & ROPE_MODE_NEOX:
        n_dims, n_orig_ctx, xf, p = _setup(x, pos, n_dims, n_orig_ctx, n_ctx)
        corr_lo, corr_hi = yarn_corr_dims(n_dims, n_orig_ctx, freq_base,
                                          beta_fast, beta_slow)
        h = n_dims // 2
        j = torch.arange(h, dtype=torch.float32, device=x.device)
        # the reference: theta_base *= freq_scale once, then rope_yarn
        # scales it again
        if freq_scale != 1.0:
            p = p * freq_scale
        theta_extrap = p * _theta_scale(x, n_dims, freq_base) ** j
        cos_t, sin_t = _rope_yarn(theta_extrap, freq_scale, corr_lo, corr_hi,
                                  (-2.0 * j) / n_dims, ext_factor,
                                  attn_factor)
        if not forward:
            sin_t = -sin_t
        x0, x1 = xf[..., :h], xf[..., h:n_dims]
        r0, r1 = _rotate(x0, x1, cos_t, sin_t, None)
        return torch.cat([r0, r1, xf[..., n_dims:]], dim=-1).to(x.dtype)
    xf, cos_t, sin_t, zeta = _normal_mode_setup(
        x, pos, n_dims, freq_base=freq_base, freq_scale=freq_scale,
        ext_factor=ext_factor, attn_factor=attn_factor, beta_fast=beta_fast,
        beta_slow=beta_slow, n_orig_ctx=n_orig_ctx, n_ctx=n_ctx,
        xpos_base=xpos_base, xpos_down=xpos_down, forward=forward)
    r0, r1 = _rotate(xf[..., 0::2], xf[..., 1::2], cos_t, sin_t, zeta)
    return torch.stack([r0, r1], dim=-1).reshape(xf.shape).to(x.dtype)


def rope_split(x, pos, n_dims: int | None = None, *,
               freq_base: float = 10000.0, freq_scale: float = 1.0,
               ext_factor: float = 0.0, attn_factor: float = 1.0,
               beta_fast: float = 32.0, beta_slow: float = 1.0,
               n_orig_ctx: int = 0, n_ctx: int = 0,
               xpos_base: float = 0.0, xpos_down: bool = False,
               forward: bool = True):
    """Normal mode on split-half data: pair i lives at lanes (i, D/2 + i).
    Equal to `rope(mode=0)` under split_rope_permutation, bit for bit: the
    same tables and the same association of the products."""
    xf, cos_t, sin_t, zeta = _normal_mode_setup(
        x, pos, n_dims, freq_base=freq_base, freq_scale=freq_scale,
        ext_factor=ext_factor, attn_factor=attn_factor, beta_fast=beta_fast,
        beta_slow=beta_slow, n_orig_ctx=n_orig_ctx, n_ctx=n_ctx,
        xpos_base=xpos_base, xpos_down=xpos_down, forward=forward)
    D = x.shape[-1]
    r0, r1 = _rotate(xf[..., : D // 2], xf[..., D // 2:], cos_t, sin_t, zeta)
    return torch.cat([r0, r1], dim=-1).to(x.dtype)


def split_rope_permutation(D: int) -> np.ndarray:
    """Column permutation taking interleaved pairs to split halves within
    one head: source column for target t is 2t (t < D/2) or 2(t-D/2)+1."""
    t = np.arange(D)
    return np.where(t < D // 2, 2 * t, 2 * (t - D // 2) + 1)
