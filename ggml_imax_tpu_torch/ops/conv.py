"""Convolution, pooling and resampling (counterpart of
ggml_imax_tpu/ops/conv.py): ggml_conv_1d / _2d, ggml_conv_transpose_1d,
ggml_conv_transpose_2d_p0, ggml_im2col, ggml_pool_1d / _2d, ggml_upscale,
ggml_pad and a bilinear resize. The reference computes every convolution
in f32 (lax.conv_general_dilated on f32 casts); no Pallas kernel computes
one, so these are torch's convolutions with cuDNN's TF32 off. Layouts are
ggml's reversed: NCW / NCHW, ggml's (s0, p0, d0) on the W axis and
(s1, p1, d1) on H.

`_resize_bilinear` is jax.image.resize's "bilinear" (the reference's
interpolate_bilinear, SAM's preprocess and mask upscale, YOLO's
letterbox): per resized axis one weight matrix, made as
jax.image.scale_and_translate makes it (half-pixel centres; on a
downscale the triangle kernel widened by the scale, so it antialiases;
weights renormalised at the edges). F.interpolate does not antialias and
its antialias=True is another kernel.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _cudnn_without_tf32():
    """cuDNN may run an f32 convolution in TF32 (10-bit mantissas) while
    torch.backends.cudnn.allow_tf32 is True, its default. This sets the
    flag to False for the block only and puts the caller's value back
    after it, so the convolution is f32 as the reference's is and no
    global setting outlives the call."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def conv_1d(x, w, s0: int = 1, p0: int = 0, d0: int = 1):
    """x: (N, Cin, W), w: (Cout, Cin, K) -> (N, Cout, OW) f32."""
    with _cudnn_without_tf32():
        return F.conv1d(x.float(), w.float(), stride=s0, padding=p0,
                        dilation=d0)


def conv_2d(x, w, s0: int = 1, s1: int = 1, p0: int = 0, p1: int = 0,
            d0: int = 1, d1: int = 1):
    """x: (N, Cin, H, W), w: (Cout, Cin, KH, KW) -> (N, Cout, OH, OW) f32."""
    with _cudnn_without_tf32():
        return F.conv2d(x.float(), w.float(), stride=(s1, s0),
                        padding=(p1, p0), dilation=(d1, d0))


def conv_transpose_1d(x, w, s0: int = 1, p0: int = 0, d0: int = 1):
    """x: (N, Cin, W), w: (Cin, Cout, K) -> (N, Cout, OW), OW =
    (W - 1) s0 - 2 p0 + d0 (K - 1) + 1."""
    with _cudnn_without_tf32():
        return F.conv_transpose1d(x.float(), w.float(), stride=s0,
                                  padding=p0, dilation=d0)


def conv_transpose_2d_p0(x, w, stride: int):
    """x: (N, Cin, H, W), w: (Cin, Cout, KH, KW), no padding."""
    with _cudnn_without_tf32():
        return F.conv_transpose2d(x.float(), w.float(), stride=stride)


def im2col(x, kh: int, kw: int, s0: int = 1, s1: int = 1, p0: int = 0,
           p1: int = 0, d0: int = 1, d1: int = 1):
    """ggml_im2col 2-D: x (N, Cin, H, W) -> (N, OH, OW, Cin*KH*KW) f32
    patches in (Cin, KH, KW) order, so conv == patches @ w.reshape(Cout,
    -1).T."""
    n, c, h, wdt = x.shape
    oh = (h + 2 * p1 - d1 * (kh - 1) - 1) // s1 + 1
    ow = (wdt + 2 * p0 - d0 * (kw - 1) - 1) // s0 + 1
    cols = F.unfold(x.float(), (kh, kw), dilation=(d1, d0),
                    padding=(p1, p0), stride=(s1, s0))
    return cols.reshape(n, c * kh * kw, oh, ow).permute(0, 2, 3, 1)


def pool_1d(x, op: str, k0: int, s0: int, p0: int = 0):
    """x: (N, C, W); op 'max' or 'avg'."""
    return _pool(x.unsqueeze(-2), op, (1, k0), (1, s0), (0, p0)).squeeze(-2)


def pool_2d(x, op: str, k0: int, k1: int, s0: int, s1: int,
            p0: int = 0, p1: int = 0):
    """x: (N, C, H, W); (k0, s0, p0) on W, (k1, s1, p1) on H."""
    return _pool(x, op, (k1, k0), (s1, s0), (p1, p0))


def _pool(x, op, k, s, p):
    """Over the last two axes: padded by p with -inf (max) or 0 (avg) at
    any width (F.max_pool2d refuses a pad over k/2, so the pad comes
    first), then pooled with none; avg divides the window's sum by the
    whole window."""
    if op not in ("max", "avg"):
        raise ValueError(op)
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    xf = x.float().reshape(-1, 1, h, w)
    xf = F.pad(xf, (p[1], p[1], p[0], p[0]),
               value=float("-inf") if op == "max" else 0.0)
    if op == "max":
        out = F.max_pool2d(xf, k, s)
    else:
        out = F.avg_pool2d(xf, k, s, divisor_override=1) / float(k[0] * k[1])
    return out.reshape(*lead, *out.shape[-2:])


def upscale(x, scale: int):
    """Nearest-neighbour integer upscale of the two innermost axes: each
    element repeated `scale` times along H and along W."""
    return x.repeat_interleave(scale, dim=-2).repeat_interleave(scale, dim=-1)


def interpolate_bilinear(x, oh: int, ow: int, align_corners: bool = False):
    """Bilinear resize of (N, C, H, W) to (N, C, oh, ow). align_corners is
    ignored, as the reference ignores it (jax.image.resize has no such
    option)."""
    return _resize_bilinear(x, tuple(x.shape[:-2]) + (oh, ow))


def pad(x, *widths):
    """ggml_pad: zeros after the end of each axis; widths innermost axis
    first (p0 on the last axis)."""
    cfg = []
    for wdt in widths:
        cfg += [0, wdt]
    return F.pad(x, cfg)


_EPS32 = float(np.finfo(np.float32).eps)


def _resize_weights(m: int, n: int, device) -> torch.Tensor:
    """(m, n) f32 weights taking an axis of m samples to n, as
    jax.image.compute_weight_mat makes them for the triangle kernel with
    antialias and no translation, in f32 and in its order of operations."""
    inv_scale = 1.0 / (n / m)
    f32 = dict(dtype=torch.float32, device=device)
    kernel_scale = torch.full((), max(inv_scale, 1.0), **f32)
    sample_f = (torch.arange(n, **f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(m, **f32)[:, None]).abs() \
        / kernel_scale
    weights = torch.clamp(1 - x.abs(), min=0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * _EPS32,
        weights / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def _resize_bilinear(x, shape):
    """jax.image.resize(x, shape, "bilinear") for a float x: each axis whose
    size changes is contracted with its weight matrix (an axis that keeps
    its size is left as it is, as the reference skips it)."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} for a tensor of rank {x.ndim}")
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m != n:
            w = _resize_weights(m, n, x.device).to(x.dtype)
            # contiguous: a matmul over a strided batch takes a slow path
            x = torch.movedim(torch.movedim(x, d, -1).contiguous() @ w, -1, d)
    return x
