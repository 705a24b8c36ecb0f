"""Normalization (counterpart of ggml_imax_tpu/ops/norms.py), computed in
f32 whatever the input dtype."""
from __future__ import annotations

import torch

GGML_EPS_DEFAULT = 1e-5


def layer_norm(x, weight=None, bias=None, eps: float = GGML_EPS_DEFAULT):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm(x, weight=None, eps: float = GGML_EPS_DEFAULT):
    """x / sqrt(mean(x^2) + eps), times weight: the reciprocal of the
    square root, as the reference computes it."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(ms + eps))
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def group_norm(x, n_groups: int, eps: float = GGML_EPS_DEFAULT):
    """ggml's group_norm over (channels of a group, spatial), no affine: x
    laid out as ggml's conv tensors, (..., C, S) with S = H * W."""
    xf = x.float()
    *lead, c, s = xf.shape
    g = xf.reshape(*lead, n_groups, c // n_groups * s)
    mean = g.mean(dim=-1, keepdim=True)
    var = ((g - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (g - mean) / torch.sqrt(var + eps)
    return y.reshape(*lead, c, s).to(x.dtype)
