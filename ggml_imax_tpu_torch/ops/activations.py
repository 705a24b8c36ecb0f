"""Activations (counterpart of ggml_imax_tpu/ops/activations.py), evaluated
in f32: ggml's GELU is the tanh form; SiLU is x / (1 + exp(-x))."""
from __future__ import annotations

import math

import torch

SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
GELU_COEF_A = 0.044715


def gelu(x):
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(
        SQRT_2_OVER_PI * xf * (1.0 + GELU_COEF_A * xf * xf)))
    return y.to(x.dtype)


def silu(x):
    xf = x.float()
    return (xf / (1.0 + torch.exp(-xf))).to(x.dtype)
