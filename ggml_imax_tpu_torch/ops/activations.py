"""Unary activations (counterpart of ggml_imax_tpu/ops/activations.py,
ggml's enum ggml_unary_op). ggml's GELU is the tanh form; SiLU is
x / (1 + exp(-x)). The dtype rule is the reference's: gelu, gelu_quick,
silu, hardswish and hardsigmoid compute in f32 and return x's dtype; the
others compute in x's dtype."""
from __future__ import annotations

import math

import torch

SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
GELU_COEF_A = 0.044715
GELU_QUICK_COEF = -1.702


def gelu(x):
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(
        SQRT_2_OVER_PI * xf * (1.0 + GELU_COEF_A * xf * xf)))
    return y.to(x.dtype)


def gelu_quick(x):
    xf = x.float()
    return (xf * (1.0 / (1.0 + torch.exp(GELU_QUICK_COEF * xf)))).to(x.dtype)


def silu(x):
    xf = x.float()
    return (xf / (1.0 + torch.exp(-xf))).to(x.dtype)


def relu(x):
    return torch.clamp(x, min=0)


def leaky_relu(x, negative_slope: float = 0.1):
    return torch.where(x > 0, x, x * negative_slope)


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def elu(x):
    """x for x > 0, else expm1(x) (alpha 1)."""
    pos = x > 0
    return torch.where(pos, x, torch.expm1(torch.where(pos, 0, x)))


def hardswish(x):
    xf = x.float()
    return (xf * torch.clamp(xf / 6.0 + 0.5, 0.0, 1.0)).to(x.dtype)


def hardsigmoid(x):
    xf = x.float()
    return torch.clamp(xf / 6.0 + 0.5, 0.0, 1.0).to(x.dtype)


def abs_(x):
    return torch.abs(x)


def sgn(x):
    return torch.sign(x)


def neg(x):
    return -x


def step(x):
    return (x > 0).to(x.dtype)


def relu_squared(x):
    r = torch.clamp(x, min=0)
    return r * r
