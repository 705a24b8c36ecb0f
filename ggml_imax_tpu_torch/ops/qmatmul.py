"""Quantized matrix multiplication dispatch (counterpart of
ggml_imax_tpu/ops/qmatmul.py).

`qmatmul` sends repacked weights (natpair, nat8, and the permuted planes,
row-pair and u-order int8 layouts) whose N is a multiple of 128 to the
hand-written kernels (ops/qmm.py) — the reference's fused-path gate — and
everything else through a plain dequantize + matmul, the role XLA played
in the JAX package. The codebook layouts of the IQ2 and IQ3 formats (nib2,
nib4 with a lut) always take the plain route, as they take XLA's in the
JAX package: no Pallas kernel computes them. Where XLA fuses their
expansion into the dot, reading the weight at its packed width, this route
writes a (K, N) copy of the weight in the compute dtype at every product.

The kernel routes are differentiable in x (the counterpart of the
reference's `_qmm_fused` VJP): dx = bf16(dy) @ dequantize(W, bf16)^T with
f32 sums. Quantized weights are frozen and get no gradient. The plain route
is ordinary torch ops.
"""
from __future__ import annotations

import torch

from ..quant.device import QTensor, codebook_q
from .qmm import natural_q, qmatmul_nat8, qmatmul_natpair, qmatmul_permuted


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Expand a QTensor to a dense (K, N) tensor in `dtype` (counterpart of
    dequantize_xla: every nib4 and int8 layout, the codebook layouts, and
    dense)."""
    if qt.kind == "dense":
        return qt.q.to(dtype)
    n_groups = qt.scale.shape[0]
    q = codebook_q(qt) if qt.lut is not None else natural_q(qt)
    w = q.reshape(n_groups, qt.k // n_groups, qt.n).to(dtype) \
        * qt.scale.to(dtype)[:, None, :]
    if qt.bias is not None:
        w = w + qt.bias.to(dtype)[:, None, :]
    return w.reshape(qt.k, qt.n)


class _KernelRoute(torch.autograd.Function):
    """route(x, qt) with the dequantized-weight VJP for x."""

    @staticmethod
    def forward(ctx, x, qt, route):
        ctx.qt, ctx.x_dtype = qt, x.dtype
        return route(x, qt)

    @staticmethod
    def backward(ctx, dy):
        w = dequantize(ctx.qt, dtype=torch.bfloat16)
        dx = dy.to(torch.bfloat16).float() @ w.float().T
        return dx.to(ctx.x_dtype), None, None


def _kernel_route(x, qt, route):
    if torch.is_grad_enabled() and x.requires_grad:
        return _KernelRoute.apply(x, qt, route)
    return route(x, qt)


def qmatmul(x: torch.Tensor, qt: QTensor, *, compute_dtype=torch.bfloat16,
            out_dtype=None) -> torch.Tensor:
    """x @ dequant(W): x (..., K) -> (..., N). Repacked weights with
    N % 128 == 0 take the kernels: natpair and nat8 W4A8 / W8A8 at m == 1,
    W4A16 / W8A16 above; the planes, row-pair and u-order int8 layouts
    W4A16 / W8A16 at every m. Others dequantize to `compute_dtype` and
    multiply with f32 accumulation."""
    out_dtype = out_dtype or x.dtype
    if qt.n % 128 == 0 and qt.interleaved_bk > 0 and qt.lut is None:
        route = {("nib4", 3): qmatmul_natpair, ("int8", 4): qmatmul_nat8,
                 ("nib4", 0): qmatmul_permuted, ("nib4", 1): qmatmul_permuted,
                 ("int8", 2): qmatmul_permuted}.get((qt.kind, qt.q4_layout))
        if route is not None:
            return _kernel_route(x, qt, route).to(out_dtype)
    w = dequantize(qt, dtype=compute_dtype)
    y = x.to(compute_dtype).float() @ w.float()
    return y.to(out_dtype)
