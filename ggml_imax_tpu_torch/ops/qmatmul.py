"""Quantized matrix multiplication dispatch (counterpart of
ggml_imax_tpu/ops/qmatmul.py).

`qmatmul` sends natpair and nat8 weights whose N is a multiple of 128 to
the hand-written kernels (ops/qmm.py) — the reference's fused-path gate —
and everything else through a plain dequantize + matmul, the role XLA
played in the JAX package.

The kernel routes are differentiable in x (the counterpart of the
reference's `_qmm_fused` VJP): dx = bf16(dy) @ dequantize(W, bf16)^T with
f32 sums. Quantized weights are frozen and get no gradient. The plain route
is ordinary torch ops.
"""
from __future__ import annotations

import torch

from ..quant.device import QTensor
from .qmm import qmatmul_nat8, qmatmul_natpair, unpack_natpair


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Expand a QTensor to a dense (K, N) tensor in `dtype` (counterpart of
    dequantize_xla: natpair and natural plane-split nib4, natural and
    nat8 int8, dense)."""
    if qt.kind == "dense":
        return qt.q.to(dtype)
    if qt.lut is not None or qt.kind not in ("nib4", "int8"):
        raise NotImplementedError(f"dequantize: {qt.kind} with lut")
    n_groups = qt.scale.shape[0]
    group = qt.k // n_groups
    if qt.kind == "int8":
        if qt.q4_layout not in (0, 4):        # nat8 rows are natural
            raise NotImplementedError(f"dequantize: int8 layout {qt.q4_layout}")
        q = qt.q
    elif qt.q4_layout == 3:
        q = unpack_natpair(qt.q)
    elif qt.q4_layout == 0 and qt.interleaved_bk == 0:
        g = qt.q.reshape(qt.k // 32, 16, qt.n)
        q = torch.cat([(g & 0x0F).to(torch.int8) - qt.zero,
                       (g >> 4).to(torch.int8) - qt.zero],
                      dim=1).reshape(qt.k, qt.n)
    else:
        raise NotImplementedError(
            f"dequantize: nib4 layout {qt.q4_layout}/{qt.interleaved_bk}")
    w = q.reshape(n_groups, group, qt.n).to(dtype) \
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
    """x @ dequant(W): x (..., K) -> (..., N). Natpair and nat8 weights with
    N % 128 == 0 take the kernels (W4A8 / W8A8 at m == 1, W4A16 / W8A16
    above); others dequantize to `compute_dtype` and multiply with f32
    accumulation."""
    out_dtype = out_dtype or x.dtype
    if qt.n % 128 == 0:
        if qt.kind == "nib4" and qt.q4_layout == 3:
            return _kernel_route(x, qt, qmatmul_natpair).to(out_dtype)
        if qt.kind == "int8" and qt.q4_layout == 4:
            return _kernel_route(x, qt, qmatmul_nat8).to(out_dtype)
    w = dequantize(qt, dtype=compute_dtype)
    y = x.to(compute_dtype).float() @ w.float()
    return y.to(out_dtype)
