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

Two hooks run at the top of `qmatmul`, before a route is chosen, so the
kernel routes and the plain route alike see them: an activation observer
(quant/imatrix.ImatrixCollector) and the "w4a8" activation sim (the
quality rows). A captured CUDA graph replays no Python, so neither may be
set while a stream captures: `qmatmul` raises then, and so does a captured
step's replay (runtime/engine.CapturedStep).
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


# called as observer(qt, x) on every qmatmul (quant/imatrix.py's
# collector); None: off
_activation_observer = None

# "w4a8": every product with a quantized weight first takes its activation
# through the reference's Q8_0 round trip (quantize_row_q8_0) in value
# terms, so a whole model's output can be held against ggml's W4A8
# integer-dot math (the quality rows); None: off
_activation_sim = None


def set_activation_observer(fn):
    """Install (or remove, with None) the activation observer."""
    global _activation_observer
    _activation_observer = fn


def set_activation_sim(mode):
    """None (the default) or "w4a8"."""
    global _activation_sim
    if mode not in (None, "w4a8"):
        raise ValueError(f"activation sim {mode!r}: None or 'w4a8'")
    _activation_sim = mode


def hooks_active() -> bool:
    """Whether an observer or a sim is set."""
    return _activation_observer is not None or _activation_sim is not None


def refuse_capture(where: str):
    """Raise if an observer or a sim is set: `where` (a CUDA graph capture or
    replay) would run no Python and silently bypass them."""
    if hooks_active():
        raise RuntimeError(
            f"{where}: an activation observer or sim is set, and a captured "
            "CUDA graph runs no Python; collect or simulate through eager "
            "forwards")


def _q8_0_sim(x: torch.Tensor) -> torch.Tensor:
    """Per-32 symmetric int8 round trip, d = amax / 127, in f32
    (quantize_row_q8_0 in value terms; torch.round is round half to even,
    as the JAX package's sim, where the reference's roundf rounds half away
    from zero)."""
    xr = x.float().reshape(*x.shape[:-1], -1, 32)
    amax = xr.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which rounds d an ulp off the host's (and the JAX sim's)
    d = amax / torch.full_like(amax, 127.0)
    q = torch.where(d > 0, torch.round(xr / torch.where(d > 0, d, 1.0)), 0.0)
    return (q * d).reshape(x.shape)


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
    if hooks_active():
        if torch.cuda.is_available() \
                and torch.cuda.is_current_stream_capturing():
            refuse_capture("qmatmul during a CUDA graph capture")
        if _activation_observer is not None:
            _activation_observer(qt, x)
        if _activation_sim == "w4a8" and qt.kind != "dense":
            x = _q8_0_sim(x)
    if qt.n % 128 == 0 and qt.interleaved_bk > 0 and qt.lut is None:
        route = {("nib4", 3): qmatmul_natpair, ("int8", 4): qmatmul_nat8,
                 ("nib4", 0): qmatmul_permuted, ("nib4", 1): qmatmul_permuted,
                 ("int8", 2): qmatmul_permuted}.get((qt.kind, qt.q4_layout))
        if route is not None:
            return _kernel_route(x, qt, route).to(out_dtype)
    w = dequantize(qt, dtype=compute_dtype)
    y = x.to(compute_dtype).float() @ w.float()
    return y.to(out_dtype)
