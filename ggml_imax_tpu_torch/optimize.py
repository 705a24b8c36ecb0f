"""The optimizer loop (counterpart of ggml_imax_tpu/optimize.py, the
ggml_opt analog): Adam(W) with gradient clipping, weight decay and the
ggml_opt/ggml_opt_resume convergence tests.

Autodiff is `torch.autograd.grad` over the float leaves of the params tree
(tensors in dicts and lists, and the `.q` of dense QTensors; quantized
weights stay frozen). The update is the reference's optax chain, in its
order and arithmetic: clip_by_global_norm(gclip) if gclip > 0,
scale_by_adam (bias-corrected, m_hat / (sqrt(v_hat) + eps)),
add_decayed_weights(decay) on leaves with ndim >= decay_min_ndim if
decay > 0, then scale(-alpha * sched). Unlike the reference, which returns
new arrays, the leaves are updated in place under torch.no_grad() (no
second copy of the params) and `opt` returns the same tree.

L-BFGS is not ported yet: type "lbfgs" raises NotImplementedError.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from .quant.device import QTensor


class OptResult(enum.Enum):
    """Mirrors enum ggml_opt_result."""
    OK = 0
    DID_NOT_CONVERGE = 1
    FAIL = 2
    CANCEL = 3


@dataclass
class AdamParams:
    """Defaults mirror ggml_opt_default_params(GGML_OPT_TYPE_ADAM)."""
    n_iter: int = 10000
    sched: float = 1.0
    decay: float = 0.0
    decay_min_ndim: int = 2
    alpha: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    eps_f: float = 1e-5
    eps_g: float = 1e-3
    gclip: float = 0.0


@dataclass
class LBFGSParams:
    """Defaults mirror ggml_opt_default_params(GGML_OPT_TYPE_LBFGS)."""
    m: int = 6
    n_iter: int = 100
    max_linesearch: int = 20
    eps: float = 1e-5
    ftol: float = 1e-4
    wolfe: float = 0.9


@dataclass
class OptParams:
    """ggml_opt_params analog."""
    type: str = "adam"                     # "adam" | "lbfgs"
    past: int = 0                          # delta-based convergence window
    delta: float = 1e-5
    max_no_improvement: int = 100
    n_gradient_accumulation: int = 1
    adam: AdamParams = field(default_factory=AdamParams)
    lbfgs: LBFGSParams = field(default_factory=LBFGSParams)


def default_params(type: str = "adam") -> OptParams:
    p = OptParams(type=type)
    if type == "lbfgs":
        p.past = 0
        p.max_no_improvement = 0
    return p


@dataclass
class OptContext:
    """ggml_opt_context analog: carries the optimizer state across
    opt_resume calls."""
    params: OptParams
    tx: Any
    opt_state: Any
    iter: int = 0
    fx_best: float = float("inf")
    fx_prev: float = float("inf")
    n_no_improvement: int = 0
    past_f: list = field(default_factory=list)
    just_initialized: bool = True
    loss_before: float = 0.0
    loss_after: float = 0.0


def float_leaves(params) -> list[torch.Tensor]:
    """The trainable leaves of a params tree, in a fixed order: float
    tensors in dicts (by key order) and lists, and the `.q` of dense
    QTensors."""
    out = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, QTensor):
            if x.kind == "dense":
                walk(x.q)
        elif isinstance(x, torch.Tensor) and x.is_floating_point():
            out.append(x)
    walk(params)
    return out


class _Adam:
    """The reference's optax chain for type "adam" (see the module
    docstring); state: step count and the first and second moments."""

    def __init__(self, a: AdamParams):
        self.a = a

    def init(self, leaves):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def update(self, grads, state, leaves, gnorm):
        """Apply one step to `leaves` in place; gnorm is the global norm of
        `grads` (a 0-d tensor)."""
        a = self.a
        if a.gclip > 0 and not bool(gnorm < a.gclip):
            grads = [g / gnorm * a.gclip for g in grads]
        state["count"] += 1
        bc1 = _bias_correction(a.beta1, state["count"])
        bc2 = _bias_correction(a.beta2, state["count"])
        step = -a.alpha * a.sched
        for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
            mu.copy_((1 - a.beta1) * g + a.beta1 * mu)
            nu.copy_((1 - a.beta2) * (g * g) + a.beta2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + a.eps)
            if a.decay > 0 and p.dim() >= a.decay_min_ndim:
                u = u + a.decay * p
            p.add_(u * step)


def _bias_correction(beta: float, n: int) -> float:
    """1 - beta ** n in f32, as the reference computes it: the power of
    f32(beta) rounded to f32 once, then the f32 difference."""
    return float(np.float32(1) - np.float32(np.float64(np.float32(beta)) ** n))


def _make_tx(p: OptParams):
    if p.type == "adam":
        return _Adam(p.adam)
    if p.type == "lbfgs":
        raise NotImplementedError("L-BFGS is not ported yet")
    raise ValueError(p.type)


def opt_init(params_opt: OptParams, params) -> OptContext:
    """ggml_opt_init analog."""
    tx = _make_tx(params_opt)
    return OptContext(params_opt, tx, tx.init(float_leaves(params)))


def opt(loss_fn: Callable, params, params_opt: OptParams | None = None,
        callback: Callable[[int, float], bool | None] | None = None):
    """ggml_opt analog: minimize loss_fn(params) (a 0-d tensor) starting
    from params. Returns (OptResult, params, OptContext); params is the
    same tree, its leaves updated in place. `callback(iter, loss)` may
    return True to cancel."""
    params_opt = params_opt or default_params()
    ctx = opt_init(params_opt, params)
    res, params = opt_resume(ctx, loss_fn, params, callback)
    return res, params, ctx


def opt_resume(ctx: OptContext, loss_fn: Callable, params, callback=None):
    """ggml_opt_resume analog: continue optimizing with the carried state."""
    p = ctx.params
    n_iter = p.adam.n_iter
    leaves = float_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)

    result = OptResult.DID_NOT_CONVERGE
    for it in range(n_iter):
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        ctx.tx.update(grads, ctx.opt_state, leaves, gnorm)
        f, gn = float(loss.detach()), float(gnorm)
        del loss, grads
        if ctx.just_initialized:
            ctx.loss_before = f
            ctx.just_initialized = False
        ctx.iter += 1
        ctx.loss_after = f
        if callback is not None and callback(ctx.iter, f):
            result = OptResult.CANCEL
            break

        # convergence: |f - f_prev| < eps_f * max(1, |f|)
        if it > 0 and abs(f - ctx.fx_prev) < p.adam.eps_f * max(1.0, abs(f)):
            result = OptResult.OK
            break
        # gradient norm test
        if gn < p.adam.eps_g:
            result = OptResult.OK
            break
        # delta-based past-window test
        if p.past > 0:
            ctx.past_f.append(f)
            if len(ctx.past_f) > p.past:
                f_past = ctx.past_f.pop(0)
                if abs(f - f_past) < p.delta * max(1.0, abs(f)):
                    result = OptResult.OK
                    break
        # max_no_improvement
        if p.max_no_improvement > 0:
            if f < ctx.fx_best:
                ctx.fx_best = f
                ctx.n_no_improvement = 0
            else:
                ctx.n_no_improvement += 1
                if ctx.n_no_improvement >= p.max_no_improvement:
                    result = OptResult.OK
                    break
        ctx.fx_prev = f

    return result, params
