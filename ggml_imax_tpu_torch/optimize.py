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

Type "lbfgs" is the reference's optax.lbfgs(memory_size=m, linesearch=
scale_by_zoom_linesearch(max_linesearch_steps, slope_rtol=ftol,
curv_rtol=wolfe)) as plain tensor code (`_LBFGS`): the two-loop recursion
over the last m (s, y) pairs, then scale(-1), then the zoom line search
with optax's defaults (tol 0, increase factor 2, approx_dec_rtol 1e-6,
stepsize precision 1e-5, no largest stepsize, initial guess "keep": each
search starts from the stepsize the last one accepted). Arithmetic is in
the leaves' dtype (f32) as optax's, the search's scalars as numpy float32
on the host: one sync per trial point. Each iteration evaluates the loss
and gradient once at the current point, then once per trial point of the
search (whose last value is not reused), as the reference does.
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


_F32 = np.float32


def _vdot(a, b) -> torch.Tensor:
    """Sum over leaves of <a_i, b_i> (optax.tree.vdot), a 0-d tensor."""
    out = None
    for x, y in zip(a, b):
        d = torch.sum(x * y)
        out = d if out is None else out + d
    return out


def _two_loop(g, dw, du, rho, gamma, idx: int):
    """optax's _precondition_by_lbfgs: the L-BFGS product P_k g by the
    two-loop recursion. dw/du: m slots of per-leaf parameter and gradient
    differences, rho (m,) their weights 1/<dw, du> (0 for an empty slot),
    gamma the identity scale (0-d), idx the slot of the current iteration
    (count % m): slots are visited newest first (idx - 1 down to idx), then
    oldest first."""
    m = rho.shape[0]
    order = [(idx + j) % m for j in range(m)]
    vec, alphas = list(g), {}
    for i in reversed(order):
        alphas[i] = rho[i] * _vdot(dw[i], vec)
        vec = [v + (-alphas[i]) * u for v, u in zip(vec, du[i])]
    vec = [gamma * v for v in vec]
    for i in order:
        beta = rho[i] * _vdot(du[i], vec)
        vec = [v + (alphas[i] - beta) * w for v, w in zip(vec, dw[i])]
    return vec


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's _cubicmin in float32: the critical point of the cubic through
    (a, fa), (b, fb), (c, fc) with slope fpa at a; NaN where there is none
    (the zoom then ignores it)."""
    a, fa, fpa, b, fb, c, fc = map(_F32, (a, fa, fpa, b, fb, c, fc))
    with np.errstate(all="ignore"):
        C = fpa
        db, dc = b - a, c - a
        dbdc = db * dc
        denom = dbdc * dbdc * (db - dc)
        r0, r1 = fb - fa - C * db, fc - fa - C * dc
        A = (dc * dc * r0 + -(db * db) * r1) / denom
        B = (-(dc * (dc * dc)) * r0 + db * (db * db) * r1) / denom
        radical = B * B - _F32(3.0) * A * C
        return a + (-B + np.sqrt(radical)) / (_F32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """optax's _quadmin in float32: the critical point of the quadratic
    through (a, fa), (b, fb) with slope fpa at a."""
    a, fa, fpa, b, fb = map(_F32, (a, fa, fpa, b, fb))
    with np.errstate(all="ignore"):
        db = b - a
        B = (fb - fa - fpa * db) / (db * db)
        return a - fpa / (_F32(2.0) * B)


class _ZoomLinesearch:
    """optax's zoom_linesearch (Nocedal and Wright's Algorithms 3.5 and 3.6
    with Hager and Zhang's approximate Wolfe decrease) at the reference's
    settings, its scalars numpy float32 on the host. `run` takes a function
    giving (value, slope) at a stepsize and returns (stepsize, trial
    points evaluated, decrease error, curvature error). `branches` counts
    the trial points by how each was chosen: "first" (the initial guess),
    "doubling", and in the zoom "cubic", "quadratic" and "bisection"."""

    def __init__(self, max_steps: int, slope_rtol: float, curv_rtol: float,
                 tol: float = 0.0, increase_factor: float = 2.0,
                 approx_dec_rtol: float = 1e-6,
                 interval_threshold: float = 1e-5):
        self.max_steps = max_steps
        self.slope_rtol, self.curv_rtol = _F32(slope_rtol), _F32(curv_rtol)
        self.tol, self.increase = _F32(tol), _F32(increase_factor)
        self.approx_dec_rtol = _F32(approx_dec_rtol)
        # the reference's 2 * slope_rtol - 1.0, formed in Python floats
        self.approx_slope = _F32(2 * slope_rtol - 1.0)
        self.threshold = _F32(interval_threshold)
        self.branches = {"first": 0, "doubling": 0, "cubic": 0,
                         "quadratic": 0, "bisection": 0}

    def _decrease_error(self, stepsize, value, slope, value_init, slope_init):
        err = value - value_init - self.slope_rtol * stepsize * slope_init
        approx = slope - self.approx_slope * slope_init
        delta = value - value_init - self.approx_dec_rtol * np.abs(value_init)
        err = np.minimum(np.maximum(approx, delta), err)
        err = np.maximum(err, _F32(0))
        return _F32(np.inf) if np.isnan(err) else err

    def _curvature_error(self, slope, slope_init):
        err = np.maximum(np.abs(slope) - self.curv_rtol * np.abs(slope_init),
                         _F32(0))
        return _F32(np.inf) if np.isnan(err) else err

    def run(self, value_and_slope, value_init, slope_init, guess):
        zero = _F32(0)
        value_init, slope_init = _F32(value_init), _F32(slope_init)
        s = dict(count=0, stepsize=zero, value=value_init, slope=slope_init,
                 dec=_F32(np.inf), curv=_F32(np.inf), interval=False,
                 done=False, failed=False, low=zero, v_low=value_init,
                 s_low=slope_init, high=zero, v_high=value_init,
                 s_high=slope_init, cref=zero, v_cref=value_init,
                 safe=zero, v_safe=value_init)
        while not (s["done"] or s["failed"]):
            if s["interval"]:
                self._zoom(s, value_and_slope, value_init, slope_init)
            else:
                self._search(s, value_and_slope, value_init, slope_init,
                             _F32(guess))
            if s["failed"] and (s["safe"] > 0 or np.isinf(s["dec"])):
                s["stepsize"], s["value"] = s["safe"], s["v_safe"]
        return s["stepsize"], s["count"], s["dec"], s["curv"]

    def _search(self, s, value_and_slope, value_init, slope_init, guess):
        """_search_interval: the first trial at the guess, then doubling."""
        first = s["count"] == 0
        self.branches["first" if first else "doubling"] += 1
        prev, v_prev, s_prev = s["stepsize"], s["value"], s["slope"]
        new = guess if first else self.increase * prev
        v, sl = value_and_slope(new)
        dec = self._decrease_error(new, v, sl, value_init, slope_init)
        curv = self._curvature_error(sl, slope_init)
        err = np.maximum(dec, curv)
        if dec <= self.tol:
            s["safe"], s["v_safe"] = new, v
        high_to_new = bool(dec > 0) or (bool(v >= v_prev) and not first)
        low_to_new = bool(sl >= 0) and not high_to_new
        if low_to_new:
            bounds = (new, v, sl, prev, v_prev, s_prev)
        else:
            bounds = (prev, v_prev, s_prev, new, v, sl)
        (s["low"], s["v_low"], s["s_low"],
         s["high"], s["v_high"], s["s_high"]) = bounds
        s["cref"], s["v_cref"] = s["low"], s["v_low"]
        s["interval"] = high_to_new or low_to_new or bool(err <= self.tol)
        s["done"] = bool(err <= self.tol)
        s["failed"] = s["count"] + 1 >= self.max_steps and not s["done"]
        s.update(count=s["count"] + 1, stepsize=new, value=v, slope=sl,
                 dec=dec, curv=curv)

    def _zoom(self, s, value_and_slope, value_init, slope_init):
        """_zoom_into_interval: cubic, else quadratic, else bisection."""
        low, high = s["low"], s["high"]
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        cubic_chk, quad_chk = _F32(0.2) * delta, _F32(0.1) * delta
        cubic = _cubicmin(low, s["v_low"], s["s_low"], high, s["v_high"],
                          s["cref"], s["v_cref"])
        quad = _quadmin(low, s["v_low"], s["s_low"], high, s["v_high"])
        if left + cubic_chk < cubic < right - cubic_chk:
            middle, how = cubic, "cubic"
        elif left + quad_chk < quad < right - quad_chk:
            middle, how = quad, "quadratic"
        else:
            middle, how = (low + high) / _F32(2.0), "bisection"
        self.branches[how] += 1
        v, sl = value_and_slope(middle)
        dec = self._decrease_error(middle, v, sl, value_init, slope_init)
        curv = self._curvature_error(sl, slope_init)
        err = np.maximum(dec, curv)
        if dec <= self.tol and v < s["v_safe"]:
            s["safe"], s["v_safe"] = middle, v
        done = bool(err <= self.tol)
        high_to_middle = bool(dec > 0) or bool(v >= s["v_low"])
        high_to_low = bool(sl * (high - low) >= 0) and not high_to_middle
        old_low = (low, s["v_low"], s["s_low"])
        old_high = (high, s["v_high"], s["s_high"])
        new_high = (middle, v, sl) if high_to_middle else old_high
        if high_to_low:
            new_high = old_low
        new_low = old_low if high_to_middle else (middle, v, sl)
        s["cref"], s["v_cref"] = ((high, s["v_high"]) if high_to_middle
                                  or high_to_low else (low, s["v_low"]))
        (s["low"], s["v_low"], s["s_low"]) = new_low
        (s["high"], s["v_high"], s["s_high"]) = new_high
        too_small = bool(delta <= self.threshold)
        failed = (s["count"] + 1 >= self.max_steps
                  or (too_small and bool(s["safe"] > 0)))
        s.update(count=s["count"] + 1, stepsize=middle, value=v, slope=sl,
                 dec=dec, curv=curv, done=done, failed=failed and not done)


class _LBFGS:
    """The reference's optax.lbfgs chain for type "lbfgs" (see the module
    docstring). State: the iteration count, the last point and gradient,
    m slots of differences with their weights, the last accepted stepsize
    and, per iteration, the line search's trial points (`info`)."""

    def __init__(self, lb: LBFGSParams):
        self.lb = lb
        self.search = _ZoomLinesearch(lb.max_linesearch, lb.ftol, lb.wolfe)

    def init(self, leaves):
        m = self.lb.m
        zeros = lambda: [torch.zeros_like(p) for p in leaves]
        dev = leaves[0].device if leaves else None
        return {"count": 0, "params": zeros(), "updates": zeros(),
                "dw": [zeros() for _ in range(m)],
                "du": [zeros() for _ in range(m)],
                "rho": torch.zeros(m, dtype=torch.float32, device=dev),
                "lr": _F32(1.0), "info": [],
                "branches": self.search.branches}

    def initial_guess(self, state):
        """initial_guess_strategy "keep": the last accepted stepsize (1 at
        the first iteration)."""
        return state["lr"]

    @torch.no_grad()
    def direction(self, grads, state, leaves):
        """scale_by_lbfgs then scale(-1): store the newest (dw, du) pair,
        then -P_k g."""
        m, count = self.lb.m, state["count"]
        idx, prev = count % m, (count - 1) % m
        if count > 0:
            dw = [p - q for p, q in zip(leaves, state["params"])]
            du = [g - u for g, u in zip(grads, state["updates"])]
            sy = _vdot(du, dw)
            state["rho"][prev] = torch.where(sy == 0, torch.zeros_like(sy),
                                             1.0 / sy)
            state["dw"][prev], state["du"][prev] = dw, du
            yy = _vdot(du, du)
            gamma = torch.where(yy > 0, sy / yy, torch.ones_like(yy))
        else:                      # the slots are init's zeros, rho 0
            gamma = torch.clamp(1.0 / torch.sqrt(_vdot(grads, grads)),
                                max=1.0)
        d = _two_loop(grads, state["dw"], state["du"], state["rho"], gamma,
                      idx)
        state["params"] = [p.detach().clone() for p in leaves]
        state["updates"] = list(grads)
        state["count"] = count + 1
        return [-x for x in d]

    def update(self, grads, state, leaves, loss, value_and_grad):
        """One iteration: the direction, then the zoom search along it from
        `leaves` (where `loss` and `grads` were evaluated); the accepted
        point is written into the leaves. value_and_grad() evaluates the
        loss and gradient at the leaves as they stand."""
        u = self.direction(grads, state, leaves)
        x0 = [p.detach().clone() for p in leaves]

        @torch.no_grad()
        def put(stepsize):
            for p, x, d in zip(leaves, x0, u):
                p.copy_(x + float(stepsize) * d)

        def value_and_slope(stepsize):
            put(stepsize)
            f, g = value_and_grad()
            with torch.no_grad():
                both = torch.stack([f.float().reshape(()), _vdot(g, u)])
            v, sl = both.tolist()
            return _F32(v), _F32(sl)

        with torch.no_grad():
            slope = float(_vdot(u, grads))
        lr, n, dec, curv = self.search.run(value_and_slope, float(loss),
                                           slope, self.initial_guess(state))
        put(lr)
        state["lr"] = lr
        state["info"].append({"num_linesearch_steps": n,
                              "decrease_error": float(dec),
                              "curvature_error": float(curv)})


def _make_tx(p: OptParams):
    if p.type == "adam":
        return _Adam(p.adam)
    if p.type == "lbfgs":
        return _LBFGS(p.lbfgs)
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
    lbfgs = p.type == "lbfgs"
    n_iter = p.lbfgs.n_iter if lbfgs else p.adam.n_iter
    # L-BFGS's eps serves both convergence tests, as in the reference
    eps_f, eps_g = ((p.lbfgs.eps, p.lbfgs.eps) if lbfgs
                    else (p.adam.eps_f, p.adam.eps_g))
    leaves = float_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)

    def value_and_grad():
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    result = OptResult.DID_NOT_CONVERGE
    for it in range(n_iter):
        loss, grads = value_and_grad()
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if lbfgs:
            ctx.tx.update(grads, ctx.opt_state, leaves, loss, value_and_grad)
        else:
            ctx.tx.update(grads, ctx.opt_state, leaves, gnorm)
        f, gn = float(loss), float(gnorm)
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
        if it > 0 and abs(f - ctx.fx_prev) < eps_f * max(1.0, abs(f)):
            result = OptResult.OK
            break
        # gradient norm test
        if gn < eps_g:
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
