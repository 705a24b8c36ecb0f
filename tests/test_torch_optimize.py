"""Port parity: the optimizer (ggml_imax_tpu_torch/optimize.py against
ggml_imax_tpu/optimize.py).

Each case runs the JAX package's `opt`/`opt_resume` and the port's on the
same numpy problem: the params before every step (recorded inside the loss)
and after the last agree within 1e-6 of their largest magnitude, and the
OptResult and iteration counts are equal. The two gradients differ by f32
summation order alone (~4e-8 here); the bias correction is rounded as the
reference rounds it, without which the params part by ~1e-6 in a few
steps. Problems: test_optimize.py's least squares (converges, resume
continues, callback cancel), plus gradient clipping, weight decay masked
by ndim, the past-window test and max_no_improvement.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu import optimize as jopt
from ggml_imax_tpu_torch import optimize as topt
from ggml_imax_tpu_torch.quant.device import QTensor
from ggml_imax_tpu_torch.quant.formats import GGMLType


def lstsq(seed, m=32, n=8):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n)).astype(np.float32)
    b = rng.standard_normal((m,)).astype(np.float32)
    x0 = {"w": rng.standard_normal((n, 1)).astype(np.float32),
          "b": rng.standard_normal((1,)).astype(np.float32)}
    return a, b, x0


def run_jax(a, b, x0, p, resumes, callback):
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    seen = []

    def loss(x):
        jax.debug.callback(lambda w, c: seen.append(
            np.concatenate([np.ravel(w), np.ravel(c)])), x["w"], x["b"])
        r = aj @ x["w"][:, 0] + x["b"][0] - bj
        return jnp.mean(r * r)

    res, x, ctx = jopt.opt(loss, {k: jnp.asarray(v) for k, v in x0.items()},
                           p, callback=callback)
    outs = [(res.name, ctx.iter)]
    for _ in range(resumes):
        res, x = jopt.opt_resume(ctx, loss, x)
        outs.append((res.name, ctx.iter))
    seen.append(np.concatenate([np.ravel(x["w"]), np.ravel(x["b"])]))
    return outs, seen


def run_port(a, b, x0, p, resumes, callback):
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    seen = []

    def loss(x):
        seen.append(torch.cat([x["w"].q.detach().ravel(),
                               x["b"].detach().ravel()]).numpy().copy())
        r = at @ x["w"].q[:, 0] + x["b"][0] - bt
        return torch.mean(r * r)

    # the matrix as a dense QTensor, as model weights are held
    w = torch.from_numpy(x0["w"].copy())
    x = {"w": QTensor("dense", w, None, None, w.shape[0], w.shape[1],
                      GGMLType.F32),
         "b": torch.from_numpy(x0["b"].copy())}
    res, x, ctx = topt.opt(loss, x, p, callback=callback)
    outs = [(res.name, ctx.iter)]
    for _ in range(resumes):
        res, x = topt.opt_resume(ctx, loss, x)
        outs.append((res.name, ctx.iter))
    seen.append(torch.cat([x["w"].q.detach().ravel(),
                           x["b"].detach().ravel()]).numpy().copy())
    return outs, seen


CASES = {
    # test_opt_adam_converges's settings but eps_f: at 1e-9 (or 1e-6) the
    # stop hangs on loss differences of f32 rounding, and the packages stop
    # a step or more apart; at 1e-4 the stopping step's change is a third
    # of the limit and every earlier one over 3.8 times it
    "converges": (dict(n_iter=2000, alpha=5e-2, eps_f=1e-4, eps_g=1e-6), {}, 0,
                  None),
    "resume": (dict(n_iter=50, alpha=1e-2, eps_f=0.0, eps_g=0.0),
               dict(max_no_improvement=0), 1, None),
    "cancel": (dict(n_iter=1000, alpha=1e-3, eps_f=0.0, eps_g=0.0), {}, 0,
               lambda it, f: it >= 5),
    "gclip": (dict(n_iter=60, alpha=5e-2, eps_f=0.0, eps_g=0.0, gclip=0.5),
              {}, 0, None),
    "decay": (dict(n_iter=60, alpha=5e-2, eps_f=0.0, eps_g=0.0, decay=0.1),
              {}, 0, None),
    "past": (dict(n_iter=2000, alpha=2e-2, eps_f=0.0, eps_g=0.0),
             dict(past=5, delta=1e-3, max_no_improvement=0), 0, None),
    "no_improvement": (dict(n_iter=500, alpha=0.5, eps_f=0.0, eps_g=0.0),
                       dict(max_no_improvement=3), 0, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_opt_matches_reference_step_for_step(case):
    adam, opt_kw, resumes, callback = CASES[case]
    a, b, x0 = lstsq(7)
    got, want = {}, {}
    for mod, run, out in ((jopt, run_jax, want), (topt, run_port, got)):
        p = mod.default_params("adam")
        p.adam = mod.AdamParams(**adam)
        for k, v in opt_kw.items():
            setattr(p, k, v)
        out["res"], out["seen"] = run(a, b, x0, p, resumes, callback)
    assert got["res"] == want["res"]
    assert len(got["seen"]) == len(want["seen"])
    for i, (g, w) in enumerate(zip(got["seen"], want["seen"])):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= 1e-6, (i, err)
    n_steps = want["res"][-1][1]
    assert len(want["seen"]) == n_steps + 1
    if case == "converges":
        assert want["res"] == [("OK", n_steps)] and n_steps < 2000
    if case == "resume":
        assert want["res"] == [("DID_NOT_CONVERGE", 50),
                               ("DID_NOT_CONVERGE", 100)]
    if case == "cancel":
        assert want["res"] == [("CANCEL", 5)]
    if case in ("past", "no_improvement"):
        assert want["res"][0][0] == "OK" and n_steps < adam["n_iter"]


def test_decay_skips_low_ndim_leaves():
    """With decay alone (no gradient), only leaves with ndim >= 2 shrink."""
    w = torch.ones(3, 2)
    b = torch.ones(2)
    p = topt.default_params("adam")
    p.adam = topt.AdamParams(n_iter=1, alpha=0.5, decay=0.2, eps_f=0.0,
                             eps_g=-1.0)
    topt.opt(lambda x: (x["w"] * 0).sum() + (x["b"] * 0).sum(),
             {"w": w, "b": b}, p)
    torch.testing.assert_close(w, torch.full((3, 2), 0.9))
    torch.testing.assert_close(b, torch.ones(2))


def test_frozen_quantized_weights_are_not_leaves():
    q4 = QTensor("nib4", torch.zeros(16, 4, dtype=torch.uint8),
                 torch.ones(1, 4), None, 32, 4, GGMLType.Q4_0)
    dense = QTensor("dense", torch.zeros(2, 2), None, None, 2, 2, GGMLType.F32)
    tree = {"a": [q4, dense], "b": torch.zeros(3), "n": None,
            "i": torch.zeros(2, dtype=torch.int32)}
    leaves = topt.float_leaves(tree)
    assert [t is x for t, x in zip(leaves, (dense.q, tree["b"]))] == [True, True]
    assert len(leaves) == 2

