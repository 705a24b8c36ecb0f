"""Port parity for the rest of the op set (ggml_imax_tpu_torch/ops/
softmax.py, tensor_ops.py, activations.py, norms.group_norm,
attention.causal_mask, conv.py): the same seeded numpy inputs through the
JAX package's function (jitted, one compile a case) and the port's
(device "cpu"), at the cases and NMSE tolerances of
tests/test_backend_ops_sweep.py and tests/test_backend_ops_sweep2.py
(`TOL` copied here) and of tests/test_ops_extended.py. Ops whose every
step is exact in f32 (moves, selections, comparisons) are held bit for
bit. ssm, moe and the transposed convolutions are in
tests/test_torch_ops_extended.py, rope's modes in
tests/test_torch_rope_modes.py, the bilinear resize in
tests/test_torch_resize.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.ops import activations, attention, conv, moe, norms, rope
from ggml_imax_tpu.ops import softmax, ssm, tensor_ops
from ggml_imax_tpu_torch.ops import activations as tact
from ggml_imax_tpu_torch.ops import attention as tattn
from ggml_imax_tpu_torch.ops import conv as tconv
from ggml_imax_tpu_torch.ops import norms as tnorms
from ggml_imax_tpu_torch.ops import rope as trope
from ggml_imax_tpu_torch.ops import softmax as tsoft
from ggml_imax_tpu_torch.ops import tensor_ops as ttop

# tests/test_backend_ops_sweep.py's TOL (NMSE per op family)
TOL = {
    "unary_f32": 1e-10,
    "unary_bf16": 1e-4,
    "binary_f32": 1e-12,
    "softmax": 1e-10,
    "mulmat_f32": 5e-9,
    "mulmat_pallas": 5e-5,
    "conv": 1e-9,
    "block_f32": 5e-7,
}
SWEEP2_NMSE = 1e-9          # tests/test_backend_ops_sweep2.py's rope/norms


def jit_call(fn, *args, **kw):
    """fn(*args, **kw) under jax.jit, the JAX arrays traced and every other
    argument static: one compile a case, where each eager op would compile
    on its own."""
    static = tuple(i for i, a in enumerate(args)
                   if not isinstance(a, jax.Array))
    return jax.jit(fn, static_argnums=static,
                   static_argnames=tuple(kw))(*args, **kw)


class Jitted:
    """A JAX-package module whose functions run through jit_call."""

    def __init__(self, mod):
        self.mod = mod

    def __getattr__(self, name):
        return lambda *a, **kw: jit_call(getattr(self.mod, name), *a, **kw)


jact, jattn, jconv, jmoe, jnorms, jrope, jsoft, jssm, jtop = map(
    Jitted, (activations, attention, conv, moe, norms, rope, softmax, ssm,
             tensor_ops))


@pytest.fixture()
def rng():
    return np.random.default_rng(20250817)


def nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2) / (np.mean(b * b) + 1e-300))


def host(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def both(x, dt="f32"):
    """The same values as a JAX array and a CPU torch tensor."""
    x = np.asarray(x)
    if dt == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(
            x.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def same(got, ref):
    g, r = host(got), host(ref)
    assert g.shape == r.shape and g.dtype == r.dtype, (g.dtype, r.dtype)
    np.testing.assert_array_equal(g, r)


# ---------------------------------------------------------------- unary ----
UNARY = ["abs_", "elu", "gelu", "gelu_quick", "hardsigmoid", "hardswish",
         "leaky_relu", "neg", "relu", "relu_squared", "sgn", "sigmoid",
         "silu", "step", "tanh"]
UNARY_SHAPES = [(7,), (63, 129), (2, 3, 5, 7), (128, 256)]


@pytest.mark.parametrize("name", UNARY)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_unary_sweep(rng, name, dt):
    for shape in UNARY_SHAPES:
        x = rng.standard_normal(shape).astype(np.float32) * 2.0
        jx, tx = both(x, dt)
        ref = getattr(jact, name)(jx)
        got = getattr(tact, name)(tx)
        assert got.dtype == (torch.float32 if dt == "f32" else torch.bfloat16)
        assert host(ref).dtype == host(got).dtype
        assert nmse(host(got), host(ref)) < TOL[f"unary_{dt}"], (name, shape)


@pytest.mark.parametrize("name", ["abs_", "neg", "relu", "sgn", "step",
                                  "leaky_relu", "relu_squared"])
def test_exact_unaries_bit_equal(rng, name):
    x = rng.standard_normal((63, 129)).astype(np.float32) * 2.0
    x[0, :4] = [0.0, -0.0, 1e-30, -1e-30]
    jx, tx = both(x)
    same(getattr(tact, name)(tx), getattr(jact, name)(jx))


# -------------------------------------------------------------- softmax ----
# the mask's two branches: full rank, and rank x.ndim - 1 (B, Tq, Tk),
# which the reference reads only with ALiBi (it gains the head axis there)
@pytest.mark.parametrize("scale", [1.0, 0.125])
@pytest.mark.parametrize("max_bias,mask_rank", [(0.0, "full"), (8.0, "full"),
                                                (8.0, "minus_one")])
def test_softmax_sweep(rng, scale, max_bias, mask_rank):
    for B, H, Tq, Tk in [(1, 1, 5, 7), (2, 4, 16, 33), (1, 8, 1, 257)]:
        x = rng.standard_normal((B, H, Tq, Tk)).astype(np.float32)
        shape = (B, 1, Tq, Tk) if mask_rank == "full" else (B, Tq, Tk)
        mask = np.where(rng.random(shape) < 0.2, -np.inf, 0.0).astype(
            np.float32)
        mask[..., 0] = 0.0
        (jx, tx), (jm, tm) = both(x), both(mask)
        ref = jsoft.soft_max_ext(jx, jm, scale=scale, max_bias=max_bias)
        got = tsoft.soft_max_ext(tx, tm, scale=scale, max_bias=max_bias)
        assert nmse(host(got), host(ref)) < TOL["softmax"], (B, H, Tq, Tk)
        # -inf lanes give exact zeros
        assert np.all(host(got)[np.broadcast_to(
            np.isneginf(mask if mask_rank == "full" else mask[:, None]),
            x.shape)] == 0)


def test_softmax_bf16_and_no_mask(rng):
    x = rng.standard_normal((2, 4, 16, 33)).astype(np.float32)
    jx, tx = both(x, "bf16")
    ref = jsoft.soft_max_ext(jx, None, scale=0.5)
    got = tsoft.soft_max_ext(tx, None, scale=0.5)
    assert got.dtype == torch.bfloat16
    assert nmse(host(got), host(ref)) < TOL["unary_bf16"]


def test_softmax_fully_masked_rows_give_zeros(rng):
    x = rng.standard_normal((1, 2, 3, 8)).astype(np.float32)
    mask = np.full((1, 1, 3, 8), -np.inf, np.float32)
    mask[0, 0, 1, 2] = 0.0                       # one row sees one key
    (jx, tx), (jm, tm) = both(x), both(mask)
    for mb in (0.0, 8.0):
        got = host(tsoft.soft_max_ext(tx, tm, max_bias=mb))
        ref = host(jsoft.soft_max_ext(jx, jm, max_bias=mb))
        assert not np.isnan(got).any()
        np.testing.assert_array_equal(got[:, :, [0, 2]], 0.0)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_head", [1, 5, 8, 12, 32])
@pytest.mark.parametrize("max_bias", [0.0, 8.0])
def test_alibi_slopes_equal(n_head, max_bias):
    np.testing.assert_array_equal(tsoft.alibi_slopes(n_head, max_bias),
                                  softmax.alibi_slopes(n_head, max_bias))
    assert tattn.alibi_slopes is tsoft.alibi_slopes      # one home


# ---------------------------------------------------------- tensor ops -----
BCAST_SHAPES = [((16, 10, 2, 5), (16, 10, 2, 5)), ((64, 262, 1, 1), (1,)),
                ((2, 3, 4, 5), (1, 3, 1, 5))]


def test_elementwise_tensor_ops(rng):
    for sa, _ in BCAST_SHAPES:
        x = rng.standard_normal(sa).astype(np.float32)
        jx, tx = both(x)
        same(ttop.scale(tx, 0.37), jtop.scale(jx, 0.37))
        same(ttop.clamp(tx, -0.5, 0.75), jtop.clamp(jx, -0.5, 0.75))
        same(ttop.sqr(tx), jtop.sqr(jx))
        same(ttop.flip(tx, 1), jtop.flip(jx, 1))
        same(ttop.leaky_relu(tx, 0.2), jtop.leaky_relu(jx, 0.2))
        jp, tp = both(np.abs(x) + 0.1)
        for name in ("sqrt_", "log_"):
            assert nmse(host(getattr(ttop, name)(tp)),
                        host(getattr(jtop, name)(jp))) < TOL["unary_f32"]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_reductions(rng, dt):
    for shape in [(4, 33), (2, 3, 16), (1, 257)]:
        x = rng.standard_normal(shape).astype(np.float32)
        jx, tx = both(x, dt)
        tol = TOL["binary_f32"] if dt == "f32" else TOL["unary_bf16"]
        for name in ("sum_", "sum_rows", "mean"):
            got, ref = getattr(ttop, name)(tx), getattr(jtop, name)(jx)
            assert host(got).shape == host(ref).shape
            assert host(got).dtype == host(ref).dtype, name
            assert nmse(host(got), host(ref)) < tol, (name, shape)
        assert ttop.sum_(tx).shape == (1,)
        same(ttop.argmax(tx), jtop.argmax(jx))


def test_argmax_ties_take_the_first(rng):
    x = np.zeros((3, 9), np.float32)
    x[0, [2, 5]] = 1.0
    x[1, [0, 8]] = 3.0
    jx, tx = both(x)
    same(ttop.argmax(tx), jtop.argmax(jx))


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("n", [1, 7, 128])
def test_argsort_sweep(rng, desc, n):
    x = rng.standard_normal((3, n)).astype(np.float32)
    x[:, ::3] = np.round(x[:, ::3])                # ties
    jx, tx = both(x)
    same(ttop.argsort(tx, descending=desc), jtop.argsort(jx, descending=desc))


@pytest.mark.parametrize("k", [1, 3, 16])
def test_top_k_sweep_with_ties(rng, k):
    x = rng.integers(-3, 3, (2, 32)).astype(np.float32)
    jx, tx = both(x)
    same(ttop.top_k(tx, k), jtop.top_k(jx, k))


@pytest.mark.parametrize("n_past", [0, 2, 5])
def test_diag_masks(rng, n_past):
    x = rng.standard_normal((2, 6, 6)).astype(np.float32)
    jx, tx = both(x)
    same(ttop.diag_mask_inf(tx, n_past), jtop.diag_mask_inf(jx, n_past))
    same(ttop.diag_mask_zero(tx, n_past), jtop.diag_mask_zero(jx, n_past))
    for tq, tk in [(4, 9), (1, 5), (6, 6)]:
        same(tattn.causal_mask(tq, tk, n_past, device="cpu"),
             jattn.causal_mask(tq, tk, n_past))


def test_repeat_concat_outer(rng):
    x = rng.standard_normal((2, 1, 3)).astype(np.float32)
    jx, tx = both(x)
    same(ttop.repeat(tx, (4, 5, 6)), jtop.repeat(jx, (4, 5, 6)))
    a = rng.standard_normal((1, 2, 3, 4)).astype(np.float32)
    b = rng.standard_normal((1, 5, 3, 4)).astype(np.float32)
    (ja, ta), (jb, tb) = both(a), both(b)
    same(ttop.concat(ta, tb, axis=1), jtop.concat(ja, jb, axis=1))
    same(ttop.concat(ta, ta), jtop.concat(ja, ja))
    a2 = rng.standard_normal((3, 7)).astype(np.float32)
    b2 = rng.standard_normal((3, 5)).astype(np.float32)
    (ja, ta), (jb, tb) = both(a2), both(b2)
    got, ref = ttop.outer_prod(ta, tb), jtop.outer_prod(ja, jb)
    assert got.shape == (3, 5, 7)
    same(got, ref)


@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 2, 3), (5, 9, 9)])
def test_acc_and_set_are_functional(rng, offsets):
    dst = rng.standard_normal((4, 6, 8)).astype(np.float32)
    src = rng.standard_normal((2, 3, 4)).astype(np.float32)
    (jd, td), (js, ts) = both(dst), both(src)
    before = td.clone()
    same(ttop.acc(td, ts, offsets), jtop.acc(jd, js, offsets))
    same(ttop.set_(td, ts, offsets), jtop.set_(jd, js, offsets))
    assert torch.equal(td, before)               # dst is left as it was


def test_arange_and_timestep_embedding(rng):
    for args in [(0.0, 10.0, 1.0), (-2.5, 3.0, 0.5), (1.0, 2.0, 0.1)]:
        got = host(ttop.arange(*args, device="cpu"))
        ref = host(jtop.arange(*args))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    ts = np.array([0.0, 1.0, 17.5, 999.0], np.float32)
    jt, tt = both(ts)
    for dim in (16, 15, 8):
        got = host(ttop.timestep_embedding(tt, dim))
        ref = host(jtop.timestep_embedding(jt, dim))
        assert got.shape == ref.shape == (4, dim)
        assert nmse(got, ref) < SWEEP2_NMSE


@pytest.mark.parametrize("h,w,win", [(13, 17, 8), (14, 14, 14), (64, 64, 14)])
def test_win_part_unpart(rng, h, w, win):
    x = rng.standard_normal((2, h, w, 4)).astype(np.float32)
    jx, tx = both(x)
    parts = ttop.win_part(tx, win)
    same(parts, jtop.win_part(jx, win))
    same(ttop.win_unpart(parts, h, w, win), jx)


@pytest.mark.parametrize("qh,kh", [(7, 7), (14, 14), (64, 64), (4, 9), (9, 4)])
def test_get_rel_pos(rng, qh, kh):
    rel = rng.standard_normal((2 * max(qh, kh) - 1, 3)).astype(np.float32)
    jr, tr = both(rel)
    same(ttop.get_rel_pos(tr, qh, kh), jtop.get_rel_pos(jr, qh, kh))


def test_add_rel_pos(rng):
    for b, qh, qw, kh, kw in [(1, 2, 2, 2, 2), (3, 4, 5, 4, 5)]:
        attn = rng.standard_normal((b, qh * qw, kh * kw)).astype(np.float32)
        rw = rng.standard_normal((b, qh, qw, kw)).astype(np.float32)
        rh = rng.standard_normal((b, qh, qw, kh)).astype(np.float32)
        (ja, ta), (jw, tw), (jh, th) = both(attn), both(rw), both(rh)
        same(ttop.add_rel_pos(ta, tw, th), jtop.add_rel_pos(ja, jw, jh))


def test_cross_entropy_loss(rng):
    """tests/test_ops_extended.py's case (one-hot labels) and soft labels,
    within its 1e-5."""
    logits = rng.standard_normal((5, 11)).astype(np.float32)
    for labels in (np.eye(11, dtype=np.float32)[rng.integers(0, 11, 5)],
                   rng.dirichlet(np.ones(11), 5).astype(np.float32)):
        (jl, tl), (jy, ty) = both(logits), both(labels)
        got = ttop.cross_entropy_loss(tl, ty)
        ref = jtop.cross_entropy_loss(jl, jy)
        assert got.shape == (1,)
        assert abs(float(got[0]) - float(host(ref)[0])) < 1e-5


# ------------------------------------------------------------- norms -------
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_group_norm_sweep(rng, groups):
    x = (rng.standard_normal((2, 8, 30)) * 2).astype(np.float32)
    jx, tx = both(x)
    got = tnorms.group_norm(tx, groups, eps=1e-6)
    ref = jnorms.group_norm(jx, groups, eps=1e-6)
    assert nmse(host(got), host(ref)) < SWEEP2_NMSE
    jb, tb = both(x, "bf16")
    got = tnorms.group_norm(tb, groups)
    assert got.dtype == torch.bfloat16
    assert nmse(host(got), host(jnorms.group_norm(jb, groups))) < \
        TOL["unary_bf16"]


# ------------------------------------------------------------- conv --------
@pytest.mark.parametrize("case", [
    (3, 8, 3, 3, 16, 16, (1, 1), (1, 1), (1, 1)),
    (4, 4, 5, 3, 20, 17, (2, 2), (2, 2), (1, 1)),
    (1, 2, 3, 3, 9, 9, (1, 1), (0, 0), (2, 2)),
    (3, 4, 3, 5, 12, 14, (1, 2), (2, 1), (2, 1)),      # (W, H) per axis
    (3, 16, 16, 16, 64, 64, (16, 16), (0, 0), (1, 1)),  # a patch embed
])
def test_conv_2d(rng, case):
    ic, oc, kh, kw, h, w, (s0, s1), (p0, p1), (d0, d1) = case
    x = rng.standard_normal((2, ic, h, w)).astype(np.float32)
    k = rng.standard_normal((oc, ic, kh, kw)).astype(np.float32)
    (jx, tx), (jk, tk) = both(x), both(k)
    kw_ = dict(s0=s0, s1=s1, p0=p0, p1=p1, d0=d0, d1=d1)
    got, ref = tconv.conv_2d(tx, tk, **kw_), jconv.conv_2d(jx, jk, **kw_)
    assert got.shape == ref.shape
    assert nmse(host(got), host(ref)) < TOL["conv"], case


@pytest.mark.parametrize("s0", [1, 2])
@pytest.mark.parametrize("p0", [0, 2])
@pytest.mark.parametrize("d0", [1, 2])
def test_conv_1d_and_transpose_1d_grid(rng, s0, p0, d0):
    x = rng.standard_normal((1, 4, 20)).astype(np.float32)
    w = rng.standard_normal((6, 4, 3)).astype(np.float32)
    (jx, tx), (jw, tw) = both(x), both(w)
    assert nmse(host(tconv.conv_1d(tx, tw, s0, p0, d0)),
                host(jconv.conv_1d(jx, jw, s0, p0, d0))) < TOL["conv"]
    wt = rng.standard_normal((4, 6, 3)).astype(np.float32)   # (Cin, Cout, K)
    jw, tw = both(wt)
    got = tconv.conv_transpose_1d(tx, tw, s0, p0, d0)
    ref = jconv.conv_transpose_1d(jx, jw, s0, p0, d0)
    assert got.shape == ref.shape
    assert nmse(host(got), host(ref)) < TOL["conv"]


@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("p", [0, 1])
def test_im2col(rng, s, p):
    x = rng.standard_normal((2, 3, 10, 11)).astype(np.float32)
    jx, tx = both(x)
    for kh, kw, d in [(3, 3, 1), (2, 3, 2)]:
        kw_ = dict(s0=s, s1=s, p0=p, p1=p, d0=d, d1=d)
        same(tconv.im2col(tx, kh, kw, **kw_), jconv.im2col(jx, kh, kw, **kw_))
    w = rng.standard_normal((5, 3, 3, 3)).astype(np.float32)
    cols = host(tconv.im2col(tx, 3, 3, s0=s, s1=s, p0=p, p1=p))
    direct = host(tconv.conv_2d(tx, torch.from_numpy(w), s0=s, s1=s, p0=p,
                                p1=p))
    via = (cols @ w.reshape(5, -1).T).transpose(0, 3, 1, 2)
    assert nmse(direct, via) < 1e-10


@pytest.mark.parametrize("op", ["max", "avg"])
def test_pool_2d(rng, op):
    # the sweep's cases, a k 2 s 1 pool (YOLO's), and pads past k/2
    for (c, h, w, k0, k1, s0, s1, p0, p1) in [
            (3, 16, 16, 2, 2, 2, 2, 0, 0), (2, 15, 17, 3, 3, 2, 2, 1, 1),
            (3, 8, 10, 2, 2, 2, 2, 0, 0), (2, 13, 13, 2, 2, 1, 1, 0, 0),
            (2, 9, 7, 2, 3, 1, 2, 2, 1)]:
        x = rng.standard_normal((2, c, h, w)).astype(np.float32)
        jx, tx = both(x)
        got = tconv.pool_2d(tx, op, k0, k1, s0, s1, p0, p1)
        ref = conv.pool_2d(jx, op, k0, k1, s0, s1, p0, p1)   # eager: avg
        assert got.shape == ref.shape
        if op == "max":
            same(got, ref)
        else:
            assert nmse(host(got), host(ref)) < TOL["conv"]


@pytest.mark.parametrize("op", ["max", "avg"])
def test_pool_1d(rng, op):
    for (c, w, k, s, p) in [(3, 16, 2, 2, 0), (2, 17, 3, 2, 1), (1, 9, 2, 1, 1)]:
        x = rng.standard_normal((2, c, w)).astype(np.float32)
        jx, tx = both(x)
        got = tconv.pool_1d(tx, op, k, s, p)
        ref = conv.pool_1d(jx, op, k, s, p)       # eager: avg
        assert got.shape == ref.shape
        assert nmse(host(got), host(ref)) < TOL["conv"]


def test_pad_upscale_and_interpolate(rng):
    x = rng.standard_normal((1, 2, 3, 4)).astype(np.float32)
    jx, tx = both(x)
    same(tconv.pad(tx, 3, 2, 1), jconv.pad(jx, 3, 2, 1))
    same(tconv.pad(tx, 3, 1), jconv.pad(jx, 3, 1))
    for s in (1, 2, 3):
        same(tconv.upscale(tx, s), jconv.upscale(jx, s))
    for oh, ow in [(6, 8), (2, 3), (5, 7)]:
        for ac in (False, True):
            got = tconv.interpolate_bilinear(tx, oh, ow, align_corners=ac)
            ref = jconv.interpolate_bilinear(jx, oh, ow, align_corners=ac)
            assert nmse(host(got), host(ref)) < TOL["conv"]


# ---------------------------------------------------------- rope sweep -----
@pytest.mark.parametrize("mode", [0, 2])
@pytest.mark.parametrize("n_dims", [16, 32])
@pytest.mark.parametrize("freq_scale", [1.0, 0.5])
@pytest.mark.parametrize("t", [1, 7])
def test_rope_sweep(rng, mode, n_dims, freq_scale, t):
    """tests/test_backend_ops_sweep2.py's rope grid (normal mode only at
    the full head dim)."""
    if mode == 0 and n_dims != 32:
        n_dims = 32
    x = rng.standard_normal((2, t, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 100, (2, t)).astype(np.int32)
    (jx, tx), (jp, tp) = both(x), both(pos)
    got = trope.rope(tx, tp, n_dims, mode, freq_scale=freq_scale)
    ref = jrope.rope(jx, jp, n_dims, mode, freq_scale=freq_scale)
    assert nmse(host(got), host(ref)) < SWEEP2_NMSE
