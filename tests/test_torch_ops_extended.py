"""Port parity for ops/ssm.py, ops/moe.py and the transposed convolutions
(ggml_imax_tpu_torch/ops/conv.py): the cases and tolerances of
tests/test_ops_extended.py and tests/test_moe.py (and the sweep's `conv`
NMSE), the same seeded numpy inputs through the JAX package's function
(jitted) and the port's on the host; plus top-k ties in moe_ffn, capacity
overflow in mul_mat_id_grouped and the ssm state carried across calls.
The rest of the op set is in tests/test_torch_ops_sweep.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu_torch.ops import conv as tconv
from ggml_imax_tpu_torch.ops import moe as tmoe
from ggml_imax_tpu_torch.ops import ssm as tssm
from test_torch_ops_sweep import TOL, both, host, jconv, jmoe, jssm, nmse, same


@pytest.fixture()
def rng():
    return np.random.default_rng(20250818)


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_conv_transpose_2d_p0(rng, stride):
    for cin, cout, k, h, w in [(3, 4, 3, 5, 6), (8, 2, 2, 4, 4)]:
        x = rng.standard_normal((1, cin, h, w)).astype(np.float32)
        k_ = rng.standard_normal((cin, cout, k, k)).astype(np.float32)
        (jx, tx), (jk, tk) = both(x), both(k_)
        got = tconv.conv_transpose_2d_p0(tx, tk, stride)
        ref = jconv.conv_transpose_2d_p0(jx, jk, stride)
        assert got.shape == ref.shape
        assert nmse(host(got), host(ref)) < TOL["conv"]




# ---------------------------------------------------------------- ssm ------
def ssm_inputs(rng, t, di=6, ds=4):
    return (rng.standard_normal((di, ds)).astype(np.float32) * 0.1,
            rng.standard_normal((t, di)).astype(np.float32),
            rng.standard_normal((t, di)).astype(np.float32),
            -np.abs(rng.standard_normal((di, ds))).astype(np.float32),
            rng.standard_normal((t, ds)).astype(np.float32),
            rng.standard_normal((t, ds)).astype(np.float32))


@pytest.mark.parametrize("t", [1, 12, 64])
def test_ssm_scan_matches_jax(rng, t):
    """tests/test_ops_extended.py's tolerance (rtol 1e-4, atol 1e-5): the
    reference's associative scan and the port's token loop sum in another
    order."""
    args = ssm_inputs(rng, t)
    args[2][0, :3] = [25.0, 20.0, -30.0]          # softplus's cut at 20
    gy, gh = tssm.ssm_scan(*[torch.from_numpy(a) for a in args])
    ry, rh = jssm.ssm_scan(*map(jnp.asarray, args))
    np.testing.assert_allclose(host(gy), host(ry), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(host(gh), host(rh), rtol=1e-4, atol=1e-5)


def test_ssm_state_carried_across_calls(rng):
    state, x, dt, a, b, c = [torch.from_numpy(v) for v in ssm_inputs(rng, 20)]
    y, h = tssm.ssm_scan(state, x, dt, a, b, c)
    y1, h1 = tssm.ssm_scan(state, x[:7], dt[:7], a, b[:7], c[:7])
    y2, h2 = tssm.ssm_scan(h1, x[7:], dt[7:], a, b[7:], c[7:])
    assert torch.equal(torch.cat([y1, y2]), y) and torch.equal(h2, h)
    cs = torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32))
    cw = torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32))
    y, s = tssm.ssm_conv(cs, x, cw)
    y1, s1 = tssm.ssm_conv(cs, x[:5], cw)
    y2, s2 = tssm.ssm_conv(s1, x[5:], cw)
    assert torch.equal(torch.cat([y1, y2]), y) and torch.equal(s2, s)


@pytest.mark.parametrize("dc", [1, 4])
def test_ssm_conv_matches_jax(rng, dc):
    t, di = 10, 5
    state = rng.standard_normal((di, dc - 1)).astype(np.float32)
    x = rng.standard_normal((t, di)).astype(np.float32)
    c = rng.standard_normal((di, dc)).astype(np.float32)
    gy, gs = tssm.ssm_conv(*[torch.from_numpy(a) for a in (state, x, c)])
    ry, rs = jssm.ssm_conv(*map(jnp.asarray, (state, x, c)))
    np.testing.assert_allclose(host(gy), host(ry), rtol=1e-5, atol=1e-5)
    same(gs, rs)


# ---------------------------------------------------------------- moe ------
@pytest.fixture
def problem(rng):
    e, k, n, t, u = 4, 16, 8, 10, 2
    return (rng.standard_normal((e, k, n)).astype(np.float32),
            rng.standard_normal((t, k)).astype(np.float32),
            rng.integers(0, e, (t, u)).astype(np.int32))


def test_mul_mat_id_dense_and_grouped(problem):
    """tests/test_moe.py's tolerance (rtol 1e-5, atol 1e-5)."""
    as_, x, ids = problem
    ja, ta = both(as_)
    jx, tx = both(x)
    ji, ti = both(ids)
    ref = jmoe.mul_mat_id(ja, jx, ji)
    np.testing.assert_allclose(host(tmoe.mul_mat_id(ta, tx, ti)), host(ref),
                               rtol=1e-5, atol=1e-5)
    for cap in (32, None):
        got = tmoe.mul_mat_id_grouped(ta, tx, ti, capacity=cap)
        ref = jmoe.mul_mat_id_grouped(ja, jx, ji, capacity=cap)
        np.testing.assert_allclose(host(got), host(ref), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("cap", [1, 3, 4])
def test_mul_mat_id_grouped_capacity_overflow(rng, cap):
    """Over-capacity rows give zeros, the earlier rows of an expert are
    kept, as the reference's cumsum rank decides."""
    e, k, n = 3, 8, 4
    as_ = rng.standard_normal((e, k, n)).astype(np.float32)
    x = rng.standard_normal((7, k)).astype(np.float32)
    ids = np.array([[0, 1], [0, 0], [2, 0], [1, 1], [0, 2], [1, 0], [0, 0]],
                   np.int32)
    got = host(tmoe.mul_mat_id_grouped(*[torch.from_numpy(a) for a in
                                         (as_, x, ids)], capacity=cap))
    ref = host(jmoe.mul_mat_id_grouped(*map(jnp.asarray, (as_, x, ids)),
                                       capacity=cap))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got == 0, ref == 0)
    assert (np.abs(got).sum(-1) == 0).sum() > 0


def moe_weights(rng, e_emb=12, f=24, ne=4):
    return (rng.standard_normal((e_emb, ne)).astype(np.float32),
            rng.standard_normal((ne, e_emb, f)).astype(np.float32),
            rng.standard_normal((ne, e_emb, f)).astype(np.float32),
            rng.standard_normal((ne, f, e_emb)).astype(np.float32))


@pytest.mark.parametrize("n_used", [1, 2, 3])
def test_moe_ffn_matches_jax(rng, n_used):
    """tests/test_moe.py's tolerance (rtol 1e-4, atol 1e-4)."""
    x = rng.standard_normal((6, 12)).astype(np.float32)
    ws = moe_weights(rng)
    got = tmoe.moe_ffn(*[torch.from_numpy(a) for a in (x,) + ws],
                       n_used=n_used)
    ref = jmoe.moe_ffn(*map(jnp.asarray, (x,) + ws), n_used=n_used)
    np.testing.assert_allclose(host(got), host(ref), rtol=1e-4, atol=1e-4)


def test_moe_ffn_top_k_ties_take_the_lower_expert(rng):
    """Routers with equal columns give equal logits: lax.top_k keeps the
    lower expert index first, and so must the port (different experts
    behind the tied logits, so a wrong pick shows in the output)."""
    x = rng.standard_normal((6, 12)).astype(np.float32)
    router, wu, wg, wd = moe_weights(rng, ne=5)
    router[:, 3] = router[:, 1]                    # experts 1 and 3 tie
    router[:, 4] = router[:, 0]                    # experts 0 and 4 tie
    for n_used in (1, 2, 3):
        got = tmoe.moe_ffn(*[torch.from_numpy(a) for a in
                             (x, router, wu, wg, wd)], n_used=n_used)
        ref = jmoe.moe_ffn(*map(jnp.asarray, (x, router, wu, wg, wd)),
                           n_used=n_used)
        np.testing.assert_allclose(host(got), host(ref), rtol=1e-4,
                                   atol=1e-4)
        logits = x @ router
        top = np.argsort(-logits, kind="stable")[:, :n_used]
        assert (np.isin(top, [3, 4])).sum() < top.size      # not all ties
