"""Port parity: the LLaMA slice's elementwise ops against the JAX package.

rms_norm and silu (f32 and bf16 inputs) and rope in normal mode and NeoX
mode (with freq_scale != 1, and NeoX with n_dims < D, the dims past n_dims
passed through) on the same inputs. Tolerances: rms_norm and silu 2e-6 in
f32 (two libraries' exp and sqrt) and one bf16 step in bf16; rope 1e-5
against JAX (two libraries' sin and cos at positions up to ~1000) and
3e-3 against the golden vectors (the reference's CPU rope accumulates
theta by repeated products, as tests/test_ops.py notes). The arguments the
port does not take (YaRN, xPos, GLM mode) raise.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.ops import activations as jact
from ggml_imax_tpu.ops import norms as jnorms
from ggml_imax_tpu.ops import rope as jrope
from ggml_imax_tpu_torch.ops import activations as tact
from ggml_imax_tpu_torch.ops import norms as tnorms
from ggml_imax_tpu_torch.ops import rope as trope

GOLD = Path(__file__).parent / "fixtures" / "golden_rope.npz"


def _pair(x, dtype):
    t = torch.from_numpy(x)
    if dtype == "bf16":
        return t.to(torch.bfloat16), jnp.asarray(x).astype(jnp.bfloat16)
    return t, jnp.asarray(x)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_weight", [False, True])
def test_rms_norm_matches_reference(dtype, with_weight):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 256)) * 3).astype(np.float32)
    w = (rng.standard_normal(256) * 0.1 + 1).astype(np.float32)
    tx, jx = _pair(x, dtype)
    got = tnorms.rms_norm(tx, torch.from_numpy(w) if with_weight else None,
                          eps=1e-5)
    ref = jnorms.rms_norm(jx, jnp.asarray(w) if with_weight else None,
                          eps=1e-5)
    assert got.dtype == tx.dtype
    tol = 2e-6 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), _np(ref), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_silu_matches_reference(dtype):
    x = np.concatenate([np.linspace(-30, 30, 601),
                        np.random.default_rng(2).standard_normal(400) * 4,
                        [0.0, -0.0, 1e-30, -90.0, 90.0]]).astype(np.float32)
    tx, jx = _pair(x, dtype)
    got, ref = tact.silu(tx), jact.silu(jx)
    assert got.dtype == tx.dtype
    assert float(tact.silu(torch.zeros(3)).abs().max()) == 0.0
    tol = 2e-6 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), _np(ref), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("mode,n_dims,freq_scale,freq_base", [
    (0, None, 1.0, 10000.0), (0, None, 0.25, 10000.0), (0, 64, 0.5, 500.0),
    (2, None, 1.0, 10000.0), (2, None, 0.25, 10000.0), (2, 64, 0.5, 10000.0),
    (2, 32, 1.0, 1e6)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_matches_reference(mode, n_dims, freq_scale, freq_base, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 3, 128)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 7)).astype(np.int32)
    tx, jx = _pair(x, dtype)
    kw = dict(n_dims=n_dims, mode=mode, freq_base=freq_base,
              freq_scale=freq_scale)
    got = trope.rope(tx, torch.from_numpy(pos).long(), **kw)
    ref = jrope.rope(jx, jnp.asarray(pos), **kw)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), _np(ref), rtol=tol,
                               atol=tol)
    if mode == 2 and n_dims is not None:            # the dims past n_dims
        assert torch.equal(got[..., n_dims:], tx[..., n_dims:])


@pytest.mark.parametrize("case", ["normal", "normal_scaled", "normal_base",
                                  "neox", "neox_part"])
def test_rope_matches_golden_vectors(case):
    z = np.load(GOLD)
    nd, mode, _, _, fb, fs, ef, af, _, _ = z[f"rope_{case}_params"]
    assert ef == 0.0 and af == 1.0
    got = trope.rope(torch.from_numpy(z["x"])[None],
                     torch.from_numpy(z["pos"]).long()[None], n_dims=int(nd),
                     mode=int(mode), freq_base=float(fb), freq_scale=float(fs))
    assert np.abs(got[0].numpy() - z[f"rope_{case}"]).max() < 3e-3


def test_rope_split_is_rope_under_the_permutation():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 5, 2, 64)).astype(np.float32))
    pos = torch.arange(5)[None] * 37
    perm = torch.from_numpy(trope.split_rope_permutation(64))
    for nd in (None, 32):
        a = trope.rope(x, pos, n_dims=nd)[..., perm]
        b = trope.rope_split(x[..., perm], pos, n_dims=nd)
        assert torch.equal(a, b)


def test_unported_rope_arguments_raise():
    """The arguments rope once refused (GLM mode, YaRN, xPos) are ported
    now: they run, none raises NotImplementedError (their parity with the
    JAX package is tests/test_torch_rope_modes.py's); an odd n_dims still
    raises."""
    x = torch.ones(1, 2, 1, 8)
    pos = torch.arange(2, dtype=torch.long)[None]
    for kw in (dict(mode=4, n_ctx=4), dict(mode=2, ext_factor=1.0,
                                           freq_scale=0.5),
               dict(xpos_base=512.0)):
        y = trope.rope(x, pos, **kw)
        assert y.shape == x.shape and bool(torch.isfinite(y).all()), kw
    with pytest.raises(ValueError, match="even"):
        trope.rope(x, pos, n_dims=5)
