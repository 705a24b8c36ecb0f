"""Port parity for rope's modes (ggml_imax_tpu_torch/ops/rope.py): GLM,
YaRN (freq_scale 0.25 with ext_factor), xPos up and down and the backward
rotation, each against the JAX package's rope (jitted) at the rope NMSE of
tests/test_backend_ops_sweep2.py (1e-9); rope(forward=False) inverting
rope at that file's 1e-10; the rope_split identity P(rope(x)) ==
rope_split(P(x)) bit for bit in every normal-mode variant; and the routes
the models take (modes 0 and 2, linear freq_scale, n_dims under the head
dim, rope_split) bit for bit against the port's rope before YaRN, xPos
and GLM were added (its code kept here as `seed_rope`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.ops import rope as jrope_mod
from ggml_imax_tpu_torch.ops import rope as trope

NMSE = 1e-9


def nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2) / (np.mean(b * b) + 1e-300))


@functools.lru_cache
def _jitted(n_dims, mode, items):
    return jax.jit(lambda x, p: jrope_mod.rope(x, p, n_dims, mode,
                                               **dict(items)))


def jrope(x, pos, n_dims=None, mode=0, **kw):
    return np.asarray(_jitted(n_dims, mode, tuple(sorted(kw.items())))(
        jnp.asarray(x), jnp.asarray(pos)))


def inputs(seed, shape=(2, 9, 3, 32), n_pos=4096):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, n_pos, shape[:2]).astype(np.int32)
    pos[0, :3] = [0, 1, n_pos - 1]
    return x, pos


def port(x, pos, n_dims=None, mode=0, **kw):
    return trope.rope(torch.from_numpy(x), torch.from_numpy(pos), n_dims,
                      mode, **kw).numpy()


YARN = dict(freq_scale=0.25, ext_factor=1.0, attn_factor=1.0, n_orig_ctx=512,
            beta_fast=32.0, beta_slow=1.0)
CASES = {
    "glm": (4, None, dict(n_ctx=64)),
    "glm_backward": (4, None, dict(n_ctx=64, forward=False)),
    "glm_n_dims": (4, 16, dict(n_ctx=130, freq_base=500.0)),
    "yarn_normal": (0, None, YARN),
    "yarn_normal_mscale": (0, None, dict(YARN, attn_factor=0.8)),
    "yarn_neox": (2, None, YARN),
    "yarn_neox_n_dims": (2, 16, dict(YARN, n_ctx=1024, n_orig_ctx=0)),
    "yarn_half_ext": (0, 16, dict(YARN, ext_factor=0.5, beta_fast=16.0)),
    "xpos_up": (0, None, dict(xpos_base=512.0)),
    "xpos_down": (0, None, dict(xpos_base=512.0, xpos_down=True)),
    "backward_normal": (0, None, dict(forward=False)),
    "backward_neox": (2, 24, dict(forward=False, freq_scale=0.5)),
    "backward_yarn_xpos": (0, None, dict(YARN, xpos_base=256.0,
                                         forward=False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mode_matches_jax(case):
    mode, n_dims, kw = CASES[case]
    x, pos = inputs(sum(map(ord, case)))
    got = port(x, pos, n_dims, mode, **kw)
    ref = jrope(x, pos, n_dims, mode, **kw)
    assert nmse(got, ref) < NMSE, (case, nmse(got, ref))


@pytest.mark.parametrize("case", ["glm", "yarn_normal", "yarn_neox",
                                  "xpos_up", "xpos_down", "plain_neox"])
def test_backward_inverts_forward(case):
    """The ROPE_BACK contract (tests/test_backend_ops_sweep2.py): forward
    then backward gives x back; with xPos the scaling is undone only by
    the other direction of zeta, so xPos is inverted with xpos_down
    flipped; YaRN scales both directions by its mscale, so x comes back
    times mscale^2."""
    mode, n_dims, kw = CASES.get(case, (2, None, {}))
    x, pos = inputs(7, n_pos=64)
    y = trope.rope(torch.from_numpy(x), torch.from_numpy(pos), n_dims, mode,
                   **kw)
    back_kw = dict(kw, forward=False)
    if "xpos_base" in kw:
        back_kw["xpos_down"] = not kw.get("xpos_down", False)
    back = trope.rope(y, torch.from_numpy(pos), n_dims, mode, **back_kw)
    gain = 1.0
    if kw.get("ext_factor", 0.0):
        gain = (kw["attn_factor"] * (1 + 0.1 * np.log(1 / kw["freq_scale"])))
    assert nmse(back.numpy(), x * gain ** 2) < 1e-10


SPLIT_CASES = {
    "plain": dict(),
    "freq_base": dict(freq_base=500.0),
    "freq_scale": dict(freq_scale=0.5),
    "yarn": YARN,
    "xpos_up": dict(xpos_base=512.0),
    "xpos_down": dict(xpos_base=512.0, xpos_down=True),
    "backward": dict(forward=False, freq_scale=0.25),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
@pytest.mark.parametrize("n_dims", [None, 16])
def test_rope_split_identity_bit_for_bit(case, n_dims):
    kw = SPLIT_CASES[case]
    x, pos = inputs(11)
    perm = trope.split_rope_permutation(32)
    tx, tp = torch.from_numpy(x), torch.from_numpy(pos)
    a = trope.rope(tx, tp, n_dims, 0, **kw)[..., perm]
    b = trope.rope_split(tx[..., perm], tp, n_dims, **kw)
    assert torch.equal(a, b), case


# ---- the routes the models take, against the port's rope before this
# slice (ggml_imax_tpu_torch/ops/rope.py as it was: modes 0 and 2, linear
# freq_scale; rope_split with freq_base only)

def _seed_tables(x, pos, n_pairs, n_dims, freq_base, freq_scale,
                 pos_scale=1.0):
    theta_scale = torch.full((), freq_base ** (-2.0 / n_dims),
                             dtype=torch.float32, device=x.device)
    i = torch.arange(n_pairs, dtype=torch.float32, device=x.device)
    p = pos.float()[..., None, None]
    if pos_scale != 1.0:
        p = p * pos_scale
    theta = p * theta_scale ** i
    if freq_scale != 1.0:
        theta = freq_scale * theta
    return torch.cos(theta), torch.sin(theta)


def seed_rope(x, pos, n_dims=None, mode=0, *, freq_base=10000.0,
              freq_scale=1.0):
    n_dims = n_dims or x.shape[-1]
    D = x.shape[-1]
    xf = x.float()
    if mode == 2:
        h = n_dims // 2
        cos_t, sin_t = _seed_tables(x, pos, h, n_dims, freq_base, freq_scale,
                                    pos_scale=freq_scale)
        x0, x1 = xf[..., :h], xf[..., h:n_dims]
        out = torch.cat([x0 * cos_t - x1 * sin_t, x0 * sin_t + x1 * cos_t,
                         xf[..., n_dims:]], dim=-1)
        return out.to(x.dtype)
    cos_t, sin_t = _seed_tables(x, pos, D // 2, n_dims, freq_base,
                                freq_scale)
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x0 * cos_t - x1 * sin_t, x0 * sin_t + x1 * cos_t],
                      dim=-1).reshape(xf.shape)
    return out.to(x.dtype)


def seed_rope_split(x, pos, n_dims=None, *, freq_base=10000.0):
    D = x.shape[-1]
    cos_t, sin_t = _seed_tables(x, pos, D // 2, n_dims or D, freq_base, 1.0)
    xf = x.float()
    x0, x1 = xf[..., : D // 2], xf[..., D // 2:]
    out = torch.cat([x0 * cos_t - x1 * sin_t, x0 * sin_t + x1 * cos_t], dim=-1)
    return out.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,n_dims,kw", [
    (0, None, {}), (0, 64, {}), (0, None, dict(freq_scale=0.5)),
    (0, 16, dict(freq_base=500.0)), (2, None, {}), (2, 32, {}),
    (2, None, dict(freq_scale=0.25, freq_base=1e6)), (2, 64, dict())])
def test_model_routes_unchanged_bit_for_bit(dtype, mode, n_dims, kw):
    x, pos = inputs(13, shape=(2, 5, 4, 128))
    tx, tp = torch.from_numpy(x).to(dtype), torch.from_numpy(pos)
    assert torch.equal(trope.rope(tx, tp, n_dims, mode, **kw),
                       seed_rope(tx, tp, n_dims, mode, **kw))
    if mode == 0 and "freq_scale" not in kw:
        assert torch.equal(trope.rope_split(tx, tp, n_dims, **kw),
                           seed_rope_split(tx, tp, n_dims, **kw))
