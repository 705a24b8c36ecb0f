"""Port parity: the serving slice's KV-cell writes, cell mask, celled and
fused decode attention, and the device sampler. The same numpy inputs go
through the JAX package (its Pallas kernels in interpret mode) and the
port's plain versions on the CPU.

Tolerances: KV writes, scales, masks and arena contents bit-exact;
attention outputs atol 2e-2, the JAX package's own for decode attention
(tests/test_stacked_decode.py; p is rounded to bf16 relative to a running
max in the reference and to the global max in the plain version); sampled
ids identical under the same Gumbel noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.models import common as jcommon
from ggml_imax_tpu.ops import decode_attention as jdec
from ggml_imax_tpu.ops import sampling as jsampling
from ggml_imax_tpu_torch.models import common as tcommon
from ggml_imax_tpu_torch.ops import decode_attention as tdec
from ggml_imax_tpu_torch.ops import sampling as tsampling

T = torch.from_numpy
KV = {"bf16": (jnp.bfloat16, torch.bfloat16), "q8_0": ("q8_0", "q8_0")}


def as_np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def assert_same_cache(tc, jc):
    for name in ("k", "v", "ks", "vs"):
        a, b = getattr(tc, name), getattr(jc, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(as_np(a), as_np(b), err_msg=name)


def caches(kv, L, B, n_ctx, H, D):
    jd, td = KV[kv]
    return (jcommon.init_kv_cache(L, B, n_ctx, H, D, jd, flat=True),
            tcommon.init_kv_cache(L, B, n_ctx, H, D, td, device="cpu"))


def fill(jc, tc, rng, li, B, n, H, D):
    """The same random K/V into rows [0, n) of layer li of both arenas."""
    k, v = (rng.standard_normal((B, n, H, D)).astype(np.float32)
            for _ in range(2))
    jc = jcommon.update_kv(jc, li, jnp.asarray(k), jnp.asarray(v), 0)
    tcommon.update_kv(tc, li, T(k), T(v), 0)
    return jc


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_update_kv_cells_bit_exact(kv):
    L, B, N, H, D, Tn = 2, 2, 32, 2, 64, 5
    rng = np.random.default_rng(0)
    jc, tc = caches(kv, L, B, N, H, D)
    cells = np.stack([rng.permutation(N)[:Tn] for _ in range(B)]) \
        .astype(np.int32)
    k, v = (rng.standard_normal((B, Tn, H, D)).astype(np.float32) * 3
            for _ in range(2))
    jc = jcommon.update_kv_cells(jc, 1, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(cells))
    out = tcommon.update_kv_cells(tc, 1, T(k), T(v), T(cells).long())
    assert out is tc
    assert_same_cache(tc, jc)


def test_cells_attention_mask_exact():
    n_ctx, Tn = 48, 6
    rng = np.random.default_rng(1)
    cell_pos = rng.integers(-1, 20, n_ctx).astype(np.int32)
    cell_seq = rng.integers(0, 2 ** 32, n_ctx, dtype=np.uint64) \
        .astype(np.uint32)
    cell_seq[:4] = np.uint32(1 << 31)            # cells tagged with seq 31
    cell_seq[4] = np.uint32(0xFFFFFFFF)
    tok_pos = rng.integers(0, 20, Tn).astype(np.int32)
    tok_seq = np.array([0, 3, 31, 30, 31, 7], np.int32)
    ref = jcommon.cells_attention_mask(
        jnp.asarray(tok_pos[None]), jnp.asarray(tok_seq[None]),
        jnp.asarray(cell_pos[None]), jnp.asarray(cell_seq[None]))
    got = tcommon.cells_attention_mask(
        T(tok_pos[None]), T(tok_seq[None]), T(cell_pos[None]),
        T(cell_seq.view(np.int32)[None]))
    assert got.shape == (1, 1, Tn, n_ctx) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[0, 0, 2, :4] == 0).any()          # seq 31 sees its cells


def cells_case(rng, n_ctx, nb, n_pad):
    """A registry where each query row sees a random subset of cells (its
    sequence's) and the last n_pad rows are pads (seq 31, nothing visible).
    Returns the (nb, n_ctx) additive mask as numpy."""
    cell_pos = np.arange(n_ctx, dtype=np.int32)
    cell_seq = (np.uint32(1) << rng.integers(0, nb - n_pad, n_ctx)
                .astype(np.uint32)).astype(np.uint32)
    cell_pos[rng.random(n_ctx) < 0.2] = -1
    tok_seq = np.r_[np.arange(nb - n_pad), np.full(n_pad, 31)].astype(np.int32)
    tok_pos = np.full(nb, n_ctx, np.int32)
    m = jcommon.cells_attention_mask(
        jnp.asarray(tok_pos[None]), jnp.asarray(tok_seq[None]),
        jnp.asarray(cell_pos[None]), jnp.asarray(cell_seq[None]))
    return np.array(m)[0, 0]


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)])
def test_decode_attention_cells_matches_kernel(kv, hq, hkv):
    L, N, D, NB = 2, 64, 128, 3
    rng = np.random.default_rng(2)
    jc, tc = caches(kv, L, 1, N, hkv, D)
    for li in range(L):
        jc = fill(jc, tc, rng, li, 1, N, hkv, D)
    mask = cells_case(rng, N, NB, n_pad=1)
    assert np.isneginf(mask[-1]).all()            # the pad row sees nothing
    q = rng.standard_normal((NB, 1, hq, D)).astype(np.float32)
    for li in range(L):
        ref = jdec.decode_attention_cells(jc, li, jnp.asarray(q),
                                          jnp.asarray(mask), interpret=True)
        got = tdec.decode_attention_cells(tc, li, T(q), T(mask))
        assert got.shape == (NB, 1, hq, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=2e-2)
    # the pad row's output is the mean of V over the arena
    v = tcommon.read_kv(tc, L - 1, dtype=torch.float32)[1][0].float()
    np.testing.assert_allclose(got[-1, 0, ::hq // hkv].numpy(),
                               v.mean(0).numpy(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_decode_attention_update_flat_matches_kernel(kv):
    L, B, N, H, D, n_past = 2, 2, 64, 2, 128, 40
    rng = np.random.default_rng(3)
    jc, tc = caches(kv, L, B, N, H, D)
    jc = fill(jc, tc, rng, 1, B, N, H, D)        # row n_past holds stale data
    q, kn, vn = (rng.standard_normal((B, 1, H, D)).astype(np.float32)
                 for _ in range(3))
    pos = np.full((B, 1), n_past, np.int32)
    jmask = jcommon.attention_mask(jnp.asarray(pos), N, n_past)
    tmask = tcommon.attention_mask(T(pos).long(), N, n_past)
    ref, jc = jdec.decode_attention_update_stacked(
        jc, 1, jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), n_past,
        jmask, interpret=True)
    before = {n: getattr(tc, n).clone() for n in ("k", "v") + (
        ("ks", "vs") if tc.quantized else ())}
    got, out_cache = tdec.decode_attention_update(tc, 1, T(q), T(kn), T(vn),
                                                  n_past, tmask)
    assert out_cache is tc and got.shape == (B, 1, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-2)
    assert_same_cache(tc, jc)                    # written rows exact
    for n, t in before.items():                  # and nothing else moved
        keep = torch.ones(N, dtype=torch.bool)
        keep[n_past] = False
        assert torch.equal(getattr(tc, n)[:, :, keep], t[:, :, keep])
        assert torch.equal(getattr(tc, n)[0], t[0])


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)])
def test_decode_attention_update_cells_matches_kernel(kv, hq, hkv):
    L, N, D, NB = 2, 64, 128, 3
    rng = np.random.default_rng(4)
    jc, tc = caches(kv, L, 1, N, hkv, D)
    jc = fill(jc, tc, rng, 0, 1, N, hkv, D)
    mask = cells_case(rng, N, NB, n_pad=1)
    rows = np.array([5, 17, N - 1], np.int32)     # the pad row: the trash cell
    mask[np.arange(NB - 1), rows[:-1]] = 0.0      # each row's own cell
    q = rng.standard_normal((NB, 1, hq, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((NB, 1, hkv, D)).astype(np.float32)
              for _ in range(2))
    ref, jc = jdec.decode_attention_update_cells(
        jc, 0, jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(rows), jnp.asarray(mask), interpret=True)
    got, _ = tdec.decode_attention_update_cells(
        tc, 0, T(q), T(kn), T(vn), T(rows), T(mask))
    assert got.shape == (NB, hq, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-2)
    assert_same_cache(tc, jc)


def test_select_decode_path():
    sel = tdec.select_decode_path
    m = torch.zeros(1)
    assert sel(T=8, B=1, D=128, cells=m, cells_kernel=True, mask=m) == "cells2"
    assert sel(T=8, B=1, D=128, cells=m, cells_kernel=True, mask=m,
               fused_kv_update=True) == "cells"
    assert sel(T=8, B=1, D=128, cells=m, mask=m) == "xla"       # mixed
    assert sel(T=8, B=1, D=64, cells=m, cells_kernel=True, mask=m) == "xla"
    assert sel(T=1, B=2, D=256, cells=None) == "kernel"
    assert sel(T=1, B=1, D=256, cells=None, fused_kv_update=True) == "fused"
    assert sel(T=16, B=1, D=256, cells=None, fused_kv_update=True) == "xla"


def test_sample_device_matches_reference_under_shared_noise():
    nb, V, k_max = 6, 300, 64
    rng = np.random.default_rng(5)
    temp = np.array([0.5, 1.0, 1.5, 0.8, 1.2, 0.9], np.float32)
    top_k = np.array([40, 1, 0, 64, 10, -1], np.int32)      # <= 0: the window
    top_p = np.array([0.9, 0.95, 1.0, 0.0, 0.5, -1.0], np.float32)  # <= 0: greedy
    ref_k = np.where(top_k <= 0, k_max, top_k)     # what the reference is fed
    for i in range(8):
        logits = (rng.standard_normal((nb, V)) * 3).astype(np.float32)
        key = jax.random.key(i)
        noise = np.array(jax.random.gumbel(key, (nb, k_max)))
        ref = jsampling.sample_device(
            jnp.asarray(logits), key, top_k=jnp.asarray(ref_k)[:, None],
            top_p=jnp.asarray(top_p)[:, None], temp=jnp.asarray(temp)[:, None],
            k_max=k_max)
        got = tsampling.sample_gumbel(
            T(logits), T(noise), top_k=T(top_k).long()[:, None],
            top_p=T(top_p)[:, None], temp=T(temp)[:, None])
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert got[1] == int(np.argmax(logits[1]))          # top_k 1
        for row in (3, 5):                                   # top_p <= 0
            assert got[row] == int(np.argmax(logits[row]))


def test_sample_device_draws_from_a_generator():
    gen = torch.Generator()
    gen.manual_seed(0)
    logits = torch.randn(4, 100, generator=gen)
    ids = tsampling.sample_device(logits, gen, top_k=5, top_p=0.9, temp=0.7,
                                  k_max=64)
    top5 = logits.topk(5).indices
    assert ids.shape == (4,) and bool((top5 == ids[:, None]).any(-1).all())
