"""The flash backward's tile map and skip rule (ops/flash_backward.py,
csrc/flash_backward.cu), on the CPU.

- `backward_tile_map_plain` against a direct loop over the 64 x 64 tiles.
- P and dS are exactly 0 on the scores `skipped_plain` marks (the all-NEG
  tiles whose query rows all have lse > -1e30), so zeroing them changes no
  bit of `flash_attention_bwd_plain`'s dq, dk and dv: the skip is exact.
- The port's backward (`flash_attention_bwd`) on these masks against the
  JAX package's, whose Pallas backward kernels run in interpret mode, on the
  same out and lse, within 1e-2 of each gradient's largest magnitude (the
  tolerance of tests/test_torch_flash_backward.py: both round q/k/v/dO and
  P, dS to bf16 at the same points and sum in f32).

Masks hide keys with -inf, as the port's models do (`_prep` clamps them to
NEG): causal at a ragged T, a sliding window, a cell-style block mask, a
fully masked row in tiles that would otherwise be skipped, ALiBi (with key
distances in the mask), softcap and GQA 8:2 on a rectangular causal mask.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.ops import flash_backward as jfb
from ggml_imax_tpu_torch.models.common import attention_mask
from ggml_imax_tpu_torch.ops import flash_attention as tfa
from ggml_imax_tpu_torch.ops import flash_backward as tfb
from ggml_imax_tpu_torch.ops.decode_attention import NEG

SCALE = 0.25


def visible(kind, Tq, Tk):
    """(Tq, Tk) bool of the keys each query sees."""
    i = np.arange(Tq)[:, None] + (Tk - Tq)
    j = np.arange(Tk)[None, :]
    if kind == "window":                   # the last 48 keys up to i
        return (j <= i) & (j > i - 48)
    if kind == "cells":                    # three packed sequences
        seq = np.searchsorted([70, 130], np.arange(Tk), side="right")
        return (j <= i) & (seq[None, :] == seq[i])
    return j <= i


CASES = {
    # B, Tq, Tk, Hq, Hkv, D, mask kind, softcap, max_bias, fully masked row
    "causal": (1, 200, 200, 2, 2, 32, "causal", 0.0, 0.0, None),
    "window": (1, 200, 200, 2, 2, 32, "window", 0.0, 0.0, None),
    "cells": (2, 200, 200, 2, 2, 32, "cells", 0.0, 0.0, None),
    "masked_row": (1, 200, 200, 2, 2, 32, "causal", 0.0, 0.0, 5),
    "alibi": (1, 200, 200, 4, 4, 32, "causal", 0.0, 8.0, None),
    "softcap": (1, 200, 200, 2, 2, 32, "causal", 5.0, 0.0, None),
    "gqa": (1, 100, 200, 8, 2, 32, "causal", 0.0, 0.0, None),
}


def inputs(name, seed=20241017):
    B, Tq, Tk, Hq, Hkv, D, kind, _, max_bias, row = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32)
    vis = visible(kind, Tq, Tk)
    fill = 0.0
    if max_bias:                           # ALiBi: the key's distance
        fill = (np.arange(Tk)[None, :] - np.arange(Tq)[:, None]
                - (Tk - Tq)).astype(np.float32)
    m = np.where(vis, fill, -np.inf).astype(np.float32)
    if row is not None:
        m[row] = -np.inf
    mask = np.broadcast_to(m[None, None], (B, 1, Tq, Tk)).copy()
    do = rng.standard_normal((B, Tq, Hq, D)).astype(np.float32)
    return q, k, v, mask, do


def prepared(name):
    """The backward's prepared inputs, from the port's plain forward."""
    softcap, max_bias = CASES[name][7], CASES[name][8]
    q, k, v, mask, do = inputs(name)
    qb, kb, vb, m3, slopes = tfa._prep(*map(torch.from_numpy, (q, k, v, mask)),
                                       max_bias)
    out, lse = tfa.flash_attention_plain(qb, kb, vb, m3, slopes, SCALE,
                                         softcap, True)
    di = (torch.from_numpy(do) * out).sum(-1).transpose(1, 2).contiguous()
    dob = torch.from_numpy(do).to(torch.bfloat16)
    return (qb, kb, vb, dob, m3, slopes, lse, di, SCALE, softcap)


@pytest.mark.parametrize("name", CASES)
def test_tile_map_matches_direct(name):
    m3 = prepared(name)[4]
    got = tfb.backward_tile_map_plain(m3).numpy()
    B, Tq, Tk = m3.shape
    m = m3.numpy()
    T = tfb.TILE
    want = np.empty((B, -(-Tq // T), -(-Tk // T)), np.uint8)
    for b, i, j in np.ndindex(*want.shape):
        tile = m[b, i * T:(i + 1) * T, j * T:(j + 1) * T]
        want[b, i, j] = (tfb.TILE_NEG if (tile == np.float32(NEG)).all()
                         else tfb.TILE_ZERO if (tile == 0).all()
                         else tfb.TILE_MIXED)
    np.testing.assert_array_equal(got, want)
    assert (want == tfb.TILE_NEG).any() and (want == tfb.TILE_MIXED).any()


def p_ds(qb, kb, vb, dob, m3, slopes, lse, di, scale, softcap):
    """P and dS (B, Hq, Tq, Tk) f32 as flash_attention_bwd_plain forms them
    before rounding them to bf16 for its products."""
    rep = qb.shape[2] // kb.shape[2]
    qf, dof = (t.float().transpose(1, 2) for t in (qb, dob))
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(rep, dim=1)
              for t in (kb, vb))
    s = (qf @ kf.transpose(-1, -2)) * scale
    t = None
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    mb = m3[:, None]
    if slopes is not None:
        mb = mb * slopes.reshape(1, -1, 1, 1)
    p = torch.exp(torch.clamp(s + mb, min=NEG) - lse[..., None])
    ds = p * (dof @ vf.transpose(-1, -2) - di[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    return p, ds


@pytest.mark.parametrize("name", CASES)
def test_skipping_changes_no_bit(name):
    """P and dS are exactly 0 on every score `skipped_plain` marks, with the
    guard over 64-row tiles (the dQ kernel, dK/dV at D 64 and 256) and over
    32-row steps (dK/dV at D 128): zeroing them, as a skipped tile does,
    changes no bit of the plain backward's dq, dk and dv."""
    args = prepared(name)
    m3, slopes, lse = args[4], args[5], args[6]
    tiles = tfb.backward_tile_map_plain(m3)
    p, ds = p_ds(*args)
    row = CASES[name][9]
    for rows in (tfb.TILE, 32):
        skip = tfb.skipped_plain(tiles, lse, slopes, m3.shape[2], rows)
        assert skip.shape == p.shape and bool(skip.any())
        if row is not None:   # its lse is about NEG: its rows are computed
            assert float(lse[:, :, row].max()) < -1e30
            assert not bool(skip[:, :, row // rows * rows:
                                 (row // rows + 1) * rows].any())
        assert bool((p[skip] == 0).all()) and bool((ds[skip] == 0).all())
    # the 32-row guard skips all the 64-row one does
    wide, narrow = (tfb.skipped_plain(tiles, lse, slopes, m3.shape[2], r)
                    for r in (tfb.TILE, 32))
    assert bool((narrow | ~wide).all())
    assert tfb.dkv_rows(64) == tfb.dkv_rows(256) == tfb.TILE
    assert tfb.dkv_rows(128) == 32


@pytest.mark.parametrize("name", CASES)
def test_backward_matches_reference_kernels(name):
    """The port's backward entry and the JAX package's, fed the same forward
    out and lse (the port's; the JAX forward pads Tk to a multiple of 128, and
    at a ragged Tk a fully masked row's uniform P then counts its padded
    keys, a difference of the forwards that is not under test here)."""
    softcap, max_bias = CASES[name][7], CASES[name][8]
    kw = dict(scale=SCALE, logit_softcap=softcap, max_bias=max_bias)
    q, k, v, mask, do = inputs(name)
    qt, kt, vt, mt, dot = map(torch.from_numpy, (q, k, v, mask, do))
    out, lse = tfa.flash_attention(qt, kt, vt, mt, out_dtype=torch.float32,
                                   want_lse=True, **kw)
    got = tfb.flash_attention_bwd(qt, kt, vt, mt, out, lse, dot, **kw)
    B, Tq, Hq, _ = q.shape
    tq = -(-Tq // 8) * 8                     # the JAX layout at block_q 256
    lse_j = np.pad(lse.numpy().reshape(B * Hq, Tq), ((0, 0), (0, tq - Tq)))
    lse_j = np.repeat(lse_j[..., None], 8, -1)
    want = jfb.flash_attention_bwd(*map(jnp.asarray, (q, k, v, mask)),
                                   jnp.asarray(out.numpy()),
                                   jnp.asarray(lse_j), jnp.asarray(do),
                                   block_q=256, block_k=512, interpret=True,
                                   **kw)
    for label, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-2, f"d{label}: {err:.3e}"


def test_training_mask_computes_36_of_64_tiles():
    """GPT-2 117M training's causal mask (B 8, T 512, attention_mask as
    gpt2.forward builds it): 36 of the 64 tile pairs hold a visible key, the
    28 above the diagonal are all NEG, the 8 on it mixed."""
    pos = torch.arange(512)[None].expand(8, 512)
    m3 = tfa._prep(torch.zeros(8, 512, 1, 16), torch.zeros(8, 512, 1, 16),
                   torch.zeros(8, 512, 1, 16), attention_mask(pos, 512, 0),
                   0.0)[3]
    tiles = tfb.backward_tile_map_plain(m3)
    assert tiles.shape == (8, 8, 8)
    i, j = torch.meshgrid(torch.arange(8), torch.arange(8), indexing="ij")
    want = torch.where(j > i, tfb.TILE_NEG,
                       torch.where(j == i, tfb.TILE_MIXED, tfb.TILE_ZERO))
    assert torch.equal(tiles, want.to(torch.uint8).expand(8, 8, 8))
    assert int((tiles[0] != tfb.TILE_NEG).sum()) == 36
