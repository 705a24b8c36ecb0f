"""The fused KV write + decode attention kernel (csrc/decode_attention_update.cu)
on the CPU: its launch plan at the update's shapes (`decode_plan` blocks of
one thread-block cluster, `decode_slices` keys a rank, the rank that owns
each destination row and writes it), a plain model of the kernel's order
of arithmetic held to the plain version and to the JAX package's fused
kernels (interpret mode), and the wrapper's gates. The kernel itself is
held to its plain version on the card in tests/test_torch_cuda.py.

Tolerances: the model against decode_attention_update_plain rel 1e-2 (the
card test's; p is rounded to bf16 against a running max per 64-key chunk
in the model and the kernel, against the row's global max in the plain
version); against the JAX package atol 2e-2, as
tests/test_torch_cells_attention.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.models import common as jcommon
from ggml_imax_tpu.ops import decode_attention as jdec
from ggml_imax_tpu_torch import _build
from ggml_imax_tpu_torch.models import common as tcommon
from ggml_imax_tpu_torch.ops import decode_attention as da

CHUNK = 64              # keys of one ring stage of the kernel
KV = {"bf16": (jnp.bfloat16, torch.bfloat16), "q8_0": ("q8_0", "q8_0")}


def owner(row, T, S):
    """The rank whose slice holds arena row `row`: the one block of a kv
    head that reads it, and so the one that writes the fresh row there."""
    hits = [r for r, (lo, hi) in enumerate(da.decode_slices(T, S))
            if lo <= row < hi]
    assert len(hits) == 1
    return hits[0]


@pytest.mark.parametrize("mode,B,hkv,T,S", [
    ("flat", 1, 16, 512, 8),         # GPT-J's Engine: 128 blocks of 64 keys
    ("cells", 1, 16, 2048, 8),       # the serving ubatch: 128 blocks of 256
    ("flat", 8, 16, 512, 1),         # batch 8 fills the SMs unsplit
])
def test_plan_at_the_update_shapes(mode, B, hkv, T, S):
    assert da.decode_plan(B, hkv, T) == S
    chunk = -(-T // S)
    assert da.decode_slices(T, S) == [(r * chunk, (r + 1) * chunk)
                                      for r in range(S)]


@pytest.mark.parametrize("T", [9, 200, 512, 2048])
@pytest.mark.parametrize("S", [1, 3, 8])
def test_every_destination_row_has_one_owner(T, S):
    """Each row of [0, T) lies in exactly one rank's slice: rank row //
    ceil(T/S); ranks past the last key own none."""
    chunk = -(-T // S)
    owners = [owner(row, T, S) for row in range(T)]
    assert owners == [row // chunk for row in range(T)]


@pytest.mark.parametrize("T,rows,want", [
    (512, [0, 63, 64, 127, 448, 511], [0, 0, 1, 1, 7, 7]),
    (2048, [0, 255, 256, 1791, 1792, 2047], [0, 0, 1, 6, 7, 7]),
])
def test_rank_edges_own_their_rows(T, rows, want):
    """The first and the last key of a rank, and T - 1 (the trash cell of a
    cells arena), at the main paths' S 8."""
    assert [owner(r, T, 8) for r in rows] == want


def kernel_order(q3, k, v, ks, vs, kn, vn, kns, vns, mask2, rows, hkv, scale,
                 S):
    """The kernel's order of arithmetic: each rank of the cluster takes its
    slice in 64-key chunks, online (a running max, p rounded to bf16 against
    it, l and acc rescaled in f32); the ranks' (m, l, acc) are merged in
    rank order; the fresh row (its p not rounded) is folded in last."""
    NB, Hq, D = q3.shape
    T = k.shape[1]
    rep = Hq // hkv
    kd = da._dense(k, ks, NB, hkv).repeat_interleave(rep, dim=1)
    vd = da._dense(v, vs, NB, hkv).repeat_interleave(rep, dim=1)
    qb = q3.to(torch.bfloat16).float()
    s = torch.einsum("bhd,bhtd->bht", qb, kd) * scale
    s = torch.clamp(s + mask2[:, None, :], min=da.NEG)
    stale = torch.arange(T)[None] == rows[:, None]
    s = torch.where(stale[:, None, :], da.NEG, s)
    ms, ls, accs = [], [], []
    for lo, hi in da.decode_slices(T, S):
        m = torch.full((NB, Hq, 1), -math.inf)
        l = torch.zeros(NB, Hq, 1)
        acc = torch.zeros(NB, Hq, D)
        for c0 in range(lo, hi, CHUNK):
            c1 = min(c0 + CHUNK, hi)
            sc = s[..., c0:c1]
            mn = torch.maximum(m, sc.amax(-1, keepdim=True))
            al = torch.exp(m - mn)
            p = torch.exp(sc - mn)
            l = l * al + p.sum(-1, keepdim=True)
            acc = acc * al + torch.einsum(
                "bht,bhtd->bhd", p.to(torch.bfloat16).float(),
                vd[:, :, c0:c1])
            m = mn
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    M = ms[0]
    for m in ms[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    A = torch.zeros(NB, Hq, D)
    for m, l, acc in zip(ms, ls, accs):
        e = torch.exp(m - M)
        L = L + e * l
        A = A + e * acc
    kf = da._dense(kn[:, None], None if kns is None else kns[:, None], NB,
                   hkv)[:, :, 0].repeat_interleave(rep, dim=1)
    vf = da._dense(vn[:, None], None if vns is None else vns[:, None], NB,
                   hkv)[:, :, 0].repeat_interleave(rep, dim=1)
    s_n = (qb * kf).sum(-1, keepdim=True) * scale
    m2 = torch.maximum(M, s_n)
    a2, p_n = torch.exp(M - m2), torch.exp(s_n - m2)
    return (A * a2 + p_n * vf) / torch.clamp(L * a2 + p_n, min=1e-30)


def update_args(kv, mode, NB, hq, hkv, D, T, rows, masked=(), seed=0):
    """A layer of T random keys (layer 1 of 2), queries, fresh rows in the
    arena's type, destination rows and a mask (flat: keys past the largest
    destination hidden; cells: a random half of the cells; `masked` rows
    see none)."""
    g = torch.Generator().manual_seed(seed)
    Bk = NB if mode == "flat" else 1
    cache = tcommon.init_kv_cache(2, Bk, T, hkv, D, KV[kv][1], device="cpu")
    tcommon.update_kv(cache, 1, torch.randn(Bk, T, hkv, D, generator=g),
                      torch.randn(Bk, T, hkv, D, generator=g), 0)
    q = torch.randn(NB, hq, D, generator=g)
    kn, vn = (torch.randn(NB, 1, hkv, D, generator=g) for _ in range(2))
    if cache.quantized:
        (k8, kd), (v8, vd) = tcommon._q8_rows(kn), tcommon._q8_rows(vn)
        fresh = (k8.reshape(NB, -1), v8.reshape(NB, -1), kd.reshape(NB, -1),
                 vd.reshape(NB, -1))
    else:
        fresh = (kn.reshape(NB, -1).bfloat16(),
                 vn.reshape(NB, -1).bfloat16(), None, None)
    rows = torch.tensor(rows, dtype=torch.int64)
    if mode == "flat":
        mask = torch.zeros(NB, T)
        mask[:, int(rows.max()) + 1:] = da.NEG
    else:
        mask = torch.where(torch.rand(NB, T, generator=g) < 0.5, 0.0, da.NEG)
    for n in masked:
        mask[n] = da.NEG
    arena = (cache.k[1], cache.v[1],
             None if cache.ks is None else cache.ks[1],
             None if cache.vs is None else cache.vs[1])
    return q, arena, fresh, mask, rows, hkv, 1 / math.sqrt(D)


# kv, mode, NB, hq, hkv, D, T, destination rows, rows that see no key
ORDER_CASES = {
    "flat gptj 4 heads T 512": ("flat", 1, 4, 4, 256, 512, [499], ()),
    "flat B 2 GQA 8:2": ("flat", 2, 8, 2, 128, 200, [150, 150], ()),
    "cells rank edges T 512": ("cells", 6, 2, 2, 128, 512,
                               [0, 63, 64, 127, 448, 511], ()),
    "cells T 2048 first, last key": ("cells", 4, 2, 2, 128, 2048,
                                     [256, 1791, 1000, 2047], ()),
    "cells g_rep 8": ("cells", 3, 16, 2, 128, 300, [5, 77, 299], ()),
    "cells NB 24 (two 16-row passes)": ("cells", 24, 2, 2, 128, 256,
                                        list(range(0, 240, 10)), ()),
    "cells a row sees no key": ("cells", 4, 4, 4, 128, 200,
                                [3, 77, 150, 199], (2,)),
    "flat ranks 5-7 own no key": ("flat", 1, 2, 2, 128, 9, [8], ()),
}


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("case", list(ORDER_CASES))
def test_kernel_order_matches_plain(kv, case):
    mode, NB, hq, hkv, D, T, rows, masked = ORDER_CASES[case]
    q, arena, fresh, mask, rows, hkv, scale = update_args(
        kv, mode, NB, hq, hkv, D, T, rows, masked)
    S = da.decode_plan(arena[0].shape[0], hkv, T)
    got = kernel_order(q, *arena, *fresh, mask, rows, hkv, scale, S)
    ref = da.decode_attention_update_plain(q, *[None if t is None else t.clone()
                                                for t in arena],
                                           *fresh, mask, rows, hkv, scale)
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err < 1e-2, err
    for n in masked:   # no visible key: the fresh row alone
        vf = da._dense(fresh[1][n][None, None],
                       None if fresh[3] is None else fresh[3][n][None, None],
                       1, hkv)[0, :, 0].repeat_interleave(hq // hkv, dim=0)
        torch.testing.assert_close(got[n], vf, rtol=0, atol=1e-6)


def jax_caches(kv, B, N, H, D, rng, li=1):
    jc = jcommon.init_kv_cache(2, B, N, H, D, KV[kv][0], flat=True)
    tc = tcommon.init_kv_cache(2, B, N, H, D, KV[kv][1], device="cpu")
    k, v = (rng.standard_normal((B, N, H, D)).astype(np.float32)
            for _ in range(2))
    jc = jcommon.update_kv(jc, li, jnp.asarray(k), jnp.asarray(v), 0)
    tcommon.update_kv(tc, li, torch.from_numpy(k), torch.from_numpy(v), 0)
    return jc, tc


def fresh_rows(tc, kn, vn, NB):
    if tc.quantized:
        (k8, kd), (v8, vd) = tcommon._q8_rows(kn), tcommon._q8_rows(vn)
        return (k8.reshape(NB, -1), v8.reshape(NB, -1), kd.reshape(NB, -1),
                vd.reshape(NB, -1))
    return (kn.reshape(NB, -1).to(tc.k.dtype),
            vn.reshape(NB, -1).to(tc.v.dtype), None, None)


def layer(tc, li=1):
    return (tc.k[li], tc.v[li], None if tc.ks is None else tc.ks[li],
            None if tc.vs is None else tc.vs[li])


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("n_past", [0, 63, 64, 127])
def test_kernel_order_matches_jax_flat(kv, n_past):
    """Flat mode against decode_attention_update_stacked (interpret mode),
    the destination at a rank's first and last key (T 128, S 8: 16 keys a
    rank)."""
    B, N, H, D = 2, 128, 2, 128
    rng = np.random.default_rng(5 + n_past)
    jc, tc = jax_caches(kv, B, N, H, D, rng)
    q, kn, vn = (rng.standard_normal((B, 1, H, D)).astype(np.float32)
                 for _ in range(3))
    pos = np.full((B, 1), n_past, np.int32)
    jmask = jcommon.attention_mask(jnp.asarray(pos), N, n_past)
    ref, _ = jdec.decode_attention_update_stacked(
        jc, 1, jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), n_past,
        jmask, interpret=True)
    tmask = tcommon.attention_mask(torch.from_numpy(pos).long(), N, n_past)
    m2 = torch.clamp(tmask.reshape(B, -1)[:, -N:].float(), min=da.NEG)
    rows = torch.full((B,), n_past, dtype=torch.int64)
    S = da.decode_plan(B, H, N)
    assert owner(n_past, N, S) == n_past // (N // S)
    got = kernel_order(torch.from_numpy(q).reshape(B, H, D), *layer(tc),
                       *fresh_rows(tc, torch.from_numpy(kn),
                                   torch.from_numpy(vn), B),
                       m2, rows, H, 1 / math.sqrt(D), S)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(B, H, D),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (8, 2)])
def test_kernel_order_matches_jax_cells(kv, hq, hkv):
    """Cells mode against decode_attention_update_cells (interpret mode):
    three rows of distinct sequences and a pad row on the trash cell."""
    N, D, NB = 128, 128, 4
    rng = np.random.default_rng(6)
    jc, tc = jax_caches(kv, 1, N, hkv, D, rng)
    vis = rng.random((NB, N)) < 0.5
    vis[-1] = False                               # the pad row sees nothing
    rows = np.array([5, 64, 127 - 16, N - 1], np.int32)
    vis[np.arange(NB - 1), rows[:-1]] = True      # each row's own cell
    mask = np.where(vis, 0.0, -np.inf).astype(np.float32)
    q = rng.standard_normal((NB, 1, hq, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((NB, 1, hkv, D)).astype(np.float32)
              for _ in range(2))
    ref, _ = jdec.decode_attention_update_cells(
        jc, 1, jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(rows), jnp.asarray(mask), interpret=True)
    m2 = torch.clamp(torch.from_numpy(mask), min=da.NEG)
    got = kernel_order(torch.from_numpy(q).reshape(NB, hq, D), *layer(tc),
                       *fresh_rows(tc, torch.from_numpy(kn),
                                   torch.from_numpy(vn), NB),
                       m2, torch.from_numpy(rows).long(), hkv,
                       1 / math.sqrt(D), da.decode_plan(1, hkv, N))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-2)


def refusal_args(kv="bf16", D=128, NB=2, hq=4, hkv=4, T=64):
    q, arena, fresh, mask, rows, hkv, scale = update_args(
        kv, "cells", NB, hq, hkv, D, T, list(range(NB)))
    return [q, *arena, *fresh, mask, rows, hkv, scale]


def offset(t):
    """t's values in a buffer one element past 16-byte alignment."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


REFUSALS = {
    "D 64": (lambda a: a, {"D": 64}, "D 128 or 256"),
    "D 384": (lambda a: a, {"D": 384}, "D 128 or 256"),
    "k misaligned": (lambda a: a[:1] + [offset(a[1])] + a[2:], {}, "aligned"),
    "vs misaligned": (lambda a: a[:4] + [offset(a[4])] + a[5:],
                      {"kv": "q8_0"}, "aligned"),
    "kn misaligned": (lambda a: a[:5] + [offset(a[5])] + a[6:], {}, "aligned"),
    "kn of another dtype": (lambda a: a[:5] + [a[5].float()] + a[6:], {},
                            "fresh rows"),
    "vn of another shape": (lambda a: a[:6] + [a[6][:1]] + a[7:], {},
                            "fresh rows"),
    "fresh scales missing": (lambda a: a[:7] + [None] + a[8:],
                             {"kv": "q8_0"}, "fresh scales"),
    "rows int32": (lambda a: a[:10] + [a[10].int()] + a[11:], {}, "int64"),
    "arena batch 3 for 2 rows": (
        lambda a: [a[0], a[1].expand(3, -1, -1), a[2].expand(3, -1, -1)]
        + a[3:], {}, "arena batch"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses_without_a_launch(case):
    edit, kw, match = REFUSALS[case]
    args = edit(refusal_args(**kw))
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        da.decode_attention_update_kernel(*args)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("mode", ["flat", "cells"])
def test_cpu_route_runs_the_plain_version(monkeypatch, kv, mode):
    """On CPU tensors the entry points take decode_attention_update_plain
    and never the kernel wrapper: the arena is written as the plain
    version writes it and no launch is counted."""
    def kernel(*a):
        raise AssertionError("the kernel wrapper ran on CPU tensors")
    monkeypatch.setattr(da, "decode_attention_update_kernel", kernel)
    NB, H, D, N = 2, 2, 128, 96
    B = NB if mode == "flat" else 1
    rng = np.random.default_rng(7)
    _, tc = jax_caches(kv, B, N, H, D, rng, li=0)
    twin = tcommon.init_kv_cache(2, B, N, H, D, KV[kv][1], device="cpu")
    for name in ("k", "v", "ks", "vs"):
        if getattr(tc, name) is not None:
            getattr(twin, name).copy_(getattr(tc, name))
    q, kn, vn = (torch.from_numpy(rng.standard_normal(
        (NB, 1, H, D)).astype(np.float32)) for _ in range(3))
    before = dict(_build.LAUNCHES)
    if mode == "flat":
        mask = torch.zeros(NB, 1, 1, N)
        got, _ = da.decode_attention_update(tc, 0, q, kn, vn, 40, mask)
        rows = torch.full((NB,), 40, dtype=torch.int64)
        m2 = mask.reshape(NB, N)
    else:
        rows = torch.tensor([7, N - 1])
        m2 = torch.zeros(NB, N)
        got, _ = da.decode_attention_update_cells(tc, 0, q, kn, vn, rows, m2)
        got = got.reshape(NB, 1, H, D)
    assert _build.LAUNCHES == before
    ref = da.decode_attention_update_plain(
        q.reshape(NB, H, D), *layer(twin, 0),
        *fresh_rows(twin, kn, vn, NB), m2, rows, H, 1 / math.sqrt(D))
    torch.testing.assert_close(got.reshape(NB, H, D), ref, rtol=0, atol=0)
    for name in ("k", "v", "ks", "vs"):
        if getattr(tc, name) is not None:
            assert torch.equal(getattr(tc, name), getattr(twin, name)), name
