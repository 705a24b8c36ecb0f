"""The read-only cells kernel (csrc/decode_attention_cells.cu) on the CPU:
its launch plan (`decode_plan(1, Hkv, T)` blocks of one thread-block
cluster, `decode_slices` keys a rank), a plain model of the kernel's order
of arithmetic held to the plain version and to the JAX package's cells
kernel (interpret mode), and the wrapper's gates. The kernel itself is held
to its plain version on the card in tests/test_torch_cuda.py.

Tolerances: the model against decode_attention_plain rel 1e-2 (the card
test's; p is rounded to bf16 against a running max per 64-key chunk in the
model and the kernel, against the row's global max in the plain version);
against the JAX package atol 2e-2, as tests/test_torch_cells_attention.py;
a pad row against the mean of V atol 1e-5 (f32 sums in another order).
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


@pytest.mark.parametrize("T", [200, 512, 2048])
@pytest.mark.parametrize("hkv,S", [(4, 8), (16, 8), (20, 6)])
def test_cells_plan(T, hkv, S):
    """S = decode_plan(1, hkv, T) blocks a cluster (16 kv heads: 128
    blocks; 20: 6 ranks, 120 blocks), each rank ceil(T/S) keys in rank
    order, the last cut at T, together [0, T) once."""
    assert da.decode_plan(1, hkv, T) == S
    assert S * hkv <= da.SMS
    slices = da.decode_slices(T, S)
    chunk = -(-T // S)
    assert slices == [(min(r * chunk, T), min((r + 1) * chunk, T))
                      for r in range(S)]
    covered = [t for lo, hi in slices for t in range(lo, hi)]
    assert covered == list(range(T))


@pytest.mark.parametrize("T,S,chunks", [
    (200, 8, [1] * 8),               # 25 keys a rank: one partial chunk
    (2048, 8, [4] * 8),              # the serving arena: 4 full chunks a rank
    (9, 8, [1] * 5 + [0] * 3),       # ranks 5-7 own no key
    (300, 6, [1] * 6),
])
def test_chunks_a_rank(T, S, chunks):
    """A rank walks its slice in ceil(keys / 64) chunks of the ring."""
    assert [-(-(hi - lo) // CHUNK) for lo, hi in da.decode_slices(T, S)] \
        == chunks


def kernel_order(q3, k, v, ks, vs, mask2, hkv, scale, S, beyond=None):
    """The kernel's order of arithmetic: each rank of the cluster takes its
    slice in 64-key chunks, online (a running max, p rounded to bf16
    against it, l and acc rescaled in f32), a partial last chunk filled
    past the slice with the keys after it (the next rank's, then `beyond`
    (2, Hkv, 64, D), the K and V rows after T, zeros by default: what the
    tensor copy brings), which score -inf; the ranks' (m, l, acc) are merged in rank order; out = acc
    / max(l, 1e-30)."""
    NB, Hq, D = q3.shape
    T = k.shape[1]
    rep = Hq // hkv
    kd = da._dense(k, ks, 1, hkv)[0]                 # (hkv, T, D)
    vd = da._dense(v, vs, 1, hkv)[0]
    pad = torch.zeros(2, hkv, CHUNK, D) if beyond is None else beyond
    kd = torch.cat([kd, pad[0]], dim=1).repeat_interleave(rep, dim=0)
    vd = torch.cat([vd, pad[1]], dim=1).repeat_interleave(rep, dim=0)
    qb = q3.to(torch.bfloat16).float()
    s = torch.einsum("bhd,htd->bht", qb, kd) * scale
    mext = torch.cat([mask2, torch.zeros(NB, CHUNK)], dim=1)
    s = torch.clamp(s + mext[:, None, :], min=da.NEG)
    ms, ls, accs = [], [], []
    for lo, hi in da.decode_slices(T, S):
        m = torch.full((NB, Hq, 1), -math.inf)
        l = torch.zeros(NB, Hq, 1)
        acc = torch.zeros(NB, Hq, D)
        for c0 in range(lo, hi, CHUNK):
            sc = s[..., c0:c0 + CHUNK].clone()
            sc[..., max(0, hi - c0):] = -math.inf      # past the slice
            mn = torch.maximum(m, sc.amax(-1, keepdim=True))
            al = torch.exp(m - mn)
            p = torch.exp(sc - mn)
            l = l * al + p.sum(-1, keepdim=True)
            acc = acc * al + torch.einsum(
                "bht,htd->bhd", p.to(torch.bfloat16).float(),
                vd[:, c0:c0 + CHUNK])
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
    return A / torch.clamp(L, min=1e-30)


def cells_args(kv, NB, hq, hkv, D, T, n_pad=1, masked=(), seed=0):
    """A layer of T random cells (layer 1 of 2 of a batch-1 arena),
    queries, and a mask: each row sees a random half of the cells, the last
    n_pad rows (pad rows) and the rows in `masked` none."""
    g = torch.Generator().manual_seed(seed)
    cache = tcommon.init_kv_cache(2, 1, T, hkv, D, KV[kv][1], device="cpu")
    tcommon.update_kv(cache, 1, torch.randn(1, T, hkv, D, generator=g),
                      torch.randn(1, T, hkv, D, generator=g), 0)
    q = torch.randn(NB, hq, D, generator=g)
    vis = torch.rand(NB, T, generator=g) < 0.5
    vis[NB - n_pad:] = False
    for n in masked:
        vis[n] = False
    mask = torch.where(vis, 0.0, da.NEG)
    arena = (cache.k[1], cache.v[1],
             None if cache.ks is None else cache.ks[1],
             None if cache.vs is None else cache.vs[1])
    return q, arena, mask, hkv, 1 / math.sqrt(D)


# NB, hq, hkv, D, T, pad rows, rows that see no key
ORDER_CASES = {
    "serving NB 8 T 2048 (4 chunks a rank)": (8, 2, 2, 128, 2048, 1, ()),
    "T 200: a partial chunk a rank": (5, 4, 4, 128, 200, 1, ()),
    "T 300, S 6": (3, 20, 20, 128, 300, 1, ()),
    "g_rep 8": (3, 16, 2, 128, 300, 1, ()),
    "NB 24 (two 16-row passes)": (24, 2, 2, 128, 256, 1, ()),
    "two pad rows, a row that sees no key": (6, 4, 4, 256, 512, 2, (1,)),
    "T 9: ranks 5-7 own no key": (3, 2, 2, 128, 9, 1, ()),
}


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("case", list(ORDER_CASES))
def test_kernel_order_matches_plain(kv, case):
    NB, hq, hkv, D, T, n_pad, masked = ORDER_CASES[case]
    q, arena, mask, hkv, scale = cells_args(kv, NB, hq, hkv, D, T, n_pad,
                                            masked)
    got = kernel_order(q, *arena, mask, hkv, scale, da.decode_plan(1, hkv, T))
    ref = da.decode_attention_plain(q, *arena, mask, hkv, scale)
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err < 1e-2, err
    # a row that sees no cell is the mean of V over exactly T keys
    vmean = da._dense(arena[1], arena[3], 1, hkv)[0].mean(1)   # (hkv, D)
    for n in list(range(NB - n_pad, NB)) + list(masked):
        torch.testing.assert_close(got[n, ::hq // hkv], vmean, rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("T,S", [(200, 8), (300, 6), (100, 1)])
def test_keys_past_the_slice_take_no_part(T, S):
    """A partial last chunk holds up to 63 keys past the rank's slice (the
    next rank's, or past T): whatever they hold, the result is the same
    bits, since they score -inf and p is exactly 0."""
    q, arena, mask, hkv, scale = cells_args("bf16", 4, 4, 4, 128, T)
    zeros = kernel_order(q, *arena, mask, hkv, scale, S)
    junk = torch.randn(2, hkv, CHUNK, 128,
                       generator=torch.Generator().manual_seed(9)) * 1e3
    got = kernel_order(q, *arena, mask, hkv, scale, S, beyond=junk)
    assert torch.equal(got, zeros)


def jax_cells(kv, N, H, D, rng, li=1):
    jc = jcommon.init_kv_cache(2, 1, N, H, D, KV[kv][0], flat=True)
    tc = tcommon.init_kv_cache(2, 1, N, H, D, KV[kv][1], device="cpu")
    k, v = (rng.standard_normal((1, N, H, D)).astype(np.float32)
            for _ in range(2))
    jc = jcommon.update_kv(jc, li, jnp.asarray(k), jnp.asarray(v), 0)
    tcommon.update_kv(tc, li, torch.from_numpy(k), torch.from_numpy(v), 0)
    return jc, tc


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("hq,hkv,N", [(2, 2, 128), (8, 2, 200)])
def test_kernel_order_matches_jax(kv, hq, hkv, N):
    """Against the JAX decode_attention_cells (_kernel_cellsb, interpret
    mode): rows of distinct sequences under a cell mask, the last a pad row
    (its mask -inf everywhere, clamped to NEG as the port's entry does);
    N 200 gives partial chunks (25 keys a rank)."""
    D, NB = 128, 4
    rng = np.random.default_rng(11)
    jc, tc = jax_cells(kv, N, hkv, D, rng)
    vis = rng.random((NB, N)) < 0.5
    vis[-1] = False
    mask = np.where(vis, 0.0, -np.inf).astype(np.float32)
    q = rng.standard_normal((NB, 1, hq, D)).astype(np.float32)
    ref = jdec.decode_attention_cells(jc, 1, jnp.asarray(q),
                                      jnp.asarray(mask), interpret=True)
    m2 = torch.clamp(torch.from_numpy(mask), min=da.NEG)
    arena = (tc.k[1], tc.v[1], None if tc.ks is None else tc.ks[1],
             None if tc.vs is None else tc.vs[1])
    got = kernel_order(torch.from_numpy(q).reshape(NB, hq, D), *arena, m2,
                       hkv, 1 / math.sqrt(D), da.decode_plan(1, hkv, N))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(NB, hq, D),
                               rtol=0, atol=2e-2)


def offset(t):
    """t's values in a buffer one element past 16-byte alignment."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def strided(t):
    """t's values as a non-contiguous view of the same shape."""
    return torch.cat([t, t], dim=-1)[..., :t.shape[-1]]


# (edit of [q, k, v, ks, vs, mask, hkv, scale], cells_args keywords, match)
REFUSALS = {
    "D 64": (lambda a: a, {"D": 64}, "D 128 or 256"),
    "D 384": (lambda a: a, {"D": 384}, "D 128 or 256"),
    "k misaligned": (lambda a: a[:1] + [offset(a[1])] + a[2:], {}, "aligned"),
    "v misaligned": (lambda a: a[:2] + [offset(a[2])] + a[3:], {}, "aligned"),
    "ks misaligned": (lambda a: a[:3] + [offset(a[3])] + a[4:],
                      {"kv": "q8_0"}, "aligned"),
    "vs misaligned": (lambda a: a[:4] + [offset(a[4])] + a[5:],
                      {"kv": "q8_0"}, "aligned"),
    "v not contiguous": (lambda a: a[:2] + [strided(a[2])] + a[3:], {},
                         "contiguous"),
    "arena batch 2": (lambda a: [a[0], a[1].expand(2, -1, -1),
                                 a[2].expand(2, -1, -1)] + a[3:], {},
                      "decode_attention_cells"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses_without_a_launch(monkeypatch, case):
    """The wrapper raises ValueError before it reaches the kernel library
    (never built here) or counts a launch."""
    def no_lib():
        raise AssertionError("the kernel library was reached")
    monkeypatch.setattr(_build, "lib", no_lib)
    edit, kw, match = REFUSALS[case]
    kw = {"kv": "bf16", "NB": 2, "hq": 4, "hkv": 4, "D": 128, "T": 64, **kw}
    q, arena, mask, hkv, scale = cells_args(**kw)
    args = edit([q, *arena, mask, hkv, scale])
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        da.decode_attention_cells_kernel(*args)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_cpu_route_runs_the_plain_version(monkeypatch, kv):
    """On CPU tensors decode_attention_cells takes decode_attention_plain
    and never the kernel wrapper; no launch is counted."""
    def kernel(*a):
        raise AssertionError("the kernel wrapper ran on CPU tensors")
    monkeypatch.setattr(da, "decode_attention_cells_kernel", kernel)
    NB, H, D, N = 3, 2, 128, 96
    _, tc = jax_cells(kv, N, H, D, np.random.default_rng(12), li=0)
    q = torch.randn(NB, 1, H, D, generator=torch.Generator().manual_seed(1))
    m2 = torch.where(torch.rand(NB, N, generator=torch.Generator()
                                .manual_seed(2)) < 0.5, 0.0, da.NEG)
    before = dict(_build.LAUNCHES)
    got = da.decode_attention_cells(tc, 0, q, m2)
    assert _build.LAUNCHES == before
    ref = da.decode_attention_plain(
        q.reshape(NB, H, D), tc.k[0], tc.v[0],
        None if tc.ks is None else tc.ks[0],
        None if tc.vs is None else tc.vs[0], m2, H, 1 / math.sqrt(D))
    torch.testing.assert_close(got.reshape(NB, H, D), ref, rtol=0, atol=0)
