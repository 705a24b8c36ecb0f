"""The launch plan of the decode attention kernel (csrc/decode_attention.cu):
`decode_plan` picks how many blocks of one thread-block cluster share the
keys of a (batch row, kv head), `decode_slices` which keys each owns. Plain
functions, so they are checked here on the CPU, with the wrapper's gates
and the split's arithmetic (a global max, partial sums added in rank
order); the kernel itself is held to its plain version in
tests/test_torch_cuda.py."""
import math

import numpy as np
import pytest
import torch

from ggml_imax_tpu_torch import _build
from ggml_imax_tpu_torch.models.common import init_kv_cache, update_kv
from ggml_imax_tpu_torch.ops import decode_attention as da

SMS = 132
MAX_SPLIT = 8           # the blocks of a portable cluster


@pytest.mark.parametrize("b", [1, 2, 8, 33, 64])
@pytest.mark.parametrize("hkv", [1, 2, 4, 16, 32])
@pytest.mark.parametrize("t", [1, 2, 5, 9, 300, 512, 2048])
def test_plan_keeps_a_cluster_and_a_key_a_block(b, hkv, t):
    s = da.decode_plan(b, hkv, t)
    assert 1 <= s <= MAX_SPLIT and s <= t
    if b * hkv * s > SMS:                  # over the SMs only when unsplit
        assert s == 1
    larger = s + 1
    if larger <= min(MAX_SPLIT, t):        # one more block a cluster overflows
        assert b * hkv * larger > SMS


def test_gptj_batch_1_takes_8():
    """GPT-J-6B decode: 16 kv heads at batch 1, T 512: 128 blocks of 64
    keys."""
    assert da.decode_plan(1, 16, 512) == 8
    assert da.decode_slices(512, 8) == [(64 * r, 64 * (r + 1))
                                        for r in range(8)]


@pytest.mark.parametrize("b,hkv", [(9, 16), (1, 132), (33, 4), (66, 2),
                                   (132, 1), (4, 64), (8, 16), (67, 1)])
def test_a_grid_that_fills_the_sms_is_unsplit(b, hkv):
    """S = 1 at B * Hkv >= 132, and where two blocks a cluster would pass
    the SMs (B 8 x 16 heads: 128 blocks)."""
    assert b * hkv >= SMS or 2 * b * hkv > SMS
    assert da.decode_plan(b, hkv, 512) == 1


@pytest.mark.parametrize("t", [1, 5, 300, 512, 1000, 2048])
@pytest.mark.parametrize("s", range(1, MAX_SPLIT + 1))
def test_slices_cover_the_keys_once(t, s):
    slices = da.decode_slices(t, s)
    assert len(slices) == s
    keys = [k for lo, hi in slices for k in range(lo, hi)]
    assert keys == list(range(t))          # each key once, in rank order
    chunk = -(-t // s)
    assert all(hi - lo <= chunk for lo, hi in slices)


def arena_args(kv, B, hq, hkv, D, T, visible, masked_row=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    cache = init_kv_cache(2, B, T, hkv, D, kv, device="cpu")
    update_kv(cache, 1, torch.randn(B, T, hkv, D, generator=g),
              torch.randn(B, T, hkv, D, generator=g), 0)
    mask = torch.zeros(B, T)
    mask[:, visible:] = da.NEG
    if masked_row is not None:
        mask[masked_row] = da.NEG
    return (torch.randn(B, hq, D, generator=g), cache.k[1], cache.v[1],
            cache.ks if cache.ks is None else cache.ks[1],
            cache.vs if cache.vs is None else cache.vs[1], mask, hkv,
            1 / math.sqrt(D))


def split_reference(q3, k, v, ks, vs, mask2, hkv, scale, S):
    """The kernel's arithmetic: the scores as the plain version takes them,
    cut into the ranks' slices; the row's max M is the largest of the
    ranks' maxima (-inf for a rank without keys), p = bf16(exp(s - M)), and
    the ranks' l and P V (float64 sums) are added in rank order."""
    B, Hq, D = q3.shape
    rep = Hq // hkv
    kd = da._dense(k, ks, B, hkv).repeat_interleave(rep, dim=1)
    vd = da._dense(v, vs, B, hkv).repeat_interleave(rep, dim=1).double()
    s = torch.einsum("bhd,bhtd->bht", q3.to(torch.bfloat16).float(), kd)
    s = torch.clamp(s * scale + mask2[:, None, :], min=da.NEG)
    slices = da.decode_slices(k.shape[1], S)
    m = torch.full((B, Hq, 1), -math.inf)
    for lo, hi in slices:
        if hi > lo:
            m = torch.maximum(m, s[..., lo:hi].amax(-1, keepdim=True))
    l = torch.zeros(B, Hq, 1, dtype=torch.float64)
    pv = torch.zeros(B, Hq, D, dtype=torch.float64)
    for lo, hi in slices:
        p = torch.exp(s[..., lo:hi] - m)
        l += p.double().sum(-1, keepdim=True)
        pv += torch.einsum("bht,bhtd->bhd", p.to(torch.bfloat16).double(),
                           vd[:, :, lo:hi])
    return (pv / torch.clamp(l, min=1e-30)).float()


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
@pytest.mark.parametrize("case", [
    # b, hq, hkv, d, T, visible keys, split
    (1, 4, 4, 256, 512, 500, 8),          # GPT-J's shape, cut to 4 heads
    (2, 8, 2, 128, 300, 290, 6),          # GQA, a short last slice
    (1, 4, 4, 128, 9, 9, 8),              # ranks 5-7 own no key
    (1, 4, 4, 128, 5, 5, 8),              # ranks 5-7 own no key
    (2, 4, 2, 128, 64, 60, 1),
])
def test_split_arithmetic_matches_plain(kv, case):
    """Splitting the keys with p rounded against the row's global max gives
    the plain version's numbers up to the order of its sums."""
    B, hq, hkv, D, T, visible, S = case
    args = arena_args(kv, B, hq, hkv, D, T, visible)
    got = split_reference(*args, S)
    ref = da.decode_attention_plain(*args)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
def test_split_arithmetic_masked_row_is_mean_of_v(kv):
    B, hq, hkv, D, T = 2, 4, 2, 128, 200
    args = arena_args(kv, B, hq, hkv, D, T, 150, masked_row=1)
    got = split_reference(*args, 8)
    mean = da._dense(args[2], args[4], B, hkv).mean(dim=2) \
        .repeat_interleave(hq // hkv, dim=1)
    np.testing.assert_allclose(got[1].numpy(), mean[1].numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               da.decode_attention_plain(*args).numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("D", [384, 64, 96])
def test_wrapper_refuses_other_widths_without_a_launch(D):
    args = arena_args(torch.bfloat16, 1, 4, 4, D, 16, 16)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="D 128 or 256"):
        da.decode_attention_kernel(*args)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("kv,which", [(torch.bfloat16, 1), (torch.bfloat16, 2),
                                      ("q8_0", 3), ("q8_0", 4)])
def test_wrapper_refuses_a_misaligned_slice_without_a_launch(kv, which):
    args = list(arena_args(kv, 1, 4, 4, 128, 16, 16))
    t = args[which]
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    args[which] = buf[1:].view(t.shape)
    args[which].copy_(t)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="aligned"):
        da.decode_attention_kernel(*args)
    assert _build.LAUNCHES == before


def test_wrapper_refuses_a_slice_past_the_score_room_without_a_launch(
        monkeypatch):
    """A block keeps its slice's scores in shared memory: 16384 floats, so
    2048 keys of 8 query heads, and no more."""
    monkeypatch.setattr(da, "decode_plan", lambda *a: 1)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="do not fit"):
        da.decode_attention_kernel(*arena_args(torch.bfloat16, 1, 8, 1, 128,
                                               2049, 2049))
    assert _build.LAUNCHES == before


def test_cpu_route_runs_the_plain_version(monkeypatch):
    """On CPU tensors decode_attention takes the plain version, never plans
    a launch and counts none."""
    def no_plan(*a):
        raise AssertionError("planned a launch for a CPU tensor")
    monkeypatch.setattr(da, "decode_plan", no_plan)
    cache = init_kv_cache(2, 1, 32, 2, 128, torch.bfloat16, device="cpu")
    g = torch.Generator().manual_seed(0)
    update_kv(cache, 1, torch.randn(1, 20, 2, 128, generator=g),
              torch.randn(1, 20, 2, 128, generator=g), 0)
    q = torch.randn(1, 1, 4, 128, generator=g)
    mask = torch.zeros(1, 1, 1, 32)
    mask[..., 20:] = -math.inf
    before = dict(_build.LAUNCHES)
    out = da.decode_attention(cache, 1, q, mask)
    assert out.shape == (1, 1, 4, 128)
    assert _build.LAUNCHES == before
