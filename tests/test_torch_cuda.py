"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (marker ``cuda``; they skip without an NVIDIA GPU). Run them
on a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The kernels are built from ggml_imax_tpu_torch/csrc at first use.
"""
import math
from dataclasses import replace

import numpy as np
import pytest
import torch

from ggml_imax_tpu_torch import _build
from ggml_imax_tpu_torch.models import gpt2, gptj
from ggml_imax_tpu_torch.models.common import _q8_rows, init_kv_cache, update_kv
from ggml_imax_tpu_torch.ops import decode_attention as da
from ggml_imax_tpu_torch.ops import flash_attention as fa
from ggml_imax_tpu_torch.ops import qmm
from ggml_imax_tpu_torch.quant.device import QTensor
from ggml_imax_tpu_torch.quant.formats import GGMLType

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    try:
        _build._nvcc()
    except RuntimeError as e:
        pytest.skip(f"needs nvcc to build the CUDA kernels: {e}")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def rel(got, ref):
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def natpair(K, N, gen, scale_dtype=torch.float32, bias=False):
    q = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8, generator=gen,
                      device="cuda")
    s = torch.rand((K // 32, N), generator=gen, device="cuda") * 0.01
    b = torch.rand((K // 32, N), generator=gen, device="cuda") * 0.01 \
        if bias else None
    return QTensor("nib4", q, s.to(scale_dtype), None if b is None
                   else b.to(scale_dtype), K, N, GGMLType.Q4_0, zero=8,
                   interleaved_bk=512, q4_layout=3)


# (K, N): the first case; a long K on 4 column blocks (split 8); K with an
# odd (3) and a prime-times-3 (33) number of quant blocks (split 3)
W4A8_SHAPES = [(2048, 1280), (20480, 512), (96, 128), (1056, 384)]


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("k,n", W4A8_SHAPES)
def test_w4a8_kernel_matches_plain(gen, scale_dtype, bias, k, n):
    qt = natpair(k, n, gen, scale_dtype, bias)
    x = torch.randn(1, k, generator=gen, device="cuda")
    before = _build.LAUNCHES["w4a8_gemv"]
    got = qmm.qmatmul_natpair(x, qt)
    assert _build.LAUNCHES["w4a8_gemv"] == before + 1
    x8, dx = qmm.quantize_activations_q8(x)
    xs = dx[:, 0] * x8[:, 0].float().sum(-1)
    ref = qmm.w4a8_gemv_plain(x8[:, 0], dx[:, 0], qt, xs)
    err = rel(got[0], ref)
    print(f"w4a8_gemv K {k} N {n}: rel {err:.3e}")      # shown with -s
    assert err < 1e-5


def check_w4a8(qt, x, launches=1):
    """`launches` wrapper calls on x (1, K), each counted, each giving the
    same bits, against the plain version."""
    x8, dx = qmm.quantize_activations_q8(x)
    x8, dx = x8[:, 0], dx[:, 0]
    xs = None if qt.bias is None else dx * x8.float().sum(-1)
    before = _build.LAUNCHES["w4a8_gemv"]
    runs = [qmm.w4a8_gemv(x8, dx, qt, xs) for _ in range(launches)]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["w4a8_gemv"] == before + launches
    ref = qmm.w4a8_gemv_plain(x8, dx, qt, xs)
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    err = rel(runs[0], ref)
    print(f"w4a8_gemv K {qt.k} N {qt.n} split {qmm.w4a8_plan(qt.k, qt.n)}: "
          f"rel {err:.3e}")                                 # shown with -s
    assert err < 1e-5


# every split the plan may pick (a divisor of K/32, at most 8), forced:
# GPT-J's of_w (640 quant blocks), a long K on 4 column blocks, K 1344 (42
# quant blocks: 3, 6, 7), the odd K 96 and 1056
W4A8_SPLITS = [(k, n, s) for k, n in [(20480, 4096), (20480, 512), (1344, 256),
                                      (96, 128), (1056, 384)]
               for s in range(1, 9) if (k // 32) % s == 0]


@pytest.mark.parametrize("k,n,split", W4A8_SPLITS)
@pytest.mark.parametrize("scale_dtype,bias", [(torch.float32, False),
                                              (torch.bfloat16, True)])
def test_w4a8_every_split_matches_plain(gen, monkeypatch, k, n, split,
                                        scale_dtype, bias):
    qt = natpair(k, n, gen, scale_dtype, bias)
    x = torch.randn(1, k, generator=gen, device="cuda")
    monkeypatch.setattr(qmm, "w4a8_plan", lambda *a: split)
    check_w4a8(qt, x, launches=2)


@pytest.mark.parametrize("nibble", [0, 15])
@pytest.mark.parametrize("scale_dtype,bias", [(torch.float32, False),
                                              (torch.bfloat16, True)])
def test_w4a8_extremes(gen, nibble, scale_dtype, bias):
    """Every weight at q = 0 (-8) or 15 (+7), every x8 at +-127: the
    integer dots' largest magnitudes."""
    qt = natpair(20480, 512, gen, scale_dtype, bias)
    qt.q.fill_((nibble ^ 8) * 0x11)
    x = torch.randn(1, 20480, generator=gen, device="cuda").sign() * 3.0
    x8, _ = qmm.quantize_activations_q8(x)
    assert int(x8.abs().min()) == 127
    check_w4a8(qt, x)


def test_w4a8_one_launch_a_call_when_split(gen):
    qt = natpair(20480, 512, gen)
    assert qmm.w4a8_plan(20480, 512) == 8
    check_w4a8(qt, torch.randn(1, 20480, generator=gen, device="cuda"),
               launches=3)


def test_w4a8_refuses_what_the_kernel_does_not_take(gen):
    x8 = torch.zeros(16, 32, dtype=torch.int8, device="cuda")
    dx = torch.ones(16, device="cuda")
    before = _build.LAUNCHES["w4a8_gemv"]
    with pytest.raises(ValueError, match="N % 128"):
        qmm.w4a8_gemv(x8, dx, natpair(512, 192, gen))
    qt = natpair(512, 256, gen)
    with pytest.raises(ValueError, match="int8 x8"):
        qmm.w4a8_gemv(x8.to(torch.uint8), dx, qt)
    s = torch.empty(16 * 256 + 1, device="cuda")[1:].view(16, 256)
    s.copy_(qt.scale)
    with pytest.raises(ValueError, match="16-byte"):
        qmm.w4a8_gemv(x8, dx, replace(qt, scale=s))
    assert _build.LAUNCHES["w4a8_gemv"] == before


@pytest.mark.parametrize("m", [8, 100, 512])
@pytest.mark.parametrize("bias", [False, True])
def test_w4a16_kernel_matches_plain(gen, m, bias):
    qt = natpair(1024, 640, gen, torch.float32, bias)
    x = torch.randn(m, 1024, generator=gen, device="cuda")
    got = qmm.w4a16_gemm(x, qt)
    ref = qmm.w4a16_gemm_plain(x, qt)
    assert rel(got, ref) < 1e-4


def check_w4a16(qt, x, launches=1):
    """`launches` wrapper calls, each counted, each giving the same bits,
    against the plain version."""
    before = _build.LAUNCHES["w4a16_gemm"]
    runs = [qmm.w4a16_gemm(x, qt) for _ in range(launches)]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["w4a16_gemm"] == before + launches
    ref = qmm.w4a16_gemm_plain(x, qt)
    assert runs[0].shape == ref.shape == (x.shape[0], qt.n)
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert rel(runs[0], ref) < 1e-4
    return runs[0]


# M up to 8 takes the small-M route, above it the tile route (a ragged
# 128-row tile at 100 and 600; N 640 leaves its last 256-column tile half
# full); K 1056 leaves the tile route's last K step of 64 half full
@pytest.mark.parametrize("m", [2, 5, 8, 9, 64, 100, 128, 512, 600])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("k", [1536, 1056])
def test_w4a16_routes_match_plain(gen, m, scale_dtype, bias, k):
    qt = natpair(k, 640, gen, scale_dtype, bias)
    x = torch.randn(m, k, generator=gen, device="cuda")
    assert qmm.natpair_plan(m, k, 640)[0] == ("small" if m <= 8 else "tile")
    check_w4a16(qt, x, launches=2)


# Each route at splits 1, 2, the plan's and the most a cluster takes: the
# same bits on every launch, each against the plain version. GPT-J-6B's
# of_w at M 8 and 128 (the plan's 5 pieces), a long K on 2 column blocks
# (K 20480, N 256: split 8 at M 8), K 1056 (17 tile steps: no divisor
# but 1, so 2 pieces of 8 and 9 steps)
@pytest.mark.parametrize("k,n,m", [(20480, 4096, 8), (20480, 4096, 128),
                                   (20480, 256, 8), (20480, 256, 3),
                                   (4096, 256, 64), (4096, 384, 512),
                                   (1056, 384, 9)])
@pytest.mark.parametrize("scale_dtype,bias", [(torch.float32, False),
                                              (torch.bfloat16, True)])
def test_w4a16_split_is_deterministic(gen, monkeypatch, k, n, m, scale_dtype,
                                      bias):
    qt = natpair(k, n, gen, scale_dtype, bias)
    x = torch.randn(m, k, generator=gen, device="cuda")
    plan = qmm.natpair_plan
    route, split = plan(m, k, n)
    units = k // 32 if route == "small" else -(-k // 64)
    most = max(s for s in range(1, 9) if units % s == 0)    # a cluster's blocks
    outs = {}
    for s in sorted({1, 2, split, most}):
        monkeypatch.setattr(qmm, "natpair_plan", lambda *a, s=s: (route, s))
        outs[s] = check_w4a16(qt, x, launches=2)
    assert len(outs) > 1
    if (k, n) == (20480, 256) and m == 8:
        assert split == most == 8


def test_w4a16_refuses_what_the_kernel_does_not_take(gen):
    qt = natpair(512, 192, gen)                                # N % 128 != 0
    with pytest.raises(ValueError, match="N % 128"):
        qmm.w4a16_gemm(torch.randn(3, 512, device="cuda"), qt)
    qt = natpair(512, 256, gen, bias=True)
    before = _build.LAUNCHES["w4a16_gemm"]
    flat = torch.randn(12 * 512 + 1, generator=gen, device="cuda")
    # the tile route (M > 8) reads bf16 x as it is: a 2-byte offset
    xb = flat.to(torch.bfloat16)[1:].view(12, 512)
    with pytest.raises(ValueError, match="aligned"):
        qmm.w4a16_gemm(xb, qt)
    # the small-M route reads f32 x as it is: a 4-byte offset
    xf = flat[1:].view(12, 512)
    with pytest.raises(ValueError, match="aligned"):
        qmm.w4a16_gemm(xf[:5], qt)
    # a weight 1 byte off its 16-byte alignment
    qbuf = torch.empty(256 * 256 + 1, dtype=torch.uint8, device="cuda")
    q = qbuf[1:].view(256, 256)
    q.copy_(qt.q)
    with pytest.raises(ValueError, match="aligned"):
        qmm.w4a16_gemm(xf[:5].contiguous(), QTensor(**{**qt.__dict__, "q": q}))
    assert _build.LAUNCHES["w4a16_gemm"] == before
    # each route takes what the other refused once it is copied: the small-M
    # route copies bf16 x to f32, the tile route f32 x to bf16
    check_w4a16(qt, xb[:5])
    check_w4a16(qt, xf)


def decode_args(gen, kv, B, hq, hkv, D, T, visible, masked_row=None):
    """One layer's arena of T random keys (layer 1 of 2), queries, and a
    mask that shows each row its first `visible` keys (none to
    `masked_row`)."""
    cache = init_kv_cache(2, B, T, hkv, D, kv, device="cuda")
    k = torch.randn(B, T, hkv, D, generator=gen, device="cuda")
    v = torch.randn(B, T, hkv, D, generator=gen, device="cuda")
    update_kv(cache, 1, k, v, 0)
    q = torch.randn(B, hq, D, generator=gen, device="cuda")
    mask = torch.zeros(B, T, device="cuda")
    mask[:, visible:] = da.NEG
    if masked_row is not None:
        mask[masked_row] = da.NEG
    return (q, cache.k[1], cache.v[1],
            None if cache.ks is None else cache.ks[1],
            None if cache.vs is None else cache.vs[1], mask, hkv,
            1 / math.sqrt(D))


# b, hq, hkv, d, T, visible keys, the split the plan gives, or a forced one
DECODE_CASES = {
    "gptj": (1, 16, 16, 256, 512, 500, 8),        # n_past 499
    "b2 4:4": (2, 4, 4, 128, 384, 300, 8),
    "b2 8:2": (2, 8, 2, 128, 384, 300, 8),
    "gqa 6:2": (1, 6, 2, 256, 256, 200, 8),       # 3 of a block's 4 heads
    "gqa 16:1": (1, 16, 1, 128, 256, 256, 8),     # two blocks of 8 heads
    "ragged T 300": (1, 16, 16, 256, 300, 290, 8),   # slices of 38, last 34
    "ragged T 1000": (2, 20, 10, 128, 1000, 990, 6),  # slices of 167, last 165
    "tiny T 5": (1, 16, 16, 256, 5, 5, 5),
    "T 9, ranks 5-7 empty": (1, 16, 16, 256, 9, 9, 8),
    "tiny T 5 at split 8": (1, 16, 16, 256, 5, 5, "8"),
    "b8 x 16 heads": (8, 16, 16, 256, 512, 400, 1),  # V past 128 staged rows
    # LLaMA-2 7B: 32 kv heads of 128 (S 4), and a GQA 2:1 shape at D 128
    "llama 32:32 D 128": (1, 32, 32, 128, 512, 500, 4),
    "llama gqa 32:16 D 128": (1, 32, 16, 128, 512, 300, 8),
}


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_attention_kernel_matches_plain(gen, monkeypatch, kv, case):
    B, hq, hkv, D, T, visible, split = DECODE_CASES[case]
    if isinstance(split, str):                        # forced past the plan
        monkeypatch.setattr(da, "decode_plan", lambda *a: int(split))
    else:
        assert da.decode_plan(B, hkv, T) == split
    args = decode_args(gen, kv, B, hq, hkv, D, T, visible)
    err = rel(da.decode_attention_kernel(*args),
              da.decode_attention_plain(*args))
    print(f"decode_attention {case} {kv}: rel {err:.3e}")   # shown with -s
    assert err < 1e-2


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
def test_decode_attention_masked_row_is_mean_of_v(gen, kv):
    """A batch row whose keys are all masked scores NEG everywhere: p = 1
    on every key, the mean of the (bf16-rounded) V rows, as the plain
    version gives; the other row is held to the plain version as usual."""
    B, hq, hkv, D, T = 2, 8, 2, 256, 512
    args = decode_args(gen, kv, B, hq, hkv, D, T, 500, masked_row=1)
    got = da.decode_attention_kernel(*args)
    err = rel(got, da.decode_attention_plain(*args))
    print(f"decode_attention masked row {kv}: rel {err:.3e}")   # shown with -s
    assert err < 1e-2
    mean = da._dense(args[2], args[4], B, hkv).mean(dim=2) \
        .repeat_interleave(hq // hkv, dim=1)
    # f32 sums of 512 values in another order: ~1e-6 apart
    assert rel(got[1], mean[1]) < 1e-4


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
def test_decode_attention_is_deterministic_and_counted(gen, kv):
    args = decode_args(gen, kv, 1, 16, 16, 256, 512, 500)
    before = _build.LAUNCHES["decode_attention"]
    first = da.decode_attention_kernel(*args)
    assert _build.LAUNCHES["decode_attention"] == before + 1
    second = da.decode_attention_kernel(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_attention"] == before + 2
    assert torch.equal(first, second)


def test_decode_attention_refuses_what_the_kernel_does_not_take(gen):
    before = _build.LAUNCHES["decode_attention"]
    for D in (384, 64):
        args = decode_args(gen, torch.bfloat16, 1, 4, 4, D, 64, 64)
        with pytest.raises(ValueError, match="D 128 or 256"):
            da.decode_attention_kernel(*args)
    # a bf16 arena slice 2 bytes off its 16-byte alignment
    q, k, v, ks, vs, mask, hkv, scale = decode_args(
        gen, torch.bfloat16, 1, 4, 4, 128, 64, 64)
    buf = torch.empty(k.numel() + 1, dtype=k.dtype, device="cuda")
    k1 = buf[1:].view(k.shape)
    k1.copy_(k)
    with pytest.raises(ValueError, match="aligned"):
        da.decode_attention_kernel(q, k1, v, ks, vs, mask, hkv, scale)
    # a q8_0 scale slice 4 bytes off
    q, k, v, ks, vs, mask, hkv, scale = decode_args(
        gen, "q8_0", 1, 4, 4, 128, 64, 64)
    buf = torch.empty(vs.numel() + 1, dtype=vs.dtype, device="cuda")
    vs1 = buf[1:].view(vs.shape)
    vs1.copy_(vs)
    with pytest.raises(ValueError, match="aligned"):
        da.decode_attention_kernel(q, k, v, ks, vs1, mask, hkv, scale)
    assert _build.LAUNCHES["decode_attention"] == before


@pytest.mark.parametrize("b,tq,tk,hq,hkv,d,kw", [
    (1, 64, 64, 2, 2, 256, {}),
    (2, 70, 130, 4, 2, 128, {}),
    (1, 48, 48, 8, 8, 64, {"max_bias": 8.0}),
    (1, 33, 33, 2, 2, 128, {"logit_softcap": 30.0}),
    (1, 40, 96, 2, 1, 64, {"want_lse": True}),
])
def test_flash_kernel_matches_plain(gen, b, tq, tk, hq, hkv, d, kw):
    q = torch.randn(b, tq, hq, d, generator=gen, device="cuda")
    k = torch.randn(b, tk, hkv, d, generator=gen, device="cuda")
    v = torch.randn(b, tk, hkv, d, generator=gen, device="cuda")
    qi = torch.arange(tq, device="cuda")[:, None] + (tk - tq)
    mask = torch.where(torch.arange(tk, device="cuda")[None] <= qi, 0.0,
                       float("-inf"))[None, None].expand(b, 1, tq, tk)
    args = fa._prep(q, k, v, mask, kw.get("max_bias", 0.0)) + (
        1 / math.sqrt(d), kw.get("logit_softcap", 0.0), kw.get("want_lse", False))
    got, got_lse = fa.flash_attention_kernel(*args, tiles=tile_map(args[3]))
    ref, ref_lse = fa.flash_attention_plain(*args)
    assert rel(got, ref) < 1e-2
    if got_lse is not None:
        assert rel(got_lse, ref_lse) < 1e-4


def serving_mask(nb, T, seed=3):
    """The cell mask (1, 1, nb, T) of a mixed serving ubatch, the registry of
    chip_smoke.py's mixed_ubatch_mask: 7 sequences decoding (a run of cells
    each), a new request's 100-token prompt chunk, and pad rows up to nb
    that see no cell; the rest of the arena empty."""
    from ggml_imax_tpu_torch.models.common import cells_attention_mask
    from ggml_imax_tpu_torch.runtime.batched import MAX_SEQ
    rng = np.random.default_rng(seed)
    cell_pos, cell_seq = np.full(T, -1, np.int64), np.zeros(T, np.int64)
    tok_pos, tok_seq, head = [], [], 0
    for s, n in enumerate(rng.integers(64, 128, 7) + rng.integers(0, 32, 7)):
        cell_pos[head:head + n + 1] = np.arange(n + 1)
        cell_seq[head:head + n + 1] = 1 << s
        tok_pos.append(n)
        tok_seq.append(s)
        head += n + 1
    cell_pos[head:head + 100] = np.arange(100)
    cell_seq[head:head + 100] = 1 << 7
    tok_pos += list(range(100)) + [0] * (nb - 107)
    tok_seq += [7] * 100 + [MAX_SEQ - 1] * (nb - 107)
    return cells_attention_mask(*(
        torch.as_tensor(np.asarray(a), device="cuda")[None]
        for a in (tok_pos, tok_seq, cell_pos, cell_seq)))


def forward_args(gen, b, tq, tk, hq, hkv, d, kw):
    """The forward kernel's prepared arguments under a causal mask over the
    last tq keys; kw: max_bias (key distances in the mask), window (the last
    `window` keys only), masked_row (a row that sees no key), serving (the
    cell mask of serving_mask instead), want_lse."""
    q = torch.randn(b, tq, hq, d, generator=gen, device="cuda")
    k, v = (torch.randn(b, tk, hkv, d, generator=gen, device="cuda")
            for _ in range(2))
    if kw.get("serving"):
        mask = serving_mask(tq, tk).expand(b, 1, tq, tk).clone()
    else:
        mask = causal_mask(b, tq, tk, kw.get("max_bias", 0) > 0,
                           kw.get("window")).clone()
    if kw.get("masked_row") is not None:
        mask[:, :, kw["masked_row"]] = float("-inf")
    return fa._prep(q, k, v, mask, kw.get("max_bias", 0.0)) + (
        1 / math.sqrt(d), 0.0, kw.get("want_lse", True))


def tile_map(m3):
    from ggml_imax_tpu_torch.ops import flash_backward as fb
    return fb.backward_tile_map(m3)


def check_forward(args):
    """The kernel (one map launch, one forward launch) against the plain
    version: out within 1e-2 of its largest magnitude, lse within 1e-4 on
    the rows with a visible key and 1e-6 on those with none (about NEG)."""
    n0 = dict(_build.LAUNCHES)
    got, got_lse = fa.flash_attention_kernel(*args, tiles=tile_map(args[3]))
    assert _build.LAUNCHES["flash_attention"] == n0["flash_attention"] + 1
    assert _build.LAUNCHES["flash_backward_tiles"] \
        == n0["flash_backward_tiles"] + 1
    ref, ref_lse = fa.flash_attention_plain(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and rel(got, ref) < 1e-2
    seen = ref_lse.abs() < 1e30
    assert rel(got_lse[seen], ref_lse[seen]) < 1e-4
    if not bool(seen.all()):
        assert rel(got_lse[~seen], ref_lse[~seen]) < 1e-6


# a row that sees no key at a ragged Tk: the reference's average over
# padded_keys(Tk) keys (256, 384, 1024), its all-NEG tiles skipped
@pytest.mark.parametrize("tk", [200, 300, 600])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_kernel_masked_row_matches_plain(gen, tk, d):
    kw = {"masked_row": 5, "max_bias": 8.0 if tk == 300 else 0.0}
    args = forward_args(gen, 1, 72, tk, 4, 2, d, kw)
    check_forward(args)
    got, _ = fa.flash_attention_kernel(*args, tiles=tile_map(args[3]))
    v = args[2][0, :, :, :].float()                      # (Tk, Hkv, D)
    want = v.sum(0).repeat_interleave(2, 0) / fa.padded_keys(tk)
    torch.cuda.synchronize()
    assert rel(got[0, 5], want) < 1e-2


# a mixed serving ubatch (128 rows over 2048 cells, 21 pad rows) at 4 and
# 16 heads of 256 (a cluster of 8 and of 4 blocks a query tile); a sliding
# window
@pytest.mark.parametrize("b,tq,tk,hq,hkv,d,kw", [
    (1, 128, 2048, 4, 4, 256, {"serving": True}),
    (1, 128, 2048, 16, 16, 256, {"serving": True}),
    (2, 300, 300, 4, 2, 64, {"window": 70}),
    (1, 256, 256, 4, 4, 128, {"window": 100, "max_bias": 8.0,
                              "masked_row": 130}),
])
def test_flash_kernel_masks_match_plain(gen, b, tq, tk, hq, hkv, d, kw):
    check_forward(forward_args(gen, b, tq, tk, hq, hkv, d, kw))


SKIP_CASES = [
    # B 2 x 8 heads x 8 query tiles: 128 blocks, no split (D 64 and 256)
    (2, 512, 512, 8, 8, 64, {}),
    (2, 512, 512, 8, 8, 256, {"masked_row": 200}),
    # split key ranges (clusters of 2-8 blocks)
    (1, 300, 300, 4, 2, 128, {"window": 70, "masked_row": 5}),
    (1, 128, 2048, 4, 4, 256, {"serving": True}),
    (1, 200, 200, 4, 4, 64, {"max_bias": 8.0, "masked_row": 70}),
]


@pytest.mark.parametrize("case", SKIP_CASES)
def test_flash_forward_skip_is_exact(gen, case):
    """The kernel with the mask's tile map and with a map that marks every
    tile mixed (nothing skipped, the mask read everywhere): equal bits on
    every row with a visible key (a skipped tile adds exact zeros, and the
    split walks the same key tiles in both); on a row with none, within
    1e-5 (its V sum taken in another order)."""
    from ggml_imax_tpu_torch.ops import flash_backward as fb
    args = forward_args(gen, *case)
    tiles = fb.backward_tile_map(args[3])
    assert bool((tiles == fb.TILE_NEG).any())
    every = torch.full_like(tiles, fb.TILE_MIXED)
    (out, lse), (out_e, lse_e) = (fa.flash_attention_kernel(*args, tiles=t)
                                  for t in (tiles, every))
    torch.cuda.synchronize()
    seen = (args[3] > da.NEG).any(-1)                     # (B, Tq)
    assert torch.equal(out[seen], out_e[seen])
    assert torch.equal(lse.transpose(1, 2)[seen], lse_e.transpose(1, 2)[seen])
    if not bool(seen.all()):
        assert rel(out[~seen], out_e[~seen]) < 1e-5
    assert rel(lse, lse_e) < 1e-6


@pytest.mark.parametrize("case", [SKIP_CASES[i] for i in (1, 2, 3)])
def test_flash_forward_is_deterministic(gen, case):
    """Two launches on the same inputs give the same bits (the split's
    partial sums are added in rank order, no atomics)."""
    args = forward_args(gen, *case)
    tiles = tile_map(args[3])
    first, second = (fa.flash_attention_kernel(*args, tiles=tiles)
                     for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_flash_kernel_refuses_what_it_does_not_take(gen):
    args = list(forward_args(gen, 1, 64, 64, 2, 2, 64, {}))
    with pytest.raises(ValueError):           # a map of another shape
        fa.flash_attention_kernel(*args, tiles=torch.zeros(
            1, 2, 1, dtype=torch.uint8, device="cuda"))
    with pytest.raises(ValueError):           # a mask without its map
        fa.flash_attention_kernel(*args)
    q = torch.randn(1, 64, 2, 72, generator=gen, device="cuda")
    with pytest.raises(ValueError):           # D % 16 != 0
        fa.flash_attention_kernel(*fa._prep(q, q, q, None, 0.0), 1.0, 0.0,
                                  False)


def test_small_gptj_on_card_matches_cpu(gen):
    cfg = gptj.GPTJConfig(n_vocab=512, n_ctx=128, n_embd=256, n_head=2,
                          n_layer=2, n_rot=64)
    prompt = np.random.default_rng(1).integers(0, 512, 24)
    outs = {}
    for dev in ("cuda", "cpu"):
        p = qmm.params_repack(gptj.prepare_fused(
            gptj.synthetic_params(cfg, seed=2, device=dev), cfg))
        cache = gptj.init_cache(cfg, device=dev)
        lg, cache = gptj.forward(cfg, p, torch.as_tensor(prompt[None], device=dev),
                                 torch.arange(24, device=dev)[None], cache, 0)
        lg2, _ = gptj.forward(cfg, p, torch.tensor([[7]], device=dev),
                              torch.tensor([[24]], device=dev), cache, 24)
        outs[dev] = (lg.cpu(), lg2.cpu())
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert float((a - b).abs().max()) < 5e-2


def nat8(K, N, gen, g=32, scale_dtype=torch.float32, bias=False):
    q = torch.randint(-127, 128, (K, N), dtype=torch.int8, generator=gen,
                      device="cuda")
    s = torch.rand((K // g, N), generator=gen, device="cuda") * 0.01
    b = torch.rand((K // g, N), generator=gen, device="cuda") * 0.01 \
        if bias else None
    return QTensor("int8", q, s.to(scale_dtype), None if b is None
                   else b.to(scale_dtype), K, N, GGMLType.Q8_0,
                   interleaved_bk=K, q4_layout=4)


@pytest.mark.parametrize("g", [16, 32])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [False, True])
def test_nat8_w8a8_kernel_matches_plain(gen, g, scale_dtype, bias):
    qt = nat8(1600, 1280, gen, g, scale_dtype, bias)      # K = 1600: 400 quads
    x = torch.randn(1, 1600, generator=gen, device="cuda")
    before = _build.LAUNCHES["nat8_w8a8"]
    got = qmm.qmatmul_nat8(x, qt)
    assert _build.LAUNCHES["nat8_w8a8"] == before + 1
    x8, dx = qmm.quantize_activations_q8(x, g)
    xs = dx[:, 0] * x8[:, 0].float().sum(-1)
    ref = qmm.nat8_w8a8_gemv_plain(x8[:, 0], dx[:, 0], qt, xs)
    assert rel(got[0], ref) < 1e-5


def check_w8a8(qt, x, launches=2):
    """`launches` W8A8 wrapper calls on x (1, K), each counted, each giving
    the same bits, against the plain version."""
    x8, dx = qmm.quantize_activations_q8(x, qmm.nat8_group(qt))
    x8, dx = x8[:, 0], dx[:, 0]
    xs = None if qt.bias is None else dx * x8.float().sum(-1)
    before = _build.LAUNCHES["nat8_w8a8"]
    runs = [qmm.nat8_w8a8_gemv(x8, dx, qt, xs) for _ in range(launches)]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["nat8_w8a8"] == before + launches
    ref = qmm.nat8_w8a8_gemv_plain(x8, dx, qt, xs)
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    err = rel(runs[0], ref)
    print(f"nat8_w8a8 K {qt.k} N {qt.n} g {qmm.nat8_group(qt)} split "
          f"{qmm.nat8_gemv_plan(qt.k, qt.n, qmm.nat8_group(qt))}: "
          f"rel {err:.3e}")                                 # shown with -s
    assert err < 1e-5


# the kernel's eight instances: g 32 / 16, f32 / bf16 scales, bias or not
W8A8_INSTANCES = [(g, sdt, bias) for g in (32, 16)
                  for sdt in (torch.float32, torch.bfloat16)
                  for bias in (False, True)]


@pytest.mark.parametrize("split", range(1, 9))
@pytest.mark.parametrize("g,scale_dtype,bias", W8A8_INSTANCES)
def test_nat8_w8a8_fc_w_every_split(gen, monkeypatch, split, g, scale_dtype,
                                    bias):
    """GPT-2 XL's fc_w (50 units of 32 rows) at every split the kernel
    takes (1 .. 8, pieces of whole units differing by at most one; the
    plan takes 4), two launches a split."""
    assert qmm.nat8_gemv_plan(1600, 6400, g) == 4
    qt = nat8(1600, 6400, gen, g, scale_dtype, bias)
    x = torch.randn(1, 1600, generator=gen, device="cuda")
    monkeypatch.setattr(qmm, "nat8_gemv_plan", lambda *a: split)
    check_w8a8(qt, x)


# (K, N) at the plan's split: 132 column blocks unsplit, two units a warp
# (K 512); 3 units of one (split 3); a long K on 13 column blocks (split
# 8); GPT-2 117M's fc_w (24 column blocks, 8 pieces of 3 units) and out_w
# (6 column blocks, 8 pieces of 12)
@pytest.mark.parametrize("k,n", [(512, 16896), (96, 128), (6400, 1664),
                                 (768, 3072), (3072, 768)])
@pytest.mark.parametrize("g,scale_dtype,bias", W8A8_INSTANCES)
def test_nat8_w8a8_shapes_match_plain(gen, k, n, g, scale_dtype, bias):
    check_w8a8(nat8(k, n, gen, g, scale_dtype, bias),
               torch.randn(1, k, generator=gen, device="cuda"))


@pytest.mark.parametrize("w", [-128, 127])
@pytest.mark.parametrize("g,scale_dtype,bias", [(32, torch.float32, False),
                                                (16, torch.bfloat16, True)])
def test_nat8_w8a8_extremes(gen, w, g, scale_dtype, bias):
    """Every weight at -128 or 127, every x8 at +-127: the integer dots'
    largest magnitudes (32 x 128 x 127), still exact."""
    qt = nat8(1600, 6400, gen, g, scale_dtype, bias)
    qt.q.fill_(w)
    x = torch.randn(1, 1600, generator=gen, device="cuda").sign() * 3.0
    x8, _ = qmm.quantize_activations_q8(x, g)
    assert int(x8.abs().min()) == 127
    check_w8a8(qt, x)


def test_nat8_w8a8_is_one_kernel(gen):
    """One CUDA kernel a call at fc_w's split 4 and nothing else (no
    workspace, no second pass): torch.profiler's device events."""
    from torch.profiler import ProfilerActivity, profile
    qt = nat8(1600, 6400, gen, 16, torch.bfloat16, True)
    x8, dx = qmm.quantize_activations_q8(
        torch.randn(1, 1600, generator=gen, device="cuda"), 16)
    x8, dx = x8[:, 0].contiguous(), dx[:, 0].contiguous()
    xs = (dx * x8.float().sum(-1)).contiguous()
    qmm.nat8_w8a8_gemv(x8, dx, qt, xs)                # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        qmm.nat8_w8a8_gemv(x8, dx, qt, xs)
        torch.cuda.synchronize()
    dev = [(ev.key, ev.count) for ev in prof.key_averages()
           if str(ev.device_type).endswith("CUDA")
           and ev.self_device_time_total > 0]
    print(f"nat8_w8a8: device events {dev}")
    assert len(dev) == 1 and dev[0][1] == 1 and "nat8_gemv_kernel" in dev[0][0]


def test_nat8_w8a8_refuses_what_the_kernel_does_not_take(gen):
    """An N or K the kernel does not take (N % 16 == 0 was taken before the
    kernel's 128-column blocks; the N % 128 gate sends none such), a
    misaligned scale or bias, a bias without xs and a non-int8 x8 raise
    before any launch."""
    before = _build.LAUNCHES["nat8_w8a8"]

    def acts(qt):
        g = qmm.nat8_group(qt)
        return (torch.zeros(qt.k // g, g, dtype=torch.int8, device="cuda"),
                torch.ones(qt.k // g, device="cuda"))

    qt = nat8(512, 144, gen)
    with pytest.raises(ValueError, match="N % 128"):
        qmm.nat8_w8a8_gemv(*acts(qt), qt)
    qt = nat8(1616, 256, gen, 16)
    with pytest.raises(ValueError, match="K % 32"):
        qmm.nat8_w8a8_gemv(*acts(qt), qt)
    qt = nat8(512, 256, gen, 32, torch.float32, True)
    x8, dx = acts(qt)
    with pytest.raises(ValueError, match="xs"):
        qmm.nat8_w8a8_gemv(x8, dx, qt)
    with pytest.raises(ValueError, match="int8 x8"):
        qmm.nat8_w8a8_gemv(x8.to(torch.uint8), dx, qt, dx)
    for which in ("scale", "bias"):
        t = getattr(qt, which)
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        off = buf[1:].view(t.shape)
        off.copy_(t)
        with pytest.raises(ValueError, match="16-byte"):
            qmm.nat8_w8a8_gemv(x8, dx, replace(qt, **{which: off}), dx)
    assert _build.LAUNCHES["nat8_w8a8"] == before


@pytest.mark.parametrize("m,n", [(5, 640), (100, 200), (512, 640)])
@pytest.mark.parametrize("g,bias", [(32, False), (16, True)])
def test_nat8_w8a16_kernel_matches_plain(gen, m, n, g, bias):
    qt = nat8(1600, n, gen, g, torch.float32, bias)
    x = torch.randn(m, 1600, generator=gen, device="cuda")
    before = _build.LAUNCHES["nat8_w8a16"]
    got = qmm.nat8_w8a16_gemm(x, qt)
    assert _build.LAUNCHES["nat8_w8a16"] == before + 1
    assert rel(got, qmm.nat8_w8a16_gemm_plain(x, qt)) < 1e-4


def test_nat8_w8a16_refuses_misaligned_x(gen):
    qt = nat8(1600, 640, gen)
    flat = torch.randn(5 * 1600 + 1, generator=gen, device="cuda")
    x = flat.to(torch.bfloat16)[1:].view(5, 1600)       # 2-byte offset
    before = _build.LAUNCHES["nat8_w8a16"]
    with pytest.raises(ValueError, match="aligned"):
        qmm.nat8_w8a16_gemm(x, qt)
    assert _build.LAUNCHES["nat8_w8a16"] == before


def check_nat8(qt, x, launches=2):
    """`launches` wrapper calls, each counted, each giving the same bits,
    against the plain version."""
    before = _build.LAUNCHES["nat8_w8a16"]
    runs = [qmm.nat8_w8a16_gemm(x, qt) for _ in range(launches)]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["nat8_w8a16"] == before + launches
    ref = qmm.nat8_w8a16_gemm_plain(x, qt)
    assert runs[0].shape == ref.shape == (x.shape[0], qt.n)
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert rel(runs[0], ref) < 1e-4
    return runs[0]


# M up to 8 takes the small-M route, above it the tile route (ragged
# 128-row tiles at 9 and 100); N 200 loads value by value (N % 16 != 0),
# N 640 leaves the last 256-column tile half full, N 6400 is GPT-2 XL's
# fc_w; K 1568 leaves the tile route's last K step of 64 half full
@pytest.mark.parametrize("m", [2, 5, 8, 9, 100, 512])
@pytest.mark.parametrize("g,bias", [(32, False), (32, True), (16, False),
                                    (16, True)])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1600, 1568])
@pytest.mark.parametrize("n", [200, 640, 6400])
def test_nat8_routes_match_plain(gen, m, g, bias, scale_dtype, k, n):
    qt = nat8(k, n, gen, g, scale_dtype, bias)
    x = torch.randn(m, k, generator=gen, device="cuda")
    assert qmm.nat8_plan(m, k, n)[0] == ("small" if m <= 8 else "tile")
    check_nat8(qt, x)


# Each route at every split a cluster takes that divides K's pieces: the
# same bits on every launch, each against the plain version. GPT-2 XL's
# fc_w at M 8 (small: 50 pieces, splits 1, 2, 5), M 128 and 512 (tile: 25
# steps, 1 and 5); K 3072 (small: 96 pieces, tile: 48 steps, each 1, 2,
# 3, 4, 6, 8) on a ragged N; K 1568 (small: 49 pieces, 1 and 7)
@pytest.mark.parametrize("k,n,m", [(1600, 6400, 8), (1600, 6400, 128),
                                   (1600, 6400, 512), (3072, 200, 5),
                                   (3072, 640, 100), (1568, 640, 3)])
@pytest.mark.parametrize("scale_dtype,g,bias", [(torch.float32, 32, False),
                                                (torch.bfloat16, 16, True)])
def test_nat8_split_is_deterministic(gen, monkeypatch, k, n, m, scale_dtype,
                                     g, bias):
    qt = nat8(k, n, gen, g, scale_dtype, bias)
    x = torch.randn(m, k, generator=gen, device="cuda")
    route, split = qmm.nat8_plan(m, k, n)
    units = k // 32 if route == "small" else -(-k // 64)
    splits = [s for s in range(1, 9) if units % s == 0]
    assert split in splits and len(splits) > 1
    for s in splits:
        monkeypatch.setattr(qmm, "nat8_plan", lambda *a, s=s: (route, s))
        check_nat8(qt, x)


def test_nat8_routes_refuse_misaligned_x(gen):
    qt = nat8(1600, 640, gen, 16, torch.bfloat16, True)
    flat = torch.randn(12 * 1600 + 1, generator=gen, device="cuda")
    before = _build.LAUNCHES["nat8_w8a16"]
    # f32 x at a 4-byte offset, on the small-M and the tile route
    xf = flat[1:].view(12, 1600)
    for x in (xf[:5], xf):
        with pytest.raises(ValueError, match="aligned"):
            qmm.nat8_w8a16_gemm(x, qt)
    # bf16 x at a 2-byte offset, on the tile route
    xb = flat.to(torch.bfloat16)[1:].view(12, 1600)
    with pytest.raises(ValueError, match="aligned"):
        qmm.nat8_w8a16_gemm(xb, qt)
    assert _build.LAUNCHES["nat8_w8a16"] == before
    # aligned copies are taken, and bf16 x gives the same product as its
    # f32 copy on either route
    check_nat8(qt, xf.clone())
    for rows in (5, 12):
        xbm = xb[:rows].clone()
        assert torch.equal(check_nat8(qt, xbm), check_nat8(qt, xbm.float()))


def test_gpt2_device_weights_are_q8_0(gen):
    cfg = gpt2.GPT2Config(n_vocab=1000, n_ctx=64, n_embd=320, n_head=5,
                          n_layer=2)
    p = gpt2.synthetic_params_device(cfg, seed=1)
    for w in [p["wte"]] + [lp[k] for lp in p["layers"]
                           for k in ("attn_w", "proj_w", "fc_w", "out_w")]:
        assert w.kind == "int8" and w.ggml_type == GGMLType.Q8_0
        assert w.q.dtype == torch.int8 and int(w.q.min()) >= -127
        assert w.scale.shape == (w.k // 32, w.n) and bool((w.scale >= 0).all())


@pytest.mark.parametrize("wtype", [GGMLType.Q8_0, GGMLType.Q4_0])
def test_small_gpt2_on_card_matches_cpu(gen, wtype):
    cfg = gpt2.GPT2Config(n_vocab=1000, n_ctx=64, n_embd=320, n_head=5,
                          n_layer=2)
    prompt = np.random.default_rng(3).integers(0, 1000, 24)
    outs = {}
    for dev in ("cuda", "cpu"):
        p = qmm.params_repack(gpt2.synthetic_params(cfg, wtype, seed=4,
                                                    device=dev))
        cache = gpt2.init_cache(cfg, device=dev)
        lg, cache = gpt2.forward(cfg, p, torch.as_tensor(prompt[None], device=dev),
                                 torch.arange(24, device=dev)[None], cache, 0)
        lg2, _ = gpt2.forward(cfg, p, torch.tensor([[7]], device=dev),
                              torch.tensor([[24]], device=dev), cache, 24)
        outs[dev] = (lg.cpu(), lg2.cpu())
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert float((a - b).abs().max()) < 5e-2


def filled_cache(gen, kv, B, T, hkv, D):
    cache = init_kv_cache(2, B, T, hkv, D, kv, device="cuda")
    k = torch.randn(B, T, hkv, D, generator=gen, device="cuda")
    v = torch.randn(B, T, hkv, D, generator=gen, device="cuda")
    update_kv(cache, 1, k, v, 0)
    return cache


def arena_args(cache):
    return (cache.k[1], cache.v[1], None if cache.ks is None else cache.ks[1],
            None if cache.vs is None else cache.vs[1])


def cells_mask(gen, nb, T, n_pad):
    """Each row sees a random ~half of the cells; the last n_pad rows are
    pad rows that see none."""
    vis = torch.rand(nb, T, generator=gen, device="cuda") < 0.5
    vis[nb - n_pad:] = False
    return torch.where(vis, 0.0, da.NEG)


# nb, hq, hkv, D, T, pad rows, rows that see no key. S is decode_plan(1,
# hkv, T): 8 but in "S 6"; T 200 gives slices of 25 keys (the mask by
# cp.async), T 512 and 2048 by tensor copies; nb 9 x g_rep 4 = 36 query
# rows take three 16-row passes of the block
CELLS_CASES = {
    "nb 5 4:4": (5, 4, 4, 128, 200, 1, ()),
    "nb 5 8:2": (5, 8, 2, 128, 200, 1, ()),
    "nb 9 8:2": (9, 8, 2, 128, 200, 1, ()),
    "gptj NB 8 T 2048": (8, 16, 16, 256, 2048, 1, ()),
    "gptj NB 16 T 2048": (16, 16, 16, 256, 2048, 1, ()),
    "gptj NB 24 T 2048": (24, 16, 16, 256, 2048, 1, ()),
    "gptj NB 8 T 200": (8, 16, 16, 256, 200, 1, ()),
    "NB 8 T 512 D 128": (8, 4, 4, 128, 512, 1, ()),
    "NB 24 T 512 D 128": (24, 4, 4, 128, 512, 1, ()),
    "g_rep 8 D 256": (3, 16, 2, 256, 512, 1, ()),
    "g_rep 8 D 128 T 2048": (4, 16, 2, 128, 2048, 1, ()),
    "two pad rows and a row that sees no key": (8, 16, 16, 256, 2048, 2,
                                                (2,)),
    "S 6": (4, 20, 20, 128, 512, 1, ()),
    # LLaMA-2 7B serving: 32 kv heads of 128 over 2048 cells
    # (decode_plan(1, 32, 2048)), 8 and 16 rows
    "llama NB 8 32x128 T 2048": (8, 32, 32, 128, 2048, 1, ()),
    "llama NB 16 32x128 T 2048": (16, 32, 32, 128, 2048, 2, (3,)),
}


def cells_case(gen, kv, nb, hq, hkv, D, T, n_pad=1, masked=()):
    cache = filled_cache(gen, kv, 1, T, hkv, D)
    q = torch.randn(nb, hq, D, generator=gen, device="cuda")
    mask = cells_mask(gen, nb, T, n_pad)
    for n in masked:
        mask[n] = da.NEG
    return cache, (q, *arena_args(cache), mask, hkv, 1 / math.sqrt(D))


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
@pytest.mark.parametrize("case", list(CELLS_CASES))
def test_decode_attention_cells_kernel_matches_plain(gen, kv, case):
    """The cells kernel against decode_attention_plain (rel 1e-2: p is
    rounded against a running max per 64-key chunk in the kernel, against
    the row's global max in the plain version); a row that sees no cell
    (pad rows included) is the mean of V over the T keys, as in the
    reference."""
    nb, hq, hkv, D, T, n_pad, masked = CELLS_CASES[case]
    cache, args = cells_case(gen, kv, nb, hq, hkv, D, T, n_pad, masked)
    before = _build.LAUNCHES["decode_attention_cells"]
    got = da.decode_attention_cells_kernel(*args)
    assert _build.LAUNCHES["decode_attention_cells"] == before + 1
    ref = da.decode_attention_plain(*args)
    err = rel(got, ref)
    print(f"decode_attention_cells {case} {kv}: rel {err:.3e}")  # with -s
    assert err < 1e-2
    vmean = da._dense(cache.v[1], None if cache.vs is None else cache.vs[1],
                      1, hkv)[0].mean(1)                 # (hkv, D)
    for n in list(range(nb - n_pad, nb)) + list(masked):
        assert rel(got[n, ::hq // hkv], vmean) < 1e-2


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
def test_decode_attention_cells_is_deterministic_and_counted(gen, kv):
    """Two launches on the same inputs give equal bits (the ranks merge in
    rank order); each adds one to the counter."""
    _, args = cells_case(gen, kv, 8, 16, 16, 256, 2048)
    before = _build.LAUNCHES["decode_attention_cells"]
    first = da.decode_attention_cells_kernel(*args)
    second = da.decode_attention_cells_kernel(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_attention_cells"] == before + 2
    assert torch.equal(first, second)


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
def test_decode_attention_cells_is_one_kernel(gen, kv):
    """One CUDA kernel a call and nothing else (no workspace, no combine
    pass): torch.profiler's device events of one call at the serving
    shape."""
    from torch.profiler import ProfilerActivity, profile
    _, args = cells_case(gen, kv, 8, 16, 16, 256, 2048)
    da.decode_attention_cells_kernel(*args)          # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        da.decode_attention_cells_kernel(*args)
        torch.cuda.synchronize()
    dev = [(ev.key, ev.count) for ev in prof.key_averages()
           if str(ev.device_type).endswith("CUDA")
           and ev.self_device_time_total > 0]
    print(f"decode_attention_cells {kv}: device events {dev}")
    assert len(dev) == 1 and dev[0][1] == 1 and "cells_kernel" in dev[0][0]


def test_decode_attention_cells_refuses_without_a_launch(gen):
    """A D the kernel does not take, a misaligned or non-contiguous arena
    slice raise before any launch; a misaligned q3 is copied, not
    refused."""
    before = _build.LAUNCHES["decode_attention_cells"]
    for D in (64, 384):
        _, args = cells_case(gen, torch.bfloat16, 2, 4, 4, D, 64)
        with pytest.raises(ValueError, match="D 128 or 256"):
            da.decode_attention_cells_kernel(*args)
    for kv, which in ((torch.bfloat16, 1), ("q8_0", 4)):
        _, args = cells_case(gen, kv, 2, 4, 4, 128, 64)
        args = list(args)
        t = args[which]
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        args[which] = buf[1:].view(t.shape)
        with pytest.raises(ValueError, match="aligned"):
            da.decode_attention_cells_kernel(*args)
    _, args = cells_case(gen, torch.bfloat16, 2, 4, 4, 128, 64)
    args = list(args)
    args[2] = torch.cat([args[2], args[2]], dim=2)[:, :, :512]
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention_cells_kernel(*args)
    assert _build.LAUNCHES["decode_attention_cells"] == before
    _, args = cells_case(gen, torch.bfloat16, 2, 4, 4, 128, 64)
    q = args[0]
    q_off = torch.empty(q.numel() + 1, device="cuda")[1:].view(q.shape)
    q_off.copy_(q)
    got = da.decode_attention_cells_kernel(q_off, *args[1:])
    assert _build.LAUNCHES["decode_attention_cells"] == before + 1
    assert rel(got, da.decode_attention_plain(*args)) < 1e-2


def update_case(gen, kv, mode, nb, hq, hkv, D, T, rows, masked=(), n_pad=1):
    """Two equal arenas (layer 1 of 2: the kernel's and the plain version's),
    queries, fresh rows in the arena's type, int64 destination rows and a
    mask: flat, keys past the largest destination hidden; cells, a random
    half of the cells, the last n_pad rows pad rows that see none. Rows in
    `masked` see no key either."""
    B = nb if mode == "flat" else 1
    cache = filled_cache(gen, kv, B, T, hkv, D)
    twin = init_kv_cache(2, B, T, hkv, D, kv, device="cuda")
    for name in ("k", "v", "ks", "vs"):
        if getattr(cache, name) is not None:
            getattr(twin, name).copy_(getattr(cache, name))
    q = torch.randn(nb, hq, D, generator=gen, device="cuda")
    kn, vn = (torch.randn(nb, 1, hkv, D, generator=gen, device="cuda")
              for _ in range(2))
    rows = torch.tensor(rows, dtype=torch.int64, device="cuda")
    if mode == "flat":
        mask = torch.zeros(nb, T, device="cuda")
        mask[:, int(rows.max()) + 1:] = da.NEG
    else:
        mask = cells_mask(gen, nb, T, n_pad)
    for n in masked:
        mask[n] = da.NEG
    if kv == "q8_0":
        k8, kd = _q8_rows(kn)
        v8, vd = _q8_rows(vn)
        fresh = (k8.reshape(nb, -1), v8.reshape(nb, -1), kd.reshape(nb, -1),
                 vd.reshape(nb, -1))
    else:
        fresh = (kn.reshape(nb, -1).bfloat16(), vn.reshape(nb, -1).bfloat16(),
                 None, None)
    return cache, twin, q, fresh, (mask, rows, hkv, 1 / math.sqrt(D))


# mode, nb, hq, hkv, D, T, destination rows (cells: the last is the pad
# row's trash cell T - 1), rows that see no key; S is decode_plan's (8 in
# each but "cells S 6"; "flat B 4"'s T 200 gives slices of 25 keys)
UPDATE_CASES = {
    "flat B 4 4:4": ("flat", 4, 4, 4, 128, 200, [150] * 4, ()),
    "cells 4:4": ("cells", 4, 4, 4, 128, 200, [3, 77, 150, 199], ()),
    "cells 8:2": ("cells", 4, 8, 2, 128, 200, [3, 77, 150, 199], ()),
    # GPT-J's 16 heads of 256: T 512, 64 keys a rank
    "gptj flat n_past 499": ("flat", 1, 16, 16, 256, 512, [499], ()),
    "gptj flat first key of a rank": ("flat", 1, 16, 16, 256, 512, [448], ()),
    "gptj flat last key of a rank": ("flat", 1, 16, 16, 256, 512, [63], ()),
    "gptj flat T - 1": ("flat", 1, 16, 16, 256, 512, [511], ()),
    # the serving arena: T 2048, 256 keys a rank
    "gptj cells NB 8 T 2048": ("cells", 8, 16, 16, 256, 2048,
                               [0, 255, 256, 511, 1024, 1792, 2046, 2047],
                               ()),
    "gptj cells NB 16 T 2048": ("cells", 16, 16, 16, 256, 2048,
                                list(range(5, 1880, 125)) + [2047], ()),
    "gptj cells NB 24 T 2048": ("cells", 24, 16, 16, 256, 2048,
                                list(range(3, 2047, 89)) + [2047], ()),
    "cells T 512 rank edges D 128": ("cells", 6, 4, 4, 128, 512,
                                     [0, 63, 64, 448, 510, 511], ()),
    "cells g_rep 8": ("cells", 3, 16, 2, 128, 512, [10, 300, 511], ()),
    "flat g_rep 8 D 256": ("flat", 2, 16, 2, 256, 512, [300, 300], ()),
    "cells a row hides every key": ("cells", 4, 16, 16, 256, 2048,
                                    [5, 900, 1500, 2047], (1,)),
    # 20 kv heads: S 6, which does not divide D into the ranks' columns
    "cells S 6": ("cells", 4, 20, 20, 128, 512, [5, 100, 300, 511], ()),
    # LLaMA-2 7B: 32 kv heads of 128 (S 4, 128 keys a rank), and GQA 2:1
    "llama flat 32:32 n_past 499": ("flat", 1, 32, 32, 128, 512, [499], ()),
    "llama flat 32:32 first key of a rank": ("flat", 1, 32, 32, 128, 512,
                                             [384], ()),
    "llama flat gqa 32:16": ("flat", 1, 32, 16, 128, 512, [300], ()),
    "llama cells gqa 2:1": ("cells", 2, 2, 1, 128, 256, [17, 255], ()),
    # LLaMA-2 7B serving: 32 kv heads of 128 over 2048 cells
    "llama cells NB 8 32x128 T 2048": ("cells", 8, 32, 32, 128, 2048,
                                       [0, 511, 512, 1023, 1024, 1535,
                                        2046, 2047], ()),
}


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_decode_attention_update_kernel_matches_plain(gen, kv, case):
    """The fused kernel against its plain version (rel 1e-2: p is rounded
    against a running max per 64-key chunk in the kernel, against the row's
    global max in the plain version); its arena equals the plain version's
    after the call, and only the destination rows moved."""
    mode, nb, hq, hkv, D, T, rows, masked = UPDATE_CASES[case]
    cache, twin, q, fresh, tail = update_case(gen, kv, mode, nb, hq, hkv, D,
                                              T, rows, masked)
    start = {n: getattr(cache, n).clone() for n in ("k", "v")}
    before = _build.LAUNCHES["decode_attention_update"]
    got = da.decode_attention_update_kernel(q, *arena_args(cache), *fresh,
                                            *tail)
    assert _build.LAUNCHES["decode_attention_update"] == before + 1
    ref = da.decode_attention_update_plain(q, *arena_args(twin), *fresh, *tail)
    err = rel(got, ref)
    print(f"decode_attention_update {case} {kv}: rel {err:.3e}")  # with -s
    assert err < 1e-2
    for name in ("k", "v", "ks", "vs"):          # the rows written in place
        if getattr(cache, name) is not None:
            assert torch.equal(getattr(cache, name), getattr(twin, name)), name
    written = torch.zeros(T, dtype=torch.bool, device="cuda")
    written[tail[1]] = True
    for name, t in start.items():                # and nothing else moved
        a = getattr(cache, name)
        assert torch.equal(a[0], t[0]) and torch.equal(a[1][:, ~written],
                                                       t[1][:, ~written])
        assert not torch.equal(a[1][:, written], t[1][:, written])
    for n in masked:                             # no visible key: v_new alone
        vf = da._dense(fresh[1][n][None, None],
                       None if fresh[3] is None else fresh[3][n][None, None],
                       1, hkv)[0, :, 0].repeat_interleave(hq // hkv, dim=0)
        assert rel(got[n], vf) < 1e-6


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
def test_decode_attention_update_pad_rows_share_the_trash_cell(gen, kv):
    """Two pad rows write the trash cell T - 1: the arena equals the plain
    version's everywhere else, and the trash cell holds one pad row's
    fresh values (K, V and scales from the same row)."""
    T, D, hkv = 512, 256, 16
    cache, twin, q, fresh, tail = update_case(
        gen, kv, "cells", 5, 16, hkv, D, T, [40, 300, 470, T - 1, T - 1],
        n_pad=2)
    got = da.decode_attention_update_kernel(q, *arena_args(cache), *fresh,
                                            *tail)
    ref = da.decode_attention_update_plain(q, *arena_args(twin), *fresh, *tail)
    assert rel(got, ref) < 1e-2
    for name, new in zip(("k", "v", "ks", "vs"), fresh):
        a, b = getattr(cache, name), getattr(twin, name)
        if a is None:
            continue
        assert torch.equal(a[:, :, :T - 1], b[:, :, :T - 1]), name
        assert torch.equal(a[0], b[0]), name
    pick = [n for n in (3, 4)
            if all(t is None or torch.equal(getattr(cache, name)[1, 0, T - 1],
                                            t[n])
                   for name, t in zip(("k", "v", "ks", "vs"), fresh))]
    assert pick, "the trash cell holds neither pad row's values"


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
@pytest.mark.parametrize("mode", ["flat", "cells"])
def test_decode_attention_update_is_deterministic_and_counted(gen, kv, mode):
    """Two launches on the same inputs give equal bits (the ranks merge in
    rank order); each adds one to the counter. The arena is put back
    between them: the first launch writes the fresh rows, and a pad row
    (it sees no key) averages every row, its destination's included."""
    nb, T = (1, 512) if mode == "flat" else (8, 2048)
    rows = [499] if mode == "flat" else list(range(100, 1500, 200)) + [T - 1]
    cache, twin, q, fresh, tail = update_case(gen, kv, mode, nb, 16, 16, 256,
                                              T, rows)
    before = _build.LAUNCHES["decode_attention_update"]
    first = da.decode_attention_update_kernel(q, *arena_args(cache), *fresh,
                                              *tail)
    for name in ("k", "v", "ks", "vs"):
        if getattr(cache, name) is not None:
            getattr(cache, name).copy_(getattr(twin, name))
    second = da.decode_attention_update_kernel(q, *arena_args(cache), *fresh,
                                               *tail)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decode_attention_update"] == before + 2
    assert torch.equal(first, second)


@pytest.mark.parametrize("mode", ["flat", "cells"])
def test_decode_attention_update_is_one_kernel(gen, mode):
    """One CUDA kernel a call and nothing else (no workspace, no cast of
    rows): torch.profiler's device events of one call, int64 rows."""
    from torch.profiler import ProfilerActivity, profile
    nb, T, kv = (1, 512, torch.bfloat16) if mode == "flat" \
        else (8, 2048, "q8_0")
    rows = [499] if mode == "flat" else list(range(100, 1500, 200)) + [T - 1]
    cache, _, q, fresh, tail = update_case(gen, kv, mode, nb, 16, 16, 256, T,
                                           rows)
    args = (q, *arena_args(cache), *fresh, *tail)
    da.decode_attention_update_kernel(*args)        # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        da.decode_attention_update_kernel(*args)
        torch.cuda.synchronize()
    dev = [(ev.key, ev.count) for ev in prof.key_averages()
           if str(ev.device_type).endswith("CUDA")
           and ev.self_device_time_total > 0]
    print(f"decode_attention_update {mode}: device events {dev}")
    assert len(dev) == 1 and dev[0][1] == 1 and "update_kernel" in dev[0][0]


def test_decode_attention_update_refuses_without_a_launch(gen):
    """A D the kernel does not take, a misaligned arena slice or fresh row,
    and int32 rows raise before any launch."""
    before = _build.LAUNCHES["decode_attention_update"]
    for D in (64, 384):
        cache, _, q, fresh, tail = update_case(gen, torch.bfloat16, "flat", 1,
                                               4, 4, D, 64, [10])
        with pytest.raises(ValueError, match="D 128 or 256"):
            da.decode_attention_update_kernel(q, *arena_args(cache), *fresh,
                                              *tail)
    for kv, which in ((torch.bfloat16, 0), ("q8_0", 3)):
        cache, _, q, fresh, tail = update_case(gen, kv, "cells", 2, 4, 4, 128,
                                               64, [5, 63])
        ar = list(arena_args(cache))
        buf = torch.empty(ar[which].numel() + 1, dtype=ar[which].dtype,
                          device="cuda")
        ar[which] = buf[1:].view(ar[which].shape)
        with pytest.raises(ValueError, match="aligned"):
            da.decode_attention_update_kernel(q, *ar, *fresh, *tail)
    cache, _, q, fresh, (mask, rows, hkv, scale) = update_case(
        gen, torch.bfloat16, "cells", 2, 4, 4, 128, 64, [5, 63])
    kn = torch.empty(fresh[0].numel() + 1, dtype=fresh[0].dtype,
                     device="cuda")[1:].view(fresh[0].shape)
    with pytest.raises(ValueError, match="aligned"):
        da.decode_attention_update_kernel(q, *arena_args(cache), kn,
                                          *fresh[1:], mask, rows, hkv, scale)
    with pytest.raises(ValueError, match="int64"):
        da.decode_attention_update_kernel(q, *arena_args(cache), *fresh, mask,
                                          rows.int(), hkv, scale)
    assert _build.LAUNCHES["decode_attention_update"] == before


def test_small_gptj_batched_on_card_matches_cpu(gen):
    """The BatchedEngine on the card (cells kernels, fused and not) against
    the same engine on the CPU: greedy tokens equal."""
    from ggml_imax_tpu_torch.runtime.batched import BatchedEngine
    cfg = gptj.GPTJConfig(n_vocab=512, n_ctx=128, n_embd=256, n_head=2,
                          n_layer=2, n_rot=64)
    outs = {}
    for dev in ("cuda", "cpu"):
        p = qmm.params_repack(gptj.prepare_fused(
            gptj.synthetic_params(cfg, seed=2, device=dev), cfg))
        for fused in (False, True):
            be = BatchedEngine(gptj, cfg, p, kv_dtype="q8_0", device=dev,
                               fused_kv_update=fused)
            rids = [be.add_request(pr, 6, temp=0.0)
                    for pr in ([3, 5, 7, 11], [13, 17])]
            res = be.run()
            outs[dev, fused] = [res[r] for r in rids]
    assert outs["cuda", False] == outs["cpu", False] == outs["cuda", True]


def causal_mask(b, tq, tk, dist=False, window=None):
    qi = torch.arange(tq, device="cuda")[:, None] + (tk - tq)
    kj = torch.arange(tk, device="cuda")[None]
    fill = (kj - qi).float() if dist else torch.zeros(tq, tk, device="cuda")
    vis = kj <= qi if window is None else (kj <= qi) & (kj > qi - window)
    return torch.where(vis, fill, float("-inf"))[None, None] \
        .expand(b, 1, tq, tk)


def backward_args(gen, b, tq, tk, hq, hkv, d, causal, kw):
    """The backward kernels' prepared inputs, from the forward kernel's out
    and lse; kw as test_flash_backward_kernels_match_plain takes it."""
    kw = dict(kw)
    row, window = kw.pop("masked_row", None), kw.pop("window", None)
    q = torch.randn(b, tq, hq, d, generator=gen, device="cuda")
    k, v = (torch.randn(b, tk, hkv, d, generator=gen, device="cuda")
            for _ in range(2))
    mask = causal_mask(b, tq, tk, kw.get("max_bias", 0) > 0, window) \
        if causal else None
    if row is not None:
        mask = mask.clone()
        mask[:, :, row] = float("-inf")
    prep = fa._prep(q, k, v, mask, kw.get("max_bias", 0.0))
    scale, cap = 1 / math.sqrt(d), kw.get("logit_softcap", 0.0)
    tiles = None if mask is None else tile_map(prep[3])
    out, lse = fa.flash_attention_kernel(*prep, scale, cap, True, tiles=tiles)
    do = torch.randn(out.shape, generator=gen, device="cuda")
    di = (do * out).sum(-1).transpose(1, 2).contiguous()
    return (*prep[:3], do.bfloat16(), *prep[3:], lse, di, scale, cap)


BACKWARD_CASES = [
    # the reference's flash-backward test cases (tests/test_flash_backward.py)
    (2, 16, 16, 4, 4, 32, False, {}),
    (1, 24, 40, 4, 2, 64, True, {}),
    (1, 16, 16, 4, 4, 32, True, {"logit_softcap": 5.0}),
    (1, 16, 16, 8, 8, 32, True, {"max_bias": 8.0}),
    (2, 8, 128, 4, 1, 16, False, {}),
    # GPT-2 117M training (D 64), GPT-J (D 256, key tiles of 32), ragged
    # GQA with softcap and ALiBi and a fully masked row
    (2, 128, 128, 12, 12, 64, True, {}),
    (1, 96, 96, 4, 4, 256, True, {}),
    (2, 72, 100, 8, 2, 128, True, {"logit_softcap": 20.0, "max_bias": 8.0,
                                   "masked_row": 5}),
    # the training shape at B 1; a sliding window; T not a multiple of 64;
    # a fully masked row in tiles that would otherwise be skipped
    (1, 512, 512, 12, 12, 64, True, {}),
    (2, 256, 256, 4, 4, 64, True, {"window": 80}),
    (2, 200, 200, 4, 2, 64, True, {}),
    (1, 200, 200, 4, 4, 64, True, {"masked_row": 5}),
    (1, 300, 300, 4, 2, 128, True, {"window": 70, "masked_row": 3}),
    # ALiBi with a fully masked row at D 128: its 32-row query step is
    # computed, the other half of its all-NEG tiles skipped
    (1, 200, 200, 4, 4, 128, True, {"max_bias": 8.0, "masked_row": 70}),
]


@pytest.mark.parametrize("b,tq,tk,hq,hkv,d,causal,kw", BACKWARD_CASES)
def test_flash_backward_kernels_match_plain(gen, b, tq, tk, hq, hkv, d, causal,
                                            kw):
    from ggml_imax_tpu_torch.ops import flash_backward as fb
    args = backward_args(gen, b, tq, tk, hq, hkv, d, causal, kw)
    n0 = dict(_build.LAUNCHES)
    got = fb.flash_attention_bwd_kernel(*args)
    assert _build.LAUNCHES["flash_backward_dq"] == n0["flash_backward_dq"] + 1
    assert _build.LAUNCHES["flash_backward_dkv"] == n0["flash_backward_dkv"] + 1
    assert _build.LAUNCHES["flash_backward_tiles"] \
        == n0["flash_backward_tiles"] + causal       # one map a masked call
    want = fb.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert rel(g, w) < 1e-2, name


@pytest.mark.parametrize("case", [BACKWARD_CASES[i] for i in (7, 8, 9, 11)])
def test_flash_backward_kernels_are_deterministic(gen, case):
    """Two launches on the same inputs give the same bits (every sum in a
    fixed order, no atomics)."""
    from ggml_imax_tpu_torch.ops import flash_backward as fb
    args = backward_args(gen, *case)
    first = fb.flash_attention_bwd_kernel(*args)
    second = fb.flash_attention_bwd_kernel(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("case", [BACKWARD_CASES[i]
                                  for i in (6, 9, 11, 12, 13)])
def test_flash_backward_skip_is_exact(gen, case):
    """The kernels give equal results with the mask's tile map and with a
    map that marks every tile mixed (nothing skipped, the mask read in every
    tile): a skipped tile adds exact zeros, and the lse guard keeps the
    tiles of a fully masked row (D 64 and 128, the register route; D 256,
    the shared-memory route)."""
    from ggml_imax_tpu_torch.ops import flash_backward as fb
    args = backward_args(gen, *case)
    tiles = fb.backward_tile_map(args[4])
    assert bool((tiles == fb.TILE_NEG).any())
    every = torch.full_like(tiles, fb.TILE_MIXED)
    for kernel in (fb.flash_backward_dq, fb.flash_backward_dkv):
        skipped, computed = kernel(*args, tiles), kernel(*args, every)
        torch.cuda.synchronize()
        for g, w in zip(*(t if isinstance(t, tuple) else (t,)
                          for t in (skipped, computed))):
            assert torch.equal(g, w), kernel.__name__


@pytest.mark.parametrize("tq,tk,window,row", [(512, 512, None, None),
                                              (200, 300, 70, None),
                                              (131, 257, None, 64),
                                              (64, 64, None, None)])
def test_flash_backward_tile_map_matches_plain(gen, tq, tk, window, row):
    from ggml_imax_tpu_torch.ops import flash_backward as fb
    mask = causal_mask(3, tq, tk, window=window).clone()
    mask[1, :, :, 0] = 0.5                         # one mixed column
    if row is not None:
        mask[:, :, row] = float("-inf")
    m3 = fa._prep(torch.zeros(3, tq, 1, 16, device="cuda"),
                  torch.zeros(3, tk, 1, 16, device="cuda"),
                  torch.zeros(3, tk, 1, 16, device="cuda"), mask, 0.0)[3]
    n0 = _build.LAUNCHES["flash_backward_tiles"]
    got = fb.backward_tile_map(m3)
    assert _build.LAUNCHES["flash_backward_tiles"] == n0 + 1
    assert torch.equal(got.cpu(), fb.backward_tile_map_plain(m3.cpu()))


def test_flash_attention_grads_on_card_match_cpu(gen):
    q = torch.randn(2, 40, 4, 64, generator=gen, device="cuda")
    k, v = (torch.randn(2, 56, 2, 64, generator=gen, device="cuda")
            for _ in range(2))
    mask = causal_mask(2, 40, 56)
    grads = {}
    for dev in ("cuda", "cpu"):
        args = [t.to(dev).clone().requires_grad_(True) for t in (q, k, v)]
        o = fa.flash_attention(*args, mask.to(dev), out_dtype=torch.float32)
        grads[dev] = torch.autograd.grad(torch.sin(o).sum(), args)
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert rel(g.cpu(), w) < 1e-2


@pytest.mark.parametrize("route,m", [("natpair", 1), ("natpair", 64),
                                     ("nat8", 1), ("nat8", 64)])
def test_kernel_routes_carry_gradients(gen, route, m):
    """dx through each kernel route (W4A8, W4A16, W8A8, W8A16) on the card:
    the product launches its kernel and the gradient is the dequantized-
    weight VJP, as on the CPU."""
    from ggml_imax_tpu_torch.ops.qmatmul import dequantize, qmatmul
    qt = natpair(512, 256, gen) if route == "natpair" else nat8(512, 256, gen)
    name = {("natpair", 1): "w4a8_gemv", ("natpair", 64): "w4a16_gemm",
            ("nat8", 1): "nat8_w8a8", ("nat8", 64): "nat8_w8a16"}[route, m]
    x = torch.randn(m, 512, generator=gen, device="cuda").requires_grad_(True)
    n0 = _build.LAUNCHES[name]
    y = qmatmul(x, qt, out_dtype=torch.float32)
    assert _build.LAUNCHES[name] == n0 + 1 and y.grad_fn is not None
    (dx,) = torch.autograd.grad(torch.sin(y).sum(), x)
    ref = torch.cos(y.detach()).bfloat16().float() \
        @ dequantize(qt, torch.bfloat16).float().T
    assert rel(dx, ref) < 1e-5


def test_small_gpt2_training_step_on_card_matches_cpu(gen):
    """Loss and every float leaf's gradient through gpt2.forward (flash with
    its backward kernels on the card, plain versions on the CPU)."""
    from ggml_imax_tpu_torch.optimize import float_leaves
    cfg = gpt2.GPT2Config(n_vocab=256, n_ctx=64, n_embd=128, n_head=2,
                          n_layer=2)
    rng = np.random.default_rng(3)
    toks, tgts = rng.integers(0, 256, (2, 48)), rng.integers(0, 256, (2, 48))
    out = {}
    for dev in ("cuda", "cpu"):
        p = gpt2.synthetic_params(cfg, seed=1, device=dev)
        leaves = float_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_(True)
        cache = gpt2.init_cache(cfg, batch=2, n_ctx=48, dtype=torch.float32,
                                device=dev)
        lg, _ = gpt2.forward(cfg, p, torch.as_tensor(toks, device=dev),
                             torch.arange(48, device=dev)[None].expand(2, 48),
                             cache, 0, compute_dtype=torch.float32)
        loss = -torch.log_softmax(lg, -1).gather(
            -1, torch.as_tensor(tgts, device=dev)[..., None]).mean()
        out[dev] = (float(loss.detach()), [g.cpu() for g in
                                  torch.autograd.grad(loss, leaves)])
    assert abs(out["cuda"][0] - out["cpu"][0]) < 1e-3 * abs(out["cpu"][0])
    for g, w in zip(out["cuda"][1], out["cpu"][1]):
        assert rel(g, w) < 2e-2


def permuted(layout, K, N, gen, bk, g=32, zero=8, bias=False,
             scale_dtype=torch.float32):
    """A random weight in one of the permuted layouts (planes, rowpair,
    int8) with distinct scale rows, so a swapped low/high plane shows."""
    kind, q4l = {"planes": ("nib4", 0), "rowpair": ("nib4", 1),
                 "int8": ("int8", 2)}[layout]
    if kind == "nib4":
        q = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8,
                          generator=gen, device="cuda")
    else:
        q = torch.randint(-127, 128, (K, N), dtype=torch.int8, generator=gen,
                          device="cuda")
    s = torch.rand((K // g, N), generator=gen, device="cuda") * 0.01
    b = (torch.rand((K // g, N), generator=gen, device="cuda") - 0.5) * 0.02 \
        if bias else None
    return QTensor(kind, q, s.to(scale_dtype), None if b is None
                   else b.to(scale_dtype), K, N, GGMLType.Q2_K if g == 16
                   else GGMLType.Q4_0, zero=zero, interleaved_bk=bk,
                   q4_layout=q4l)


KERNEL_OF = {"planes": "planes_w4a16", "rowpair": "rowpair_w4a16",
             "int8": "int8_rows_w8a16"}


def check_permuted(qt, layout, m, gen):
    x = torch.randn(m, qt.k, generator=gen, device="cuda")
    name = KERNEL_OF[layout]
    before = _build.LAUNCHES[name]
    got = getattr(qmm, name)(x, qt)
    assert _build.LAUNCHES[name] == before + 1
    ref = getattr(qmm, name + "_plain")(x, qt)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (m, qt.n)
    assert rel(got, ref) < 1e-4
    return x, got


# Q3_K (per-16, zero 4), Q2_K (per-16, zero 0, bias) and a per-32 case
@pytest.mark.parametrize("m", [1, 5, 64, 512, 600])
@pytest.mark.parametrize("bk", [256, 512])
@pytest.mark.parametrize("g,zero,bias", [(16, 4, False), (16, 0, True),
                                         (32, 8, False)])
def test_planes_kernel_matches_plain(gen, m, bk, g, zero, bias):
    qt = permuted("planes", 1024, 640, gen, bk, g, zero, bias)
    x, got = check_permuted(qt, "planes", m, gen)
    if g == 16:
        # the low and high planes take different scale rows: swapping them
        # must show
        s = qt.scale.reshape(-1, 2, qt.n).flip(1).reshape(qt.scale.shape)
        swapped = qmm.planes_w4a16_plain(x, QTensor(**{**qt.__dict__,
                                                       "scale": s}))
        assert rel(got, swapped) > 1e-2


@pytest.mark.parametrize("m", [1, 5, 64, 512, 600])
@pytest.mark.parametrize("bk", [256, 512])
@pytest.mark.parametrize("bias", [False, True])
def test_rowpair_kernel_matches_plain(gen, m, bk, bias):
    check_permuted(permuted("rowpair", 1024, 640, gen, bk, bias=bias),
                   "rowpair", m, gen)


@pytest.mark.parametrize("m", [1, 5, 64, 512, 600])
@pytest.mark.parametrize("bk", [256, 512])
@pytest.mark.parametrize("g,bias", [(32, False), (16, True), (16, False)])
def test_int8_rows_kernel_matches_plain(gen, m, bk, g, bias):
    check_permuted(permuted("int8", 1024, 640, gen, bk, g, 0, bias),
                   "int8", m, gen)


# GPT-2 117M's products: attn_w (K 768, tag 256) and out_w (K 3072, 512),
# bf16 scales as a half-width variant
@pytest.mark.parametrize("layout", ["planes", "rowpair", "int8"])
@pytest.mark.parametrize("k,n,bk", [(768, 2304, 256), (3072, 768, 512)])
@pytest.mark.parametrize("m", [1, 512])
def test_permuted_kernels_at_path_shapes(gen, layout, k, n, bk, m):
    g = 16 if layout != "rowpair" else 32
    qt = permuted(layout, k, n, gen, bk, g, 4 if layout == "planes" else 8,
                  bias=layout == "int8", scale_dtype=torch.bfloat16)
    check_permuted(qt, layout, m, gen)


# (g, zero, bias, scale dtype) per layout: per-16 and per-32 scales, bias on
# and off, f32 and bf16
ROUTE_VARIANTS = {
    "planes": [(16, 4, False, torch.float32), (16, 0, True, torch.bfloat16),
               (32, 8, False, torch.bfloat16), (32, 8, True, torch.float32)],
    "rowpair": [(32, 8, False, torch.float32), (32, 8, True, torch.bfloat16)],
    "int8": [(32, 0, False, torch.float32), (16, 0, True, torch.bfloat16),
             (16, 0, False, torch.bfloat16), (32, 0, True, torch.float32)],
}


# K 1536 takes every tag: bk 32 and 96 give odd NB (1, 3), 256 and 512 even;
# M up to 8 takes the GEMV route, above it the tile route
@pytest.mark.parametrize("layout", ["planes", "rowpair", "int8"])
@pytest.mark.parametrize("m", [1, 2, 5, 8, 9, 64, 512])
@pytest.mark.parametrize("bk", [32, 96, 256, 512])
def test_permuted_routes_match_plain(gen, layout, m, bk):
    for g, zero, bias, sdt in ROUTE_VARIANTS[layout]:
        qt = permuted(layout, 1536, 640, gen, bk, g, zero, bias, sdt)
        x, got = check_permuted(qt, layout, m, gen)
        if layout == "planes" and g == 16:
            s = qt.scale.reshape(-1, 2, qt.n).flip(1).reshape(qt.scale.shape)
            swapped = qmm.planes_w4a16_plain(x, QTensor(**{**qt.__dict__,
                                                           "scale": s}))
            assert rel(got, swapped) > 1e-2


# GPT-2 117M's products at M 1, 8 and 512: the plan's split, no split, 2
# and the most pieces a cluster takes are each the same bits from run to
# run, and each matches the plain version
@pytest.mark.parametrize("layout", ["planes", "rowpair", "int8"])
@pytest.mark.parametrize("k,n,bk", [(768, 2304, 256), (3072, 768, 512)])
@pytest.mark.parametrize("m", [1, 8, 512])
def test_permuted_split_is_deterministic(gen, monkeypatch, layout, k, n, bk,
                                         m):
    g = 32 if layout == "rowpair" else 16
    qt = permuted(layout, k, n, gen, bk, g, 4 if layout == "planes" else 8,
                  bias=True, scale_dtype=torch.bfloat16)
    x = torch.randn(m, k, generator=gen, device="cuda")
    name = KERNEL_OF[layout]
    ref = getattr(qmm, name + "_plain")(x, qt)
    plan = qmm.permuted_plan
    route, split = plan(layout, m, k, n, bk, g)
    assert route == ("gemv" if m <= 8 else "tile")
    units = qmm.permuted_units(layout, k, bk, g) if m <= 8 else k // 64
    most = max(s for s in range(1, 9) if units % s == 0)    # a cluster's blocks
    outs = {}
    for s in sorted({1, 2, split, most}):
        monkeypatch.setattr(qmm, "permuted_plan",
                            lambda *a, s=s: (plan(*a)[0], s))
        runs = [getattr(qmm, name)(x, qt) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1]), s
        assert rel(runs[0], ref) < 1e-4, s
        outs[s] = runs[0]
    assert len(outs) > 1


def test_permuted_wrappers_refuse_what_the_kernel_does_not_take(gen):
    qt = permuted("planes", 512, 200, gen, 256, 16, 4)       # N % 16 != 0
    with pytest.raises(ValueError, match="N % 16"):
        qmm.planes_w4a16(torch.randn(3, 512, device="cuda"), qt)
    qt = permuted("int8", 512, 256, gen, 256, 16)
    flat = torch.randn(12 * 512 + 1, generator=gen, device="cuda")
    x = flat.to(torch.bfloat16)[1:].view(12, 512)             # 2-byte offset
    before = _build.LAUNCHES["int8_rows_w8a16"]
    # the tile route (M > 8) reads x as it is, in bf16
    with pytest.raises(ValueError, match="aligned"):
        qmm.int8_rows_w8a16(x, qt)
    assert _build.LAUNCHES["int8_rows_w8a16"] == before
    # the GEMV route (M <= 8) reads an f32 copy
    got = qmm.int8_rows_w8a16(x[:3], qt)
    assert _build.LAUNCHES["int8_rows_w8a16"] == before + 1
    assert rel(got, qmm.int8_rows_w8a16_plain(x[:3], qt)) < 1e-4


@pytest.mark.parametrize("route", ["planes", "rowpair", "int8"])
def test_permuted_routes_carry_gradients(gen, route):
    from ggml_imax_tpu_torch.ops.qmatmul import dequantize, qmatmul
    qt = permuted(route, 512, 256, gen, 256, 16 if route == "planes" else 32,
                  0 if route == "planes" else 8, bias=True)
    x = torch.randn(64, 512, generator=gen, device="cuda").requires_grad_(True)
    n0 = _build.LAUNCHES[KERNEL_OF[route]]
    y = qmatmul(x, qt, out_dtype=torch.float32)
    assert _build.LAUNCHES[KERNEL_OF[route]] == n0 + 1 and y.grad_fn is not None
    (dx,) = torch.autograd.grad(torch.sin(y).sum(), x)
    ref = torch.cos(y.detach()).bfloat16().float() \
        @ dequantize(qt, torch.bfloat16).float().T
    assert rel(dx, ref) < 1e-5


@pytest.mark.parametrize("wtype", [GGMLType.Q3_K, GGMLType.Q2_K])
def test_small_gpt2_kquants_on_card_match_cpu(gen, wtype):
    cfg = gpt2.GPT2Config(n_vocab=1000, n_ctx=64, n_embd=256, n_head=4,
                          n_layer=2)
    prompt = np.random.default_rng(3).integers(0, 1000, 24)
    outs = {}
    for dev in ("cuda", "cpu"):
        p = qmm.params_repack(gpt2.synthetic_params(cfg, wtype, seed=4,
                                                    device=dev))
        n0 = _build.LAUNCHES["planes_w4a16"]
        cache = gpt2.init_cache(cfg, device=dev)
        lg, cache = gpt2.forward(cfg, p, torch.as_tensor(prompt[None], device=dev),
                                 torch.arange(24, device=dev)[None], cache, 0)
        lg2, _ = gpt2.forward(cfg, p, torch.tensor([[7]], device=dev),
                              torch.tensor([[24]], device=dev), cache, 24)
        # 4 products a layer, 2 layers, 2 forwards; none on the CPU
        assert _build.LAUNCHES["planes_w4a16"] - n0 == (16 if dev == "cuda"
                                                         else 0)
        outs[dev] = (lg.cpu(), lg2.cpu())
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert float((a - b).abs().max()) < 5e-2


# ---- decode spans and chunks as CUDA graphs (runtime/engine.py, batched.py)

SMALL_GPTJ = dict(n_vocab=512, n_ctx=256, n_embd=512, n_head=2, n_layer=2,
                  n_rot=64)


def small_gptj_card():
    cfg = gptj.GPTJConfig(**SMALL_GPTJ)
    return cfg, qmm.params_repack(gptj.prepare_fused(
        gptj.synthetic_params(cfg, seed=5, device="cuda"), cfg))


def arena_copy(cache):
    return [None if t is None else t.clone()
            for t in (cache.k, cache.v, cache.ks, cache.vs)]


def arena_load(cache, saved):
    for t, s in zip((cache.k, cache.v, cache.ks, cache.vs), saved):
        if t is not None:
            t.copy_(s)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
def test_captured_span_replays_the_eager_span_bit_for_bit(gen, kv, fused):
    """A span's first run is eager (the warm-up), the second a replay of
    its graph: from the same arena and the same uniforms, the same ids,
    last-step logits and arena, bit for bit; greedy, the chunk-1 tokens."""
    from ggml_imax_tpu_torch.runtime.engine import Engine
    cfg, p = small_gptj_card()
    eng = Engine(gptj, cfg, p, kv_dtype=kv, fused_kv_update=fused)
    prompt = list(np.random.default_rng(2).integers(0, 512, 40))
    want = eng.generate(prompt, 9, temp=0)            # the prompt's rows
    saved = arena_copy(eng.arena)
    runs = []
    for _ in range(2):
        arena_load(eng.arena, saved)
        g = torch.Generator(device="cuda")
        g.manual_seed(9)
        ids = eng.decode_span([want[0]], 40, 8, temp=0.9, top_k=40,
                              top_p=0.95, generator=g)
        st, run = eng._spans[(8, 1, 64)]
        runs.append((ids, st.logits.clone(), arena_copy(eng.arena)))
    assert run.graph is not None
    (ids_e, lg_e, ar_e), (ids_r, lg_r, ar_r) = runs
    assert np.array_equal(ids_e, ids_r), (ids_e[:, 0], ids_r[:, 0])
    assert torch.equal(lg_e, lg_r), float((lg_e - lg_r).abs().max())
    for i, (a, b) in enumerate(zip(ar_e, ar_r)):
        assert a is None or torch.equal(a, b), \
            (i, (a != b).nonzero()[:8].tolist())
    chunked = eng.generate(prompt, 9, temp=0, chunk=8)
    assert chunked == want, (chunked, want)


def test_replays_count_the_eager_steps_launches(gen):
    from ggml_imax_tpu_torch.runtime.engine import Engine
    cfg, p = small_gptj_card()
    eng = Engine(gptj, cfg, p)
    eng.generate(list(range(3, 43)), 5, temp=0, chunk=4)   # capture (4, 1)
    _build.reset_launches()
    eng.decode_step(eng.arena, np.array([7]), 44)
    step = dict(_build.LAUNCHES)
    assert step["w4a8_gemv"] == 2 * 2 + 1 and step["decode_attention"] == 2
    _build.reset_launches()
    for i in range(3):
        eng.decode_span([7], 40 + 4 * i, 4)
    assert _build.LAUNCHES == {k: 3 * 4 * n for k, n in step.items()}
    _build.reset_launches()


@pytest.mark.parametrize("fused", [False, True])
def test_run_pipelined_on_card_matches_step_loop(gen, fused):
    from ggml_imax_tpu_torch.runtime.batched import BatchedEngine
    cfg, p = small_gptj_card()
    prompts = [list(np.random.default_rng(s).integers(0, 512, n))
               for s, n in ((1, 21), (2, 9), (3, 30))]
    outs = []
    for pipelined in (False, True):
        be = BatchedEngine(gptj, cfg, p, kv_dtype="q8_0",
                           on_device_sampling=True, fused_kv_update=fused)
        rids = [be.add_request(pr, n, temp=0.0)
                for pr, n in zip(prompts, (11, 7, 18))]
        if pipelined:
            res = be.run_pipelined(4)
            assert be._chunks and all(run.graph is not None
                                      for _, run in be._chunks.values())
        else:
            res = be.run()
        outs.append([res[r] for r in rids])
        assert (be.cell_pos[:-1] == -1).all()
    assert outs[0] == outs[1]


# ---- the LLaMA slice: Q4_K natpair products, its ops, the small model

# the LLaMA-2 7B products after prepare_fused (qkv_w, o_w, gu_w, down_w,
# output), a small one and one with an odd number of quant blocks
Q4K_SHAPES = [(4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096),
              (4096, 32000), (512, 256), (1056, 384)]


def q4k_natpair(K, N, gen, scale_dtype):
    """A Q4_K weight as models/llama.synthetic_params_device draws it
    (uniform bytes, scale |N| 0.02 / 9, bias -|N| 0.02 / 3, zero 0),
    repacked to natpair: the bias takes 8 * scale before the cast."""
    q = torch.randint(0, 256, (K // 2, N), dtype=torch.uint8, generator=gen,
                      device="cuda")
    s = torch.randn((K // 32, N), generator=gen, device="cuda").abs() * 0.02 / 9
    b = torch.randn((K // 32, N), generator=gen, device="cuda").abs() \
        * -0.02 / 3
    qt = QTensor("nib4", q, s, b, K, N, GGMLType.Q4_K, zero=0)
    return qmm.repack_natpair(qt, 512 if K % 512 == 0 else 32,
                              scale_dtype=scale_dtype)


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", Q4K_SHAPES)
def test_w4a8_on_q4k_weights_matches_plain(gen, scale_dtype, k, n):
    qt = q4k_natpair(k, n, gen, scale_dtype)
    assert qt.bias is not None and qt.bias.dtype == scale_dtype
    check_w4a8(qt, torch.randn(1, k, generator=gen, device="cuda"),
               launches=2)


def test_w4a8_instances_ptxas(gen, tmp_path):
    """w4a8_gemv.cu compiled alone with the library's flags: ptxas reports
    its four instances (f32 / bf16 scales, with and without a bias), each
    line shown with -s (the f32 + bias instance spilled in an earlier
    design)."""
    import subprocess
    res = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-c",
         str(_build.CSRC / "w4a8_gemv.cu"), "-o", str(tmp_path / "w4a8.o")],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
             if any(w in ln for w in ("Compiling entry", "spill",
                                      "registers"))]
    print("\n".join(lines))
    assert sum("Compiling entry" in ln and "w4a8_split_k" in ln
               for ln in lines) == 4


@pytest.mark.parametrize("m", [8, 100, 512])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(4096, 12288), (4096, 22528), (11264, 4096),
                                 (512, 256)])
def test_w4a16_on_q4k_weights_matches_plain(gen, m, scale_dtype, k, n):
    qt = q4k_natpair(k, n, gen, scale_dtype)
    check_w4a16(qt, torch.randn(m, k, generator=gen, device="cuda"),
                launches=2)


def test_llama_ops_on_card_match_cpu(gen):
    from ggml_imax_tpu_torch.ops import activations, norms, rope
    x = torch.randn(2, 9, 4, 128, generator=gen, device="cuda") * 3
    w = torch.randn(128, generator=gen, device="cuda") * 0.1 + 1
    pos = torch.arange(9, device="cuda")[None].expand(2, 9) * 57
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        pairs = [(norms.rms_norm(xd, w), norms.rms_norm(xd.cpu(), w.cpu())),
                 (activations.silu(xd), activations.silu(xd.cpu()))]
        for mode, nd, fs in ((2, None, 1.0), (2, 64, 0.5), (0, None, 0.25)):
            kw = dict(n_dims=nd, mode=mode, freq_scale=fs)
            pairs.append((rope.rope(xd, pos, **kw),
                          rope.rope(xd.cpu(), pos.cpu(), **kw)))
        for got, ref in pairs:
            assert got.dtype == dt and got.device.type == "cuda"
            # f32: rope's theta reaches ~456 rad here, where the two
            # devices' pow and cos part by a few ulps of theta (3e-5 rad):
            # 1.04e-5 on an H100
            tol = 1e-4 if dt == torch.float32 else 2 ** -7
            assert rel(got.cpu(), ref) < tol


SMALL_LLAMA = dict(n_vocab=512, n_ctx=256, n_embd=256, n_head=2, n_head_kv=1,
                   n_layer=2, n_ff=768)


def small_llama(dev):
    """The CPU tests' small LLaMA (head_dim 128, GQA 2:1, n_ff 768 padded to
    1024): normal weights of std 0.08 quantized to Q4_K on the host (the
    same weights on both devices; the benchmark's structural draw gives
    every token the same top logit at this size), fused, repacked, moved to
    `dev`."""
    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.quant.device import quantize_for_device
    cfg = llama.LlamaConfig(**SMALL_LLAMA)
    rng = np.random.default_rng(5)
    E, F, kv = cfg.n_embd, cfg.n_ff, cfg.n_head_kv * cfg.head_dim

    def q(k, n):
        w = (rng.standard_normal((k, n)) * 0.08).astype(np.float32)
        return quantize_for_device(w, GGMLType.Q4_K, device="cpu")

    def norm(n):
        return torch.from_numpy((1 + 0.1 * rng.standard_normal(n))
                                .astype(np.float32))

    p = {"tok_embd": q(E, cfg.n_vocab), "out_norm": norm(E),
         "output": q(E, cfg.n_vocab), "layers": []}
    for _ in range(cfg.n_layer):
        p["layers"].append({
            "attn_norm": norm(E), "q_w": q(E, E), "k_w": q(E, kv),
            "v_w": q(E, kv), "o_w": q(E, E), "ffn_norm": norm(E),
            "gate_w": q(E, F), "up_w": q(E, F), "down_w": q(F, E)})
    p = llama.fuse_gate_up(llama.fuse_qkv(p), pad_multiple=1024)
    return cfg, moved(qmm.params_repack(p), dev)


def moved(d, dev):
    if isinstance(d, dict):
        return {k: moved(v, dev) for k, v in d.items()}
    if isinstance(d, list):
        return [moved(v, dev) for v in d]
    if isinstance(d, QTensor):
        opt = lambda t: None if t is None else t.to(dev)
        return replace(d, q=d.q.to(dev), scale=opt(d.scale), bias=opt(d.bias),
                       lut=opt(d.lut), signs=opt(d.signs))
    return d.to(dev)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
def test_small_llama_on_card_matches_cpu(gen, kv, fused):
    """A 24-token prefill and two decode steps; on the card each layer's
    four products and the head take W4A16 (prefill) or W4A8 (decode).
    Logits within 3.5% of the largest |logit| (chip_smoke's ROUTE_TOL): the
    kernels sum in another order than the plain versions (W4A16 ~2e-6
    apart), which flips bf16 and int8 roundings of the activations
    downstream; such noise alone moves this model's logits by up to 2.2%
    of the largest on the CPU, and an H100 read 1.2-2.1%."""
    from ggml_imax_tpu_torch.models import llama
    prompt = np.random.default_rng(1).integers(0, 512, 24)
    outs = {}
    for dev in ("cuda", "cpu"):
        cfg, p = small_llama(dev)
        cache = llama.init_cache(cfg, dtype=kv, device=dev)
        _build.reset_launches()
        lg, cache = llama.forward(cfg, p, torch.as_tensor(prompt[None],
                                                          device=dev),
                                  torch.arange(24, device=dev)[None], cache,
                                  0, fused_kv_update=fused)
        steps = [lg.cpu()]
        for i, tok in enumerate((7, 300)):
            lg, cache = llama.forward(
                cfg, p, torch.tensor([[tok]], device=dev),
                torch.tensor([[24 + i]], device=dev), cache, 24 + i,
                fused_kv_update=fused)
            steps.append(lg.cpu())
        if dev == "cuda":
            counts = {k: n for k, n in _build.LAUNCHES.items() if n}
        outs[dev] = steps
    attn = "decode_attention_update" if fused else "decode_attention"
    assert counts == {"w4a16_gemm": 9, "flash_attention": 2,
                      "flash_backward_tiles": 2, "w4a8_gemv": 18, attn: 4}
    limit = 3.5e-2 * max(float(b.abs().max()) for b in outs["cpu"])
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) < limit
    _build.reset_launches()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
def test_small_llama_captured_span_replays_the_eager_span(gen, kv, fused):
    """The small LLaMA's decode span of 4: its replay gives the eager run's
    ids and arena bit for bit; generate(chunk=4) the chunk-1 tokens."""
    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.runtime.engine import Engine
    cfg, p = small_llama("cuda")
    eng = Engine(llama, cfg, p, kv_dtype=kv, fused_kv_update=fused)
    prompt = list(np.random.default_rng(2).integers(0, 512, 40))
    want = eng.generate(prompt, 9, temp=0)
    saved = arena_copy(eng.arena)
    runs = []
    for _ in range(2):
        arena_load(eng.arena, saved)
        ids = eng.decode_span([want[0]], 40, 4)
        runs.append((ids, arena_copy(eng.arena)))
    assert eng._spans[(4, 1, 64)][1].graph is not None
    (ids_e, ar_e), (ids_r, ar_r) = runs
    assert np.array_equal(ids_e, ids_r)
    assert all(a is None or torch.equal(a, b) for a, b in zip(ar_e, ar_r))
    assert eng.generate(prompt, 9, temp=0, chunk=4) == want


# ---- the float and non-codebook block formats on the card: each format's
# weights quantized on the host by the port's codecs, repacked, moved

NEW_FORMATS = ["Q4_1", "Q5_0", "Q5_1", "Q8_1", "Q5_K", "Q6_K"]


def host_weight(fmt, k, n, scale_dtype, seed=3):
    from ggml_imax_tpu_torch.quant.device import quantize_for_device
    w = (np.random.default_rng(seed).standard_normal((k, n)) * 0.05) \
        .astype(np.float32)
    qt = quantize_for_device(w, GGMLType[fmt], device="cpu")
    return moved(qmm.params_repack({"w": qt}, scale_dtype=scale_dtype)["w"],
                 "cuda")


@pytest.mark.parametrize("m", [1, 5, 64])
@pytest.mark.parametrize("scale_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("fmt", NEW_FORMATS)
def test_new_format_products_match_plain(gen, fmt, scale_dtype, m):
    """Q4_1 takes natpair with a bias (W4A8 at m 1, W4A16 above), the rest
    nat8 (W8A8 / W8A16; Q5_1 and Q5_K with a bias, Q6_K at g 16): one
    launch a call, within rel 1e-4 of the plain version on the card."""
    qt = host_weight(fmt, 512, 256, scale_dtype)
    nat8_w = qt.q4_layout == 4
    g = qt.k // qt.scale.shape[0]
    assert (g, qt.bias is not None) == {
        "Q4_1": (32, True), "Q5_0": (32, False), "Q5_1": (32, True),
        "Q8_1": (32, False), "Q5_K": (32, True), "Q6_K": (16, False)}[fmt]
    x = torch.randn(m, 512, generator=gen, device="cuda")
    name = ("nat8_w8a8" if nat8_w else "w4a8_gemv") if m == 1 else \
        ("nat8_w8a16" if nat8_w else "w4a16_gemm")
    _build.reset_launches()
    got = (qmm.qmatmul_nat8 if nat8_w else qmm.qmatmul_natpair)(x, qt)
    assert {k: c for k, c in _build.LAUNCHES.items() if c} == {name: 1}
    if m == 1:
        x8, dx = qmm.quantize_activations_q8(x, g)
        xs = None if qt.bias is None else dx[:, 0] * x8[:, 0].float().sum(-1)
        plain = qmm.nat8_w8a8_gemv_plain if nat8_w else qmm.w4a8_gemv_plain
        ref = plain(x8[:, 0], dx[:, 0], qt, xs)[None]
    else:
        ref = qmm.a16_gemm_plain(x, qt)
    assert rel(got, ref) < 1e-4
    _build.reset_launches()


def use_more_bits(layer: int, n_layer: int) -> bool:
    """llama.cpp's use_more_bits (llama_tensor_get_type, mid-2024)."""
    return (layer < n_layer // 8 or layer >= 7 * n_layer // 8
            or (layer - n_layer // 8) % 3 == 2)


def q4_k_m_types(n_layer):
    """types(name, layer) of llama.cpp's Q4_K_M mix, as chip_smoke.py
    phase 9b draws it: `output` Q6_K, v_w and down_w Q6_K where
    use_more_bits, every other weight Q4_K."""
    def types(name, layer):
        if name == "output" or (name in ("v_w", "down_w")
                                and use_more_bits(layer, n_layer)):
            return GGMLType.Q6_K
        return GGMLType.Q4_K
    return types


def small_q4km_llama(dev):
    """The small LLaMA of small_llama in the Q4_K_M mix (at 2 layers
    use_more_bits picks layer 1: its v_w and down_w Q6_K, and the head),
    host-quantized, prepared by fuse_gate_up alone, repacked with bf16
    scales as phase 9b does, moved to `dev`."""
    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.quant.device import quantize_for_device
    cfg = llama.LlamaConfig(**SMALL_LLAMA)
    rng = np.random.default_rng(5)
    types = q4_k_m_types(cfg.n_layer)
    E, F, kv = cfg.n_embd, cfg.n_ff, cfg.n_head_kv * cfg.head_dim

    def q(name, layer, k, n):
        w = (rng.standard_normal((k, n)) * 0.08).astype(np.float32)
        return quantize_for_device(w, types(name, layer), device="cpu")

    def norm(n):
        return torch.from_numpy((1 + 0.1 * rng.standard_normal(n))
                                .astype(np.float32))

    p = {"tok_embd": q("tok_embd", None, E, cfg.n_vocab), "out_norm": norm(E),
         "output": q("output", None, E, cfg.n_vocab), "layers": []}
    for li in range(cfg.n_layer):
        p["layers"].append({
            "attn_norm": norm(E), "q_w": q("q_w", li, E, E),
            "k_w": q("k_w", li, E, kv), "v_w": q("v_w", li, E, kv),
            "o_w": q("o_w", li, E, E), "ffn_norm": norm(E),
            "gate_w": q("gate_w", li, E, F), "up_w": q("up_w", li, E, F),
            "down_w": q("down_w", li, F, E)})
    with pytest.raises(ValueError, match="fuse_gate_up alone"):
        llama.prepare_fused(p)
    p = llama.fuse_gate_up(p, pad_multiple=1024)
    return cfg, moved(qmm.params_repack(p, scale_dtype=torch.bfloat16), dev)


def test_small_q4km_llama_launch_counts(gen):
    """Phase 9b's launch arithmetic at 2 layers, one mixed: a decode step
    runs 6 L - 2 m Q4_K products on W4A8 and 2 m + 1 Q6_K ones (v_w,
    down_w, the head) on nat8 W8A8 (L 2, m 1: 10 and 3; L 32, m 16: 160
    and 33), a prefill the same on W4A16 and W8A16. Logits within 3.5% of
    the largest |logit| of the CPU run (chip_smoke's ROUTE_TOL, as
    test_small_llama_on_card_matches_cpu)."""
    from ggml_imax_tpu_torch.models import llama
    prompt = np.random.default_rng(1).integers(0, 512, 24)
    outs = {}
    for dev in ("cuda", "cpu"):
        cfg, p = small_q4km_llama(dev)
        cache = llama.init_cache(cfg, device=dev)
        _build.reset_launches()
        lg, cache = llama.forward(cfg, p, torch.as_tensor(prompt[None],
                                                          device=dev),
                                  torch.arange(24, device=dev)[None], cache, 0)
        steps = [lg.cpu()]
        for i, tok in enumerate((7, 300)):
            lg, cache = llama.forward(cfg, p, torch.tensor([[tok]], device=dev),
                                      torch.tensor([[24 + i]], device=dev),
                                      cache, 24 + i)
            steps.append(lg.cpu())
        if dev == "cuda":
            counts = {k: n for k, n in _build.LAUNCHES.items() if n}
        outs[dev] = steps
    L, m = 2, 1
    assert counts == {"w4a16_gemm": 6 * L - 2 * m, "nat8_w8a16": 2 * m + 1,
                      "flash_attention": L, "flash_backward_tiles": L,
                      "w4a8_gemv": 2 * (6 * L - 2 * m),
                      "nat8_w8a8": 2 * (2 * m + 1), "decode_attention": 2 * L}
    limit = 3.5e-2 * max(float(b.abs().max()) for b in outs["cpu"])
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) < limit
    _build.reset_launches()


# ---- the IQ formats: IQ4 on the nat8 kernels, the codebook layouts' plain
# route, the bf16 residency

def iq4_nat8(K, N, gen, levels=None):
    """An IQ4_XS weight as quant.device lays it out and params_repack tags
    it: int8 values of KVALUES_IQ4NL (uniform, or all `levels`), per-32
    f32 scales, no bias, nat8."""
    from ggml_imax_tpu_torch.quant.codecs import KVALUES_IQ4NL
    table = torch.from_numpy(KVALUES_IQ4NL).cuda()
    idx = torch.randint(0, 16, (K * N,), dtype=torch.int32, generator=gen,
                        device="cuda")
    q = table.index_select(0, idx).reshape(K, N)
    if levels is not None:
        q.fill_(levels)
    s = torch.rand((K // 32, N), generator=gen, device="cuda") * 0.01
    return qmm.repack_nat8(QTensor("int8", q, s, None, K, N, GGMLType.IQ4_XS),
                           512 if K % 512 == 0 else K)


@pytest.mark.parametrize("levels", [-127, 113])
def test_nat8_on_iq4_levels_at_their_extremes(gen, levels):
    """Every IQ4 weight at the table's ends (-127, 113) against Q8_0
    activations of +-127: the int32 dots' largest IQ4 magnitudes
    (32 x 127 x 127), W8A8 exact within rel 1e-5 and W8A16 within 1e-4 of
    the plain versions."""
    qt = iq4_nat8(4096, 4096, gen, levels)
    x = torch.randn(1, 4096, generator=gen, device="cuda").sign() * 3.0
    x8, _ = qmm.quantize_activations_q8(x, 32)
    assert int(x8.abs().min()) == 127
    check_w8a8(qt, x)
    check_nat8(qt, x.repeat(8, 1))


# LLaMA-2 7B IQ4_XS's fused products (chip_smoke phase 9c): qkv_w, o_w,
# gu_w (11008 padded to 11264, twice) and down_w
IQ4_SHAPES = [(4096, 12288), (4096, 4096), (4096, 22528), (11264, 4096)]


@pytest.mark.parametrize("m", [1, 8, 100])
@pytest.mark.parametrize("k,n", IQ4_SHAPES)
def test_nat8_on_iq4_weights_at_llama_shapes(gen, k, n, m):
    qt = iq4_nat8(k, n, gen)
    x = torch.randn(m, k, generator=gen, device="cuda")
    if m == 1:
        check_w8a8(qt, x)
    else:
        check_nat8(qt, x)


CODEBOOK = ["IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S"]


@pytest.mark.parametrize("fmt", CODEBOOK)
def test_codebook_dequantize_and_get_rows_on_card_match_cpu(gen, fmt):
    """The nib2 and lut layouts expanded on the card (dequantize, get_rows,
    the qmatmul plain route) equal the same on the CPU bit for bit (the
    matmul within rel 1e-5: its sums run in another order); no kernel is
    launched."""
    from ggml_imax_tpu_torch.ops import embedding, qmatmul
    from ggml_imax_tpu_torch.quant import codecs, device
    t = GGMLType[fmt]
    raw = codecs.random_blocks(t, 768 * 1000 // 256,
                               np.random.default_rng(1), 1e-3)
    cpu = device.to_device_format(raw, t, (768, 1000), device="cpu")
    card = device.to_device_format(raw, t, (768, 1000), device="cuda")
    assert card.q.is_cuda and card.lut.is_cuda
    assert (card.signs is not None) == (cpu.kind == "nib2")
    ids = torch.tensor([[0, 999, 5, 5], [17, 640, 128, 1]])
    _build.reset_launches()
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(qmatmul.dequantize(card, dt).cpu(),
                           qmatmul.dequantize(cpu, dt))
        assert torch.equal(embedding.get_rows(card, ids.cuda(), dt).cpu(),
                           embedding.get_rows(cpu, ids, dt))
    x = torch.randn(3, 768)
    got = qmatmul.qmatmul(x.cuda(), card, out_dtype=torch.float32).cpu()
    assert rel(got, qmatmul.qmatmul(x, cpu, out_dtype=torch.float32)) < 1e-5
    assert not any(_build.LAUNCHES.values())


def iq4_xs_types(name, layer):
    """llama.cpp's LLAMA_FTYPE_MOSTLY_IQ4_XS mix without an importance
    matrix (llama_tensor_get_type; chip_smoke phase 9c): `output` Q6_K,
    every other 2-D weight IQ4_XS."""
    return GGMLType.Q6_K if name == "output" else GGMLType.IQ4_XS


def small_iq4xs_llama(dev, fuse=True):
    """The small LLaMA of small_llama in the IQ4_XS mix, host-quantized
    (the port's IQ4_XS codec), prepare_fused (IQ4 q/k/v fuse) and
    repacked (IQ4_XS nat8 g 32 f32, the Q6_K head nat8 g 16), moved to
    `dev`; fuse False: the raw weights."""
    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.quant.device import quantize_for_device
    cfg = llama.LlamaConfig(**SMALL_LLAMA)
    rng = np.random.default_rng(5)
    E, F, kv = cfg.n_embd, cfg.n_ff, cfg.n_head_kv * cfg.head_dim

    def q(name, k, n):
        w = (rng.standard_normal((k, n)) * 0.08).astype(np.float32)
        return quantize_for_device(w, iq4_xs_types(name, None), device="cpu")

    def norm(n):
        return torch.from_numpy((1 + 0.1 * rng.standard_normal(n))
                                .astype(np.float32))

    p = {"tok_embd": q("tok_embd", E, cfg.n_vocab), "out_norm": norm(E),
         "output": q("output", E, cfg.n_vocab), "layers": []}
    for _ in range(cfg.n_layer):
        p["layers"].append({
            "attn_norm": norm(E), "q_w": q("q_w", E, E), "k_w": q("k_w", E, kv),
            "v_w": q("v_w", E, kv), "o_w": q("o_w", E, E),
            "ffn_norm": norm(E), "gate_w": q("gate_w", E, F),
            "up_w": q("up_w", E, F), "down_w": q("down_w", F, E)})
    if fuse:
        p = qmm.params_repack(llama.fuse_gate_up(llama.fuse_qkv(p),
                                                 pad_multiple=1024))
    return cfg, moved(p, dev)


def run_small_llama(cfg, p, dev, engine=None):
    """A 24-token prefill and two decode steps (the model's forward, or
    engine's prefill / decode_step): logits, and the card's launches."""
    from ggml_imax_tpu_torch.models import llama
    prompt = np.random.default_rng(1).integers(0, 512, 24)
    _build.reset_launches()
    if engine is not None:
        cache = engine.new_cache()
        lg, cache = engine.prefill(cache, prompt[None])
        steps = [torch.from_numpy(lg)]
        for i, tok in enumerate((7, 300)):
            lg, cache = engine.decode_step(cache, np.array([tok]), 24 + i)
            steps.append(torch.from_numpy(lg))
    else:
        cache = llama.init_cache(cfg, device=dev)
        lg, cache = llama.forward(cfg, p, torch.as_tensor(prompt[None],
                                                          device=dev),
                                  torch.arange(24, device=dev)[None], cache, 0)
        steps = [lg[0, -1:].cpu()]
        for i, tok in enumerate((7, 300)):
            lg, cache = llama.forward(cfg, p, torch.tensor([[tok]], device=dev),
                                      torch.tensor([[24 + i]], device=dev),
                                      cache, 24 + i)
            steps.append(lg[0].cpu())
    counts = {k: n for k, n in _build.LAUNCHES.items() if n}
    _build.reset_launches()
    return steps, counts


def test_small_iq4xs_llama_launch_counts(gen):
    """Phase 9c's launch arithmetic at 2 layers: a decode step runs 4 L + 1
    products on nat8 W8A8 (qkv_w, o_w, gu_w, down_w, the Q6_K head), a
    prefill the same on W8A16, no W4A8 / W4A16. Logits within 3.5% of the
    largest |logit| of the CPU run (chip_smoke's ROUTE_TOL, as
    test_small_llama_on_card_matches_cpu)."""
    outs, counts = {}, {}
    for dev in ("cuda", "cpu"):
        cfg, p = small_iq4xs_llama(dev)
        outs[dev], counts[dev] = run_small_llama(cfg, p, dev)
    L = 2
    assert counts["cuda"] == {"nat8_w8a16": 4 * L + 1, "nat8_w8a8":
                              2 * (4 * L + 1), "flash_attention": L,
                              "flash_backward_tiles": L,
                              "decode_attention": 2 * L}
    limit = 3.5e-2 * max(float(b.abs().max()) for b in outs["cpu"])
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) < limit


def test_engine_bf16_residency_on_card_matches_cpu(gen):
    """Engine(residency="bf16") dequantizes the IQ4_XS mix on the card into
    dense bf16 weights equal bit for bit to the CPU's; its prefill and two
    decode steps launch no product kernel (the dense plain route) and agree
    with the CPU's within 3.5% of the largest |logit|. Dropped, it frees
    its weights."""
    import gc

    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.runtime.engine import Engine
    outs, engs = {}, {}
    base = torch.cuda.memory_allocated()
    for dev in ("cuda", "cpu"):
        cfg, p = small_iq4xs_llama(dev, fuse=False)
        engs[dev] = Engine(llama, cfg, p, residency="bf16", device=dev,
                           n_ctx=64)
        del p
        outs[dev], counts = run_small_llama(cfg, None, dev, engs[dev])
        if dev == "cuda":
            card_counts = counts
            held = torch.cuda.memory_allocated() - base
    w_card = engs["cuda"].params["layers"][1]["gate_w"]
    assert w_card.kind == "dense" and w_card.q.dtype == torch.bfloat16
    assert torch.equal(w_card.q.cpu(), engs["cpu"].params["layers"][1]
                       ["gate_w"].q)
    assert set(card_counts) <= {"flash_attention", "flash_backward_tiles",
                                "decode_attention"}
    limit = 3.5e-2 * max(float(b.abs().max()) for b in outs["cpu"])
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) < limit
    assert held > 0
    del engs["cuda"], w_card
    gc.collect()
    assert torch.cuda.memory_allocated() - base < held // 2


# ---- Whisper (models/whisper.py, runtime/whisper_pipeline.py) ----

@pytest.mark.parametrize("b,tq,tk,h", [(1, 1500, 1500, 12), (1, 1500, 1500, 16),
                                       (5, 4, 1500, 12), (2, 75, 150, 2)])
def test_flash_without_a_mask_at_ragged_key_counts(gen, b, tq, tk, h):
    """Whisper's encoder (Tq = Tk = 1500, padded keys 1536) and the beam
    prompt's cross-attention: no mask, so no tile map; the padded keys add
    nothing to a row that sees a key."""
    q = torch.randn(b, tq, h, 64, generator=gen, device="cuda")
    k, v = (torch.randn(b, tk, h, 64, generator=gen, device="cuda")
            for _ in range(2))
    args = fa._prep(q, k, v, None, 0.0) + (0.125, 0.0, True)
    before = dict(_build.LAUNCHES)
    out = fa.flash_attention(q, k, v, None, out_dtype=torch.float32)
    assert _build.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert _build.LAUNCHES["flash_backward_tiles"] == \
        before["flash_backward_tiles"]
    got, got_lse = fa.flash_attention_kernel(*args)
    ref, ref_lse = fa.flash_attention_plain(*args)
    assert torch.equal(out, got)
    assert rel(got, ref) < 1e-2
    assert rel(got_lse, ref_lse) < 1e-4


@pytest.mark.parametrize("k,n,m", [(768, 3072, 1500), (768, 2304, 20),
                                   (768, 2304, 5), (768, 51968, 1),
                                   (1024, 4096, 1500), (4096, 1024, 1)])
def test_whisper_q5_0_products_match_plain(gen, k, n, m):
    """Q5_0 levels in [-16, 15], per-32 f32 scales, no bias, nat8: W8A16 at
    M 1500 (the encoder), 20 (the beam prompt) and 5 (a beam step), W8A8 at
    M 1 (a greedy step; the padded head)."""
    from ggml_imax_tpu_torch.ops.qmatmul import qmatmul
    q = torch.randint(-16, 16, (k, n), dtype=torch.int8, generator=gen,
                      device="cuda")
    s = torch.randn((k // 32, n), generator=gen, device="cuda").abs() * 0.002
    qt = qmm.repack_nat8(QTensor("int8", q, s, None, k, n, GGMLType.Q5_0),
                         256)
    x = torch.randn(m, k, generator=gen, device="cuda")
    name = "nat8_w8a8" if m == 1 else "nat8_w8a16"
    before = _build.LAUNCHES[name]
    got = qmatmul(x, qt, out_dtype=torch.float32)
    assert _build.LAUNCHES[name] == before + 1
    if m == 1:
        x8, dx = qmm.quantize_activations_q8(x)
        ref = qmm.nat8_w8a8_gemv_plain(x8[:, 0], dx[:, 0], qt)[None]
        assert rel(got, ref) < 1e-5
    else:
        assert rel(got, qmm.nat8_w8a16_gemm_plain(x, qt)) < 1e-3


@pytest.mark.parametrize("cin,stride", [(80, 1), (768, 2)])
def test_conv_1d_on_card_is_f32(gen, cin, stride):
    """conv_1d turns cuDNN's TF32 off for its call: within 1e-5 of f64."""
    from ggml_imax_tpu_torch.ops.conv import conv_1d
    x = torch.randn(1, cin, 3000, generator=gen, device="cuda")
    w = torch.randn(768, cin, 3, generator=gen, device="cuda") * 0.05
    ref = torch.nn.functional.conv1d(x.double(), w.double(), stride=stride,
                                     padding=1)
    flag = torch.backends.cudnn.allow_tf32
    assert rel(conv_1d(x, w, stride, 1), ref) < 1e-5
    assert torch.backends.cudnn.allow_tf32 == flag


def test_log_mel_on_card_matches_cpu(gen):
    from ggml_imax_tpu_torch.audio.mel import log_mel_spectrogram
    t = np.arange(40000) / 16000.0
    x = (0.3 * np.sin(2 * np.pi * 440 * t)
         + 0.01 * np.random.default_rng(0).standard_normal(40000)) \
        .astype(np.float32)
    got = log_mel_spectrogram(x)
    assert got.device.type == "cuda"
    ref = log_mel_spectrogram(x, device="cpu")
    assert float((got.cpu() - ref).abs().max()) < 1e-4


def _small_whisper(device, pad=True):
    from ggml_imax_tpu_torch.models import whisper as W
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    from ggml_imax_tpu_torch.quant.device import pad_qtensor_cols
    cfg = W.WhisperConfig(n_vocab=1000, n_audio_ctx=150, n_audio_state=128,
                          n_audio_head=2, n_audio_layer=2, n_text_ctx=32,
                          n_text_state=128, n_text_head=2, n_text_layer=2,
                          n_mels=16)
    raw = W.synthetic_params_device(cfg, seed=5, device="cpu")
    if pad:
        raw["d_te"] = pad_qtensor_cols(raw["d_te"], 128)[0]
    p = params_repack(W.prepare_fused(raw))
    if device == "cuda":
        p = _moved(p)
    return cfg, p


def _moved(p):
    if isinstance(p, dict):
        return {k: _moved(v) for k, v in p.items()}
    if isinstance(p, list):
        return [_moved(v) for v in p]
    if isinstance(p, QTensor):
        opt = lambda t: None if t is None else t.cuda()
        return replace(p, q=p.q.cuda(), scale=opt(p.scale), bias=opt(p.bias))
    return p.cuda()


@pytest.mark.parametrize("pad", [True, False])
def test_small_whisper_on_card_matches_cpu(gen, pad):
    """Encode, cross K/V, a 2-token prompt (ids past the table) and 4 fed
    steps on the card (kernels) against the CPU (plain versions), within
    5e-2 of the largest |logit|, with the card's exact launch counts."""
    from ggml_imax_tpu_torch.models import whisper as W
    mel = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 16, 300)).astype(np.float32))
    feed = [17, 400, 999, 3]
    out, counts = {}, {}
    for dev in ("cuda", "cpu"):
        cfg, p = _small_whisper(dev, pad)
        _build.reset_launches()
        cross = W.precompute_cross_kv(cfg, p, W.encode(cfg, p, mel.to(dev)))
        cache = W.init_cache(cfg, device=dev)
        lg, cache = W.decode(cfg, p, torch.tensor([[50257, 50362]], device=dev),
                             torch.arange(2, device=dev)[None], cache, cross, 0)
        logs = [lg[0].float().cpu()]
        for i, t in enumerate(feed):
            lg, cache = W.decode(cfg, p, torch.tensor([[t]], device=dev),
                                 torch.tensor([[2 + i]], device=dev), cache,
                                 cross, 2 + i)
            logs.append(lg[0].float().cpu())
        out[dev], counts[dev] = logs, dict(_build.LAUNCHES)
    scale = max(float(a.abs().max()) for a in out["cpu"])
    err = max(float((a - b).abs().max()) for a, b in zip(out["cuda"], out["cpu"]))
    assert all(a.shape[-1] == 1000 for a in out["cuda"])
    assert err < 5e-2 * scale, (err, scale)
    h = int(pad)
    want = {"nat8_w8a16": 16 + 12 + h, "flash_attention": 2 + 4,
            "flash_backward_tiles": 2, "nat8_w8a8": 4 * (12 + h)}
    assert {k: n for k, n in counts["cuda"].items() if n} == want


def test_whisper_beam_top_k_orders_ties_by_index(gen):
    from ggml_imax_tpu_torch.runtime.whisper_pipeline import (
        top_k_lower_index_first)
    x = torch.round(torch.randn(5, 51865, generator=gen, device="cuda") * 2) / 2
    x[:, 50258:] = float("-inf")
    vals, idx = top_k_lower_index_first(x, 10)
    rv, ri = top_k_lower_index_first(x.cpu(), 10)
    assert torch.equal(idx.cpu(), ri) and torch.equal(vals.cpu(), rv)


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
def test_select_batch_on_card_gathers_fresh_rows(gen, kv):
    cache = init_kv_cache(2, 5, 16, 2, 64, kv, device="cuda")
    for li in range(2):
        update_kv(cache, li, torch.randn(5, 4, 2, 64, generator=gen,
                                         device="cuda"),
                  torch.randn(5, 4, 2, 64, generator=gen, device="cuda"), 0)
    idx = torch.tensor([3, 3, 0, 1, 4], device="cuda")
    new = cache.select_batch(idx)
    assert torch.equal(new.k, cache.k[:, idx])
    assert new.k.data_ptr() != cache.k.data_ptr()
    old = cache.k.clone()
    update_kv(new, 0, torch.ones(5, 1, 2, 64, device="cuda"),
              torch.ones(5, 1, 2, 64, device="cuda"), 4)
    assert torch.equal(cache.k, old)


# ---- the runtime layer's captured and resident routes ----

def test_whisper_captured_pipeline_equals_eager_on_card(gen):
    """The small Whisper's transcribe through the captured steps (beam 5,
    and a sampled fallback step at one row) against the eager route on the
    card: equal tokens, temperatures and avg_logprob, and the KV cache of
    every attempt equal bit for bit; the steps were replayed, and the
    launch counts of the two routes are equal."""
    from ggml_imax_tpu_torch.audio.mel import mel_filterbank
    from ggml_imax_tpu_torch.runtime.whisper_pipeline import (
        FullParams, WhisperPipeline)
    cfg, p = _small_whisper("cuda", pad=True)
    rng = np.random.default_rng(4)
    samples = (rng.standard_normal(45 * 16000) * 0.1).astype(np.float32)
    fp = FullParams(beam_size=5, max_tokens=10, logprob_thold=0.0,
                    temperatures=(0.0, 0.4))
    runs = {}
    for graphs in (False, True):
        pipe = WhisperPipeline(cfg, p, mel_filterbank(cfg.n_mels),
                               graphs=graphs)
        caches = []
        real = pipe._run_beam

        def run_beam(*a, _real=real, _pipe=pipe, _caches=caches, **kw):
            out = _real(*a, **kw)
            c = _pipe.last_cache
            _caches.append([t.clone() for t in (c.k, c.v)])
            return out
        pipe._run_beam = run_beam
        pipe.transcribe(samples[:16000], fp)              # warm-up, capture
        caches.clear()
        _build.reset_launches()
        segs = pipe.transcribe(samples, fp)
        torch.cuda.synchronize()
        runs[graphs] = (segs, caches, dict(_build.LAUNCHES), pipe)
    (se, ce, ne, _), (sc, cc, nc, pipe) = runs[False], runs[True]
    assert [(s.tokens, s.temperature, s.avg_logprob) for s in sc] == \
        [(s.tokens, s.temperature, s.avg_logprob) for s in se]
    assert len(cc) == len(ce) >= 4
    assert all(torch.equal(a, b) for x, y in zip(cc, ce) for a, b in zip(x, y))
    assert nc == ne and nc["nat8_w8a16"] > 0 and nc["nat8_w8a8"] > 0
    assert {k for k in pipe._static} == {(5, 10), (1, 0)}
    assert all(st.run.graph is not None for st in pipe._static.values())


def test_whisper_timestamps_on_card_match_cpu(gen):
    """token_timestamps of the small Whisper on the card against the CPU
    (plain versions): the alignment weights within 1e-3 of each other, the
    times monotone and within 10 audio columns (0.2 s) of the CPU's."""
    from ggml_imax_tpu_torch.models import whisper as W
    from ggml_imax_tpu_torch.runtime.whisper_pipeline import (
        WhisperPipeline, alignment_weights, token_timestamps)
    mel = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 16, 300)).astype(np.float32))
    toks = [50257, 50362] + list(range(100, 140, 3))
    out = {}
    for dev in ("cuda", "cpu"):
        cfg, p = _small_whisper(dev)
        pipe = WhisperPipeline(cfg, p, device=dev)
        cross = W.precompute_cross_kv(cfg, p, W.encode(cfg, p, mel.to(dev)))
        out[dev] = (alignment_weights(pipe, cross, toks),
                    token_timestamps(pipe, cross, toks))
    (wc, tc), (wh, th) = out["cuda"], out["cpu"]
    assert wc.shape == wh.shape == (2, len(toks), 150)
    assert float(np.abs(wc - wh).max()) < 1e-3
    assert (np.diff(tc) >= 0).all() and len(tc) == len(toks)
    assert float(np.abs(tc - th).max()) <= 10 * 0.02


@pytest.mark.parametrize("residency", ["q4-fused", "q4-stacked"])
def test_engine_residency_on_card(gen, residency):
    """Engine(residency) from the unprepared small GPT-J on the card: the
    same greedy tokens as the engine on prepare_fused + params_repack with
    the same route, and the decode attention that residency takes (the
    fused KV update for q4-stacked) in every decode step."""
    from ggml_imax_tpu_torch.runtime.engine import Engine
    cfg = gptj.GPTJConfig(**SMALL_GPTJ)
    raw = gptj.synthetic_params(cfg, seed=5, device="cuda")
    fused = residency == "q4-stacked"
    prompt = list(np.random.default_rng(2).integers(0, 512, 40))
    ref = Engine(gptj, cfg, qmm.params_repack(gptj.prepare_fused(raw, cfg)),
                 fused_kv_update=fused).generate(prompt, 9, temp=0)
    eng = Engine(gptj, cfg, raw, residency=residency)
    assert eng.fused_kv_update == fused
    _build.reset_launches()
    got = eng.generate(prompt, 9, temp=0)
    assert got == ref
    L = cfg.n_layer
    route = "decode_attention_update" if fused else "decode_attention"
    other = "decode_attention" if fused else "decode_attention_update"
    assert _build.LAUNCHES[route] == 8 * L and _build.LAUNCHES[other] == 0


# ---- the loaders: files written by the port's writers, loaded on the card

def _small_files(tmp_path):
    """A small GPT-J Q4_0 .bin (SMALL_GPTJ) and a small LLaMA GGUF in the
    Q4_K_M mix (2 layers, the second mixed: Q6_K attn_v and ffn_down, Q6_K
    output), weights N(0, 0.08) quantized by the port's codecs, written by
    the port's writers. Returns (the .bin's path, the GGUF's path)."""
    from ggml_imax_tpu_torch.io.gguf import GGUFWriter
    from ggml_imax_tpu_torch.io.legacy_bin import write_legacy_bin
    from ggml_imax_tpu_torch.quant import codecs
    from ggml_imax_tpu_torch.tokenizer.bpe import bytes_to_unicode
    rng = np.random.default_rng(7)

    def enc(t, ne):
        x = (rng.standard_normal((int(np.prod(ne[1:])), ne[0])) * 0.08) \
            .astype(np.float32)
        if len(ne) == 1:
            x = x + 1.0
        return t, tuple(ne), codecs.quantize(x, t)

    T = GGMLType
    c = SMALL_GPTJ
    E, V = c["n_embd"], c["n_vocab"]
    tensors = {"transformer.wte.weight": enc(T.Q4_0, (E, V)),
               "transformer.ln_f.weight": enc(T.F32, (E,)),
               "transformer.ln_f.bias": enc(T.F32, (E,)),
               "lm_head.weight": enc(T.Q4_0, (E, V)),
               "lm_head.bias": enc(T.F32, (V,))}
    for i in range(c["n_layer"]):
        p = f"transformer.h.{i}"
        for n, ne in (("ln_1.weight", (E,)), ("ln_1.bias", (E,)),
                      ("attn.q_proj.weight", (E, E)),
                      ("attn.k_proj.weight", (E, E)),
                      ("attn.v_proj.weight", (E, E)),
                      ("attn.out_proj.weight", (E, E)),
                      ("mlp.fc_in.weight", (E, 4 * E)),
                      ("mlp.fc_in.bias", (4 * E,)),
                      ("mlp.fc_out.weight", (4 * E, E)),
                      ("mlp.fc_out.bias", (E,))):
            tensors[f"{p}.{n}"] = enc(T.Q4_0 if len(ne) == 2 else T.F32, ne)
    vocab = [bytes([b]) for b in range(0x20, 0x7F)] + \
        [f"w{i}".encode() for i in range(V - 95)]
    bin_path = tmp_path / "small-gptj.bin"
    write_legacy_bin(bin_path, dict(c, ftype=2002), gptj.HPARAM_NAMES, vocab,
                     tensors)

    b2u = bytes_to_unicode()
    tokens, merges = [b2u[b] for b in range(256)], []
    for word in ("the", "river", "and", "quick"):
        piece = word[0]
        for ch in word[1:]:
            merges.append(f"{piece} {ch}")
            piece += ch
            tokens.append(piece)
    tokens += [f"<unused{i}>" for i in range(512 - len(tokens))]
    E, F, kv = 256, 512, 128
    w = GGUFWriter(tmp_path / "small-llama.gguf")
    w.add_kv("general.architecture", "llama")
    for k, v in (("context_length", 256), ("embedding_length", E),
                 ("block_count", 2), ("feed_forward_length", F),
                 ("attention.head_count", 2), ("attention.head_count_kv", 1)):
        w.add_kv(f"llama.{k}", np.uint32(v))
    w.add_kv("tokenizer.ggml.tokens", tokens)
    w.add_kv("tokenizer.ggml.merges", merges)
    for name, ne, t in (("token_embd", (E, 512), T.Q4_K),
                        ("output_norm", (E,), T.F32),
                        ("output", (E, 512), T.Q6_K)):
        w.add_tensor(f"{name}.weight", enc(t, ne)[2], t, shape=ne)
    for i in range(2):
        more = T.Q6_K if i else T.Q4_K
        for name, ne, t in (("attn_norm", (E,), T.F32),
                            ("attn_q", (E, E), T.Q4_K),
                            ("attn_k", (E, kv), T.Q4_K),
                            ("attn_v", (E, kv), more),
                            ("attn_output", (E, E), T.Q4_K),
                            ("ffn_norm", (E,), T.F32),
                            ("ffn_gate", (E, F), T.Q4_K),
                            ("ffn_up", (E, F), T.Q4_K),
                            ("ffn_down", (F, E), more)):
            w.add_tensor(f"blk.{i}.{name}.weight", enc(t, ne)[2], t, shape=ne)
    w.write()
    return bin_path, tmp_path / "small-llama.gguf"


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, QTensor):
        return [t for t in (tree.q, tree.scale, tree.bias, tree.lut,
                            tree.signs) if t is not None]
    return [] if tree is None else [tree]


def test_loaders_on_card_match_the_cpu_load(gen, tmp_path):
    """gptj.load_legacy and llama.load_gguf with device="cuda": every
    tensor on the card, bit-equal to the same file loaded on the CPU; the
    configs and tokenizers equal; no kernel launched."""
    from ggml_imax_tpu_torch.models import llama
    bin_path, gguf_path = _small_files(tmp_path)
    _build.reset_launches()
    for load, path in ((gptj.load_legacy, bin_path),
                       (llama.load_gguf, gguf_path)):
        cfg_c, card, tok_c = load(path, device="cuda")
        cfg_h, host, tok_h = load(path, device="cpu")
        assert cfg_c == cfg_h
        assert tok_c.id_to_token == tok_h.id_to_token
        a, b = _leaves(card), _leaves(host)
        assert len(a) == len(b) > 20
        for x, y in zip(a, b):
            assert x.is_cuda and not y.is_cuda and x.dtype == y.dtype
            assert torch.equal(x.cpu(), y)
    assert not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("model", ["gptj", "llama"])
def test_loaded_engine_greedy_on_card_matches_cpu(gen, tmp_path, model):
    """The loaded small model through Engine on the card (GPT-J:
    residency="q4-fused"; the LLaMA Q4_K_M mix: fuse_gate_up +
    params_repack, as chip_smoke phase 11b) takes 12 greedy tokens with
    the kernels; the same file loaded on the CPU, teacher-forced on those
    tokens, gives logits within GPT-J's 5e-2 (check_small_models) or 3.5%
    of the largest |logit| (the small LLaMA's ROUTE_TOL) of the card's
    forward fed the same, and its picks equal the card's wherever its top-2
    margin exceeds twice that limit."""
    from ggml_imax_tpu_torch.models import llama
    from ggml_imax_tpu_torch.runtime.engine import Engine
    bin_path, gguf_path = _small_files(tmp_path)
    mod = gptj if model == "gptj" else llama
    runs = {}
    for dev in ("cuda", "cpu"):
        if model == "gptj":
            cfg, raw, tok = gptj.load_legacy(bin_path, device=dev)
            params = qmm.params_repack(gptj.prepare_fused(raw, cfg))
        else:
            cfg, raw, tok = llama.load_gguf(gguf_path, device=dev)
            params = qmm.params_repack(llama.fuse_gate_up(raw))
        runs[dev] = (cfg, params, raw)
    prompt = tok.encode("the river and the quick w1 w2 w3 w9")
    cfg, params, raw = runs["cuda"]
    eng = Engine(gptj, cfg, raw, residency="q4-fused") if model == "gptj" \
        else Engine(llama, cfg, params)
    _build.reset_launches()
    toks = eng.generate(prompt, 12, temp=0)
    assert _build.LAUNCHES["w4a8_gemv"] > 0
    assert _build.LAUNCHES["w4a16_gemm"] > 0
    logits = {}
    for dev, (cfg, params, _) in runs.items():
        cache = mod.init_cache(cfg, n_ctx=128, device=dev)
        n = len(prompt)
        lg, cache = mod.forward(cfg, params, torch.tensor([prompt], device=dev),
                                torch.arange(n, device=dev)[None], cache, 0)
        out = [lg[0, -1].float().cpu()]
        for i, t in enumerate(toks[:-1]):
            lg, cache = mod.forward(cfg, params, torch.tensor([[t]], device=dev),
                                    torch.tensor([[n + i]], device=dev), cache,
                                    n + i)
            out.append(lg[0, -1].float().cpu())
        logits[dev] = out
    scale = max(float(x.abs().max()) for x in logits["cpu"])
    limit = 5e-2 if model == "gptj" else 3.5e-2 * scale
    for c, h, t in zip(logits["cuda"], logits["cpu"], toks):
        assert bool(torch.isfinite(c).all())
        assert float((c - h).abs().max()) <= limit
        top2 = torch.topk(h, 2).values
        if float(top2[0] - top2[1]) > 2 * limit:
            assert int(h.argmax()) == t
    _build.reset_launches()
