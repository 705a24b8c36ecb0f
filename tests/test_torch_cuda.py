"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card (marker ``cuda``; they skip without an NVIDIA GPU). Run them
on a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The kernels are built from ggml_imax_tpu_torch/csrc at first use.
"""
import math

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


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [False, True])
def test_w4a8_kernel_matches_plain(gen, scale_dtype, bias):
    qt = natpair(2048, 1280, gen, scale_dtype, bias)
    x = torch.randn(1, 2048, generator=gen, device="cuda")
    before = _build.LAUNCHES["w4a8_gemv"]
    got = qmm.qmatmul_natpair(x, qt)
    assert _build.LAUNCHES["w4a8_gemv"] == before + 1
    x8, dx = qmm.quantize_activations_q8(x)
    xs = dx[:, 0] * x8[:, 0].float().sum(-1)
    ref = qmm.w4a8_gemv_plain(x8[:, 0], dx[:, 0], qt, xs)
    assert rel(got[0], ref) < 1e-5


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


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_decode_attention_kernel_matches_plain(gen, kv, hq, hkv):
    L, B, T, D = 2, 2, 384, 128
    cache = init_kv_cache(L, B, T, hkv, D, kv, device="cuda")
    k = torch.randn(B, 300, hkv, D, generator=gen, device="cuda")
    v = torch.randn(B, 300, hkv, D, generator=gen, device="cuda")
    update_kv(cache, 1, k, v, 0)
    q = torch.randn(B, hq, D, generator=gen, device="cuda")
    mask = torch.zeros(B, T, device="cuda")
    mask[:, 300:] = da.NEG
    args = (q, cache.k[1], cache.v[1],
            None if cache.ks is None else cache.ks[1],
            None if cache.vs is None else cache.vs[1], mask, hkv,
            1 / math.sqrt(D))
    assert rel(da.decode_attention_kernel(*args),
               da.decode_attention_plain(*args)) < 1e-2


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
    got, got_lse = fa.flash_attention_kernel(*args)
    ref, ref_lse = fa.flash_attention_plain(*args)
    assert rel(got, ref) < 1e-2
    if got_lse is not None:
        assert rel(got_lse, ref_lse) < 1e-4


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


# T = 200 is not a multiple of the 64-key slices; nb 9 x g_rep 4 = 36 query
# rows take three passes of the block
@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
@pytest.mark.parametrize("nb,hq,hkv", [(5, 4, 4), (5, 8, 2), (9, 8, 2)])
def test_decode_attention_cells_kernel_matches_plain(gen, kv, nb, hq, hkv):
    T, D = 200, 128
    cache = filled_cache(gen, kv, 1, T, hkv, D)
    q = torch.randn(nb, hq, D, generator=gen, device="cuda")
    args = (q, *arena_args(cache), cells_mask(gen, nb, T, 1), hkv,
            1 / math.sqrt(D))
    before = _build.LAUNCHES["decode_attention_cells"]
    got = da.decode_attention_cells_kernel(*args)
    assert _build.LAUNCHES["decode_attention_cells"] == before + 1
    ref = da.decode_attention_plain(*args)
    assert rel(got, ref) < 1e-2
    # the pad row is the mean of V, as in the reference
    vmean = da._dense(cache.v[1], None if cache.vs is None else cache.vs[1],
                      1, hkv)[0].mean(1)                 # (hkv, D)
    assert rel(got[-1, ::hq // hkv], vmean) < 1e-2


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
@pytest.mark.parametrize("mode,hq,hkv", [("flat", 4, 4), ("cells", 4, 4),
                                         ("cells", 8, 2)])
def test_decode_attention_update_kernel_matches_plain(gen, kv, mode, hq, hkv):
    T, D, nb = 200, 128, 4
    B = nb if mode == "flat" else 1
    cache = filled_cache(gen, kv, B, T, hkv, D)
    twin = filled_cache(gen, kv, B, T, hkv, D)
    for name in ("k", "v", "ks", "vs"):
        if getattr(cache, name) is not None:
            getattr(twin, name).copy_(getattr(cache, name))
    start = {n: getattr(cache, n).clone() for n in ("k", "v")}
    q = torch.randn(nb, hq, D, generator=gen, device="cuda")
    kn, vn = (torch.randn(nb, 1, hkv, D, generator=gen, device="cuda")
              for _ in range(2))
    if mode == "flat":
        rows = torch.full((nb,), 150, device="cuda")
        mask = torch.zeros(nb, T, device="cuda")
        mask[:, 151:] = da.NEG
    else:
        rows = torch.tensor([3, 77, 150, T - 1], device="cuda")   # last: pad
        mask = cells_mask(gen, nb, T, 1)
    if kv == "q8_0":
        k8, kd = _q8_rows(kn)
        v8, vd = _q8_rows(vn)
        fresh = (k8.reshape(nb, -1), v8.reshape(nb, -1), kd.reshape(nb, -1),
                 vd.reshape(nb, -1))
    else:
        fresh = (kn.reshape(nb, -1).bfloat16(), vn.reshape(nb, -1).bfloat16(),
                 None, None)
    tail = (mask, rows, hkv, 1 / math.sqrt(D))
    before = _build.LAUNCHES["decode_attention_update"]
    got = da.decode_attention_update_kernel(q, *arena_args(cache), *fresh,
                                            *tail)
    assert _build.LAUNCHES["decode_attention_update"] == before + 1
    ref = da.decode_attention_update_plain(q, *arena_args(twin), *fresh, *tail)
    assert rel(got, ref) < 1e-2
    for name in ("k", "v", "ks", "vs"):          # the rows written in place
        if getattr(cache, name) is not None:
            assert torch.equal(getattr(cache, name), getattr(twin, name)), name
    written = torch.zeros(T, dtype=torch.bool, device="cuda")
    written[rows] = True
    for name, t in start.items():                # and nothing else moved
        a = getattr(cache, name)
        assert torch.equal(a[0], t[0]) and torch.equal(a[1][:, ~written],
                                                       t[1][:, ~written])
        assert not torch.equal(a[1][:, written], t[1][:, written])


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


def causal_mask(b, tq, tk, dist=False):
    qi = torch.arange(tq, device="cuda")[:, None] + (tk - tq)
    kj = torch.arange(tk, device="cuda")[None]
    fill = (kj - qi).float() if dist else torch.zeros(tq, tk, device="cuda")
    return torch.where(kj <= qi, fill, float("-inf"))[None, None] \
        .expand(b, 1, tq, tk)


@pytest.mark.parametrize("b,tq,tk,hq,hkv,d,causal,kw", [
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
])
def test_flash_backward_kernels_match_plain(gen, b, tq, tk, hq, hkv, d, causal,
                                            kw):
    from ggml_imax_tpu_torch.ops import flash_backward as fb
    kw = dict(kw)
    row = kw.pop("masked_row", None)
    q = torch.randn(b, tq, hq, d, generator=gen, device="cuda")
    k, v = (torch.randn(b, tk, hkv, d, generator=gen, device="cuda")
            for _ in range(2))
    mask = causal_mask(b, tq, tk, kw.get("max_bias", 0) > 0) if causal \
        else None
    if row is not None:
        mask = mask.clone()
        mask[:, :, row] = float("-inf")
    prep = fa._prep(q, k, v, mask, kw.get("max_bias", 0.0))
    scale, cap = 1 / math.sqrt(d), kw.get("logit_softcap", 0.0)
    out, lse = fa.flash_attention_kernel(*prep, scale, cap, True)
    do = torch.randn(out.shape, generator=gen, device="cuda")
    di = (do * out).sum(-1).transpose(1, 2).contiguous()
    args = (*prep[:3], do.bfloat16(), *prep[3:], lse, di, scale, cap)
    n0 = dict(_build.LAUNCHES)
    got = fb.flash_attention_bwd_kernel(*args)
    assert _build.LAUNCHES["flash_backward_dq"] == n0["flash_backward_dq"] + 1
    assert _build.LAUNCHES["flash_backward_dkv"] == n0["flash_backward_dkv"] + 1
    want = fb.flash_attention_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert rel(g, w) < 1e-2, name


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
