"""The launch plan of the nat8 W8A8 GEMV (csrc/nat8_gemv.cu) and a model of
the kernel's order of arithmetic, both on the CPU.

`qmm.nat8_gemv_plan` says how far K is cut across the blocks of a
thread-block cluster: the largest split whose clusters the card runs in one
wave. `kernel_model` redoes in float32 what the kernel does in that order:
per rank, its whole 32-row units in warp order (warp w takes
units u0 + w, u0 + w + 8, ..), an exact integer dot for each group, then
acc = fma(z, dx * s, acc) (+ fma(xs, bias, acc)); at g 16 the unit's two
groups in two sums that meet at the end; the 8 warps' sums added in warp
order, then the ranks' in rank order. It is held to the port's plain version
and to the JAX package's `_qmatmul_nat8` in interpret mode at m = 1, on
weights the JAX package quantized, at NMSE < 1e-11 (the plain version's
tolerance in tests/test_torch_nat8.py). The kernel itself is held to its
plain version, at every split, in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.ops import pallas_qmm as jpq
from ggml_imax_tpu.quant import device as jdev
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.ops import qmm
from ggml_imax_tpu_torch.quant.device import QTensor
from ggml_imax_tpu_torch.quant.formats import GGMLType

SMS = 132
COLS = 128              # a block's columns
UNIT = 32               # rows a warp takes at a time
WARPS = 8
MAX_SPLIT = 8           # the split blocks of a column block form one cluster
# clusters of s blocks (two an SM) the H100 runs at once
CLUSTERS = {2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30}
# GPT-2 1558M (XL): fc_w (the one nat8 product on the kernel path: the
# others fail the N % 128 gate or are not nat8 GEMVs), then a wider and a
# longer one; GPT-2 117M's fc_w and out_w
GPT2 = [(1600, 6400), (1536, 6144), (6400, 1664), (768, 3072), (3072, 768)]
OTHER = [(32, 128), (96, 128), (512, 256), (1056, 384), (20480, 512),
         (4096, 16896), (1600, 1280)]
# (format, g, has bias) of the int8-kind formats the nat8 kernels take
FORMATS = {"Q8_0": (32, False), "Q5_1": (32, True), "Q5_K": (32, True),
           "Q6_K": (16, False)}


def splits(units):
    """Every split the kernel takes: 1 .. min(8, K/32)."""
    return list(range(1, min(units, MAX_SPLIT) + 1))


def pieces(k, split):
    """The units each rank takes: [y U / split, (y + 1) U / split) of
    U = K / 32, as the kernel's u0 and u1 say."""
    u = k // UNIT
    return [range(y * u // split, (y + 1) * u // split) for y in range(split)]


def fma(a, b, c):
    """float32 fma: a * b is exact in float64, then one more rounding (a
    double rounding on a tie in float64; never at these tolerances)."""
    return (a.double() * b.double() + c.double()).float()


def kernel_model(x8, dx, qt: QTensor, xs, split):
    """out (N,) f32 in csrc/nat8_gemv.cu's order of arithmetic at `split`."""
    g = qmm.nat8_group(qt)
    nb, n = qt.k // g, qt.n
    q = qt.q.to(torch.int64).reshape(nb, g, n)
    z = (x8.to(torch.int64)[:, :, None] * q).sum(1).float()    # exact
    ds = dx[:, None] * qt.scale.float()                           # f32
    bias = None if qt.bias is None else qt.bias.float()
    # the groups of a unit: one at g 32, two at g 16 (lanes r = 0, 1 take
    # the first, r = 2, 3 the second)
    per_unit = UNIT // g
    ranks = []
    for units in pieces(qt.k, split):
        warps = []
        for w in range(WARPS):
            sums = [torch.zeros(n) for _ in range(per_unit)]
            for u in units[w::WARPS]:
                for i in range(per_unit):
                    b = per_unit * u + i
                    sums[i] = fma(z[b], ds[b], sums[i])
                    if bias is not None:
                        sums[i] = fma(xs[b].expand(n), bias[b], sums[i])
            acc = sums[0]
            for s in sums[1:]:
                acc = acc + s
            warps.append(acc)
        total = warps[0]
        for s in warps[1:]:
            total = total + s
        ranks.append(total)
    out = ranks[0]
    for s in ranks[1:]:
        out = out + s
    return out


def nmse(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(((got - ref) ** 2).mean() / (ref ** 2).mean())


# ---- the plan

@pytest.mark.parametrize("g", [16, 32])
@pytest.mark.parametrize("k,n", GPT2 + OTHER)
def test_split_fits_a_cluster_and_the_units(k, n, g):
    assert 1 <= qmm.nat8_gemv_plan(k, n, g) <= min(MAX_SPLIT, k // UNIT)


@pytest.mark.parametrize("g", [16, 32])
@pytest.mark.parametrize("k,n", GPT2 + OTHER)
def test_split_is_the_largest_in_one_wave(k, n, g):
    """Column blocks that give every SM one run unsplit; else no larger
    split's clusters fit at once, and the plan's do."""
    split, blocks = qmm.nat8_gemv_plan(k, n, g), n // COLS
    if blocks >= SMS:
        assert split == 1
        return
    fits = [s for s in splits(k // UNIT) if s == 1 or blocks <= CLUSTERS[s]]
    assert split == fits[-1]


def test_gpt2_xl_fc_w():
    """fc_w's 50 column blocks: clusters of 5 would need 50 of the 47 the
    card runs at once, so 4 pieces (12 or 13 units each, 200 blocks) at
    either g; a column count that fills the card alone runs unsplit."""
    assert qmm.nat8_gemv_plan(1600, 6400, 32) == 4
    assert qmm.nat8_gemv_plan(1600, 6400, 16) == 4
    assert qmm.nat8_gemv_plan(1600, 132 * COLS, 32) == 1
    assert qmm.nat8_gemv_plan(1600, 128 * COLS, 32) == 2   # 128 <= 132
    assert qmm.nat8_gemv_plan(6400, 1664, 32) == 8    # 13 blocks
    assert qmm.nat8_gemv_plan(96, 128, 16) == 3       # 3 units of one
    assert qmm.nat8_gemv_plan(32, 128, 32) == 1       # one unit


def test_the_plan_takes_g_16_or_32():
    with pytest.raises(ValueError, match="g"):
        qmm.nat8_gemv_plan(1600, 6400, 8)


@pytest.mark.parametrize("g", [16, 32])
@pytest.mark.parametrize("k,n", GPT2 + OTHER)
def test_pieces_cover_every_group_once(k, n, g):
    split = qmm.nat8_gemv_plan(k, n, g)
    groups = [UNIT // g * u + i for r in pieces(k, split) for u in r
              for i in range(UNIT // g)]
    assert groups == list(range(k // g))
    sizes = [len(r) for r in pieces(k, split)]
    assert min(sizes) > 0 and max(sizes) - min(sizes) <= 1


# ---- the model of the kernel's arithmetic

def nat8_pair(fmt, k, n, scale_dtype, seed):
    """(JAX nat8 QTensor, port nat8 QTensor) from one quantized weight."""
    w = (np.random.default_rng(seed).standard_normal((k, n)) * 0.05) \
        .astype(np.float32)
    raw = jdev.quantize_for_device(w, JType[fmt])
    j = jpq.params_repack_device({"w": raw}, scale_dtype=(
        jnp.bfloat16 if scale_dtype == "bf16" else None))["w"]
    t = qmm.params_repack({"w": params_from_jax(raw, device="cpu")},
                          scale_dtype=(torch.bfloat16 if scale_dtype == "bf16"
                                       else None))["w"]
    return j, t


def activations(x, qt):
    """x8, dx and xs as qmm.qmatmul_nat8 hands them to the GEMV."""
    x8, dx = qmm.quantize_activations_q8(x, qmm.nat8_group(qt))
    x8, dx = x8[:, 0], dx[:, 0]
    return x8, dx, dx * x8.float().sum(-1)


# K 512: 16 units (two units a warp unsplit); K 1536: 48 units; each at
# every split 1 .. 8 (K-quants need K % 256 == 0)
@pytest.mark.parametrize("k", [512, 1536])
@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_model_matches_plain_and_reference(fmt, scale_dtype, k):
    g, has_bias = FORMATS[fmt]
    j, t = nat8_pair(fmt, k, 256, scale_dtype, seed=k)
    assert qmm.nat8_group(t) == g and (t.bias is not None) == has_bias
    x = np.random.default_rng(k + 1).standard_normal((1, k)).astype(np.float32)
    ref = np.asarray(jpq._qmatmul_nat8(jnp.asarray(x), j, interpret=True))[0]
    x8, dx, xs = activations(torch.from_numpy(x), t)
    plain = qmm.nat8_w8a8_gemv_plain(x8, dx, t, xs)
    assert nmse(plain, ref) < 1e-11
    for split in splits(k // UNIT):
        got = kernel_model(x8, dx, t, xs, split)
        assert nmse(got, plain) < 1e-11, split
        assert nmse(got, ref) < 1e-11, split


def test_model_at_fc_w_width_and_extremes():
    """GPT-2 XL's K (50 units; the plan's 4 pieces of 12 or 13, two units
    for warps 0-3 or 0-4) with every weight at -128 or 127 and every x8 at +-127: the
    largest integer dots, still exact in f32 (|z| <= 32 * 128 * 127)."""
    gen = torch.Generator().manual_seed(0)
    k, n = 1600, 128
    q = torch.where(torch.rand((k, n), generator=gen) < 0.5, -128, 127) \
        .to(torch.int8)
    s = torch.rand((k // 32, n), generator=gen) * 0.01
    qt = QTensor("int8", q, s, None, k, n, GGMLType.Q8_0, interleaved_bk=k,
                 q4_layout=4)
    x = torch.randn(1, k, generator=gen).sign() * 3.0
    x8, dx, _ = activations(x, qt)
    assert int(x8.abs().min()) == 127
    plain = qmm.nat8_w8a8_gemv_plain(x8, dx, qt)
    for split in splits(k // UNIT):
        assert nmse(kernel_model(x8, dx, qt, None, split), plain) < 1e-11


# ---- the wrapper on the CPU

def test_cpu_wrapper_runs_the_plain_version(monkeypatch):
    """On a CPU tensor the wrapper takes the plain version, never plans a
    launch and counts none."""
    def no_plan(*a):
        raise AssertionError("planned a launch for a CPU tensor")
    monkeypatch.setattr(qmm, "nat8_gemv_plan", no_plan)
    _, t = nat8_pair("Q5_1", 512, 128, "bf16", seed=1)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 512))
                         .astype(np.float32))
    x8, dx, xs = activations(x, t)
    before = dict(qmm._build.LAUNCHES)
    out = qmm.nat8_w8a8_gemv(x8, dx, t, xs)
    assert torch.equal(out, qmm.nat8_w8a8_gemv_plain(x8, dx, t, xs))
    assert torch.equal(qmm.qmatmul_nat8(x, t)[0], out)
    assert qmm._build.LAUNCHES == before


@pytest.mark.parametrize("g", [16, 32])
def test_a_bias_needs_its_group_sums(g):
    """A weight with a bias and no xs (or an xs of the wrong length) is
    refused before any launch, on the CPU too."""
    q = torch.zeros((64, 128), dtype=torch.int8)
    s = torch.ones((64 // g, 128))
    qt = QTensor("int8", q, s, s.clone(), 64, 128, GGMLType.Q5_1,
                 interleaved_bk=64, q4_layout=4)
    x8 = torch.zeros(64 // g, g, dtype=torch.int8)
    dx = torch.ones(64 // g)
    with pytest.raises(ValueError, match="xs"):
        qmm.nat8_w8a8_gemv(x8, dx, qt)
    with pytest.raises(ValueError, match="xs"):
        qmm.nat8_w8a8_gemv(x8, dx, qt, torch.ones(64 // g + 1))
    assert torch.equal(qmm.nat8_w8a8_gemv(x8, dx, qt, torch.ones(64 // g)),
                       torch.full((128,), 64.0 // g))
