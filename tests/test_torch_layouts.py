"""Port parity: the three permuted weight layouts and their kernels' plain
versions (TPU kernels 11-13: plane-split, row-pair and u-order int8).

- The repacks are byte-identical with the JAX package's
  repack_interleaved_device, repack_rowpair_device and
  repack_int8_rows_device over several tags, and params_repack picks the
  layout and the tag that params_repack_device picks.
- Each plain version (what its wrapper runs on CPU tensors) against the
  JAX package's Pallas kernel in interpret mode, at M 1, 5, 64 and 600
  (above the reference's 512-row tile): NMSE < 1e-11 (seen: below 1e-13).
  The bf16 weight roundings are identical, kernel 11's bias rounded inside
  the weight included, so only the f32 order of the sums differs. At M 1
  XLA on the CPU compiles the interpret-mode row-pair and int8 kernels
  with excess precision (xla_allow_excess_precision, on by default): the
  bf16 weight product reaches the dot unrounded, which the TPU kernel, the
  port's kernel and its plain version all round. So the M 1 reference is
  row 0 of the same kernel run on x padded with zero rows to 8, and the
  unpadded M 1 run is held to NMSE < 1e-4 (seen 2e-6 to 1.5e-5). Formats
  the port has no codec for (Q4_1, Q4_K, Q5_1, Q6_K) are quantized by the
  JAX package and carried over with params_from_jax.
- dequantize and get_rows are exact over the three layouts.
- qmatmul's N % 128 gate, and the kernel route's gradient in x against
  jax.grad through the reference's _qmm_fused.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.ops import embedding as jemb
from ggml_imax_tpu.ops import pallas_qmm as jpq
from ggml_imax_tpu.quant import device as jdev
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.ops import embedding as temb
from ggml_imax_tpu_torch.ops import qmatmul as tqmatmul
from ggml_imax_tpu_torch.ops import qmm as tqmm
from ggml_imax_tpu_torch.quant import device as tdev
from ggml_imax_tpu_torch.quant.formats import GGMLType

jqmatmul = importlib.import_module("ggml_imax_tpu.ops.qmatmul")

OWN_CODEC = ("Q4_0", "Q8_0", "Q2_K", "Q3_K")
# layout -> (reference repack, port repack, formats)
LAYOUTS = {
    "planes": (jpq.repack_interleaved_device, tqmm.repack_interleaved,
               ("Q3_K", "Q2_K")),
    "rowpair": (jpq.repack_rowpair_device, tqmm.repack_rowpair,
                ("Q4_0", "Q4_1", "Q4_K")),
    "int8": (jpq.repack_int8_rows_device, tqmm.repack_int8_rows,
             ("Q8_0", "Q5_1", "Q6_K")),
}
CASES = [(lay, fmt) for lay, (_, _, fmts) in LAYOUTS.items() for fmt in fmts]


def to_np(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_same_qtensor(tq, jq):
    for f in ("kind", "k", "n", "zero", "interleaved_bk", "q4_layout"):
        assert getattr(tq, f) == getattr(jq, f), f
    assert int(tq.ggml_type) == int(jq.ggml_type)
    for attr in ("q", "scale", "bias"):
        a, b = getattr(tq, attr), getattr(jq, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            a, b = to_np(a), to_np(b)
            assert a.dtype == b.dtype, attr
            np.testing.assert_array_equal(a, b, err_msg=attr)


def natural_pair(fmt, k, n, seed):
    """(JAX QTensor, port QTensor) of one weight in the natural layout: the
    port quantizes with its own codec where it has one."""
    w = (np.random.default_rng(seed).standard_normal((k, n)) * 0.05) \
        .astype(np.float32)
    j = jdev.quantize_for_device(w, JType[fmt])
    if fmt in OWN_CODEC:
        t = tdev.quantize_for_device(w, GGMLType[fmt], device="cpu")
        assert_same_qtensor(t, j)
    else:
        t = params_from_jax(j, device="cpu")
    return j, t


def repacked_pair(layout, fmt, k, n, bk, seed):
    jrep, trep, _ = LAYOUTS[layout]
    j, t = natural_pair(fmt, k, n, seed)
    return jrep(j, bk), trep(t, bk)


def nmse(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(((got - ref) ** 2).mean() / (ref ** 2).mean())


@pytest.mark.parametrize("bk", [256, 512, 1024])
@pytest.mark.parametrize("layout,fmt", CASES)
def test_repacks_byte_identical(layout, fmt, bk):
    j, t = repacked_pair(layout, fmt, 1024, 128, bk, seed=1)
    assert t.interleaved_bk == bk
    assert_same_qtensor(t, j)


@pytest.mark.parametrize("fmt,k,layout,tag", [
    ("Q3_K", 768, 0, 256),       # GPT-2 117M attn/proj/fc K: 512 halves
    ("Q3_K", 3072, 0, 512),      # GPT-2 117M out_w K
    ("Q2_K", 256, 0, 256),
    ("Q2_K", 1024, 0, 512),
    ("Q4_0", 768, 3, 256),       # per-32, zero 8: natpair, not planes
    ("Q4_K", 512, 3, 512),       # per-32, zero 0
    ("Q6_K", 768, 4, 256),       # int8: nat8
])
def test_params_repack_layout_and_tag(fmt, k, layout, tag):
    j, t = natural_pair(fmt, k, 128, seed=2)
    jr = jpq.params_repack_device({"w": j})["w"]
    tr = tqmm.params_repack({"w": t})["w"]
    assert (tr.q4_layout, tr.interleaved_bk) == (layout, tag)
    assert_same_qtensor(tr, jr)
    assert_same_qtensor(tqmm.params_repack({"w": tr})["w"], jr)  # idempotent


PLAIN = {"planes": tqmm.planes_w4a16_plain, "rowpair": tqmm.rowpair_w4a16_plain,
         "int8": tqmm.int8_rows_w8a16_plain}


@pytest.mark.parametrize("m", [1, 5, 64, 600])
@pytest.mark.parametrize("layout,fmt", CASES)
def test_plain_matches_reference_kernel(layout, fmt, m):
    j, t = repacked_pair(layout, fmt, 512, 256, 256, seed=3)
    x = np.random.default_rng(4).standard_normal((m, 512)).astype(np.float32)
    ref = np.asarray(jpq.qmatmul_pallas(jnp.asarray(x), j, interpret=True))
    got = tqmm.qmatmul_permuted(torch.from_numpy(x), t).numpy()
    assert got.shape == ref.shape == (m, 256)
    if m == 1:
        assert nmse(got, ref) < 1e-4
        ref = np.asarray(jpq.qmatmul_pallas(
            jnp.asarray(np.pad(x, ((0, 7), (0, 0)))), j, interpret=True))[:1]
    assert nmse(got, ref) < 1e-11
    # the dispatch runs the layout's own plain version on the CPU
    np.testing.assert_array_equal(
        got, PLAIN[layout](torch.from_numpy(x), t).numpy())


def test_planes_bias_is_rounded_inside_the_weight():
    """Kernel 11 adds the Q2_K bias to the bf16 weight and rounds again;
    the exact f32 bias term of the other kernels gives other numbers."""
    _, t = repacked_pair("planes", "Q2_K", 512, 256, 256, seed=5)
    w = tqmm.dequant_planes_bf16(t).float()
    exact = tqmm.unpack_planes(t.q, t).float() \
        * tqmm._expand(t.scale, t).float() + t.bias.repeat_interleave(16, 0)
    assert not torch.equal(w, exact)
    assert float((w - exact).abs().max()) <= 2 ** -7 * float(exact.abs().max())


@pytest.mark.parametrize("layout,fmt", CASES)
def test_dequantize_and_get_rows_exact(layout, fmt):
    j, t = repacked_pair(layout, fmt, 512, 96, 256, seed=6)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            to_np(tqmatmul.dequantize(t, dt)),
            to_np(jqmatmul.dequantize_xla(j, jdt)))
        ids = np.array([[0, 95, 17], [3, 3, 50]])
        np.testing.assert_array_equal(
            to_np(temb.get_rows(t, torch.from_numpy(ids), dtype=dt)),
            to_np(jemb.get_rows(j, jnp.asarray(ids), dtype=jdt)))
    # the natural layout decodes to the same values
    nat = params_from_jax(jdev.quantize_for_device(
        (np.random.default_rng(6).standard_normal((512, 96)) * 0.05)
        .astype(np.float32), JType[fmt]), device="cpu")
    if layout != "rowpair":          # row-pair folds 8 * scale into the bias
        np.testing.assert_array_equal(tqmatmul.dequantize(t, torch.float32),
                                      tqmatmul.dequantize(nat, torch.float32))


@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("layout,fmt", [("planes", "Q2_K"), ("rowpair", "Q4_0"),
                                        ("int8", "Q6_K")])
def test_qmatmul_kernel_gate(layout, fmt, n, monkeypatch):
    """N % 128 == 0 goes to the layout's wrapper; N 200 takes dequantize +
    matmul and matches the reference's XLA path."""
    j, t = repacked_pair(layout, fmt, 512, n, 256, seed=7)
    calls = []
    real = tqmatmul.qmatmul_permuted
    monkeypatch.setattr(tqmatmul, "qmatmul_permuted",
                        lambda x, qt: calls.append(qt.n) or real(x, qt))
    x = np.random.default_rng(8).standard_normal((2, 3, 512)).astype(np.float32)
    got = tqmatmul.qmatmul(torch.from_numpy(x), t, out_dtype=torch.float32)
    assert got.shape == (2, 3, n)
    assert calls == ([n] if n % 128 == 0 else [])
    if n % 128:
        ref = np.asarray(jqmatmul.qmatmul(jnp.asarray(x), j,
                                          out_dtype=jnp.float32))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout,fmt", [("planes", "Q3_K"), ("rowpair", "Q4_1"),
                                        ("int8", "Q5_1")])
def test_kernel_route_gradient_matches_jax(layout, fmt):
    """dx through the kernel route (the dequantized-weight VJP) against
    jax.grad through _qmm_fused (interpret mode): NMSE < 1e-10."""
    j, t = repacked_pair(layout, fmt, 512, 256, 256, seed=9)
    x = np.random.default_rng(10).standard_normal((5, 512)).astype(np.float32)
    ref = np.asarray(jax.grad(lambda xx: jnp.sin(
        jqmatmul._qmm_fused(xx, j)).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tqmatmul.qmatmul(xt, t, out_dtype=torch.float32)
    assert y.grad_fn is not None
    (got,) = torch.autograd.grad(torch.sin(y).sum(), xt)
    assert nmse(got.numpy(), ref) < 1e-10


def test_wrappers_check_layouts_and_shapes():
    _, planes = repacked_pair("planes", "Q3_K", 512, 128, 256, seed=11)
    _, rows = repacked_pair("int8", "Q8_0", 512, 128, 256, seed=11)
    x = torch.zeros(3, 512)
    with pytest.raises(ValueError):
        tqmm.planes_w4a16(torch.zeros(3, 256), planes)        # K mismatch
    with pytest.raises(ValueError):
        tqmm.rowpair_w4a16(x, planes)                         # wrong layout
    with pytest.raises(ValueError):
        tqmm.int8_rows_w8a16(x, planes)
    with pytest.raises(ValueError):
        tqmm.planes_w4a16(x, rows)
    with pytest.raises(ValueError):                           # stale tag
        tqmm.planes_w4a16(x, tdev.QTensor(**{**planes.__dict__,
                                             "interleaved_bk": 384}))
    with pytest.raises(ValueError):
        tqmm.repack_interleaved(planes)                       # already repacked
    with pytest.raises(ValueError):
        tqmm.repack_rowpair(natural_pair("Q2_K", 512, 128, 12)[1])  # per-16
