"""Port parity: the nat8 int8 layout and its W8A8 / W8A16 matmuls, and the
port's own Q4_0/Q8_0 codecs.

The port's plain versions (what its wrappers run on CPU tensors) against
the JAX package's Pallas kernels in interpret mode, on the same numpy
inputs. Weights are quantized by the JAX package (quantize_for_device) and
carried over with params_from_jax. Tolerance NMSE < 1e-11 for both (seen:
below 1e-13): in W8A8 the activation quantization and the integer dots are
identical and in W8A16 the bf16 weight rounding is, so only the f32 order
of the sums differs. Codecs, repack tags, dequantize and get_rows are
bit-exact.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.ops import embedding as jemb
from ggml_imax_tpu.ops import pallas_qmm as jpq
from ggml_imax_tpu.quant import codecs as jcodecs
from ggml_imax_tpu.quant import device as jdev
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.ops import embedding as temb
from ggml_imax_tpu_torch.ops import qmatmul as tqmatmul
from ggml_imax_tpu_torch.ops import qmm as tqmm
from ggml_imax_tpu_torch.quant import codecs as tcodecs
from ggml_imax_tpu_torch.quant import device as tdev
from ggml_imax_tpu_torch.quant.formats import GGMLType

jqmatmul = importlib.import_module("ggml_imax_tpu.ops.qmatmul")

# (format, g, has bias) of the int8-kind formats the nat8 kernels take
NAT8_FORMATS = {"Q8_0": (32, False), "Q5_0": (32, False), "Q5_1": (32, True),
                "Q5_K": (32, True), "Q6_K": (16, False)}


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
            assert a.dtype.itemsize == b.dtype.itemsize, attr
            np.testing.assert_array_equal(a, b, err_msg=attr)


def weight(fmt, k, n, seed):
    w = (np.random.default_rng(seed).standard_normal((k, n)) * 0.05) \
        .astype(np.float32)
    return jdev.quantize_for_device(w, JType[fmt])


def nat8_pair(fmt, k, n, scale_dtype, seed):
    """(JAX nat8 QTensor, port nat8 QTensor) from one quantized weight."""
    raw = weight(fmt, k, n, seed)
    j = jpq.params_repack_device({"w": raw}, scale_dtype=(
        jnp.bfloat16 if scale_dtype == "bf16" else None))["w"]
    t = tqmm.params_repack({"w": params_from_jax(raw, device="cpu")},
                           scale_dtype=(torch.bfloat16 if scale_dtype == "bf16"
                                        else None))["w"]
    return j, t


def nmse(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(((got - ref) ** 2).mean() / (ref ** 2).mean())


@pytest.mark.parametrize("fmt", ["F32", "Q4_0", "Q8_0"])
def test_codecs_bit_exact(fmt):
    x = np.random.default_rng(0).standard_normal((4, 256)).astype(np.float32)
    x[0, :32] = 0.0                                   # d == 0 block
    x[1, 32:64] = (np.arange(32) - 15.5) * 0.25       # ties at half steps
    x[2, 64:96] = np.float32(3.0) * (np.arange(32) % 5 - 2)
    raw_t = tcodecs.quantize(x, GGMLType[fmt])
    raw_j = jcodecs.quantize(x, JType[fmt])
    np.testing.assert_array_equal(raw_t, raw_j)
    np.testing.assert_array_equal(
        tcodecs.dequantize(raw_t, GGMLType[fmt], shape=x.shape),
        jcodecs.dequantize(raw_j, JType[fmt], shape=x.shape))


def test_codecs_reject_other_types():
    # codecs.quantize has no codebook encoder (quant.iq_encode has), and
    # Q8_K no device layout (as in the JAX package)
    with pytest.raises(NotImplementedError,
                       match="quant.imatrix.quantize_rows"):
        tcodecs.quantize(np.zeros(256, np.float32), GGMLType.IQ2_XXS)
    with pytest.raises(NotImplementedError):
        tdev.quantize_for_device(np.zeros((256, 8), np.float32),
                                 GGMLType.Q8_K, device="cpu")


@pytest.mark.parametrize("fmt", ["F32", "Q4_0", "Q8_0"])
def test_quantize_for_device_bit_exact(fmt):
    w = (np.random.default_rng(1).standard_normal((96, 40)) * 0.05) \
        .astype(np.float32)
    got = tdev.quantize_for_device(w, GGMLType[fmt], device="cpu")
    assert_same_qtensor(got, jdev.quantize_for_device(w, JType[fmt]))


@pytest.mark.parametrize("fmt,k,tag", [
    ("Q8_0", 1600, 1600),      # GPT-2 XL attn/fc K: the full-K tag
    ("Q8_0", 6400, 256),       # GPT-2 XL out_w K
    ("Q8_0", 320, 320),
    ("Q5_1", 512, 512),        # bias
    ("Q6_K", 512, 512),        # per-16 scales
])
@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
def test_nat8_repack_tags_and_bytes(fmt, k, tag, scale_dtype):
    j, t = nat8_pair(fmt, k, 128, scale_dtype, seed=2)
    assert t.q4_layout == 4 and t.interleaved_bk == tag
    assert_same_qtensor(t, j)
    # repack is idempotent on an already tagged tensor
    assert_same_qtensor(tqmm.params_repack({"w": t})["w"], j)


@pytest.mark.parametrize("m", [1, 5, 64])
@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", list(NAT8_FORMATS))
def test_nat8_plain_matches_reference(fmt, scale_dtype, m):
    """m == 1 takes W8A8 (activations quantized per g), m > 1 W8A16, in
    both packages."""
    g, has_bias = NAT8_FORMATS[fmt]
    j, t = nat8_pair(fmt, 512, 256, scale_dtype, seed=3)
    assert tqmm.nat8_group(t) == g and (t.bias is not None) == has_bias
    x = np.random.default_rng(4).standard_normal((m, 512)).astype(np.float32)
    ref = np.asarray(jpq._qmatmul_nat8(jnp.asarray(x), j, interpret=True))
    got = tqmm.qmatmul_nat8(torch.from_numpy(x), t).numpy()
    assert got.shape == ref.shape == (m, 256)
    assert nmse(got, ref) < 1e-11


def test_nat8_dispatch_matches_wrappers():
    _, t = nat8_pair("Q6_K", 256, 128, "f32", seed=5)
    x = torch.from_numpy(
        np.random.default_rng(6).standard_normal((3, 256)).astype(np.float32))
    x8, dx = tqmm.quantize_activations_q8(x[:1], 16)
    np.testing.assert_array_equal(
        tqmm.qmatmul_nat8(x[:1], t)[0].numpy(),
        tqmm.nat8_w8a8_gemv_plain(x8[:, 0], dx[:, 0], t).numpy())
    np.testing.assert_array_equal(tqmm.qmatmul_nat8(x, t).numpy(),
                                  tqmm.nat8_w8a16_gemm_plain(x, t).numpy())


@pytest.mark.parametrize("n", [256, 200])
def test_qmatmul_kernel_gate(n, monkeypatch):
    """nat8 weights with N % 128 == 0 go to qmatmul_nat8; others take
    dequantize + matmul and match the reference's XLA path."""
    j, t = nat8_pair("Q8_0", 128, n, "f32", seed=7)
    calls = []
    real = tqmatmul.qmatmul_nat8
    monkeypatch.setattr(tqmatmul, "qmatmul_nat8",
                        lambda x, qt: calls.append(qt.n) or real(x, qt))
    x = np.random.default_rng(8).standard_normal((2, 128)).astype(np.float32)
    got = tqmatmul.qmatmul(torch.from_numpy(x), t, out_dtype=torch.float32)
    assert calls == ([n] if n % 128 == 0 else [])
    if n % 128:
        ref = np.asarray(jqmatmul.qmatmul(jnp.asarray(x), j,
                                          out_dtype=jnp.float32))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fmt", ["Q8_0", "Q5_1", "Q6_K"])
@pytest.mark.parametrize("layout", ["natural", "nat8"])
def test_dequantize_and_get_rows_exact(fmt, layout):
    raw = weight(fmt, 256, 96, seed=9)
    j = raw if layout == "natural" else jpq.params_repack_device({"w": raw})["w"]
    t = params_from_jax(j, device="cpu")
    assert t.q4_layout == (4 if layout == "nat8" else 0)
    np.testing.assert_array_equal(tdev.dequantize_qtensor(t).numpy(),
                                  jdev.dequantize_qtensor(raw))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            to_np(tqmatmul.dequantize(t, dt)),
            to_np(jqmatmul.dequantize_xla(j, jdt)))
    ids = np.array([[0, 95, 17], [3, 3, 50]])
    np.testing.assert_array_equal(
        temb.get_rows(t, torch.from_numpy(ids), dtype=torch.float32).numpy(),
        np.asarray(jemb.get_rows(j, jnp.asarray(ids), dtype=jnp.float32)))


def test_nat8_wrappers_check_shapes():
    _, t = nat8_pair("Q8_0", 256, 128, "f32", seed=10)
    with pytest.raises(ValueError):
        tqmm.nat8_w8a8_gemv(torch.zeros(4, 16, dtype=torch.int8),
                            torch.zeros(4), t)
    with pytest.raises(ValueError):
        tqmm.nat8_w8a16_gemm(torch.zeros(3, 128), t)
    with pytest.raises(ValueError):
        tqmm.repack_nat8(t)                       # already tagged
    with pytest.raises(ValueError):
        tqmm.nat8_w8a16_gemm(torch.zeros(3, 256), tqmm.repack_natpair(
            params_from_jax(weight("Q4_0", 256, 128, seed=11), device="cpu")))
