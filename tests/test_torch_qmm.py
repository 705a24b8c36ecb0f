"""Port parity: the W4A8 and W4A16 natpair matmuls.

The port's plain versions (what its wrappers run on CPU tensors) against
the JAX package's Pallas kernels in interpret mode, on the same numpy
inputs: Q8_0 activation quantization bit-exact, W4A8 within rel 1e-5 and
W4A16 within rel 1e-3 (both from f32 summation order alone: the integer
dots and the bf16 weight rounding are identical).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.ops import pallas_qmm as jpq
from ggml_imax_tpu.quant import device as jdev
from ggml_imax_tpu.quant.formats import GGMLType
from ggml_imax_tpu_torch.models.gptj import params_from_jax
from ggml_imax_tpu_torch.ops import qmm as tqmm


def natpair_pair(fmt, k, n, scale_dtype, seed):
    """(jax natpair QTensor, port natpair QTensor) from one numpy weight."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    raw = jdev.quantize_for_device(w, GGMLType[fmt])
    j = jpq.params_repack_device({"w": raw}, scale_dtype=(
        jnp.bfloat16 if scale_dtype == "bf16" else None))["w"]
    t = tqmm.params_repack({"w": params_from_jax(raw, device="cpu")},
                           scale_dtype=(torch.bfloat16 if scale_dtype == "bf16"
                                        else None))["w"]
    return j, t


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_quantize_activations_q8_bit_exact():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    x[0, :32] = 0.0                                  # d == 0 block
    x[1, 32:64] = np.arange(32) - 15.5               # half-integer quotients
    x[2, 64:96] = 127.0 * (np.arange(32) % 3)
    j8, jd = jpq._quantize_activations_q8(jnp.asarray(x), 256)
    t8, td = tqmm.quantize_activations_q8(torch.from_numpy(x))
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


# K 20480 x N 256: GPT-J's of_w depth, the long K the kernel cuts across a
# cluster of 8 blocks
@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_1"])          # Q4_1: bias term
@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1024, 20480])
def test_w4a8_plain_matches_reference(fmt, scale_dtype, k):
    j, t = natpair_pair(fmt, k, 256, scale_dtype, seed=1)
    assert (t.bias is not None) == (fmt == "Q4_1")
    x = np.random.default_rng(2).standard_normal((1, k)).astype(np.float32)
    ref = jpq._qmatmul_natpair_w4a8(jnp.asarray(x), j, bn=2048, interpret=True)
    got = tqmm.qmatmul_natpair(torch.from_numpy(x), t)
    assert got.shape == (1, 256)
    assert rel(got, ref) < 1e-5


@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_1"])
@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
def test_w4a16_plain_matches_reference(fmt, scale_dtype):
    j, t = natpair_pair(fmt, 512, 256, scale_dtype, seed=3)
    x = np.random.default_rng(4).standard_normal((64, 512)).astype(np.float32)
    ref = jpq._qmatmul_natpair(jnp.asarray(x), j, interpret=True)
    got = tqmm.qmatmul_natpair(torch.from_numpy(x), t)
    assert got.shape == (64, 256)
    assert rel(got, ref) < 1e-3


def test_dispatch_rule_w4a8_only_at_m1():
    _, t = natpair_pair("Q4_0", 256, 128, "f32", seed=5)
    x = torch.from_numpy(
        np.random.default_rng(6).standard_normal((2, 256)).astype(np.float32))
    x8, dx = tqmm.quantize_activations_q8(x[:1])
    np.testing.assert_array_equal(
        tqmm.qmatmul_natpair(x[:1], t)[0].numpy(),
        tqmm.w4a8_gemv_plain(x8[:, 0], dx[:, 0], t).numpy())
    np.testing.assert_array_equal(tqmm.qmatmul_natpair(x, t).numpy(),
                                  tqmm.w4a16_gemm_plain(x, t).numpy())


def test_wrappers_check_shapes():
    _, t = natpair_pair("Q4_0", 256, 128, "f32", seed=7)
    with pytest.raises(ValueError):
        tqmm.w4a8_gemv(torch.zeros(4, 32, dtype=torch.int8), torch.zeros(4), t)
    with pytest.raises(ValueError):
        tqmm.w4a16_gemm(torch.zeros(3, 128), t)
