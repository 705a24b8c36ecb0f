"""Port parity: the natpair W4A16 dispatch at the edges of the kernel's
routes (csrc/w4a16_gemm.cu: a small-M route up to M 8, a tile route above).

`qmatmul_natpair` on CPU tensors (the plain version the wrapper runs there)
against the JAX package's `_qmatmul_natpair` with its Pallas kernel in
interpret mode, on the same numpy inputs, at M 2 and 5 (small-M route), 9
(the first tile-route M) and 130 (a ragged second 128-row tile); Q4_0 and
Q4_1 (with its exact f32 bias term), f32 and bf16 scales. Tolerance rel 1e-3
of the largest |output|: the weight rounding is identical and the two sum in
another f32 order (measured on the CPU: at most 3.2e-7).
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

K, N = 512, 256


def natpair_pair(fmt, scale_dtype, seed):
    """(jax natpair QTensor, port natpair QTensor) from one numpy weight."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    raw = jdev.quantize_for_device(w, GGMLType[fmt])
    bf16 = scale_dtype == "bf16"
    j = jpq.params_repack_device({"w": raw}, scale_dtype=(
        jnp.bfloat16 if bf16 else None))["w"]
    t = tqmm.params_repack({"w": params_from_jax(raw, device="cpu")},
                           scale_dtype=torch.bfloat16 if bf16 else None)["w"]
    return j, t


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("m", [2, 5, 9, 130])
@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_1"])
@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
def test_natpair_w4a16_matches_reference(m, fmt, scale_dtype):
    j, t = natpair_pair(fmt, scale_dtype, seed=11)
    assert (t.bias is not None) == (fmt == "Q4_1")
    assert (t.scale.dtype == torch.bfloat16) == (scale_dtype == "bf16")
    x = np.random.default_rng(m).standard_normal((m, K)).astype(np.float32)
    ref = jpq._qmatmul_natpair(jnp.asarray(x), j, interpret=True)
    got = tqmm.qmatmul_natpair(torch.from_numpy(x), t)
    assert got.shape == (m, N)
    assert rel(got, ref) < 1e-3
    assert tqmm.natpair_plan(m, K, N)[0] == ("small" if m <= 8 else "tile")
