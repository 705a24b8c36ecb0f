"""Port parity: the IQ grid-search encoders against the JAX package's.

quant.iq_encode.quantize_iq of the port (its native/iq_encoders.cpp) and
of the JAX package (its own copy and build) on random rows other than the
golden fixture's (tests/test_torch_iq_encode.py holds that one): 2 rows of
512 at two scales, one stretch of small values, an importance row drawn
from an exponential, all seven kinds with it and the four that run
without one. Exact equality. No sub-block is all zero and no run of
importance entries is: there the JAX package's copy reads scratch it never
wrote (the port's copy was fixed, native/iq_encoders.cpp's header; its
test is test_torch_iq_encode.py::test_degenerate_rows_are_deterministic).
"""
import numpy as np
import pytest

from ggml_imax_tpu.quant import iq_encode as jiq
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.quant import iq_encode as tiq
from ggml_imax_tpu_torch.quant.formats import GGMLType

KINDS = ["IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_S", "IQ1_M"]
WITHOUT = ["IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_M"]


def _inputs():
    rng = np.random.default_rng(17)
    x = (rng.standard_normal((2, 512)) * rng.uniform(0.05, 2, (2, 1))) \
        .astype(np.float32)
    x[1, 256:320] *= 1e-3
    return x, rng.exponential(1.0, 512).astype(np.float32)


@pytest.mark.parametrize("fmt,with_qw",
                         [(k, True) for k in KINDS]
                         + [(k, False) for k in WITHOUT],
                         ids=[k for k in KINDS] + [f"{k}-noqw"
                                                   for k in WITHOUT])
def test_encoders_equal_the_jax_encoders(fmt, with_qw):
    x, qw = _inputs()
    qw = qw if with_qw else None
    np.testing.assert_array_equal(tiq.quantize_iq(x, GGMLType[fmt], qw),
                                  jiq.quantize_iq(x, JType[fmt], qw))
