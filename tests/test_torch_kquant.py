"""Port parity: the port's own Q2_K and Q3_K codecs and their device layout.

Quantize and dequantize are bit-exact against the JAX package's numpy
quantizers (`_QUANTIZERS`, the golden-tested twins; its native C++ path is
not the reference here) on rows with zero blocks, tiny and 1e5-scaled
blocks and half-step ties, and against the compiled reference's golden
vectors. `to_device_format`, `quantize_for_device` and
`dequantize_qtensor` (per-16 scales, zero 0 with a bias for Q2_K, zero 4
for Q3_K) are byte- and value-exact.
"""
from pathlib import Path

import numpy as np
import pytest

from ggml_imax_tpu.quant import codecs as jcodecs
from ggml_imax_tpu.quant import device as jdev
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.quant import codecs as tcodecs
from ggml_imax_tpu_torch.quant import device as tdev
from ggml_imax_tpu_torch.quant.formats import FORMATS, GGMLType

KQUANTS = ["Q2_K", "Q3_K"]
GOLDEN = Path(__file__).parent / "fixtures" / "golden_quant.npz"


def interesting_data(rng, n):
    """Normals, a zero block, tiny and huge blocks, half-step ties (the
    cases of tests/test_native_codecs.py)."""
    x = rng.standard_normal(n).astype(np.float32)
    x[: n // 8] = 0.0
    x[n // 8: n // 4] *= 1e-18
    x[n // 4: 3 * n // 8] *= 1e5
    x[3 * n // 8: n // 2] = np.round(x[3 * n // 8: n // 2] * 2) / 2
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fmt", KQUANTS)
def test_codecs_bit_exact(fmt, seed):
    x = interesting_data(np.random.default_rng(seed), 256 * 16)
    got = tcodecs.quantize(x, GGMLType[fmt])
    ref = np.asarray(jcodecs._QUANTIZERS[JType[fmt]](x)).reshape(-1)
    assert got.dtype == np.uint8
    assert got.size == 16 * FORMATS[GGMLType[fmt]].type_size
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tcodecs.dequantize(got, GGMLType[fmt], shape=(16, 256)),
        jcodecs._DEQUANTIZERS[JType[fmt]](ref).reshape(16, 256))


@pytest.mark.parametrize("row", ["x", "x2", "x3"])
@pytest.mark.parametrize("fmt", KQUANTS)
def test_codecs_match_golden_vectors(fmt, row):
    gold = np.load(GOLDEN)
    name = fmt[:2].lower() + fmt[2:]                 # "q2_K"
    raw = tcodecs.quantize(gold[row], GGMLType[fmt])
    np.testing.assert_array_equal(raw, gold[f"{row}_{name}_bytes"])
    np.testing.assert_array_equal(tcodecs.dequantize(raw, GGMLType[fmt]),
                                  gold[f"{row}_{name}_dequant"])


def assert_same_qtensor(t, j):
    for f in ("kind", "k", "n", "zero", "interleaved_bk", "q4_layout"):
        assert getattr(t, f) == getattr(j, f), f
    assert int(t.ggml_type) == int(j.ggml_type)
    for attr in ("q", "scale", "bias"):
        a, b = getattr(t, attr), getattr(j, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype, attr
            np.testing.assert_array_equal(a, b, err_msg=attr)


@pytest.mark.parametrize("k,n", [(256, 40), (768, 96)])
@pytest.mark.parametrize("fmt", KQUANTS)
def test_device_layout_byte_identical(fmt, k, n):
    w = (np.random.default_rng(k + n).standard_normal((k, n)) * 0.05) \
        .astype(np.float32)
    w[:, 3] = 0.0                                   # an all-zero column
    got = tdev.quantize_for_device(w, GGMLType[fmt], device="cpu")
    ref = jdev.quantize_for_device(w, JType[fmt])
    assert_same_qtensor(got, ref)
    assert got.scale.shape == (k // 16, n)          # per-16
    assert got.zero == {"Q2_K": 0, "Q3_K": 4}[fmt]
    raw = tcodecs.quantize(np.ascontiguousarray(w.T), GGMLType[fmt])
    assert_same_qtensor(tdev.to_device_format(raw, GGMLType[fmt], (k, n),
                                              device="cpu"),
                        jdev.to_device_format(raw, JType[fmt], (k, n)))
    np.testing.assert_array_equal(tdev.dequantize_qtensor(got).numpy(),
                                  jdev.dequantize_qtensor(ref))
    # and it is the codec's own dequantization, row for row
    np.testing.assert_array_equal(
        tdev.dequantize_qtensor(got).numpy(),
        tcodecs.dequantize(raw, GGMLType[fmt], shape=(n, k)).T)
