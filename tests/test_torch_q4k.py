"""Port parity: the port's Q4_K codec, its device layout and the natpair
repack of it.

Quantize and dequantize are bit-exact against the JAX package's numpy
quantizer (`_QUANTIZERS[Q4_K]`, the golden-tested twin; its native C++
path is not the reference here) on rows with zero blocks, tiny and
1e5-scaled blocks and half-step ties, and against the compiled reference's
golden vectors. `to_device_format` and `quantize_for_device` (nib4, zero 0,
per-32 scale and bias -min), `dequantize_qtensor`, the K and N pads and
the natpair repack with f32 and bf16 scales are byte- or value-exact.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from ggml_imax_tpu.ops import pallas_qmm as jpq
from ggml_imax_tpu.quant import codecs as jcodecs
from ggml_imax_tpu.quant import device as jdev
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.ops import qmm
from ggml_imax_tpu_torch.quant import codecs as tcodecs
from ggml_imax_tpu_torch.quant import device as tdev
from ggml_imax_tpu_torch.quant.formats import FORMATS, GGMLType

from test_torch_kquant import assert_same_qtensor, interesting_data

GOLDEN = Path(__file__).parent / "fixtures" / "golden_quant.npz"
Q4K, JQ4K = GGMLType.Q4_K, JType.Q4_K


def _numpy_twin_device(w):
    """The JAX package's device layout of w (K, N) through its numpy
    quantizer."""
    k, n = w.shape
    raw = np.asarray(jcodecs._QUANTIZERS[JQ4K](np.ascontiguousarray(w.T)))
    return raw.reshape(-1), jdev.to_device_format(raw.reshape(-1), JQ4K,
                                                  (k, n))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_codec_bit_exact(seed):
    x = interesting_data(np.random.default_rng(seed), 256 * 16)
    got = tcodecs.quantize(x, Q4K)
    ref = np.asarray(jcodecs._QUANTIZERS[JQ4K](x)).reshape(-1)
    assert got.dtype == np.uint8 and FORMATS[Q4K].type_size == 144
    assert got.size == 16 * 144
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tcodecs.dequantize(got, Q4K, shape=(16, 256)),
        jcodecs._DEQUANTIZERS[JQ4K](ref).reshape(16, 256))


@pytest.mark.parametrize("row", ["x", "x2", "x3"])
def test_codec_matches_golden_vectors(row):
    gold = np.load(GOLDEN)
    raw = tcodecs.quantize(gold[row], Q4K)
    np.testing.assert_array_equal(raw, gold[f"{row}_q4_K_bytes"])
    np.testing.assert_array_equal(tcodecs.dequantize(raw, Q4K),
                                  gold[f"{row}_q4_K_dequant"])


def test_scale_min_field_round_trips():
    rng = np.random.default_rng(3)
    ls = rng.integers(0, 64, (50, 8)).astype(np.uint8)
    lm = rng.integers(0, 64, (50, 8)).astype(np.uint8)
    sc = tcodecs._pack_scale_min_k4(ls, lm)
    np.testing.assert_array_equal(sc, jcodecs._pack_scale_min_k4(ls, lm))
    d6, m6 = tcodecs._unpack_scale_min_k4(sc)
    np.testing.assert_array_equal(d6, ls)
    np.testing.assert_array_equal(m6, lm)


def _weight(k, n):
    w = (np.random.default_rng(k + n).standard_normal((k, n)) * 0.05) \
        .astype(np.float32)
    w[:, 3] = 0.0                                   # an all-zero column
    w[:, 5] = np.abs(w[:, 5])                       # a min of 0
    return w


@pytest.mark.parametrize("k,n", [(256, 40), (768, 96)])
def test_device_layout_byte_identical(k, n):
    w = _weight(k, n)
    raw, ref = _numpy_twin_device(w)
    got = tdev.quantize_for_device(w, Q4K, device="cpu")
    assert_same_qtensor(got, ref)
    assert got.scale.shape == got.bias.shape == (k // 32, n)      # per-32
    assert got.zero == 0 and bool((got.bias <= 0).all())
    assert_same_qtensor(tdev.to_device_format(raw, Q4K, (k, n), device="cpu"),
                        jdev.to_device_format(raw, JQ4K, (k, n)))
    np.testing.assert_array_equal(tdev.dequantize_qtensor(got).numpy(),
                                  jdev.dequantize_qtensor(ref))
    # and it is the codec's own dequantization, row for row
    np.testing.assert_array_equal(
        tdev.dequantize_qtensor(got).numpy(),
        tcodecs.dequantize(raw, Q4K, shape=(n, k)).T)


@pytest.mark.parametrize("mult", [128, 1024])
def test_pads_byte_identical(mult):
    w = _weight(768, 96)
    _, ref = _numpy_twin_device(w)
    got = tdev.quantize_for_device(w, Q4K, device="cpu")
    gr, kr = tdev.pad_qtensor_rows(got, mult)
    jr, jkr = jdev.pad_qtensor_rows(ref, mult)
    assert kr == jkr == (-768) % mult
    assert_same_qtensor(gr, jr)
    deq = tdev.dequantize_qtensor(gr)
    assert bool((deq[768:] == 0).all())             # padded rows decode to 0
    np.testing.assert_array_equal(deq[:768].numpy(),
                                  tdev.dequantize_qtensor(got).numpy())
    gc, nc = tdev.pad_qtensor_cols(got, mult)
    jc, jnc = jdev.pad_qtensor_cols(ref, mult)
    assert nc == jnc == (-96) % mult
    assert_same_qtensor(gc, jc)
    assert bool((tdev.dequantize_qtensor(gc)[:, 96:] == 0).all())
    assert tdev.pad_qtensor_rows(got, 256) == (got, 0)


def test_pad_rows_refuses_repacked_and_partial_blocks():
    got = tdev.quantize_for_device(_weight(256, 128), Q4K, device="cpu")
    with pytest.raises(ValueError, match="whole 32-row"):
        tdev.pad_qtensor_rows(got, 48)
    with pytest.raises(ValueError, match="before repacking"):
        tdev.pad_qtensor_rows(qmm.repack_natpair(got, 256), 1024)


@pytest.mark.parametrize("scale_dtype", [None, torch.bfloat16])
def test_natpair_repack_byte_identical(scale_dtype):
    import jax.numpy as jnp
    w = _weight(1024, 128)
    _, ref = _numpy_twin_device(w)
    got = tdev.quantize_for_device(w, Q4K, device="cpu")
    jsd = None if scale_dtype is None else jnp.bfloat16
    jr = jpq.repack_natpair_device(ref, 512, scale_dtype=jsd)
    tr = qmm.repack_natpair(got, 512, scale_dtype=scale_dtype)
    assert (tr.zero, tr.q4_layout, tr.interleaved_bk) == (8, 3, 512)
    np.testing.assert_array_equal(tr.q.numpy(), np.asarray(jr.q))
    for attr in ("scale", "bias"):
        a, b = getattr(tr, attr), np.asarray(getattr(jr, attr))
        if scale_dtype is None:
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            # the bf16 bias is bf16(bias + 8 scale), the sum taken in f32
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.view(torch.uint16).numpy(),
                                          b.view(np.uint16))
    want = (got.bias + 8.0 * got.scale).to(torch.bfloat16) \
        if scale_dtype else got.bias + 8.0 * got.scale
    assert torch.equal(tr.bias, want)
    # params_repack takes the same route for the Q4_K leaves of a tree
    rp = qmm.params_repack({"w": got}, scale_dtype=scale_dtype)["w"]
    assert torch.equal(rp.q, tr.q) and torch.equal(rp.bias, tr.bias)


def test_other_formats_still_refused():
    # Q8_K (the K-quants' activation format) has no device layout in
    # either package, nor have the integer and f64 tensor types
    for t in (GGMLType.Q8_K, GGMLType.I32, GGMLType.F64):
        raw = np.zeros(FORMATS.get(t, FORMATS[GGMLType.Q8_K]).type_size,
                       np.uint8)
        with pytest.raises(NotImplementedError):
            tdev.to_device_format(raw, t, (256, 1), device="cpu")
