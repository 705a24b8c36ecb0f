"""Port parity: the IQ grid-search encoders (quant/iq_encode.py over
native/iq_encoders.cpp).

- quantize_iq bit-equal to the compiled reference's bytes in the eleven
  cases of tests/fixtures/golden_iq_encode.npz (4 x 1024: all seven kinds
  with an importance row, IQ2_S, IQ3_XXS, IQ3_S and IQ1_M also without).
  The JAX package's quantize_iq on other inputs is in
  tests/test_torch_iq_encode_jax.py: a grid set's first use builds its
  neighbour lists (~12 s for IQ1's), once in each library, so the two
  libraries' halves run in two files (two workers).
- The l-value seed tables equal the JAX package's.
- Rows with all-zero sub-blocks, a whole zero super-block, runs of zero
  importance entries and tiny values encode to the same bytes however
  many other encodes ran before (the JAX package's copy reads scratch it
  never wrote there, and IQ1_M's indexed out of bounds:
  native/iq_encoders.cpp's header).
- A kind that needs an importance row refuses to run without one, through
  quantize_iq and through quantize_rows.
All comparisons are exact.
"""
from pathlib import Path

import numpy as np
import pytest

from ggml_imax_tpu.quant import iq_encode as jiq
from ggml_imax_tpu_torch.quant import iq_encode as tiq
from ggml_imax_tpu_torch.quant.formats import GGMLType
from ggml_imax_tpu_torch.quant.imatrix import quantize_rows

FIX = Path(__file__).parent / "fixtures" / "golden_iq_encode.npz"
CASES = [("iq2_xxs", "IQ2_XXS", True), ("iq2_xs", "IQ2_XS", True),
         ("iq2_s", "IQ2_S", True), ("iq3_xxs", "IQ3_XXS", True),
         ("iq3_s", "IQ3_S", True), ("iq1_s", "IQ1_S", True),
         ("iq1_m", "IQ1_M", True), ("iq2_s", "IQ2_S", False),
         ("iq3_xxs", "IQ3_XXS", False), ("iq3_s", "IQ3_S", False),
         ("iq1_m", "IQ1_M", False)]


@pytest.mark.parametrize("name,fmt,with_qw", CASES,
                         ids=[f"{c[0]}{'' if c[2] else '-noqw'}"
                              for c in CASES])
def test_encoders_equal_golden_bytes(name, fmt, with_qw):
    z = np.load(FIX)
    x, qw = z["x"], (z["qw"] if with_qw else None)
    got = tiq.quantize_iq(x, GGMLType[fmt], qw)
    assert got.shape == (4, got.shape[1]) and got.dtype == np.uint8
    np.testing.assert_array_equal(
        got.reshape(-1), z[f"{name}_bytes" + ("" if with_qw else "_noqw")])


def test_degenerate_rows_are_deterministic():
    rng = np.random.default_rng(17)
    x = (rng.standard_normal((3, 512)) * rng.uniform(0.05, 2, (3, 1))) \
        .astype(np.float32)
    x[0, 64:96] = 0.0
    x[1, 256:320] *= 1e-3
    x[2, :256] = 0.0
    qw = rng.exponential(1.0, 512).astype(np.float32)
    qw[:16] = 0.0
    qw[300:340] = 0.0
    cases = [(t, w) for t in tiq._SPEC for w in (qw, None)
             if w is not None or not tiq._SPEC[t][3]]
    first = {(t, w is None): tiq.quantize_iq(x, t, w) for t, w in cases}
    for t, w in reversed(cases):
        np.testing.assert_array_equal(tiq.quantize_iq(x, t, w),
                                      first[(t, w is None)],
                                      err_msg=f"{t.name} {w is None}")


def test_seed_tables_equal_the_jax_ones():
    grids = np.load(Path(tiq.__file__).parent / "iq_grids.npz")
    for _, name, _, _ in tiq._SPEC.values():
        np.testing.assert_array_equal(tiq._seeds(name, grids[name]),
                                      jiq._seeds(name, grids[name]))


@pytest.mark.parametrize("fmt", ["IQ2_XXS", "IQ2_XS", "IQ1_S"])
def test_required_imatrix_raises(fmt):
    x = np.ones((1, 256), np.float32)
    with pytest.raises(ValueError, match="requires an importance matrix"):
        tiq.quantize_iq(x, GGMLType[fmt])
    with pytest.raises(ValueError, match="requires an importance matrix"):
        quantize_rows(x, GGMLType[fmt])


def test_shapes_are_checked():
    with pytest.raises(ValueError, match="multiples of 256"):
        tiq.quantize_iq(np.ones((1, 128), np.float32), GGMLType.IQ3_S)
    with pytest.raises(ValueError, match="importance row"):
        tiq.quantize_iq(np.ones((1, 256), np.float32), GGMLType.IQ3_S,
                        np.ones(128, np.float32))
    assert tiq.available()
