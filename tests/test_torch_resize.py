"""Port parity for the bilinear resize (ggml_imax_tpu_torch/ops/conv.py
`_resize_bilinear`, which interpolate_bilinear, SAM's preprocess and mask
upscale and YOLO's letterbox call) against jax.image.resize(...,
"bilinear") at integer and non-integer factors, up and down, in the
layouts the models use, at the sweep's `conv` NMSE (1e-9,
tests/test_backend_ops_sweep.py). The reference antialiases on a
downscale (its triangle kernel widened by the scale) and renormalises at
the edges; F.interpolate does neither, which the last test shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

from ggml_imax_tpu_torch.ops.conv import _resize_bilinear, _resize_weights

TOL_CONV = 1e-9


def nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2) / (np.mean(b * b) + 1e-300))


@pytest.mark.parametrize("src,dst", [
    ((3, 720, 1280), (3, 576, 1024)),      # SAM's preprocess, channels first
    ((3, 480, 640), (3, 312, 416)),        # YOLO's letterbox
    ((720, 1280, 3), (576, 1024, 3)),      # SAM's preprocess layout
    ((3, 64, 64), (3, 720, 1280)),         # SAM's mask upscale
    ((3, 16, 16), (3, 32, 48)),            # integer up
    ((2, 3, 24, 36), (2, 3, 12, 9)),       # integer down
    ((3, 13, 17), (3, 29, 11)),            # non-integer up and down
    ((3, 7, 5), (3, 7, 12)),               # one axis kept
    ((1, 9, 9), (1, 1, 1)),                # to one pixel
])
def test_resize_matches_jax(src, dst):
    x = np.random.default_rng(sum(src) + sum(dst)).standard_normal(src) \
        .astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), dst, "bilinear"))
    got = _resize_bilinear(torch.from_numpy(x), dst).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert nmse(got, ref) < TOL_CONV, nmse(got, ref)


@pytest.mark.parametrize("m,n", [(720, 576), (1280, 1024), (480, 312),
                                 (640, 416), (16, 48), (13, 29), (9, 1)])
def test_weights_are_jax_weights(m, n):
    ref = np.asarray(compute_weight_mat(m, n, n / m, 0.0,
                                        _fill_triangle_kernel, True))
    got = _resize_weights(m, n, "cpu").numpy()
    assert got.shape == (m, n)
    assert nmse(got, ref) < TOL_CONV
    np.testing.assert_array_equal(got == 0, ref == 0)   # the same support


def test_kept_axes_are_untouched_and_dtype_kept():
    x = torch.randn(3, 7, 5, generator=torch.Generator().manual_seed(0))
    assert torch.equal(_resize_bilinear(x, (3, 7, 5)), x)
    y = _resize_bilinear(x.double(), (3, 7, 9))
    assert y.dtype == torch.float64 and torch.equal(y[0, :, 0], x[0, :, 0]
                                                    .double())


def test_rank_must_match():
    with pytest.raises(ValueError, match="rank"):
        _resize_bilinear(torch.zeros(3, 4, 4), (8, 8))


def test_plain_interpolate_is_not_the_reference_on_a_downscale():
    x = np.random.default_rng(1).standard_normal((1, 3, 480, 640)) \
        .astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3, 312, 416),
                                      "bilinear"))
    plain = F.interpolate(torch.from_numpy(x), size=(312, 416),
                          mode="bilinear", align_corners=False).numpy()
    assert nmse(plain, ref) > 1e-3
    assert nmse(_resize_bilinear(torch.from_numpy(x), ref.shape).numpy(),
                ref) < TOL_CONV
