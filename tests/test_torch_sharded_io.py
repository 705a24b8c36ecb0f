"""Port parity: shard-aware GGUF loading (ggml_imax_tpu_torch/io/
sharded.py). Each rank's piece from `load_qtensor_sharded(reader, name,
rank, size)` — no process group: rank and size are plain arguments — is
bit-equal to the JAX `load_qtensor_sharded`'s shard on the same device
index of a 4-device mesh, for tests/test_sharded_loading.py:17's types
(block formats, F32, and the codebook kinds: lut whole, signs cut like q),
and the pieces together equal the port's whole load."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ggml_imax_tpu.io.gguf import GGUFWriter
from ggml_imax_tpu.io.sharded import load_qtensor_sharded as jload
from ggml_imax_tpu.quant.formats import GGMLType
from ggml_imax_tpu.quant.imatrix import quantize_rows
from ggml_imax_tpu_torch.io.gguf import GGUFReader
from ggml_imax_tpu_torch.io.sharded import load_qtensor_sharded
from ggml_imax_tpu_torch.quant.device import to_device_format

N_SHARDS = 4
PARTS = ("q", "scale", "bias", "signs")


def _jax_shards(arr):
    """A sharded jax.Array's pieces by their column start, as numpy."""
    return [np.asarray(s.data) for s in sorted(
        arr.addressable_shards, key=lambda s: s.index[1].start or 0)]


@pytest.mark.parametrize("t", [GGMLType.Q4_0, GGMLType.Q8_0, GGMLType.Q4_K,
                               GGMLType.F32, GGMLType.IQ3_S,
                               GGMLType.IQ2_S])
def test_sharded_load_matches_jax_shards(tmp_path, t):
    k, n = 256, 32
    x = np.random.default_rng(int(t)).standard_normal((n, k)) \
        .astype(np.float32)
    p = tmp_path / "w.gguf"
    w = GGUFWriter(p)
    w.add_tensor("w", quantize_rows(x, t), t, shape=(k, n))
    w.write()
    from ggml_imax_tpu.io.gguf import GGUFReader as JReader
    with JReader(p) as jr:
        ref = jload(jr, "w", Mesh(np.array(jax.devices()[:N_SHARDS]),
                                  ("tp",)))
    with GGUFReader(p) as r:
        full = to_device_format(r.tensor_data("w"), t, (k, n), device="cpu")
        pieces = [load_qtensor_sharded(r, "w", i, N_SHARDS, device="cpu")
                  for i in range(N_SHARDS)]
    for part in PARTS:
        want = getattr(ref, part)
        if want is None:
            assert all(getattr(qt, part) is None for qt in pieces), part
            continue
        for qt, shard in zip(pieces, _jax_shards(want)):
            np.testing.assert_array_equal(getattr(qt, part).numpy(), shard)
        np.testing.assert_array_equal(
            torch.cat([getattr(qt, part) for qt in pieces], dim=1).numpy(),
            getattr(full, part).numpy())
    for qt in pieces:
        assert (qt.kind, qt.k, qt.n, qt.ggml_type, qt.zero) == \
            (ref.kind, k, n // N_SHARDS, t, ref.zero)
        if ref.lut is None:
            assert qt.lut is None
        else:
            np.testing.assert_array_equal(qt.lut.numpy(),
                                          np.asarray(ref.lut))


def test_sharded_load_refuses_uneven_rows(tmp_path):
    p = tmp_path / "w.gguf"
    w = GGUFWriter(p)
    w.add_tensor("w", quantize_rows(np.ones((30, 64), np.float32),
                                    GGMLType.Q8_0), GGMLType.Q8_0,
                 shape=(64, 30))
    w.write()
    with GGUFReader(p) as r, pytest.raises(ValueError, match="N=30"):
        load_qtensor_sharded(r, "w", 0, 4, device="cpu")
