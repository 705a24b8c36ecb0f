"""Port parity: the host C++ codecs (ggml_imax_tpu_torch/native/codecs.cpp)
and their build.

- codecs.quantize / dequantize of every type of _NATIVE_QUANT, which run
  the port's native library, bit-equal to the JAX package's public
  codecs.quantize / dequantize (its own native library) on a few seeds of
  the rounding-edge data the K-quant tests use.
- The numpy plain versions (_QUANTIZERS, _DEQUANTIZERS, called by name)
  bit-equal to the JAX package's numpy twins.
- Q4_K and Q5_K: the native and numpy loops disagree on some seeds of
  standard normal data, in the JAX package as in the port (ROADMAP Queue
  3). On such seeds the port's native bytes equal the JAX native bytes and
  its numpy bytes the JAX numpy bytes; both routes equal the golden
  vectors of the compiled reference.
- The build: a missing g++ or a failing compile raises (no numpy
  fallback), the library is built once under a file lock however many
  threads ask at once, and the stamp holds the digest of source, flags
  and the CPU -march=native targets.
All comparisons are exact (assert_array_equal).
"""
import os
import threading
from pathlib import Path

import numpy as np
import pytest

from ggml_imax_tpu.quant import codecs as jcodecs
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch import native
from ggml_imax_tpu_torch.quant import codecs as tcodecs
from ggml_imax_tpu_torch.quant.formats import GGMLType

from test_torch_kquant import interesting_data

NATIVE = [t.name for t in tcodecs._NATIVE_QUANT]
NUMPY = [t.name for t in tcodecs._QUANTIZERS]
GOLDEN = Path(__file__).parent / "fixtures" / "golden_quant.npz"
# standard normal seeds (16 super-blocks) where the native and numpy
# routes of the JAX package give different bytes
DISAGREE = {"Q4_K": 3, "Q5_K": 13}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fmt", NATIVE)
def test_native_codecs_equal_the_jax_public_codecs(fmt, seed):
    x = interesting_data(np.random.default_rng(seed), 256 * 16)
    got = tcodecs.quantize(x, GGMLType[fmt])
    ref = np.asarray(jcodecs.quantize(x, JType[fmt])).reshape(-1)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tcodecs.dequantize(got, GGMLType[fmt], shape=(16, 256)),
        np.asarray(jcodecs.dequantize(ref, JType[fmt], shape=(16, 256))))


@pytest.mark.parametrize("fmt", NUMPY)
def test_numpy_plain_versions_equal_the_jax_twins(fmt):
    x = interesting_data(np.random.default_rng(4), 256 * 16)
    got = tcodecs._QUANTIZERS[GGMLType[fmt]](x).reshape(-1)
    ref = np.asarray(jcodecs._QUANTIZERS[JType[fmt]](x)).reshape(-1)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tcodecs._DEQUANTIZERS[GGMLType[fmt]](got),
                                  jcodecs._DEQUANTIZERS[JType[fmt]](ref))


@pytest.mark.parametrize("fmt", sorted(DISAGREE))
def test_native_and_numpy_each_match_their_jax_route(fmt):
    x = np.random.default_rng(DISAGREE[fmt]).standard_normal(256 * 16) \
        .astype(np.float32)
    t, j = GGMLType[fmt], JType[fmt]
    native_bytes = tcodecs._native_quantize(x, t)
    numpy_bytes = tcodecs._QUANTIZERS[t](x).reshape(-1)
    assert not np.array_equal(native_bytes, numpy_bytes)
    np.testing.assert_array_equal(native_bytes,
                                  jcodecs._native_quantize(x, j))
    np.testing.assert_array_equal(
        numpy_bytes, np.asarray(jcodecs._QUANTIZERS[j](x)).reshape(-1))
    gold = np.load(GOLDEN)
    name = fmt[:2].lower() + fmt[2:]
    for row in ("x", "x2", "x3"):
        want = gold[f"{row}_{name}_bytes"]
        np.testing.assert_array_equal(tcodecs._native_quantize(gold[row], t),
                                      want)
        np.testing.assert_array_equal(
            tcodecs._QUANTIZERS[t](gold[row]).reshape(-1), want)


def test_native_refuses_partial_blocks():
    with pytest.raises(ValueError, match="whole number"):
        tcodecs.quantize(np.ones(48, np.float32), GGMLType.Q4_0)


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """The loader pointed at an empty build directory, nothing loaded."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    return tmp_path


def test_missing_gxx_raises(fresh_build, monkeypatch):
    monkeypatch.setenv("PATH", str(fresh_build))        # no g++ there
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tcodecs.quantize(np.ones(256, np.float32), GGMLType.Q4_0)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tcodecs.dequantize(np.zeros(18, np.uint8), GGMLType.Q4_0)


def test_failed_build_raises_with_the_compiler_output(fresh_build,
                                                      monkeypatch):
    src = fresh_build / "src"
    src.mkdir()
    (src / "codecs.cpp").write_text("int broken(void) { return }\n")
    monkeypatch.setattr(native, "HERE", src)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on codecs.cpp"
                       "(.|\\n)*error"):
        native.lib()
    assert not (native.BUILD_DIR / "libcodecs.so").exists()


def test_build_runs_once_under_the_lock(fresh_build, monkeypatch):
    """Four threads ask for the library at once: one g++ compiles (a
    wrapper on PATH logs each call; the others only ask what -march=native
    means), the others wait on the lock and find the stamp current."""
    log = fresh_build / "calls.log"
    wrapper = fresh_build / "bin" / "g++"
    wrapper.parent.mkdir()
    real = os.popen("command -v g++").read().strip()
    wrapper.write_text(f'#!/bin/sh\necho "$@" >> "{log}"\nexec "{real}" "$@"\n')
    wrapper.chmod(0o755)
    monkeypatch.setenv("PATH", f"{wrapper.parent}:{os.environ['PATH']}")
    errors = []

    def ask():
        try:
            native.build("codecs")
        except Exception as e:                        # pragma: no cover
            errors.append(e)
    threads = [threading.Thread(target=ask) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    calls = log.read_text().splitlines()
    assert sum(" -o " in c for c in calls) == 1 and len(calls) == 5
    stamp = (native.BUILD_DIR / "libcodecs.sha256").read_text()
    assert stamp == native._digest(native.HERE / "codecs.cpp",
                                   native._target(native._gxx()))
    assert native.lib().codecs_abi_version() == 1
