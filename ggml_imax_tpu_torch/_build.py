"""Build, load and count the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a``; the objects are linked into one shared
library with a plain C interface, ``build/ggml_imax_tpu_torch/libkernels.so``
beside the package, and loaded with ctypes. The build runs at first use
and again whenever a source or a flag changes (a SHA-256 stamp). A failed
build raises with nvcc's output.

Each C entry returns ``cudaGetLastError()`` right after its launch;
`check` raises on a nonzero code. `LAUNCHES` counts the launches of each
kernel; a wrapper adds one where, and only where, it launches its kernel,
and `CapturedLaunches` adds a captured graph's launches at each replay.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "ggml_imax_tpu_torch"
SOURCES = ("w4a8_gemv.cu", "w4a16_gemm.cu", "decode_attention.cu",
           "flash_attention.cu", "nat8_gemv.cu", "nat8_gemm.cu",
           "decode_attention_cells.cu", "decode_attention_update.cu",
           "flash_backward.cu", "permuted_gemm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argtypes (every pointer and the stream are c_void_p)
_SIGNATURES = {
    # x8, dx, q, scale, bias, xs, out, K, N, split, scale_is_bf16, stream
    "ggml_w4a8_gemv": [_P] * 7 + [_I] * 4 + [_P],
    # x, q, scale, bias, xs, out, M, K, N, split, scale_is_bf16, stream
    "ggml_w4a16_gemm": [_P] * 6 + [_I] * 5 + [_P],
    # x8, dx, q, scale, bias, xs, out, K, N, g, split, scale_is_bf16, stream
    "ggml_nat8_gemv": [_P] * 7 + [_I] * 5 + [_P],
    # x, q, scale, bias, xs, out, M, K, N, g, split, scale_is_bf16, stream
    "ggml_nat8_gemm": [_P] * 6 + [_I] * 6 + [_P],
    # q, k, v, ks, vs, mask, out, B, Hq, Hkv, D, T, split, scale, stream
    "ggml_decode_attention": [_P] * 7 + [_I] * 6 + [_F, _P],
    # q, k, v, mask, slopes, tiles, out, lse, B, Tq, Tk, Hq, Hkv, D, scale,
    # softcap, stream
    "ggml_flash_attention": [_P] * 8 + [_I] * 6 + [_F, _F, _P],
    # q, k, v, ks, vs, mask, out, NB, Hq, Hkv, D, T, split, scale, stream
    "ggml_decode_attention_cells": [_P] * 7 + [_I] * 6 + [_F, _P],
    # q, k, v, ks, vs, kn, vn, kns, vns, rows, mask, out, NB, Bk, Hq, Hkv, D,
    # T, split, scale, stream
    "ggml_decode_attention_update": [_P] * 12 + [_I] * 7 + [_F, _P],
    # q, k, v, dout, lse, di, mask, slopes, tiles, dq, B, Tq, Tk, Hq, Hkv, D,
    # scale, softcap, stream
    "ggml_flash_backward_dq": [_P] * 10 + [_I] * 6 + [_F, _F, _P],
    # the same with dk, dv in place of dq
    "ggml_flash_backward_dkv": [_P] * 11 + [_I] * 6 + [_F, _F, _P],
    # mask, tiles, B, Tq, Tk, stream
    "ggml_flash_backward_tiles": [_P, _P, _I, _I, _I, _P],
    # x, q, scale, bias, out, M, K, N, bk, g, zero, split, scale_is_bf16,
    # stream
    "ggml_planes_w4a16": [_P] * 5 + [_I] * 8 + [_P],
    # x, q, scale, bias, xs, out, M, K, N, bk, split, scale_is_bf16, stream
    "ggml_rowpair_w4a16": [_P] * 6 + [_I] * 6 + [_P],
    # x, q, scale, bias, xs, out, M, K, N, bk, g, split, scale_is_bf16, stream
    "ggml_int8_rows_w8a16": [_P] * 6 + [_I] * 7 + [_P],
}

LAUNCHES = {"w4a8_gemv": 0, "w4a16_gemm": 0, "decode_attention": 0,
            "flash_attention": 0, "nat8_w8a8": 0, "nat8_w8a16": 0,
            "decode_attention_cells": 0, "decode_attention_update": 0,
            "flash_backward_dq": 0, "flash_backward_dkv": 0,
            "flash_backward_tiles": 0,
            "planes_w4a16": 0, "rowpair_w4a16": 0, "int8_rows_w8a16": 0}

_lock = threading.Lock()
_lib = None
BUILD_LOG = ""          # nvcc's output (incl. -Xptxas -v) of the last build


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class CapturedLaunches:
    """The launches of a captured CUDA graph. A wrapper counts its launch on
    the host when it is called, and during a capture it is called but
    launches nothing; a replay launches every captured kernel but calls no
    wrapper. So `capture()` records the counts a capture added and takes
    them back, and `replayed()` adds them once a replay."""

    def __init__(self):
        self.delta: dict[str, int] = {}

    @contextlib.contextmanager
    def capture(self):
        before = dict(LAUNCHES)
        try:
            yield self
        finally:
            self.delta = {k: LAUNCHES[k] - n for k, n in before.items()
                          if LAUNCHES[k] != n}
            LAUNCHES.update(before)

    def replayed(self):
        for k, n in self.delta.items():
            LAUNCHES[k] += n


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the sources into libkernels.so unless the stamp is current."""
    global BUILD_LOG
    so = BUILD_DIR / "libkernels.so"
    stamp = BUILD_DIR / "libkernels.sha256"
    digest = _digest()
    if so.exists() and stamp.exists() and stamp.read_text() == digest:
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for name, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            if p.returncode:
                failed.append(name)
        BUILD_LOG = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
        tmp_so = Path(tmp) / "libkernels.so"
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_so), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"linking libkernels.so failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    stamp.write_text(digest)
    return so


def lib():
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                f = getattr(handle, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(rc: int, kernel: str):
    """Raise on the cudaError_t a C entry returned after its launch."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


def stream_ptr(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
