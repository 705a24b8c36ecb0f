"""The host C++ libraries: the block codecs (codecs.cpp) and the IQ
grid-search encoders (iq_encoders.cpp), the port's own copies of the JAX
package's native/ sources (counterpart of ggml_imax_tpu/native/__init__.py).

Each source is compiled at first use by one ``g++`` with the JAX package's
flags into ``build/ggml_imax_tpu_torch/lib<stem>.so`` beside the kernels'
library, and compiled again whenever the source, the flags or the CPU that
-march=native targets change (a SHA-256 stamp, as _build.py keeps for
nvcc). The build holds a file lock
(``fcntl.flock``), so processes that start together (pytest-xdist workers,
chip_smoke's host pool) build once, and the finished library is renamed
into place. The loaded library's ABI version is checked.

There is no quiet fallback: a missing ``g++`` or a failed build raises with
the compiler's output. At LLaMA-2 7B the numpy codecs would turn a
requantize of about 20 s into hours.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent.parent / "build" / "ggml_imax_tpu_torch"
# -ffp-contract=off: FMA contraction would merge a mul and an add into one
# rounding (inside nearest_int's operand, say) and break bit-exactness
FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fopenmp", "-shared",
         "-fPIC", "-fvisibility=hidden")

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_CODEC_NAMES = ("q4_0", "q4_1", "q5_0", "q5_1", "q8_0", "q8_1", "q2_K", "q3_K",
                "q4_K", "q5_K", "q6_K", "q8_K")
# library -> C entry -> (argtypes, restype)
_SIGNATURES = {
    "codecs": {
        # x or raw, out, blocks
        **{f"{c}_{d}": ([_P, _P, _I64], None) for c in _CODEC_NAMES
           for d in ("quantize", "dequantize")},
        "codecs_abi_version": ([], ctypes.c_int)},
    "iq_encoders": {
        # grid set, seeds, grid size
        "iq_init": ([ctypes.c_int, _P, ctypes.c_int], ctypes.c_int),
        # x, out, rows, row length, importance row or NULL
        **{f"{k}_quantize": ([_P, _P, _I64, _I64, _P], None)
           for k in ("iq2_xxs", "iq2_xs", "iq2_s", "iq3_xxs", "iq3_s",
                     "iq1_s", "iq1_m")},
        "iq_abi_version": ([], ctypes.c_int)},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}   # stem -> seconds of this process's g++


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the host libraries are "
                           f"built from {HERE}/*.cpp at first use")
    return gxx


def _target(gxx: str) -> str:
    """What -march=native means on this machine (g++'s target options):
    part of the stamp, so a library built for another CPU, in a copy of
    the checkout, is built again rather than loaded."""
    r = subprocess.run([gxx, "-march=native", "-Q", "--help=target"],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    return r.stdout


def _digest(src: Path, target: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(target.encode())
    h.update(src.read_bytes())
    return h.hexdigest()


def build(stem: str) -> Path:
    """Compile <stem>.cpp into BUILD_DIR/lib<stem>.so unless its stamp is
    current; raise RuntimeError with g++'s output if it cannot."""
    src = HERE / f"{stem}.cpp"
    so = BUILD_DIR / f"lib{stem}.so"
    stamp = BUILD_DIR / f"lib{stem}.sha256"
    gxx = _gxx()
    digest = _digest(src, _target(gxx))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"lib{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists() and stamp.exists() and stamp.read_text() == digest:
            return so
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = Path(tmp) / so.name
            t0 = time.perf_counter()
            r = subprocess.run([gxx, *FLAGS, str(src), "-o", str(out)],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
            BUILD_SECONDS[stem] = time.perf_counter() - t0
            if r.returncode:
                raise RuntimeError(f"g++ failed on {src.name} (exit "
                                   f"{r.returncode}):\n{r.stdout}")
            os.replace(out, so)
        stamp.write_text(digest)
    return so


def _load(stem: str, abi_symbol: str) -> ctypes.CDLL:
    with _lock:
        if stem not in _libs:
            cdll = ctypes.CDLL(str(build(stem)))
            for name, (argtypes, restype) in _SIGNATURES[stem].items():
                fn = getattr(cdll, name)
                fn.argtypes, fn.restype = argtypes, restype
            version = getattr(cdll, abi_symbol)()
            if version != 1:
                raise RuntimeError(f"lib{stem}.so: {abi_symbol}() is "
                                   f"{version}, expected 1")
            _libs[stem] = cdll
        return _libs[stem]


def lib() -> ctypes.CDLL:
    """The block-codec library (codecs.cpp), built first if needed."""
    return _load("codecs", "codecs_abi_version")


def iq_lib() -> ctypes.CDLL:
    """The IQ grid-search encoder library (iq_encoders.cpp), built first if
    needed. It keeps its grid and neighbour tables between calls
    (quant/iq_encode.py initialises each grid set once)."""
    return _load("iq_encoders", "iq_abi_version")
