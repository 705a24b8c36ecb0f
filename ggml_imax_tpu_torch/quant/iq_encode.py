"""The IQ codebook encoders (IQ2_XXS/XS/S, IQ3_XXS/S, IQ1_S/M): the port's
copy of ggml_imax_tpu/quant/iq_encode.py, the Python face of
native/iq_encoders.cpp (the reference's quantize_iq2_xxs and siblings).

The l-value seed tables are derived here from the formats' decode grids
(this package's quant/iq_grids.npz, the ggml-common.h codebooks) and handed
to the C++ init, which builds the exact-match map and the nearest-neighbour
lists (the iq2xs_init_impl / iq3xs_init_impl analogs).

There is no numpy version: the searches are sequential coordinate-descent
and grid walks, and bit-exactness with the reference needs C float
semantics. The library is built at first use (native.iq_lib); a failed
build raises.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..native import iq_lib
from .formats import FORMATS, GGMLType

# grid-set ids in iq_encoders.cpp
_GS_IQ2_XXS, _GS_IQ2_XS, _GS_IQ2_S, _GS_IQ1, _GS_IQ3_256, _GS_IQ3_512 = range(6)

_SPEC = {
    # type -> (grid-set id, npz grid name, C symbol, importance required)
    GGMLType.IQ2_XXS: (_GS_IQ2_XXS, "iq2xxs_grid", "iq2_xxs_quantize", True),
    GGMLType.IQ2_XS: (_GS_IQ2_XS, "iq2xs_grid", "iq2_xs_quantize", True),
    GGMLType.IQ2_S: (_GS_IQ2_S, "iq2s_grid", "iq2_s_quantize", False),
    GGMLType.IQ3_XXS: (_GS_IQ3_256, "iq3xxs_grid", "iq3_xxs_quantize", False),
    GGMLType.IQ3_S: (_GS_IQ3_512, "iq3s_grid", "iq3_s_quantize", False),
    GGMLType.IQ1_S: (_GS_IQ1, "iq1s_grid", "iq1_s_quantize", True),
    GGMLType.IQ1_M: (_GS_IQ1, "iq1s_grid", "iq1_m_quantize", False),
}

_INITED: set[int] = set()


def _seeds(name: str, grid: np.ndarray) -> np.ndarray:
    """A decode grid -> the packed l-value seed table (the kgrid_* constants
    of iq2xs_init_impl / iq3xs_init_impl). The decode tables hold each
    lattice coordinate as its dequantized magnitude (a codebook value, such
    as {8, 25, 43, 62} for iq2_xxs or {-1, 0, 1} for iq1), the init works on
    the quant level l; both keep the grid's order, so l is the rank of the
    coordinate's value among the grid's sorted distinct values."""
    if name.startswith("iq3"):
        b = grid.astype(np.uint32).view(np.uint8).reshape(-1, 4)
        bits, npos = 3, 4
    elif name == "iq1s_grid":
        b = grid.view(np.int8).reshape(-1, 8)
        bits, npos = 2, 8
    else:
        b = grid.view(np.uint8).reshape(-1, 8)
        bits, npos = 2, 8
    vals = np.unique(b)
    if len(vals) > 1 << bits:
        raise ValueError(f"{name}: {len(vals)} distinct values")
    l = np.searchsorted(vals, b).astype(np.uint16)
    return (l << (bits * np.arange(npos, dtype=np.uint16))).sum(
        1, dtype=np.uint16)


def available() -> bool:
    """Whether the encoder library loads (it is built if needed; a failed
    build raises rather than answering False)."""
    return iq_lib() is not None


def _ensure_init(t: GGMLType):
    lib = iq_lib()
    gs, grid_name, _, _ = _SPEC[t]
    if gs in _INITED:
        return lib
    z = np.load(Path(__file__).parent / "iq_grids.npz")
    seeds = np.ascontiguousarray(_seeds(grid_name, z[grid_name]))
    rc = lib.iq_init(gs, seeds.ctypes.data, len(seeds))
    if rc != 0:
        raise RuntimeError(f"iq_init({t.name}) returned {rc}")
    _INITED.add(gs)
    return lib


def quantize_iq(x2d: np.ndarray, t: GGMLType,
                qw: np.ndarray | None = None) -> np.ndarray:
    """Encode an (nrow, n) f32 matrix to raw IQ blocks -> (nrow, row bytes)
    uint8. `qw` is the per-column importance row (an imatrix row), required
    for IQ2_XXS, IQ2_XS and IQ1_S (ggml_quantize_requires_imatrix)."""
    lib = _ensure_init(t)
    _, _, sym, qw_required = _SPEC[t]
    x2d = np.ascontiguousarray(x2d, dtype=np.float32)
    nrow, n = x2d.shape
    if n % 256:
        raise ValueError(f"rows of {n}: the IQ formats need multiples of 256")
    if qw is None and qw_required:
        raise ValueError(f"{t.name} requires an importance matrix "
                         "(ggml_quantize_requires_imatrix)")
    qw_ptr = None
    if qw is not None:
        qw = np.ascontiguousarray(qw, dtype=np.float32)
        if qw.shape != (n,):
            raise ValueError(f"importance row {qw.shape}, expected ({n},)")
        qw_ptr = qw.ctypes.data
    out = np.zeros((nrow, n // 256 * FORMATS[t].type_size), dtype=np.uint8)
    getattr(lib, sym)(x2d.ctypes.data, out.ctypes.data, nrow, n, qw_ptr)
    return out
