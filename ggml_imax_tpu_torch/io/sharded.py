"""Shard-aware weight loading (counterpart of ggml_imax_tpu/io/sharded.py).

SURVEY §7 hard part (e): a 4 GB+ GGUF must not be replicated through every
rank's memory. Each ggml tensor is stored row-major (one output row = one
contiguous run of encoded blocks), so sharding along the output dimension
(our QTensor's N) maps to one contiguous byte range per rank: a rank reads
from the reader's mapping and lays out ONLY its rows — the replacement for
the reference's read-everything loader (gpt-2/main-backend.cpp:410-418).
"""
from __future__ import annotations

from ..quant.device import QTensor, to_device_format
from ..quant.formats import FORMATS, GGMLType
from .gguf import GGUFReader


def _row_bytes(t: GGMLType, n_per_row: int) -> int:
    info = FORMATS[t]
    if n_per_row % info.block_size:
        raise ValueError(f"{t.name}: rows of {n_per_row} elements")
    return n_per_row // info.block_size * info.type_size


def load_qtensor_sharded(reader: GGUFReader, name: str, rank: int,
                         size: int, *, device=None) -> QTensor:
    """Piece `rank` of `size` of a 2-D GGUF tensor cut along N (the output
    dim; rank and size: this process's index and count along the tp axis,
    e.g. a DeviceMesh's mesh["tp"].get_local_rank() and .size(), so no
    process group is needed): the contiguous row range [r0, r1) of the
    file, read from the reader's mapping and laid out by to_device_format
    on `device` (the card unless "cpu" is passed). A codebook's lut comes
    whole; nib2's sign bitplane is cut like q."""
    info = reader.tensors[name]
    if len(info.shape) != 2:
        raise ValueError(f"{name}: shape {info.shape} is not 2-D")
    k, n = info.shape                     # ggml ne[0] = row length, N rows
    if n % size:
        raise ValueError(f"{name}: N={n} over {size} shards")
    t = info.ggml_type
    rb = _row_bytes(t, k)
    r0, r1 = rank * n // size, (rank + 1) * n // size
    raw = reader.tensor_data(name)        # zero-copy mmap view
    return to_device_format(raw[r0 * rb:r1 * rb], t, (k, r1 - r0),
                            device=device)
