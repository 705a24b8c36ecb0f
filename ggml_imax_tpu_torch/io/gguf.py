"""GGUF v3 reader and writer: the port's own copy of
ggml_imax_tpu/io/gguf.py, numpy and the standard library only (the format:
the reference's docs/gguf.md:109-312; its reader gguf_init_from_file,
src/ggml.c:21869; its writer ggml.h:2357-2380).

The reader is mmap-based and zero-copy: tensor payloads are numpy views
into a read-only mapping (torch.from_numpy must not be given one; the
port's to_device_format builds new arrays from them). The writer holds the
tensors it is given until write() and writes each payload from its own
buffer, without a copy.
"""
from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np

from ..quant.formats import FORMATS, GGMLType, row_size

GGUF_MAGIC = 0x46554747  # "GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType:
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B", GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H", GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I", GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f", GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q", GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NUMPY_SIMPLE = {
    GGMLType.F32: np.dtype("<f4"),
    GGMLType.F16: np.dtype("<f2"),
    GGMLType.F64: np.dtype("<f8"),
    GGMLType.I8: np.dtype("i1"),
    GGMLType.I16: np.dtype("<i2"),
    GGMLType.I32: np.dtype("<i4"),
    GGMLType.I64: np.dtype("<i8"),
}


@dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]   # ggml order: ne[0] fastest (row length) first
    ggml_type: GGMLType
    offset: int              # relative to start of data section

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        info = FORMATS[self.ggml_type]
        return self.n_elements // info.block_size * info.type_size


class _Cursor:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return vals[0] if len(vals) == 1 else vals

    def read_str(self) -> str:
        n = self.read("<Q")
        s = bytes(self.buf[self.pos:self.pos + n]).decode("utf-8")
        self.pos += n
        return s

    def read_value(self, vtype: int):
        if vtype == GGUFValueType.STRING:
            return self.read_str()
        if vtype == GGUFValueType.ARRAY:
            itype = self.read("<I")
            n = self.read("<Q")
            if itype in _SCALAR_FMT and itype != GGUFValueType.BOOL:
                # fast path: bulk-read scalar arrays
                fmt = _SCALAR_FMT[itype]
                dt = np.dtype(fmt[1:]).newbyteorder("<")
                arr = np.frombuffer(self.buf, dtype=dt, count=n, offset=self.pos)
                self.pos += arr.nbytes
                return arr.copy()
            return [self.read_value(itype) for _ in range(n)]
        return self.read(_SCALAR_FMT[vtype])


class GGUFReader:
    """mmap-backed GGUF file. `metadata` is a plain dict; `tensors` maps
    name -> GGUFTensorInfo; `tensor_data(name)` returns a zero-copy uint8
    view of the encoded payload."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        cur = _Cursor(self._mm)

        magic = cur.read("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file (magic {magic:#x})")
        self.version = cur.read("<I")
        if self.version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {self.version}")
        n_tensors = cur.read("<q")
        n_kv = cur.read("<q")

        self.metadata: dict[str, Any] = {}
        # wire value-type per key, so a rewrite preserves widths exactly
        # (typed readers like gguf_get_val_u32 reject widened types)
        self.metadata_types: dict[str, int] = {}
        for _ in range(n_kv):
            key = cur.read_str()
            vtype = cur.read("<I")
            self.metadata[key] = cur.read_value(vtype)
            self.metadata_types[key] = vtype

        self.alignment = int(self.metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))

        self.tensors: dict[str, GGUFTensorInfo] = {}
        for _ in range(n_tensors):
            name = cur.read_str()
            n_dims = cur.read("<I")
            shape = tuple(cur.read("<Q") for _ in range(n_dims))
            if n_dims == 1:
                shape = (shape[0],)
            ttype = GGMLType(cur.read("<I"))
            offset = cur.read("<Q")
            self.tensors[name] = GGUFTensorInfo(name, shape, ttype, offset)

        # data section starts at the next alignment boundary
        pad = (-cur.pos) % self.alignment
        self.data_offset = cur.pos + pad

    def tensor_data(self, name: str) -> np.ndarray:
        """Zero-copy uint8 view of a tensor's encoded bytes."""
        info = self.tensors[name]
        start = self.data_offset + info.offset
        return np.frombuffer(self._mm, dtype=np.uint8, count=info.nbytes, offset=start)

    def tensor_array(self, name: str) -> np.ndarray:
        """Decode simple (non-quantized) tensors to a typed numpy view;
        quantized tensors are returned as raw uint8 (use quant.dequantize)."""
        info = self.tensors[name]
        raw = self.tensor_data(name)
        # numpy shape = reversed ggml ne (ne[0] is fastest-varying)
        np_shape = tuple(reversed(info.shape))
        if info.ggml_type in _NUMPY_SIMPLE:
            return raw.view(_NUMPY_SIMPLE[info.ggml_type]).reshape(np_shape)
        return raw

    def close(self):
        try:
            self._mm.close()
        except BufferError:
            # zero-copy tensor views are still alive; the mapping is released
            # when the last view is garbage-collected
            pass
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _value_type_of(v) -> int:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        return GGUFValueType.INT64 if v < 0 else GGUFValueType.UINT64
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    if isinstance(v, np.integer):
        return GGUFValueType.INT64 if v < 0 else GGUFValueType.UINT64
    if isinstance(v, np.floating):
        return GGUFValueType.FLOAT32
    raise TypeError(f"unsupported GGUF metadata value: {type(v)}")


_NP_TO_VT = {
    "u1": GGUFValueType.UINT8, "i1": GGUFValueType.INT8,
    "u2": GGUFValueType.UINT16, "i2": GGUFValueType.INT16,
    "u4": GGUFValueType.UINT32, "i4": GGUFValueType.INT32,
    "u8": GGUFValueType.UINT64, "i8": GGUFValueType.INT64,
    "f4": GGUFValueType.FLOAT32, "f8": GGUFValueType.FLOAT64,
}


class GGUFWriter:
    """Two-pass GGUF writer: stage metadata + tensor infos, then emit header
    followed by aligned tensor payloads."""

    def __init__(self, path: str | Path, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = Path(path)
        self.alignment = alignment
        self._kv: list[tuple[str, Any, int | None]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, np.ndarray]] = []
        self.add_kv("general.alignment", np.uint32(alignment))

    def add_kv(self, key: str, value: Any, vtype: int | None = None):
        """vtype pins the wire GGUFValueType (pass GGUFReader.metadata_types
        entries through on rewrite to keep KV sections byte-stable)."""
        self._kv.append((key, value, vtype))

    def add_tensor(self, name: str, data: np.ndarray, ggml_type: GGMLType,
                   shape: tuple[int, ...] | None = None):
        """data: encoded bytes (uint8) for quantized types, or a typed numpy
        array for simple types. shape is in ggml ne-order (row length first);
        if omitted it is derived from a typed array's numpy shape."""
        if shape is None:
            assert data.dtype != np.uint8 or ggml_type == GGMLType.I8, \
                "quantized tensors need an explicit shape"
            shape = tuple(reversed(data.shape))
        if data.dtype != np.uint8:
            data = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        data = np.ascontiguousarray(data)
        n_elements = int(np.prod(shape))
        expected = n_elements // FORMATS[ggml_type].block_size * FORMATS[ggml_type].type_size
        assert data.nbytes == expected, (name, data.nbytes, expected)
        self._tensors.append((name, shape, ggml_type, data))

    @staticmethod
    def _write_str(f: BinaryIO, s: str):
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _write_value(self, f: BinaryIO, v: Any, vtype: int | None = None):
        if vtype is None:
            vtype = _value_type_of(v)
        f.write(struct.pack("<I", vtype))
        self._write_scalar_or_composite(f, v, vtype)

    def _write_scalar_or_composite(self, f: BinaryIO, v: Any, vtype: int):
        if vtype == GGUFValueType.STRING:
            self._write_str(f, v)
        elif vtype == GGUFValueType.ARRAY:
            if isinstance(v, np.ndarray) and v.dtype.kind in "uif":
                code = v.dtype.kind + str(v.dtype.itemsize)
                itype = _NP_TO_VT[code]
                f.write(struct.pack("<IQ", itype, len(v)))
                f.write(np.ascontiguousarray(v).astype(v.dtype.newbyteorder("<")).tobytes())
            else:
                items = list(v)
                itype = (GGUFValueType.STRING if items and isinstance(items[0], str)
                         else _value_type_of(items[0]) if items else GGUFValueType.INT32)
                f.write(struct.pack("<IQ", itype, len(items)))
                for it in items:
                    self._write_scalar_or_composite(f, it, itype)
        else:
            f.write(struct.pack(_SCALAR_FMT[vtype], v))

    def write(self):
        with open(self.path, "wb") as f:
            f.write(struct.pack("<IIqq", GGUF_MAGIC, GGUF_VERSION,
                                len(self._tensors), len(self._kv)))
            # numpy scalar types preserved through add_kv for explicit widths
            for key, value, vtype in self._kv:
                self._write_str(f, key)
                if vtype is not None and vtype != GGUFValueType.ARRAY:
                    if isinstance(value, (np.integer, np.floating)):
                        value = value.item()
                    self._write_value(f, value, vtype)
                elif isinstance(value, np.integer):
                    code = ("u" if value.dtype.kind == "u" else "i") + str(value.dtype.itemsize)
                    self._write_value(f, int(value), _NP_TO_VT[code])
                elif isinstance(value, np.floating):
                    self._write_value(f, float(value),
                                      _NP_TO_VT["f" + str(value.dtype.itemsize)])
                else:
                    self._write_value(f, value)

            offset = 0
            offsets = []
            for name, shape, ttype, data in self._tensors:
                offsets.append(offset)
                self._write_str(f, name)
                f.write(struct.pack("<I", len(shape)))
                for d in shape:
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<IQ", int(ttype), offset))
                offset += data.nbytes
                offset += (-offset) % self.alignment

            f.write(b"\x00" * ((-f.tell()) % self.alignment))
            for (name, shape, ttype, data), off in zip(self._tensors, offsets):
                f.write(data.data)
                f.write(b"\x00" * ((-data.nbytes) % self.alignment))
