"""Legacy ggml ``.bin`` checkpoints (pre-GGUF): the port's own copy of
ggml_imax_tpu/io/legacy_bin.py, numpy and the standard library only.

Layout as the reference examples read it (the gpt-2 loader,
examples/gpt-2/main-backend.cpp:111-434):

    u32 magic (0x67676d6c)
    i32 hparams[n]           (model-specific count)
    vocab: i32 n_vocab, then n_vocab x { u32 len, bytes }
    tensors until EOF: { i32 n_dims, i32 name_len, i32 ttype,
                         i32 ne[n_dims], name bytes, payload }

gpt-j's layout is the same with other hparams. Whisper's files add mel
filters before the vocab and are read by models/whisper.load_legacy.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..quant.formats import FORMATS, GGMLType

GGML_FILE_MAGIC = 0x67676D6C
GGML_QNT_VERSION_FACTOR = 1000


@dataclass
class LegacyTensor:
    name: str
    shape: tuple[int, ...]   # ggml ne-order
    ggml_type: GGMLType
    data: np.ndarray         # raw encoded bytes (uint8 view into file buffer)


@dataclass
class LegacyModelFile:
    hparams: dict[str, int]
    vocab: list[bytes]
    tensors: dict[str, LegacyTensor]

    @property
    def qnt_version(self) -> int:
        return self.hparams.get("ftype", 0) // GGML_QNT_VERSION_FACTOR

    @property
    def ftype(self) -> int:
        return self.hparams.get("ftype", 0) % GGML_QNT_VERSION_FACTOR


def read_legacy_bin(path: str | Path, hparam_names: list[str],
                    has_vocab: bool = True) -> LegacyModelFile:
    """hparam_names: ordered i32 header fields for this model family, e.g.
    gpt-2: ["n_vocab","n_ctx","n_embd","n_head","n_layer","ftype"]
    gpt-j: ["n_vocab","n_ctx","n_embd","n_head","n_layer","n_rot","ftype"]
    The whole file is read into one host buffer; each tensor's data is a
    view into it."""
    buf = np.fromfile(path, dtype=np.uint8)
    pos = 0

    def rd(fmt):
        nonlocal pos
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, buf, pos)
        pos += size
        return vals[0] if len(vals) == 1 else vals

    magic = rd("<I")
    if magic != GGML_FILE_MAGIC:
        raise ValueError(f"{path}: bad magic {magic:#x}")

    hparams = {name: rd("<i") for name in hparam_names}

    vocab = []
    if has_vocab:
        n_vocab = rd("<i")
        for _ in range(n_vocab):
            ln = rd("<I")
            vocab.append(bytes(buf[pos:pos + ln]))
            pos += ln

    tensors: dict[str, LegacyTensor] = {}
    total = buf.nbytes
    while pos + 12 <= total:
        n_dims, name_len, ttype = rd("<iii")
        ne = [rd("<i") for _ in range(n_dims)]
        name = bytes(buf[pos:pos + name_len]).decode("utf-8")
        pos += name_len
        t = GGMLType(ttype)
        info = FORMATS[t]
        n_elem = int(np.prod(ne))
        nbytes = n_elem // info.block_size * info.type_size
        data = buf[pos:pos + nbytes]
        pos += nbytes
        tensors[name] = LegacyTensor(name, tuple(ne), t, data)

    return LegacyModelFile(hparams, vocab, tensors)


def write_legacy_bin(path: str | Path, hparams: dict[str, int],
                     hparam_names: list[str], vocab: list[bytes],
                     tensors: dict[str, tuple[GGMLType, tuple[int, ...], np.ndarray]],
                     has_vocab: bool = True) -> None:
    """Write a legacy ggml .bin (the inverse of read_legacy_bin; the layout
    the reference's convert scripts write, e.g.
    gpt-2/convert-ckpt-to-ggml.py). tensors: name -> (type, ne_shape,
    encoded bytes or a typed array of the simple types). The payloads are
    written one at a time, so the file is never held whole in memory."""
    with open(path, "wb") as f:
        f.write(struct.pack("<I", GGML_FILE_MAGIC))
        for name in hparam_names:
            f.write(struct.pack("<i", hparams[name]))
        if has_vocab:
            f.write(struct.pack("<i", len(vocab)))
            for tok in vocab:
                b = tok if isinstance(tok, bytes) else str(tok).encode()
                f.write(struct.pack("<I", len(b)))
                f.write(b)
        for name, (t, ne, raw) in tensors.items():
            nb = name.encode()
            f.write(struct.pack("<iii", len(ne), len(nb), int(t)))
            for d in ne:
                f.write(struct.pack("<i", d))
            f.write(nb)
            raw = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
            info = FORMATS[t]
            expect = int(np.prod(ne)) // info.block_size * info.type_size
            assert raw.nbytes == expect, (name, raw.nbytes, expect)
            f.write(raw.data)
