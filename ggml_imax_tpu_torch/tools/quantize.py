"""Model requantization, the quantize CLI's engine (counterpart of
ggml_imax_tpu/tools/quantize.py).

As ggml_common_quantize_0 (examples/common-ggml.cpp) does: walk the
model's tensors; re-encode the 2-D weight matrices whose names match the
include patterns to the target type (ggml_quantize_chunk, here
quant.imatrix.quantize_rows: the C++ codecs, the imatrix quantizers, or
the IQ grid-search encoders); keep everything else (biases, norms, 1-D
tensors) byte for byte, and update the file type.
"""
from __future__ import annotations

import fnmatch
from pathlib import Path

import numpy as np

from ..io.gguf import GGUFReader, GGUFWriter
from ..io.legacy_bin import read_legacy_bin, write_legacy_bin
from ..quant import codecs
from ..quant.formats import FORMATS, GGMLType
from ..quant.imatrix import quantize_rows

# common-ggml quantizes the matmul weights only: embeddings, norms and
# biases stay in their source precision
DEFAULT_INCLUDE = ("*.weight", "*_w", "*/w")
QUANTIZABLE_SRC = (GGMLType.F32, GGMLType.F16, GGMLType.BF16,
                   GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0,
                   GGMLType.Q5_1, GGMLType.Q8_0, GGMLType.Q2_K,
                   GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K,
                   GGMLType.Q6_K)


def _requantized(name, shape, src_type, raw, ttype, include, imatrix):
    """The tensor's bytes in ttype, or None when it is kept as it is."""
    if not (len(shape) == 2 and src_type in QUANTIZABLE_SRC
            and src_type != ttype
            and any(fnmatch.fnmatch(name, pat) for pat in include)
            and shape[0] % FORMATS[ttype].block_size == 0):
        return None
    n_per_row = shape[0]                        # ggml ne[0], the row length
    x = codecs.dequantize(raw, src_type,
                          shape=(int(np.prod(shape)) // n_per_row, n_per_row))
    return quantize_rows(x, ttype, imatrix=(imatrix or {}).get(name))


def requantize_gguf(src: str | Path, dst: str | Path, ttype: GGMLType, *,
                    include=DEFAULT_INCLUDE, imatrix: dict | None = None,
                    verbose: bool = False) -> dict:
    """Re-encode a GGUF model's weight matrices to `ttype`. Every metadata
    key keeps its wire type; general.file_type becomes ttype.
    imatrix: {tensor name: (n_per_row,) float32 importance row}.
    Returns {name: (source type, written type, bytes in, bytes out)}."""
    ttype = GGMLType(ttype)
    stats = {}
    with GGUFReader(src) as r:
        w = GGUFWriter(dst)
        for k, v in r.metadata.items():
            if k == "general.alignment":
                continue
            if k == "general.file_type":
                v = int(ttype)
            # typed readers (gguf_get_val_u32 and kin) refuse a widened type
            w.add_kv(k, v, vtype=r.metadata_types.get(k))
        if "general.file_type" not in r.metadata:
            w.add_kv("general.file_type", int(ttype))
        for name, info in r.tensors.items():
            raw = r.tensor_data(name)
            enc = _requantized(name, info.shape, info.ggml_type, raw, ttype,
                               include, imatrix)
            if enc is None:
                w.add_tensor(name, raw.copy(), info.ggml_type,
                             shape=info.shape)
                stats[name] = (info.ggml_type, info.ggml_type, raw.nbytes,
                               raw.nbytes)
            else:
                w.add_tensor(name, enc, ttype, shape=info.shape)
                stats[name] = (info.ggml_type, ttype, raw.nbytes, enc.nbytes)
                if verbose:
                    print(f"  {name}: {info.ggml_type.name} -> {ttype.name} "
                          f"({raw.nbytes} -> {enc.nbytes} bytes)")
        w.write()
    return stats


def requantize_legacy_bin(src: str | Path, dst: str | Path, ttype: GGMLType,
                          hparam_names: list[str], *,
                          include=DEFAULT_INCLUDE, has_vocab: bool = True,
                          imatrix: dict | None = None) -> dict:
    """Re-encode a legacy ggml .bin model (the gpt-2 / gpt-j / whisper
    layout; the per-model quantize.cpp programs). The ftype hparam becomes
    GGML_QNT_VERSION (2) * 1000 + ttype, as common-ggml writes it."""
    ttype = GGMLType(ttype)
    f = read_legacy_bin(src, hparam_names, has_vocab=has_vocab)
    stats, out = {}, {}
    for name, tt in f.tensors.items():
        enc = _requantized(name, tt.shape, tt.ggml_type, tt.data, ttype,
                           include, imatrix)
        if enc is None:
            out[name] = (tt.ggml_type, tt.shape, tt.data)
            stats[name] = (tt.ggml_type, tt.ggml_type, tt.data.nbytes,
                           tt.data.nbytes)
        else:
            out[name] = (ttype, tt.shape, enc)
            stats[name] = (tt.ggml_type, ttype, tt.data.nbytes, enc.nbytes)
    hp = dict(f.hparams)
    if "ftype" in hp:
        hp["ftype"] = 2000 + int(ttype)
    write_legacy_bin(dst, hp, hparam_names, f.vocab, out)
    return stats
