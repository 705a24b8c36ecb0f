"""Computation-graph export and import (counterpart of
ggml_imax_tpu/io/graph_export.py, the ggml_graph_export/import analog):
a function is traced once and saved as a file that a later process runs
without the model's code.

Where the JAX package writes jax.export's StableHLO, this writes a
torch.export ExportedProgram (`torch.export.save`), traced at the example
arguments' fixed shapes on their device. The kernels of a GPT-J decode step
are in the graph as the custom ops of ops/library.py, so a replay on the
card launches the hand-written kernels (and counts them) and a replay on
the CPU runs their plain versions.

File layout, as the JAX package's: MAGIC, a little-endian u32 header
length, a JSON header (``version``, ``n_in``, ``format`` "torch.export",
``device`` the traced device type), then the blob. The two packages'
artifacts are not interchangeable: `load_graph` refuses a StableHLO file
by name.

What the artifact holds: the graph and the tensors the traced function
closes over (MNIST's `export_model` freezes its weights in that way).
Arguments are not saved: torch.export keeps its example inputs for a
reload, and those would be a model's weights where they are passed as
arguments (a GPT-J step's params), so they are dropped before saving.

Arguments may be pytrees of tensors with QTensor and KVCache nodes,
registered here with torch's pytree (their tensors the children,
everything else the context, GGMLType as an int in the file). An
in-place write to an argument (the KV arena) is replayed in place.
"""
from __future__ import annotations

import io
import json
import struct
import time
import zipfile
from pathlib import Path

import torch
import torch.utils._pytree as pytree

from ..models.common import KVCache
from ..ops import library  # noqa: F401  (registers the kernels' ops)
from ..ops.conv import _cudnn_without_tf32
from ..quant.device import QTensor
from ..quant.formats import GGMLType

MAGIC = b"GITG"          # ggml-imax-tpu graph
VERSION = 1
FORMAT = "torch.export"

_QT_TENSORS = ("q", "scale", "bias", "lut", "signs")
_QT_CONTEXT = ("kind", "k", "n", "ggml_type", "zero", "interleaved_bk",
               "q4_layout", "name", "n_stack")
_KV_TENSORS = ("k", "v", "ks", "vs")


def _register(cls, tensors, context, name, dump, load):
    def flatten(x):
        return ([getattr(x, f) for f in tensors],
                tuple(getattr(x, f) for f in context))

    def flatten_with_keys(x):
        children, ctx = flatten(x)
        return ([(pytree.GetAttrKey(f), c) for f, c in zip(tensors, children)],
                ctx)

    def unflatten(children, ctx):
        return cls(**dict(zip(tensors, children)), **dict(zip(context, ctx)))

    pytree.register_pytree_node(
        cls, flatten, unflatten, serialized_type_name=name,
        to_dumpable_context=dump, from_dumpable_context=load,
        flatten_with_keys_fn=flatten_with_keys)


def _register_serializations():
    """QTensor and KVCache as pytree nodes a saved graph can name (the JAX
    package's ser_qt / des_qt: GGMLType written as an int)."""
    i = _QT_CONTEXT.index("ggml_type")

    def dump_qt(ctx):
        return json.dumps([int(v) if j == i else v for j, v in enumerate(ctx)])

    def load_qt(s):
        return tuple(GGMLType(v) if j == i else v
                     for j, v in enumerate(json.loads(s)))

    _register(QTensor, _QT_TENSORS, _QT_CONTEXT, "ggml_imax_tpu_torch.QTensor",
              dump_qt, load_qt)
    _register(KVCache, _KV_TENSORS, ("heads",), "ggml_imax_tpu_torch.KVCache",
              lambda ctx: json.dumps(list(ctx)),
              lambda s: tuple(json.loads(s)))


_register_serializations()


class _Fn(torch.nn.Module):
    """A function as the module torch.export traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _device_type(args) -> str:
    types = {t.device.type for t in pytree.tree_leaves(args)
             if isinstance(t, torch.Tensor)}
    return "cuda" if "cuda" in types else "cpu"


def export_graph(fn, example_args, path: str | Path) -> dict:
    """Trace fn(*example_args) (tensors, or pytrees of tensors, QTensors
    and KVCaches) and write a self-contained graph: the examples' shapes,
    dtypes and device are fixed; their values are not saved. Returns the
    seconds spent tracing and saving and the file's bytes."""
    example_args = tuple(example_args)
    t0 = time.perf_counter()
    ep = torch.export.export(_Fn(fn), example_args, strict=False)
    t1 = time.perf_counter()
    ep._example_inputs = None             # the arguments: not saved
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    header = json.dumps({"version": VERSION, "n_in": len(example_args),
                         "format": FORMAT,
                         "device": _device_type(example_args)}).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(buf.getvalue())
    return {"trace_s": t1 - t0, "save_s": time.perf_counter() - t1,
            "bytes": 8 + len(header) + buf.getbuffer().nbytes}


def load_graph(path: str | Path):
    """Read an exported graph; returns a callable running it on arguments
    of the traced structure, shapes and device (the ggml_graph_import
    analog). The callable runs with cuDNN's TF32 off, the flag the port's
    convolutions set around each call (ops/conv.py), which a traced graph
    does not record."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != MAGIC:
            raise ValueError(f"{path}: not an exported graph (magic {magic!r})")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen))
        if header.get("format") != FORMAT:
            raise ValueError(
                f"{path}: a graph exported by the JAX package (StableHLO for "
                f"{header.get('platforms')}), not a torch.export program; "
                "export it with ggml_imax_tpu_torch.io.graph_export")
        if header["version"] != VERSION:
            raise ValueError(f"unsupported graph version {header['version']}")
        blob = f.read()
    mod = torch.export.load(io.BytesIO(blob)).module()

    def run(*args):
        with _cudnn_without_tf32():
            return mod(*args)
    run.header = header
    return run


def stored_tensor_bytes(path: str | Path) -> int:
    """The bytes of the tensors an exported graph stores (torch.export's
    weights, constants and example inputs: the archive's entries under
    data/ but their JSON configs); 0 where the arguments carry every
    tensor."""
    with open(path, "rb") as f:
        f.seek(4)
        (hlen,) = struct.unpack("<I", f.read(4))
        f.seek(8 + hlen)
        z = zipfile.ZipFile(io.BytesIO(f.read()))
    return sum(i.file_size for i in z.infolist()
               if "/data/" in i.filename and not i.filename.endswith(".json"))
