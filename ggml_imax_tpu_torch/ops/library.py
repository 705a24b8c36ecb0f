"""The kernels of a GPT-J decode step as torch custom ops, so that a step
can be traced by torch.export and replayed from a saved graph
(io/graph_export.py).

The wrappers launch their kernels through ctypes with `data_ptr()`, which
a traced (fake) tensor has not; an op hides the launch from the tracer
behind a `register_fake` that gives the output's shape and dtype. Each op
takes tensors, optional tensors, ints and floats (a QTensor unpacked into
its fields) and has two implementations, chosen by the device its tensors
are on and by nothing else: on CUDA the wrapper's launch (the same C
entry, counted in `_build.LAUNCHES`, raising where the wrapper raises), on
the CPU the kernel's plain version. The wrappers route through the ops
only while `torch.compiler.is_exporting()`; the eager and CUDA-graph paths
call the wrappers as before.

    ggml_imax_tpu_torch::w4a8_gemv                qmm.w4a8_gemv
    ggml_imax_tpu_torch::decode_attention         decode_attention.decode_attention_kernel
    ggml_imax_tpu_torch::decode_attention_update  decode_attention.decode_attention_update_kernel
                                                  (writes the fresh rows into k, v, ks, vs)
"""
from __future__ import annotations

from typing import Optional

import torch

from ..quant.device import QTensor
from ..quant.formats import GGMLType
from . import decode_attention as _da
from . import qmm as _qmm

_NS = "ggml_imax_tpu_torch"


def _natpair(q, scale, bias, k: int, n: int, ggml_type: int) -> QTensor:
    """The natpair QTensor the W4A8 kernel reads (its other fields do not
    reach the launch)."""
    return QTensor("nib4", q, scale, bias, k, n, GGMLType(ggml_type),
                   zero=8, q4_layout=3)


@torch.library.custom_op(f"{_NS}::w4a8_gemv", mutates_args=(),
                         device_types="cpu")
def _w4a8_gemv(x8: torch.Tensor, dx: torch.Tensor, q: torch.Tensor,
               scale: torch.Tensor, bias: Optional[torch.Tensor],
               xs: Optional[torch.Tensor], k: int, n: int,
               ggml_type: int) -> torch.Tensor:
    return _qmm.w4a8_gemv_plain(x8, dx, _natpair(q, scale, bias, k, n,
                                                 ggml_type), xs)


@_w4a8_gemv.register_kernel("cuda")
def _(x8, dx, q, scale, bias, xs, k, n, ggml_type):
    return _qmm.w4a8_gemv(x8, dx, _natpair(q, scale, bias, k, n, ggml_type),
                          xs)


@_w4a8_gemv.register_fake
def _(x8, dx, q, scale, bias, xs, k, n, ggml_type):
    return x8.new_empty((n,), dtype=torch.float32)


def w4a8_gemv(x8, dx, qt: QTensor, xs=None) -> torch.Tensor:
    """qmm.w4a8_gemv through the op."""
    return _w4a8_gemv(x8, dx, qt.q, qt.scale, qt.bias, xs, qt.k, qt.n,
                      int(qt.ggml_type))


@torch.library.custom_op(f"{_NS}::decode_attention", mutates_args=(),
                         device_types="cpu")
def decode_attention(q3: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     ks: Optional[torch.Tensor], vs: Optional[torch.Tensor],
                     mask2: torch.Tensor, hkv: int,
                     scale: float) -> torch.Tensor:
    """decode_attention.decode_attention_kernel (arguments as its)."""
    return _da.decode_attention_plain(q3, k, v, ks, vs, mask2, hkv, scale)


@decode_attention.register_kernel("cuda")
def _(q3, k, v, ks, vs, mask2, hkv, scale):
    return _da.decode_attention_kernel(q3, k, v, ks, vs, mask2, hkv, scale)


@decode_attention.register_fake
def _(q3, k, v, ks, vs, mask2, hkv, scale):
    return q3.new_empty(q3.shape, dtype=torch.float32)


@torch.library.custom_op(f"{_NS}::decode_attention_update",
                         mutates_args=("k", "v", "ks", "vs"),
                         device_types="cpu")
def decode_attention_update(q3: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, ks: Optional[torch.Tensor],
                            vs: Optional[torch.Tensor], kn: torch.Tensor,
                            vn: torch.Tensor, kns: Optional[torch.Tensor],
                            vns: Optional[torch.Tensor], mask2: torch.Tensor,
                            rows: torch.Tensor, hkv: int,
                            scale: float) -> torch.Tensor:
    """decode_attention.decode_attention_update_kernel (arguments as its):
    the fresh rows kn, vn (kns, vns) are written into k, v (ks, vs)."""
    return _da.decode_attention_update_plain(q3, k, v, ks, vs, kn, vn, kns,
                                             vns, mask2, rows, hkv, scale)


@decode_attention_update.register_kernel("cuda")
def _(q3, k, v, ks, vs, kn, vn, kns, vns, mask2, rows, hkv, scale):
    return _da.decode_attention_update_kernel(q3, k, v, ks, vs, kn, vn, kns,
                                              vns, mask2, rows, hkv, scale)


@decode_attention_update.register_fake
def _(q3, k, v, ks, vs, kn, vn, kns, vns, mask2, rows, hkv, scale):
    return q3.new_empty(q3.shape, dtype=torch.float32)
