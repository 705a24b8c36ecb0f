"""Row gather from a (possibly quantized) embedding table (counterpart of
ggml_imax_tpu/ops/embedding.py: every nib4 and int8 layout, the codebook
layouts and dense tables).

The JAX package's get_rows reads a nib4 table with a lut as affine levels
(index - zero, the lut never looked up) and cannot reshape a nib2 table's
(K/4, N) bytes; here both are expanded through their codebook, so a row
equals the column of the table's dequantize."""
from __future__ import annotations

import torch

from ..quant.device import QTensor, codebook_q
from .qmm import natural_q


def get_rows(qt: QTensor, ids, dtype=torch.bfloat16):
    """qt: k = row length (embedding dim), n = vocab rows; ids (...) int ->
    (..., k) in `dtype`. Only the gathered columns are unpacked."""
    if qt.kind == "dense":
        return qt.q.T[ids].to(dtype)
    n_groups = qt.scale.shape[0]
    lead = ids.shape
    flat = ids.reshape(-1)
    if qt.lut is not None:      # gather the packed columns, expand those
        signs = None if qt.signs is None else qt.signs[:, flat]
        q = codebook_q(qt, qt.q[:, flat], signs)
    else:
        q = natural_q(qt, qt.q[:, flat])
    q = q.T.reshape(*lead, qt.k)
    s = qt.scale.T[ids]                                  # (..., n_groups)
    w = q.reshape(*lead, n_groups, qt.k // n_groups).to(dtype) \
        * s[..., None].to(dtype)
    if qt.bias is not None:
        w = w + qt.bias.T[ids][..., None].to(dtype)
    return w.reshape(*lead, qt.k)
