"""Row gather from a (possibly quantized) embedding table (counterpart of
ggml_imax_tpu/ops/embedding.py: every nib4 and int8 layout, and dense
tables)."""
from __future__ import annotations

import torch

from ..quant.device import QTensor
from .qmm import natural_q


def get_rows(qt: QTensor, ids, dtype=torch.bfloat16):
    """qt: k = row length (embedding dim), n = vocab rows; ids (...) int ->
    (..., k) in `dtype`. Only the gathered columns are unpacked."""
    if qt.kind == "dense":
        return qt.q.T[ids].to(dtype)
    n_groups = qt.scale.shape[0]
    lead = ids.shape
    flat = ids.reshape(-1)
    q = natural_q(qt, qt.q[:, flat]).T.reshape(*lead, qt.k)
    s = qt.scale.T[ids]                                  # (..., n_groups)
    w = q.reshape(*lead, n_groups, qt.k // n_groups).to(dtype) \
        * s[..., None].to(dtype)
    if qt.bias is not None:
        w = w + qt.bias.T[ids][..., None].to(dtype)
    return w.reshape(*lead, qt.k)
