"""Row gather from a (possibly quantized) embedding table (counterpart of
ggml_imax_tpu/ops/embedding.py: natpair nib4, natural and nat8 int8,
and dense tables)."""
from __future__ import annotations

import torch

from ..quant.device import QTensor
from .qmm import unpack_natpair


def get_rows(qt: QTensor, ids, dtype=torch.bfloat16):
    """qt: k = row length (embedding dim), n = vocab rows; ids (...) int ->
    (..., k) in `dtype`."""
    if qt.kind == "dense":
        return qt.q.T[ids].to(dtype)
    n_groups = qt.scale.shape[0]
    if qt.kind == "nib4" and qt.q4_layout == 3:
        cols = qt.q.T[ids]                               # (..., K/2)
        lead = cols.shape[:-1]
        q = unpack_natpair(cols.reshape(-1, qt.k // 2).T).T.reshape(*lead,
                                                                    qt.k)
    elif qt.kind == "int8" and qt.q4_layout in (0, 4):   # nat8 rows are natural
        q = qt.q.T[ids]                                  # (..., K)
        lead = q.shape[:-1]
    else:
        raise NotImplementedError(
            f"get_rows: {qt.kind} layout {qt.q4_layout} (natpair nib4, "
            "natural or nat8 int8, and dense tables)")
    s = qt.scale.T[ids]                                  # (..., n_groups)
    w = q.reshape(*lead, n_groups, qt.k // n_groups).to(dtype) \
        * s[..., None].to(dtype)
    if qt.bias is not None:
        w = w + qt.bias.T[ids][..., None].to(dtype)
    return w.reshape(*lead, qt.k)
