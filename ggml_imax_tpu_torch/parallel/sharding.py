"""Sharding rules for quantized params (counterpart of
ggml_imax_tpu/parallel/sharding.py).

The analog of the reference's CUDA split-buffer tensor parallelism
(ggml_backend_cuda_split_buffer_type, ggml-cuda.cu:680-945, row ranges
rounded to quant-block granularity at :580). Where the JAX package places
whole arrays on a mesh and lets GSPMD insert the collectives, each rank
here keeps only its own piece: `shard_qtensor` returns this rank's LOCAL
QTensor (k and n local), its tensors fresh contiguous copies (the kernels
take 16-byte aligned storage, ops/qmm.py).

Quant-block alignment: a row (contraction) shard is valid iff K/tp is a
whole number of 32-element quant blocks (the reference's assert,
sharding.py:37-43); scales and biases shard with their groups. A QTensor
with a codebook (IQ layouts: `lut`, nib2's `signs`) is refused by name:
no sharded path of either package runs it.

The JAX module's `constrain_heads` has no counterpart: it only anchors
GSPMD's propagation through a reshape, and explicit per-rank pieces have no
GSPMD to anchor.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..models.common import KVCache
from ..quant.device import QTensor
from .mesh import axis_coords, named, piece

COL = "col"          # shard output features (N): column-parallel
ROW = "row"          # shard contraction dim (K): row-parallel (all-reduced)
REP = "replicate"


def _plain(qt: QTensor):
    if qt.lut is not None or qt.signs is not None:
        raise ValueError(
            f"{qt.ggml_type.name}: a {qt.kind} QTensor with a codebook "
            f"({'lut and sign bitplane' if qt.signs is not None else 'lut'})"
            " has no sharded layout")


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx), dtype=torch.long, device=device)


def qtensor_cols(qt: QTensor, idx) -> QTensor:
    """Columns idx (output features, in that order) of qt, any layout
    (quant blocks run along K), as fresh contiguous tensors."""
    _plain(qt)
    i = _index(idx, qt.q.device)
    take = lambda a: None if a is None else a.index_select(-1, i)
    return replace(qt, q=take(qt.q), scale=take(qt.scale), bias=take(qt.bias),
                   n=len(i))


def qtensor_rows(qt: QTensor, idx) -> QTensor:
    """Contraction elements idx of qt, as fresh contiguous tensors: whole
    32-element quant blocks (each run of 32 from a multiple of 32) of a
    layout in natural row order (natural, natpair, nat8), any elements of a
    dense one. A repacked tensor's K-tile tag is halved until it divides
    the new K (it is only a tag for natpair and nat8)."""
    _plain(qt)
    idx = np.asarray(idx)
    if qt.kind == "dense":
        return replace(qt, q=qt.q.index_select(0, _index(idx, qt.q.device)),
                       k=len(idx))
    if qt.q4_layout not in (0, 3, 4) or (qt.q4_layout == 0
                                         and qt.interleaved_bk):
        raise ValueError("rows of a tile-permuted layout: shard before "
                         "repacking")
    blocks = idx.reshape(-1, 32)
    if (blocks[:, 0] % 32).any() or (blocks - blocks[:, :1]
                                     != np.arange(32)).any():
        raise ValueError("K is cut in whole 32-element quant blocks")
    b = blocks[:, 0] // 32
    rows = lambda per: _index((b[:, None] * per + np.arange(per)).reshape(-1),
                              qt.q.device)
    per_q = 16 if qt.kind == "nib4" else 32
    per_s = 32 * qt.scale.shape[0] // qt.k          # 1 (g 32) or 2 (g 16)
    take = lambda a, per: None if a is None else a.index_select(0, rows(per))
    k, bk = len(idx), qt.interleaved_bk
    while bk >= 64 and k % bk:
        bk //= 2
    return replace(qt, q=take(qt.q, per_q), scale=take(qt.scale, per_s),
                   bias=take(qt.bias, per_s), k=k, interleaved_bk=bk)


def qtensor_piece(qt: QTensor, how: str, index: int, parts: int) -> QTensor:
    """Piece `index` of `parts` of qt: COL splits N, ROW splits K at
    quant-block boundaries, REP keeps the whole tensor."""
    if how == REP:
        return qt
    if how == COL:
        if qt.n % parts:
            raise ValueError(f"column shard: N={qt.n} over {parts}")
        w = qt.n // parts
        return qtensor_cols(qt, np.arange(index * w, (index + 1) * w))
    if how == ROW:
        w = qt.k // parts
        if qt.k % parts or (qt.kind != "dense" and w % 32):
            raise ValueError(f"row shard misaligned to quant blocks: "
                             f"K={qt.k} / {parts}")
        return qtensor_rows(qt, np.arange(index * w, (index + 1) * w))
    raise ValueError(how)


def shard_qtensor(qt: QTensor, mesh, how: str, axis: str = "tp") -> QTensor:
    """This rank's piece of qt under a column / row / replicated layout
    over `axis` of the mesh."""
    return qtensor_piece(qt, how, *axis_coords(mesh, axis))


def shard_array(x: torch.Tensor, mesh, *spec) -> torch.Tensor:
    """This rank's piece of x, dim i cut over mesh axis spec[i]."""
    return named(mesh, *spec).piece(x)


# per-model-family weight sharding maps: name-suffix -> COL/ROW/REP
GPTJ_RULES = {
    "wte": COL, "lmh_w": COL,
    "q_w": COL, "k_w": COL, "v_w": COL, "o_w": ROW,
    "fc_in_w": COL, "fc_out_w": ROW,
    "qkv_w": COL, "qkvf_w": COL,     # fuse_qkv outputs (feature-parallel)
}
LLAMA_RULES = {
    "tok_embd": COL, "output": COL,
    "q_w": COL, "k_w": COL, "v_w": COL, "o_w": ROW,
    "gate_w": COL, "up_w": COL, "down_w": ROW,
}
GPT2_RULES = {
    "wte": COL, "lm_head": COL,
    "attn_w": COL, "proj_w": ROW, "fc_w": COL, "out_w": ROW,
}


def shard_params(params, mesh, rules: dict, axis: str = "tp"):
    """Apply a rules map to a model params tree: QTensor leaves whose dict
    key is in `rules` get this rank's piece of that layout; every other
    leaf is kept whole. Biases of column-parallel projections are cut with
    their features."""
    col_bias = {  # bias arrays that live on a column-sharded feature dim
        "attn_b": "attn_w", "fc_b": "fc_w", "fc_in_b": "fc_in_w",
        "lmh_b": "lmh_w",
    }
    index, parts = axis_coords(mesh, axis)

    def place(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, list):
                out[k] = [place(x) for x in v]
            elif isinstance(v, QTensor):
                out[k] = qtensor_piece(v, rules.get(k, REP), index, parts)
            elif k in col_bias and rules.get(col_bias[k]) == COL:
                out[k] = piece(v, v.dim() - 1, index, parts)
            else:
                out[k] = v
        return out

    return place(params)


def shard_kv_cache(cache: KVCache, mesh) -> KVCache:
    """This rank's piece of a flat KV arena (L, B, n_ctx, H*D): batch over
    dp, heads over tp (a tp piece of H*D is whole heads when tp divides
    H)."""
    tp = axis_coords(mesh, "tp")[1]
    if cache.heads % tp:
        raise ValueError(f"{cache.heads} kv heads over tp {tp}")
    nm = named(mesh, None, "dp", None, "tp")
    cut = lambda t: None if t is None else nm.piece(t)
    return KVCache(cut(cache.k), cut(cache.v), cut(cache.ks), cut(cache.vs),
                   heads=cache.heads // tp)
