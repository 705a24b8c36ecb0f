"""Mixture-of-experts ops (counterpart of ggml_imax_tpu/ops/moe.py):
ggml_mul_mat_id and the routed FFN built on it, in f32.

- `mul_mat_id`: every expert for every token, then the selected slots
  gathered (dense dispatch).
- `mul_mat_id_grouped`: rows sorted by expert into a static per-expert
  capacity, one product per expert, scattered back; a row past its
  expert's capacity gives zeros (its rank within the expert is the count
  of earlier rows of that expert, a cumsum of the one-hot).
- `moe_ffn`: top-k routing (equal logits: the lower expert index first,
  lax.top_k's order, by a stable descending sort; torch.topk promises no
  order among equal values on CUDA) with the top-k logits
  softmax-renormalised.

`precision` is the reference's signature; the products here are f32 (no
TF32: torch.backends.cuda.matmul.allow_tf32 stays as it is, off by
default).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mul_mat_id(as_, x, ids, *, precision=None):
    """as_: (E, K, N); x: (T, K); ids: (T, U) int -> (T, U, N)."""
    n = as_.shape[-1]
    y = torch.einsum("tk,ekn->etn", x.float(), as_.float())     # (E, T, N)
    idx = ids.long()[:, :, None].expand(-1, -1, n)
    return torch.gather(y.transpose(0, 1), 1, idx)              # (T, U, N)


def mul_mat_id_grouped(as_, x, ids, *, capacity: int | None = None,
                       precision=None):
    """Sort-dispatch mul_mat_id with a static per-expert capacity (default
    twice the mean load). Returns (T, U, N); rows over capacity are 0."""
    e, k, n = as_.shape
    t, u = ids.shape
    cap = capacity or max(1, (t * u * 2 + e - 1) // e)
    flat_ids = ids.reshape(-1).long()                           # (T*U,)
    onehot = F.one_hot(flat_ids, e)                             # (TU, E)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot             # rank in e
    rank = (pos_in_e * onehot).sum(dim=1)
    keep = rank < cap
    slot = torch.where(keep, flat_ids * cap + rank, e * cap)    # sink row
    gathered = torch.zeros((e * cap + 1, k), dtype=x.dtype, device=x.device)
    gathered[slot] = x.repeat_interleave(u, dim=0)
    ge = gathered[:e * cap].reshape(e, cap, k)
    ye = torch.einsum("eck,ekn->ecn", ge.float(), as_.float())
    ye = torch.cat([ye.reshape(e * cap, n),
                    torch.zeros((1, n), dtype=ye.dtype, device=ye.device)])
    out = ye[slot]                                              # (TU, N)
    return torch.where(keep[:, None], out, 0.0).reshape(t, u, n)


def moe_ffn(x, router_w, w_up, w_gate, w_down, *, n_used: int,
            activation=F.silu, precision=None):
    """Mixtral's routed FFN: x (T, E_embd); router_w (E_embd, n_expert);
    w_up / w_gate (n_expert, E_embd, F); w_down (n_expert, F, E_embd)."""
    logits = x.float() @ router_w.float()                       # (T, E)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_w, top_ids = vals[:, :n_used], idx[:, :n_used]
    top_w = torch.softmax(top_w, dim=-1)
    up = mul_mat_id(w_up, x, top_ids)                           # (T, U, F)
    gate = mul_mat_id(w_gate, x, top_ids)
    h = activation(gate) * up
    down = _mul_mat_id_h(w_down, h, top_ids)
    return (down * top_w[:, :, None]).sum(dim=1)                # (T, E_embd)


def _mul_mat_id_h(as_, h, ids):
    """mul_mat_id where each slot has its own activation: h (T, U, K) ->
    (T, U, N), slot u through expert ids[t, u]."""
    y = torch.einsum("tuk,ekn->tuen", h.float(), as_.float())
    idx = ids.long()[:, :, None, None].expand(-1, -1, 1, y.shape[-1])
    return torch.gather(y, 2, idx)[:, :, 0]
