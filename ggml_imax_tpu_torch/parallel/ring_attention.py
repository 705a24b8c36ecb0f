"""Ring attention — sequence-parallel attention over a sharded KV cache
(counterpart of ggml_imax_tpu/parallel/ring_attention.py, which is plain
XLA, not a Pallas kernel: so is this).

The reference has NO long-context strategy (SURVEY §5): context is bounded
by one device's preallocated KV (n_ctx). The KV sequence is cut over the
ranks of a group and the chunks rotate one hop a step around the ring
(`distributed.ring_shift`, point-to-point) while each rank accumulates its
queries' attention online: exact attention over a context the group's size
times larger than one device's KV memory.

Merging uses the log-sum-exp decomposition of softmax: for each KV chunk i
compute (o_i, lse_i); then o = Σ_i o_i · exp(lse_i - lse) with
lse = logaddexp_i(lse_i) — the same online-softmax algebra as flash
attention, applied across ring steps.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from .distributed import ring_shift

NEG = -0.7 * float(np.finfo(np.float32).max)


def _chunk_attention(q, k, v, mask, scale):
    """Unnormalized attention over one KV chunk: returns (o, lse) with
    o = softmax-numerator @ v / exp(lse), lse per (B, H, Tq); f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s + mask
    s = torch.clamp(s, min=NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float())
    return o, (m + torch.log(l))[..., 0]


def ring_attention_local(q, k, v, qpos, kpos, group=None, *,
                         scale: float | None = None, causal: bool = False):
    """The ring body: q/k/v are this rank's LOCAL sequence chunks (B, T_loc,
    H, D); qpos/kpos (B, T_loc) carry the chunks' ABSOLUTE positions so the
    causal mask stays exact while KV chunks (with kpos) rotate around the
    group. Returns f32 (B, T_loc, H, D) — this rank's queries attended over
    the GLOBAL sequence."""
    b, tq, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    n = dist.get_world_size(group)
    acc = torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, tq), NEG, dtype=torch.float32, device=q.device)
    for step in range(n):
        mask = None
        if causal:
            seen = kpos[:, None, None, :] <= qpos[:, None, :, None]
            mask = torch.where(seen, 0.0, float("-inf"))
        o_i, lse_i = _chunk_attention(q, k, v, mask, scale)
        new = torch.logaddexp(lse, lse_i)
        w_old = torch.exp(lse - new)[..., None].transpose(1, 2)
        w_new = torch.exp(lse_i - new)[..., None].transpose(1, 2)
        acc = acc * w_old + o_i * w_new
        lse = new
        if step < n - 1:
            k, v, kpos = ring_shift([k, v, kpos], group)
    return acc


def ring_attention(q, k, v, group=None, *, scale: float | None = None,
                   causal: bool = False, q_positions=None, kv_positions=None):
    """Exact attention with KV cut on the sequence axis over the group.

    q: (B, Tq, H, D), the same on every rank; k/v: (B, Tk, H, D), the
    whole sequence (each rank attends with its own chunk, Tk / ranks rows;
    the others reach it around the ring). With causal=True, q_positions
    (B, Tq) and kv_positions (B, Tk) give absolute positions (default:
    arange). Returns (B, Tq, H, D) in q's dtype, the same on every rank."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    b, tq = q.shape[:2]
    tk = k.shape[1]
    if tk % n:
        raise ValueError(f"Tk={tk} over {n} ranks")
    if q_positions is None:
        q_positions = torch.arange(tq, device=q.device).expand(b, tq)
    if kv_positions is None:
        kv_positions = torch.arange(tk, device=q.device).expand(b, tk)
    w = tk // n
    mine = lambda t: t[:, r * w:(r + 1) * w].contiguous()
    out = ring_attention_local(q, mine(k), mine(v), q_positions,
                               mine(kv_positions), group, scale=scale,
                               causal=causal)
    return out.to(q.dtype)
