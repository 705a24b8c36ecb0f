"""Tensor-parallel GPT-J and LLaMA decode and the tp x sp ring prefill on
torch.distributed (counterpart of ggml_imax_tpu/parallel/tp.py).

Replaces the reference's single-host multi-GPU tensor parallelism
(split-buffer weights + per-device partial GEMMs + peer-copy gathers:
ggml_backend_cuda_split_buffer_type, the reference's src/ggml-cuda.cu:
680-945, and its ggml_cuda_op_mul_mat dispatch, :1360-1660).

- Weights are sharded **component-wise at quant-block granularity** (the
  analog of get_row_split's tile rounding, ggml-cuda.cu:659-672,580): a
  rank's piece of the fused qkvf_w is its 1/tp of each of q, k, v and
  fc_in (`_dev_interleave`'s order), of of_w its 1/tp of the attention and
  of the MLP rows, cut in whole 32-element quant blocks.
- Every rank is one process and runs the SAME single-device kernels
  (W4A8 / W4A16, decode attention, flash) on its local shard: heads for
  attention, feature slices for the MLP.
- GPT-J communicates once a layer: its parallel attn + FF structure
  (examples/gpt-j/main.cpp:535) sums both row-parallel partials into the
  residual with ONE all_reduce of (B, T, E) f32, plus one all_gather of
  the column-sharded LM-head logits a step. LLaMA needs two a layer.
  Collectives run over the `group` the caller names.

Where this module parts from the JAX one, on purpose:

- `rope_split`: the JAX forward_tp and forward_ring_prefill apply
  interleaved rope whatever the params say (tp.py:262, :408), so on
  gptj.prepare_fused's params their logits are wrong; here the marker
  selects rope_split, as models/gptj.forward does.
- A QTensor with a codebook (`lut`, `signs`) raises ValueError
  (parallel/sharding.py); the JAX put_qt leaves them unplaced and its
  forward then fails on the QTensor's spec (tp.py:124).
- Sharding takes the natural layout (gptj.prepare_fused's output, before
  ops.qmm.params_repack) and each rank repacks its own shard, so the
  natpair tag is chosen for the local K (the JAX code retags an already
  repacked of_w, tp.py:139-151).
- Per-layer weights stay in params["layers"] (no stacked layout), and the
  forwards run eager: a captured CUDA graph cannot hold a gloo collective.

Alignment (ValueError): E % (tp * head_dim) == 0 so heads split evenly,
E / tp a multiple of 128 and the padded vocab a multiple of 128 * tp so
every local product keeps the kernels' N % 128 gate
(gptj.pad_lm_head(multiple=128 * tp) where the default pad falls short).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..models.common import (KVCache, attention_mask, init_kv_cache, read_kv,
                             update_kv)
from ..ops.activations import gelu, silu
from ..ops.decode_attention import decode_attention, select_decode_path
from ..ops.embedding import get_rows
from ..ops.flash_attention import attention
from ..ops.norms import layer_norm, rms_norm
from ..ops.qmatmul import qmatmul
from ..ops.rope import rope, rope_split
from ..quant.device import QTensor
from .ring_attention import ring_attention_local
from .sharding import qtensor_cols, qtensor_rows


def _dev_interleave(segments: list[tuple[int, int]], tp: int) -> np.ndarray:
    """[(start, len), ...] global element segments -> permutation that lays
    out [seg0_dev0, seg1_dev0, ..., seg0_dev1, ...]; every seg len % tp==0."""
    out = []
    for d in range(tp):
        for start, ln in segments:
            assert ln % tp == 0, (start, ln, tp)
            w = ln // tp
            out.append(np.arange(start + d * w, start + (d + 1) * w))
    return np.concatenate(out)


def _local(segments, rank: int, tp: int) -> np.ndarray:
    """This rank's elements under _dev_interleave: its 1/tp of each
    segment, in segment order."""
    return _dev_interleave(segments, tp).reshape(tp, -1)[rank]


def _require(ok: bool, msg: str):
    if not ok:
        raise ValueError(msg)


def _layer_qtensors(lp) -> set:
    return {k for k, v in lp.items() if isinstance(v, QTensor)}


def shard_params_tp(params: dict, cfg, rank: int, tp: int) -> dict:
    """Rank `rank`'s shard (of tp) of GPT-J params in gptj.prepare_fused's
    layout (qkvf_w, of_w, the padded LM head; natural, before
    ops.qmm.params_repack, which each rank then runs on its shard).
    QTensors come back LOCAL (k, n) with fresh contiguous tensors: qkvf_w
    [q_r|k_r|v_r|ff_r] columns, of_w [attn_r|ff_r] rows, fc_in_b ff_r, the
    LM head's and its bias' r-th column block; the rest (norms, fc_out_b,
    wte, the rope_split marker) is kept whole."""
    E, D = cfg.n_embd, cfg.head_dim
    F = 4 * E
    _require(E % (tp * D) == 0 and E % (tp * 128) == 0,
             f"E={E}, head_dim {D}: heads or E/tp % 128 do not split over "
             f"tp {tp}")
    head = params["lmh_w"]
    _require(head.n % (128 * tp) == 0,
             f"LM head N={head.n}: pad_lm_head(multiple={128 * tp}) before "
             "sharding")
    cols = _local([(0, E), (E, E), (2 * E, E), (3 * E, F)], rank, tp)
    rows = _local([(0, E), (E, F)], rank, tp)
    ff = torch.as_tensor(_local([(0, F)], rank, tp))
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for lp in params["layers"]:
        _require(_layer_qtensors(lp) == {"qkvf_w", "of_w"},
                 "TP sharding takes gptj.prepare_fused's layout (qkvf_w + "
                 f"of_w), not {sorted(_layer_qtensors(lp))}")
        lp = dict(lp)
        lp["qkvf_w"] = qtensor_cols(lp["qkvf_w"], cols)
        lp["of_w"] = qtensor_rows(lp["of_w"], rows)
        lp["fc_in_b"] = lp["fc_in_b"][ff.to(lp["fc_in_b"].device)]
        out["layers"].append(lp)
    w = head.n // tp
    out["lmh_w"] = qtensor_cols(head, np.arange(rank * w, (rank + 1) * w))
    out["lmh_b"] = params["lmh_b"][rank * w:(rank + 1) * w].clone()
    return out


def init_cache_tp(cfg, tp: int, batch: int = 1, n_ctx: int | None = None,
                  dtype=torch.bfloat16, *, device=None) -> KVCache:
    """This rank's flat KV arena: (L, B, n_ctx, (Hkv/tp)*D), its local kv
    heads (GQA: cfg.n_head_kv), bf16 or "q8_0"."""
    H = getattr(cfg, "n_head_kv", cfg.n_head)
    _require(H % tp == 0, f"{H} kv heads over tp {tp}")
    return init_kv_cache(cfg.n_layer, batch, n_ctx or cfg.n_ctx, H // tp,
                         cfg.head_dim, dtype, device=resolve_device(device))


def _mm(x, w):
    return qmatmul(x, w, out_dtype=torch.float32)


def _all_reduce(y, group, tp):
    if tp > 1:
        dist.all_reduce(y, group=group)
    return y


def _gather_cols(x, group, tp):
    """The column-sharded logits of every rank, concatenated in rank
    order (a tiled all_gather)."""
    if tp == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(tp)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _attend(cache, li, q, kk, vv, n_past, mask, path):
    """One layer's KV write and attention on the route select_decode_path
    gave (a flat arena: the decode kernel for one token, flash above), as
    the single-device forwards run them by default."""
    update_kv(cache, li, kk, vv, n_past)
    if path == "kernel":
        return decode_attention(cache, li, q, mask)
    return attention(q, *read_kv(cache, li, dtype=q.dtype), mask,
                     out_dtype=torch.float32)


def forward_tp(cfg, params, tokens, positions, cache: KVCache, n_past,
               group=None):
    """TP GPT-J forward on this rank's shard (shard_params_tp, repacked)
    and arena (init_cache_tp): models/gptj.forward's fused graph layer by
    layer at the local heads and features, ONE all_reduce of the of_w
    partial a layer and one all_gather of the LM-head logits. tokens /
    positions (B, T), the same on every rank. Returns (full logits (B, T,
    n_vocab) f32, the same on every rank; cache, written in place)."""
    tp = dist.get_world_size(group)
    E, D = cfg.n_embd, cfg.head_dim
    E_loc, H_loc = E // tp, cfg.n_head // tp
    B, T = tokens.shape
    if "rope_split" in params:
        _rope = lambda t: rope_split(t, positions, n_dims=cfg.n_rot)
    else:
        _rope = lambda t: rope(t, positions, n_dims=cfg.n_rot)
    x = get_rows(params["wte"], tokens, dtype=torch.float32)
    mask = attention_mask(positions, cache.n_ctx, n_past)
    path = select_decode_path(T=T, B=B, D=D, cells=None, mask=mask)
    for li, lp in enumerate(params["layers"]):
        cur = layer_norm(x, lp["ln_1_g"], lp["ln_1_b"])
        qkvf = _mm(cur, lp["qkvf_w"])
        q, kk, vv = qkvf[..., :3 * E_loc].reshape(B, T, 3, H_loc, D).unbind(2)
        attn = _attend(cache, li, _rope(q), _rope(kk), vv, n_past, mask, path)
        ff = gelu(qkvf[..., 3 * E_loc:] + lp["fc_in_b"])
        y = _mm(torch.cat([attn.reshape(B, T, E_loc), ff], dim=-1), lp["of_w"])
        x = x + _all_reduce(y, group, tp) + lp["fc_out_b"]
    x = layer_norm(x, params["ln_f_g"], params["ln_f_b"])
    logits = _gather_cols(_mm(x, params["lmh_w"]) + params["lmh_b"], group, tp)
    return logits[..., :cfg.n_vocab], cache


def collective_volume_model(cfg, tp: int, *, batch: int = 1,
                            hbm_gbps: float = 3350.0,
                            link_gbps: float = 450.0) -> dict:
    """Predicted TP scaling for quantized decode (GPT-J's image; one chip
    cannot measure it). Defaults are figures for `NVIDIA H100 80GB HBM3`
    (SXM): HBM3 at 3.35 TB/s, and NVLink 4 between SXM cards at 450 GB/s a
    direction (900 GB/s both ways).

    Per token: weights streamed per device = image/tp (HBM-bound);
    collectives = n_layer ring all-reduces of (B, E) f32 partials
    (2*(tp-1)/tp of the payload crosses the link per device) + one tiled
    all-gather of the (B, V/tp) local logits."""
    E, L, V = cfg.n_embd, cfg.n_layer, cfg.n_vocab
    layer_bytes = (3 * E + 4 * E) * E / 2 + (7 * E * E // 32) * 4 \
        + (E + 4 * E) * E / 2 + (5 * E * E // 32) * 4
    image = L * layer_bytes + V * E / 2 * 2        # + wte/lmh nib4
    ar_bytes = L * batch * E * 4 * 2 * (tp - 1) / tp
    ag_bytes = batch * (V / tp) * 4 * (tp - 1)
    t_hbm = image / tp / (hbm_gbps * 1e9)
    t_link = (ar_bytes + ag_bytes) / (link_gbps * 1e9)
    t1 = image / (hbm_gbps * 1e9)
    eff = t1 / tp / (t_hbm + t_link)
    return {"tp": tp, "image_bytes": int(image),
            "per_device_bytes": int(image / tp),
            "allreduce_bytes_per_tok": int(ar_bytes),
            "allgather_bytes_per_tok": int(ag_bytes),
            "t_step_ms": (t_hbm + t_link) * 1e3,
            "predicted_scaling_efficiency": eff}


# ---- ring prefill: tp × sp long-context prefill (SURVEY §5) ----


def init_cache_ringsp(cfg, tp: int, sp: int, batch: int = 1,
                      n_ctx: int | None = None, dtype=torch.bfloat16, *,
                      device=None) -> KVCache:
    """This rank's flat KV arena for the ring prefill: n_ctx / sp rows (its
    contiguous chunk of the global context, stored from LOCAL row 0: global
    row = sp index * (n_ctx / sp) + local row) of its kv heads over tp. The
    full-context cache never exists on one rank, so the reachable context
    is sp x one device's KV budget — the long-context capability the
    reference lacks (SURVEY.md §5; its n_ctx is bounded by one device's
    preallocation, the reference's examples/gpt-j/main.cpp:560)."""
    n_ctx = n_ctx or cfg.n_ctx
    _require(n_ctx % sp == 0, f"n_ctx={n_ctx} over sp {sp}")
    return init_cache_tp(cfg, tp, batch, n_ctx // sp, dtype, device=device)


def forward_ring_prefill(cfg, params, tokens, positions, cache: KVCache,
                         tp_group=None, sp_group=None):
    """Long-context GPT-J prefill over tp x sp ranks: weights sharded as
    for forward_tp (shard_params_tp over tp, repacked), the SEQUENCE cut
    over sp. Each rank computes q/k/v for its own token chunk, writes its
    arena chunk (init_cache_ringsp) from local row 0, and attends over the
    whole context by rotating KV chunks around the sp ring
    (ring_attention_local) with absolute-position causal masks — exact
    attention, one all_reduce a layer over tp, no sp collective outside
    attention (MLP and norms are position-local).

    tokens / positions (B, T): the whole sequence, the same on every rank;
    T fills the arena exactly (T == sp * the local arena's rows). Returns
    (this rank's chunk's logits (B, T / sp, n_vocab) f32 — the last token's
    on the last sp rank; cache, written in place)."""
    tp, sp = dist.get_world_size(tp_group), dist.get_world_size(sp_group)
    s = dist.get_rank(sp_group)
    E, D = cfg.n_embd, cfg.head_dim
    E_loc, H_loc = E // tp, cfg.n_head // tp
    B, T = tokens.shape
    _require(T == sp * cache.n_ctx,
             f"ring prefill fills the arena exactly: T={T}, sp {sp} x "
             f"{cache.n_ctx} rows")
    T_loc = T // sp
    tok = tokens[:, s * T_loc:(s + 1) * T_loc]
    pos = positions[:, s * T_loc:(s + 1) * T_loc].contiguous()
    if "rope_split" in params:
        _rope = lambda t: rope_split(t, pos, n_dims=cfg.n_rot)
    else:
        _rope = lambda t: rope(t, pos, n_dims=cfg.n_rot)
    x = get_rows(params["wte"], tok, dtype=torch.float32)
    for li, lp in enumerate(params["layers"]):
        cur = layer_norm(x, lp["ln_1_g"], lp["ln_1_b"])
        qkvf = _mm(cur, lp["qkvf_w"])
        q, kk, vv = qkvf[..., :3 * E_loc].reshape(B, T_loc, 3, H_loc,
                                                  D).unbind(2)
        q, kk = _rope(q), _rope(kk)
        update_kv(cache, li, kk, vv, 0)
        attn = ring_attention_local(q, kk, vv, pos, pos, sp_group,
                                    causal=True)
        ff = gelu(qkvf[..., 3 * E_loc:] + lp["fc_in_b"])
        y = _mm(torch.cat([attn.reshape(B, T_loc, E_loc), ff], dim=-1),
                lp["of_w"])
        x = x + _all_reduce(y, tp_group, tp) + lp["fc_out_b"]
    x = layer_norm(x, params["ln_f_g"], params["ln_f_b"])
    logits = _gather_cols(_mm(x, params["lmh_w"]) + params["lmh_b"],
                          tp_group, tp)
    return logits[..., :cfg.n_vocab], cache


# ---- LLaMA-family TP (GQA, sequential attn->mlp residuals) ----


def shard_params_tp_llama(params: dict, cfg, rank: int, tp: int) -> dict:
    """Rank `rank`'s shard (of tp) of LLaMA params fused by llama.fuse_qkv
    and llama.fuse_gate_up(params, pad_multiple=1) (natural, before
    ops.qmm.params_repack): qkv_w and gu_w cut column-wise component by
    component, o_w and down_w row-wise (one segment: a plain contiguous
    piece), norms kept whole. The LM head (`output`) is cut by columns
    when present; a tied head (tok_embd) stays whole (every rank computes
    full logits from it)."""
    E, D = cfg.n_embd, cfg.head_dim
    KV = cfg.n_head_kv * D
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = []
    for lp in params["layers"]:
        _require(_layer_qtensors(lp) == {"qkv_w", "o_w", "gu_w", "down_w"},
                 "llama TP takes fuse_qkv + fuse_gate_up's layout, not "
                 f"{sorted(_layer_qtensors(lp))}")
        F = lp["gu_w"].n // 2
        _require(F == lp["down_w"].k,
                 "TP shards gate/up and down complementarily; re-fuse with "
                 "fuse_gate_up(params, pad_multiple=1) — the single-device "
                 f"pad is incompatible with component-wise sharding (F={F}, "
                 f"down K={lp['down_w'].k})")
        _require(E % (tp * 128) == 0 and KV % (tp * D) == 0
                 and F % (tp * 128) == 0,
                 f"E={E}, KV={KV}, F={F} do not split over tp {tp}")
        lp = dict(lp)
        lp["qkv_w"] = qtensor_cols(
            lp["qkv_w"], _local([(0, E), (E, KV), (E + KV, KV)], rank, tp))
        lp["gu_w"] = qtensor_cols(lp["gu_w"], _local([(0, F), (F, F)], rank,
                                                     tp))
        lp["o_w"] = qtensor_rows(lp["o_w"], _local([(0, E)], rank, tp))
        lp["down_w"] = qtensor_rows(lp["down_w"], _local([(0, F)], rank, tp))
        out["layers"].append(lp)
    head = params.get("output")
    if head is not None:
        _require(head.n % (128 * tp) == 0,
                 f"LM head N={head.n} over 128 x tp {tp}")
        w = head.n // tp
        out["output"] = qtensor_cols(head, np.arange(rank * w, (rank + 1) * w))
    return out


def forward_tp_llama(cfg, params, tokens, positions, cache: KVCache, n_past,
                     group=None):
    """TP LLaMA forward on this rank's shard (shard_params_tp_llama,
    repacked) and arena (init_cache_tp): models/llama.forward's fused graph
    at the local heads and features, TWO all_reduces a layer (sequential
    attn and MLP residuals — no parallel structure to merge them, unlike
    GPT-J's one) and an all_gather of a column-sharded head. Returns (full
    logits (B, T, n_vocab) f32, the same on every rank; cache)."""
    tp = dist.get_world_size(group)
    E, D = cfg.n_embd, cfg.head_dim
    E_loc, H_loc, Hkv_loc = E // tp, cfg.n_head // tp, cfg.n_head_kv // tp
    KV_loc = Hkv_loc * D
    B, T = tokens.shape

    def _rope(t):
        return rope(t, positions, n_dims=D, mode=cfg.rope_mode,
                    freq_base=cfg.rope_base, freq_scale=cfg.rope_scale)

    x = get_rows(params["tok_embd"], tokens, dtype=torch.float32)
    mask = attention_mask(positions, cache.n_ctx, n_past)
    path = select_decode_path(T=T, B=B, D=D, cells=None, mask=mask)
    for li, lp in enumerate(params["layers"]):
        cur = rms_norm(x, lp["attn_norm"], eps=cfg.rms_eps)
        qkv = _mm(cur, lp["qkv_w"])
        q = qkv[..., :E_loc].reshape(B, T, H_loc, D)
        kk = qkv[..., E_loc:E_loc + KV_loc].reshape(B, T, Hkv_loc, D)
        vv = qkv[..., E_loc + KV_loc:].reshape(B, T, Hkv_loc, D)
        attn = _attend(cache, li, _rope(q), _rope(kk), vv, n_past, mask, path)
        x = x + _all_reduce(_mm(attn.reshape(B, T, E_loc), lp["o_w"]), group,
                            tp)
        cur = rms_norm(x, lp["ffn_norm"], eps=cfg.rms_eps)
        gu = _mm(cur, lp["gu_w"])
        F_loc = gu.shape[-1] // 2
        ff = silu(gu[..., :F_loc]) * gu[..., F_loc:]
        x = x + _all_reduce(_mm(ff, lp["down_w"]), group, tp)
    x = rms_norm(x, params["out_norm"], eps=cfg.rms_eps)
    if params.get("output") is not None:
        logits = _gather_cols(_mm(x, params["output"]), group, tp)
    else:
        logits = _mm(x, params["tok_embd"])
    return logits[..., :cfg.n_vocab], cache
