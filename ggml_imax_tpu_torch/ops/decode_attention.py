"""Single-token (decode) attention over one layer of the flat KV arena
(counterpart of ggml_imax_tpu/ops/decode_attention.py). Three kernels:

- `decode_attention` (csrc/decode_attention.cu): one query row per arena
  batch row, read only (`decode_attention_stacked`, the "kernel" route),
  its keys split over a thread-block cluster of `decode_plan` blocks in
  one launch;
- `decode_attention_cells` (csrc/decode_attention_cells.cu): NB query rows
  of distinct sequences over the one shared cell arena of continuous
  batching, read only (the "cells2" route); one launch, its keys split
  over a cluster of `decode_plan` blocks, every query row of a kv head in
  one block, so the arena is read once for all rows;
- `decode_attention_update` / `decode_attention_update_cells`
  (csrc/decode_attention_update.cu): the fresh K/V row is written into the
  arena in place and its attention term is folded in apart, the stale
  destination row left out of the arena pass ("fused" and "cells"); one
  launch, its keys split over a cluster of `decode_plan` blocks as
  `decode_attention`'s, every query row of a kv head in one block.

The arena is (L, B, n_ctx, Hkv*D), bf16 or q8_0 (int8 plus one f32 scale
per 32 elements along D). The kernels read layer `li` in place: no copy,
no unflatten. Where the JAX package aliases the arena through the kernel,
here the kernel writes into the tensor.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import _build
from ..models.common import _q8_rows

NEG = -0.7 * float(np.finfo(np.float32).max)
# csrc/decode_attention*.cu: the H100's SMs, the most blocks of a portable
# cluster; decode_attention.cu's floats of one block's scores in shared
# memory
SMS = 132
MAX_SPLIT = 8
_MAX_SCORES = 16384


def _dense(x, xs, rows: int, hkv: int):
    """(Bk, T, Hkv*D) arena slice -> f32 (rows, Hkv, T, D); a q8_0 slice is
    dequantized in f32 and rounded to bf16, as the kernels read it. Bk is
    1 (the shared cell arena, broadcast) or rows."""
    Bk, T = x.shape[:2]
    if xs is None:
        d = x.float()
    else:
        d = (x.float().reshape(Bk, T, -1, 32) * xs[..., None]) \
            .to(torch.bfloat16).float()
    d = d.reshape(Bk, T, hkv, -1).permute(0, 2, 1, 3)
    return d.expand(rows, -1, -1, -1)


def _attend(q3, k, v, ks, vs, mask2, hkv: int, scale: float):
    """The softmax over the arena rows, unnormalized: returns m, l (B, Hq, 1)
    and pv (B, Hq, D), p rounded to bf16 before the PV product."""
    B, Hq, D = q3.shape
    rep = Hq // hkv
    kb = _dense(k, ks, B, hkv).repeat_interleave(rep, dim=1)
    vb = _dense(v, vs, B, hkv).repeat_interleave(rep, dim=1)
    qb = q3.to(torch.bfloat16).float()                     # (B, Hq, D)
    s = torch.einsum("bhd,bhtd->bht", qb, kb) * scale
    s = torch.clamp(s + mask2[:, None, :], min=NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    pv = torch.einsum("bht,bhtd->bhd", p.to(torch.bfloat16).float(), vb)
    return m, p.sum(dim=-1, keepdim=True), pv


def decode_attention_plain(q3, k, v, ks, vs, mask2, hkv: int, scale: float):
    """Plain version of the read-only kernels. q3 (B, Hq, D); k/v (B, T,
    Hkv*D) one layer of the arena, or (1, T, Hkv*D) shared by every row (the
    cell arena); ks/vs (.., T, Hkv*D/32) or None; mask2 (B, T) f32 >= NEG.
    Returns (B, Hq, D) f32."""
    _, l, pv = _attend(q3, k, v, ks, vs, mask2, hkv, scale)
    return pv / torch.clamp(l, min=1e-30)


def _check_arena(name, q3, k, v, ks, vs, hkv, arena_batch):
    B, Hq, D = q3.shape
    T = k.shape[1]
    if D % 32 or Hq % hkv or k.shape != (arena_batch, T, hkv * D) \
            or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q3.shape)}, k {tuple(k.shape)}, "
                         f"hkv={hkv}")
    want = torch.int8 if ks is not None else torch.bfloat16
    if k.dtype != want or v.dtype != want:
        raise ValueError(f"{name}: arena dtype {k.dtype}")
    for t in (k, v, ks, vs):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: arena slices must be contiguous")


def _check_kernel_arena(name, D, tensors):
    """The gates the one-launch kernels share: D 128 or 256, and 16-byte
    aligned arena slices (and fresh rows); raises ValueError."""
    if D not in (128, 256):
        raise ValueError(f"{name}: the kernel takes D 128 or 256 "
                         f"(D % 128 == 0, D <= 256), not {D}")
    for key, t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")


def decode_plan(B: int, Hkv: int, T: int) -> int:
    """The blocks S of one thread-block cluster that share the T keys of a
    (batch row, kv head) in csrc/decode_attention.cu (and of an arena batch
    row's kv head in csrc/decode_attention_update.cu and, B 1, in
    csrc/decode_attention_cells.cu): as many as bring S * Hkv * B to the
    card's SMs, at most MAX_SPLIT and at most T (1 once B * Hkv fills the
    SMs alone). GPT-J batch 1 (16 kv heads): 8."""
    return max(1, min(MAX_SPLIT, T, SMS // (B * Hkv)))


def decode_slices(T: int, S: int):
    """The keys [lo, hi) of each rank of the cluster, in rank order: rank r
    owns [r ceil(T/S), (r + 1) ceil(T/S)) cut to [0, T) (empty past T)."""
    chunk = -(-T // S)
    return [(min(r * chunk, T), min((r + 1) * chunk, T)) for r in range(S)]


def _group(rep: int) -> int:
    """Query heads of one kv head that a block serves (the kernel's kG)."""
    return 1 if rep == 1 else 2 if rep == 2 else 4 if rep <= 4 else 8


def decode_attention_kernel(q3, k, v, ks, vs, mask2, hkv: int, scale: float):
    """Launch csrc/decode_attention.cu on one layer's arena slices, its keys
    split over a cluster of decode_plan(B, hkv, T) blocks. Takes D 128 or
    256 and 16-byte aligned arena slices; raises on anything else, without
    a launch."""
    B, Hq, D = q3.shape
    T = k.shape[1]
    _check_arena("decode_attention", q3, k, v, ks, vs, hkv, B)
    _check_kernel_arena("decode_attention", D,
                        (("k", k), ("v", v), ("ks", ks), ("vs", vs)))
    S = decode_plan(B, hkv, T)
    if -(-T // S) * _group(Hq // hkv) > _MAX_SCORES:
        raise ValueError(f"decode_attention: {T} keys in {S} slices do not "
                         f"fit a block's {_MAX_SCORES} scores")
    q3 = q3.float().contiguous()
    mask2 = mask2.float().contiguous()
    out = torch.empty(B, Hq, D, dtype=torch.float32, device=q3.device)
    rc = _build.lib().ggml_decode_attention(
        q3.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(ks),
        _build.ptr(vs), mask2.data_ptr(), out.data_ptr(), B, Hq, hkv, D, T,
        S, float(scale), _build.stream_ptr(q3))
    _build.check(rc, "decode_attention")
    _build.LAUNCHES["decode_attention"] += 1
    return out


def decode_attention_cells_kernel(q3, k, v, ks, vs, mask2, hkv: int,
                                  scale: float):
    """Launch csrc/decode_attention_cells.cu once: q3 (NB, Hq, D) over the
    shared (1, T, Hkv*D) arena slice, its keys split over a cluster of
    decode_plan(1, hkv, T) blocks; the plain version is
    decode_attention_plain. Takes D 128 or 256 and contiguous, 16-byte
    aligned arena slices; raises on anything else, without a launch.
    Allocates only the output (and a copy of q3 where it is not 16-byte
    aligned)."""
    NB, Hq, D = q3.shape
    T = k.shape[1]
    _check_arena("decode_attention_cells", q3, k, v, ks, vs, hkv, 1)
    _check_kernel_arena("decode_attention_cells", D,
                        (("k", k), ("v", v), ("ks", ks), ("vs", vs)))
    q3 = q3.float().contiguous()
    if q3.data_ptr() % 16:            # the kernel reads q in 16-byte loads
        q3 = q3.clone()
    mask2 = mask2.float().contiguous()
    out = torch.empty(NB, Hq, D, dtype=torch.float32, device=q3.device)
    rc = _build.lib().ggml_decode_attention_cells(
        q3.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(ks),
        _build.ptr(vs), mask2.data_ptr(), out.data_ptr(), NB, Hq, hkv, D, T,
        decode_plan(1, hkv, T), float(scale), _build.stream_ptr(q3))
    _build.check(rc, "decode_attention_cells")
    _build.LAUNCHES["decode_attention_cells"] += 1
    return out


def _arena_args(cache, li):
    return (cache.k[li], cache.v[li],
            None if cache.ks is None else cache.ks[li],
            None if cache.vs is None else cache.vs[li])


def decode_attention(cache, li: int, q, mask, *, scale=None):
    """q (B, 1, Hq, D) single-token queries; cache: models.common.KVCache
    (flat arena, layer li); mask additive, broadcastable to (B, 1, 1,
    n_ctx). Returns (B, 1, Hq, D) f32."""
    B, Tq, Hq, D = q.shape
    if Tq != 1:
        raise ValueError("decode attention is single-token only")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    T = cache.n_ctx
    m2 = torch.clamp(torch.broadcast_to(mask.reshape(B, -1)[:, -T:], (B, T))
                     .float(), min=NEG)
    args = (q.reshape(B, Hq, D), *_arena_args(cache, li), m2, cache.heads,
            float(scale))
    if torch.compiler.is_exporting():        # a traced graph holds the op
        from . import library
        fn = library.decode_attention
    else:
        fn = decode_attention_plain if q.device.type == "cpu" \
            else decode_attention_kernel
    return fn(*args).reshape(B, 1, Hq, D)


def decode_attention_cells(cache, li: int, q, mask, *, scale=None):
    """Read-only attention over the shared cell arena (cache batch 1): q
    (NB, 1, Hq, D) rows of distinct sequences whose fresh K/V are already in
    the arena (update_kv_cells); mask (NB, n_ctx) per-cell visibility
    (models.common.cells_attention_mask). Returns (NB, 1, Hq, D) f32."""
    NB, Tq, Hq, D = q.shape
    if Tq != 1:
        raise ValueError("decode attention is single-token only")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    m2 = torch.clamp(mask.reshape(NB, cache.n_ctx).float(), min=NEG)
    args = (q.reshape(NB, Hq, D), *_arena_args(cache, li), m2, cache.heads,
            float(scale))
    fn = decode_attention_plain if q.device.type == "cpu" \
        else decode_attention_cells_kernel
    return fn(*args).reshape(NB, 1, Hq, D)


# ---- fused KV write + decode attention (csrc/decode_attention_update.cu)


def decode_attention_update_plain(q3, k, v, ks, vs, kn, vn, kns, vns, mask2,
                                  rows, hkv: int, scale: float):
    """Plain version of the fused kernel. q3 (NB, Hq, D); k/v/ks/vs the
    layer's arena slices, (NB, T, ..) in flat mode (row n owns arena batch
    n) or (1, T, ..) in cells mode (shared); kn/vn (NB, Hkv*D) the fresh rows
    in the arena's storage type, kns/vns (NB, Hkv*D/32) f32 or None; rows
    (NB,) int64 destination rows. Row n attends over its arena with rows[n]
    left out, then the fresh row is folded in as always visible (its p not
    rounded); then the fresh rows are written into the arena. Returns
    (NB, Hq, D) f32."""
    NB, Hq, D = q3.shape
    Bk, T = k.shape[:2]
    rep = Hq // hkv
    stale = torch.arange(T, device=rows.device)[None] == rows[:, None]
    m, l, pv = _attend(q3, k, v, ks, vs, torch.where(stale, NEG, mask2), hkv,
                       scale)
    kf = _dense(kn[:, None], None if kns is None else kns[:, None], NB, hkv)
    vf = _dense(vn[:, None], None if vns is None else vns[:, None], NB, hkv)
    kf = kf[:, :, 0].repeat_interleave(rep, dim=1)          # (NB, Hq, D)
    vf = vf[:, :, 0].repeat_interleave(rep, dim=1)
    s_n = (q3.to(torch.bfloat16).float() * kf).sum(-1, keepdim=True) * scale
    m2 = torch.maximum(m, s_n)
    a, p_n = torch.exp(m - m2), torch.exp(s_n - m2)
    out = (pv * a + p_n * vf) / torch.clamp(l * a + p_n, min=1e-30)
    b = torch.arange(NB, device=rows.device) if Bk > 1 else 0
    for arena, new in ((k, kn), (v, vn), (ks, kns), (vs, vns)):
        if arena is not None:
            arena[b, rows] = new
    return out


def decode_attention_update_kernel(q3, k, v, ks, vs, kn, vn, kns, vns, mask2,
                                   rows, hkv: int, scale: float):
    """Launch csrc/decode_attention_update.cu (arguments as the plain
    version), once: the keys of each (arena batch row, kv head) split over
    a cluster of decode_plan(Bk, hkv, T) blocks. Takes D 128 or 256, int64
    rows, fresh rows of the arena's type and shape, and 16-byte aligned
    arena slices and fresh rows; raises on anything else, without a
    launch. Allocates only the output (and a copy of q3 where it is not
    16-byte aligned)."""
    NB, Hq, D = q3.shape
    Bk, T = k.shape[:2]
    if Bk not in (1, NB):
        raise ValueError(f"decode_attention_update: arena batch {Bk} for "
                         f"{NB} rows")
    _check_arena("decode_attention_update", q3, k, v, ks, vs, hkv, Bk)
    if kn.shape != (NB, hkv * D) or kn.dtype != k.dtype \
            or vn.shape != kn.shape or vn.dtype != kn.dtype:
        raise ValueError(f"decode_attention_update: fresh rows "
                         f"{tuple(kn.shape)} {kn.dtype}")
    if (ks is None) != (kns is None) or (kns is None) != (vns is None) or (
            kns is not None and (kns.shape != (NB, hkv * D // 32)
                                 or vns.shape != kns.shape)):
        raise ValueError("decode_attention_update: fresh scales do not match "
                         "the arena")
    if rows.dtype != torch.int64 or rows.shape != (NB,):
        raise ValueError(f"decode_attention_update: rows must be int64 "
                         f"({NB},), not {rows.dtype} {tuple(rows.shape)}")
    kn, vn = kn.contiguous(), vn.contiguous()
    kns = None if kns is None else kns.float().contiguous()
    vns = None if vns is None else vns.float().contiguous()
    _check_kernel_arena("decode_attention_update", D, (
        ("k", k), ("v", v), ("ks", ks), ("vs", vs), ("kn", kn), ("vn", vn),
        ("kns", kns), ("vns", vns)))
    q3 = q3.float().contiguous()
    if q3.data_ptr() % 16:            # the kernel reads q in 16-byte loads
        q3 = q3.clone()
    mask2 = mask2.float().contiguous()
    rows = rows.contiguous()
    out = torch.empty(NB, Hq, D, dtype=torch.float32, device=q3.device)
    rc = _build.lib().ggml_decode_attention_update(
        q3.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(ks),
        _build.ptr(vs), kn.data_ptr(), vn.data_ptr(), _build.ptr(kns),
        _build.ptr(vns), rows.data_ptr(), mask2.data_ptr(), out.data_ptr(),
        NB, Bk, Hq, hkv, D, T, decode_plan(Bk, hkv, T), float(scale),
        _build.stream_ptr(q3))
    _build.check(rc, "decode_attention_update")
    _build.LAUNCHES["decode_attention_update"] += 1
    return out


def _update(cache, li, q, k_new, v_new, rows, m2, scale):
    """Fresh rows in the arena's storage type (bf16 cast, or _q8_rows for
    q8_0, before the launch, as the reference quantizes them), then the
    fused kernel or its plain version."""
    NB, Hq, D = q.shape[0], q.shape[-2], q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if cache.quantized:
        k8, kd = _q8_rows(k_new)
        v8, vd = _q8_rows(v_new)
        fresh = (k8.reshape(NB, -1), v8.reshape(NB, -1), kd.reshape(NB, -1),
                 vd.reshape(NB, -1))
    else:
        fresh = (k_new.reshape(NB, -1).to(cache.k.dtype),
                 v_new.reshape(NB, -1).to(cache.v.dtype), None, None)
    args = (q.reshape(NB, Hq, D), *_arena_args(cache, li), *fresh, m2,
            rows.reshape(NB), cache.heads, float(scale))
    if torch.compiler.is_exporting():        # a traced graph holds the op
        from . import library
        fn = library.decode_attention_update
    else:
        fn = decode_attention_update_plain if q.device.type == "cpu" \
            else decode_attention_update_kernel
    return fn(*args), cache


def decode_attention_update(cache, li: int, q, k_new, v_new, n_past, mask,
                            *, scale=None):
    """Flat mode: single-token KV write at row n_past of every batch row of
    layer li plus attention (counterpart of decode_attention_update_stacked).
    q/k_new/v_new (B, 1, H, D); n_past an int or a 0-d int64 tensor on q's
    device (a captured decode step); mask additive, broadcastable to (B, 1,
    1, n_ctx). Returns (attn (B, 1, Hq, D) f32, cache), the arena written in
    place."""
    B, Tq, Hq, D = q.shape
    if Tq != 1:
        raise ValueError("decode attention is single-token only")
    T = cache.n_ctx
    m2 = torch.clamp(torch.broadcast_to(mask.reshape(B, -1)[:, -T:], (B, T))
                     .float(), min=NEG)
    if isinstance(n_past, torch.Tensor):
        rows = n_past.reshape(1).expand(B)
    else:
        rows = torch.full((B,), int(n_past), dtype=torch.int64,
                          device=q.device)
    out, cache = _update(cache, li, q, k_new, v_new, rows, m2, scale)
    return out.reshape(B, 1, Hq, D), cache


def decode_attention_update_cells(cache, li: int, q, k_new, v_new, rows, mask,
                                  *, scale=None):
    """Cells mode over the shared cell arena (cache batch 1): q/k_new/v_new
    carry NB rows of distinct sequences (decode-only ubatches), rows (NB,)
    their destination cells (pad rows: the trash cell), mask (NB, n_ctx) the
    per-cell mask. Each row sees its own fresh K/V apart and other rows'
    cells only through the mask. Returns (attn (NB, Hq, D) f32, cache)."""
    NB = q.shape[0]
    m2 = torch.clamp(mask.reshape(NB, cache.n_ctx).float(), min=NEG)
    return _update(cache, li, q, k_new, v_new, rows.long(), m2, scale)


def select_decode_path(*, T, B, D, cells, cells_kernel=False, mask=None,
                       fused_kv_update=False):
    """The decode attention route of a forward (counterpart of the
    reference's select_decode_path):

      "cells"  - fused cells kernel (decode-only celled ubatch)
      "cells2" - update_kv_cells + read-only cells kernel (decode-only
                 celled ubatch; the serving default)
      "fused"  - fused KV write + attention kernel, flat mode (one token)
      "kernel" - update_kv + read-only decode kernel (one token)
      "xla"    - update_kv or update_kv_cells + attention (flash for T > 1)

    The kernels take D % 128 == 0, the reference's head-alignment gate;
    fused_kv_update selects the fused kernels (the reference's
    GGML_FUSED_KV_UPDATE)."""
    aligned = D % 128 == 0
    if cells_kernel and cells is not None and B == 1 and mask is not None \
            and aligned:
        return "cells" if fused_kv_update else "cells2"
    if T == 1 and cells is None and aligned:
        return "fused" if fused_kv_update else "kernel"
    return "xla"
