"""Flash-attention backward (counterpart of
ggml_imax_tpu/ops/flash_backward.py; kernels in csrc/flash_backward.cu).

The forward writes the per-row lse = m + log(l); the backward rebuilds
P = exp(S_eff - lse) from it, FlashAttention-2 style:

  dQ kernel     dS = P * (dO V^T - D),  dQ = dS K * scale
  dK/dV kernel  dV = P^T dO,  dK = dS^T Q * scale, summed over each GQA group

with D_i = rowsum(dO * O) computed here in f32 torch ops. Rounding points
as the reference's kernels: q, k, v and dO in bf16; S, P, dP and dS in f32;
dS and P rounded to bf16 before their products, which sum in f32. A fully
masked row's scores and lse = m + log(tk) all round to its masked score
(NEG * slope), so its P is 1 at every key, as the reference's backward
has it.

The kernels share a map of the mask's 64 x 64 tiles (all NEG, all 0 or
mixed; `backward_tile_map`, built by the forward and kept for the backward
of a differentiable call, else one launch a backward) and skip an all-NEG tile
where that is exact: every valid query row of the tile has lse > -1e30
(`skipped_plain` states the rule, `backward_tile_map_plain` the map). The
dK/dV kernel at D in (64, 128] takes query steps of 32 rows and applies
the rule to each step (`dkv_rows`).
"""
from __future__ import annotations

import torch

from .. import _build
from .decode_attention import NEG
from .flash_attention import _prep


TILE = 64                                # the map's query and key tile
TILE_ZERO, TILE_MIXED, TILE_NEG = 0, 1, 2


def backward_tile_map_plain(m3, bq=TILE, bk=TILE):
    """(B, ceil(Tq/bq), ceil(Tk/bk)) uint8 class of each tile of m3 (its
    entries inside (Tq, Tk)): TILE_NEG where every entry is NEG, TILE_ZERO
    where every entry is 0, TILE_MIXED otherwise."""
    B, Tq, Tk = m3.shape
    nq, nk = -(-Tq // bq), -(-Tk // bk)
    pad = (0, nk * bk - Tk, 0, nq * bq - Tq)

    def every(hit):
        hit = torch.nn.functional.pad(hit, pad, value=True)
        return hit.reshape(B, nq, bq, nk, bk).all(4).all(2)
    cls = torch.full((B, nq, nk), TILE_MIXED, dtype=torch.uint8,
                     device=m3.device)
    cls[every(m3 == 0)] = TILE_ZERO
    cls[every(m3 == NEG)] = TILE_NEG
    return cls


def dkv_rows(d):
    """The query rows the dK/dV kernel walks at once at head dim d, and so
    the rows its skip rule looks at together (the dQ kernel: TILE)."""
    return 32 if 64 < d <= 128 else TILE


def skipped_plain(tiles, lse, slopes, tk, rows=TILE, bq=TILE, bk=TILE):
    """(B, Hq, Tq, tk) bool: the scores a kernel skips, those of the
    all-NEG tiles whose every query row, in blocks of `rows` (a divisor of
    bq), has lse > -1e30 (and whose head has NEG * slope < -1e32). There
    p = exp(max(s + NEG * slope, NEG) - lse) is 0 exactly, and so is ds."""
    B, Hq, Tq = lse.shape
    ok = torch.nn.functional.pad(lse > -1e30, (0, -Tq % bq), value=True)
    ok = ok.reshape(B, Hq, -1, rows).all(-1)               # (B, Hq, nq * bq/rows)
    if slopes is not None:
        ok = ok & (slopes * NEG < -1e32).reshape(1, Hq, 1)
    neg = (tiles == TILE_NEG).repeat_interleave(bq // rows, 1)[:, None]
    skip = neg & ok[..., None]                             # (B, Hq, nq * bq/rows, nk)
    skip = skip.repeat_interleave(rows, 2).repeat_interleave(bk, 3)
    return skip[:, :, :Tq, :tk]


def flash_attention_bwd_plain(qb, kb, vb, dob, m3, slopes, lse, di, scale,
                              softcap):
    """Plain version on the prepared inputs: bf16 q/dO (B, Tq, Hq, D) and
    k/v (B, Tk, Hkv, D), m3 (B, Tq, Tk) f32 >= NEG or None, slopes (Hq) or
    None, lse and di (B, Hq, Tq) f32. Returns f32 dq (B, Tq, Hq, D) and
    dk, dv (B, Tk, Hkv, D)."""
    B, Tq, Hq, D = qb.shape
    Tk, Hkv = kb.shape[1], kb.shape[2]
    rep = Hq // Hkv
    qf = qb.float().transpose(1, 2)                        # (B, Hq, Tq, D)
    dof = dob.float().transpose(1, 2)
    kf = kb.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    vf = vb.float().transpose(1, 2).repeat_interleave(rep, dim=1)
    s = (qf @ kf.transpose(-1, -2)) * scale
    t = None
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    if m3 is not None:
        mb = m3[:, None]
        if slopes is not None:
            mb = mb * slopes.reshape(1, Hq, 1, 1)
        s = torch.clamp(s + mb, min=NEG)
    p = torch.exp(s - lse[..., None])
    ds = p * (dof @ vf.transpose(-1, -2) - di[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    dsb, pb = ds.to(torch.bfloat16).float(), p.to(torch.bfloat16).float()
    dq = (dsb @ kf) * scale
    dk = (dsb.transpose(-1, -2) @ qf) * scale               # (B, Hq, Tk, D)
    dv = pb.transpose(-1, -2) @ dof
    dk = dk.reshape(B, Hkv, rep, Tk, D).sum(2)
    dv = dv.reshape(B, Hkv, rep, Tk, D).sum(2)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _launch_args(qb, kb, vb, dob, m3, slopes, lse, di, scale, softcap,
                 tiles):
    B, Tq, Hq, D = qb.shape
    Tk, Hkv = kb.shape[1], kb.shape[2]
    if D % 16 or D > 256:
        raise ValueError(f"flash backward kernels: head dim {D}")
    for t, dt in zip((qb, kb, vb, dob, lse, di), (torch.bfloat16,) * 4
                     + (torch.float32,) * 2):
        if not t.is_contiguous() or t.dtype != dt:
            raise ValueError("the flash backward kernels take contiguous bf16 "
                             "q/k/v/dO and f32 lse/di")
    if any(t.data_ptr() % 16 for t in (qb, kb, vb, dob)) \
            or (m3 is not None and m3.data_ptr() % 16):
        raise ValueError("the flash backward kernels take 16-byte aligned "
                         "q/k/v/dO and mask")
    if (tiles is None) != (m3 is None) or tiles is not None and (
            tiles.dtype != torch.uint8
            or tuple(tiles.shape) != (B, -(-Tq // TILE), -(-Tk // TILE))):
        raise ValueError("tiles: the uint8 map of backward_tile_map(m3), "
                         "given with a mask and only then")
    ins = (qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), dob.data_ptr(),
           lse.data_ptr(), di.data_ptr(), _build.ptr(m3), _build.ptr(slopes),
           _build.ptr(tiles))
    dims = (B, Tq, Tk, Hq, Hkv, D, float(scale), float(softcap),
            _build.stream_ptr(qb))
    return ins, dims


def backward_tile_map(m3):
    """Launch the tile-map kernel on m3 (B, Tq, Tk) f32 -> the map
    `backward_tile_map_plain(m3)` gives."""
    B, Tq, Tk = m3.shape
    if not m3.is_contiguous() or m3.dtype != torch.float32 \
            or m3.data_ptr() % 16:
        raise ValueError("the tile-map kernel takes a contiguous, 16-byte "
                         "aligned f32 mask")
    tiles = torch.empty(B, -(-Tq // TILE), -(-Tk // TILE), dtype=torch.uint8,
                        device=m3.device)
    rc = _build.lib().ggml_flash_backward_tiles(
        m3.data_ptr(), tiles.data_ptr(), B, Tq, Tk, _build.stream_ptr(m3))
    _build.check(rc, "flash_backward_tiles")
    _build.LAUNCHES["flash_backward_tiles"] += 1
    return tiles


def flash_backward_dq(qb, kb, vb, dob, m3, slopes, lse, di, scale, softcap,
                      tiles):
    """Launch the dQ kernel -> dq (B, Tq, Hq, D) f32. tiles: the map of
    `backward_tile_map(m3)`, or None without a mask."""
    ins, dims = _launch_args(qb, kb, vb, dob, m3, slopes, lse, di, scale,
                             softcap, tiles)
    dq = torch.empty(qb.shape, dtype=torch.float32, device=qb.device)
    rc = _build.lib().ggml_flash_backward_dq(*ins, dq.data_ptr(), *dims)
    _build.check(rc, "flash_backward_dq")
    _build.LAUNCHES["flash_backward_dq"] += 1
    return dq


def flash_backward_dkv(qb, kb, vb, dob, m3, slopes, lse, di, scale, softcap,
                       tiles):
    """Launch the dK/dV kernel -> dk, dv (B, Tk, Hkv, D) f32 (tiles as
    `flash_backward_dq` takes it)."""
    ins, dims = _launch_args(qb, kb, vb, dob, m3, slopes, lse, di, scale,
                             softcap, tiles)
    dk = torch.empty(kb.shape, dtype=torch.float32, device=kb.device)
    dv = torch.empty_like(dk)
    rc = _build.lib().ggml_flash_backward_dkv(*ins, dk.data_ptr(),
                                              dv.data_ptr(), *dims)
    _build.check(rc, "flash_backward_dkv")
    _build.LAUNCHES["flash_backward_dkv"] += 1
    return dk, dv


def flash_attention_bwd_kernel(qb, kb, vb, dob, m3, slopes, lse, di, scale,
                               softcap, tiles=None):
    """csrc/flash_backward.cu's kernels on the prepared inputs (as the plain
    version takes them): the tile map of a mask (unless the forward's is
    given), then dQ and dK/dV. The map goes last and positionally, so
    `scale` stays at index 8."""
    if tiles is None and m3 is not None:
        tiles = backward_tile_map(m3)
    args = (qb, kb, vb, dob, m3, slopes, lse.contiguous(), di, scale, softcap,
            tiles)
    return (flash_backward_dq(*args), *flash_backward_dkv(*args))


def backward_prepared(qb, kb, vb, m3, slopes, out, lse, do, scale, softcap,
                      tiles=None):
    """(dq, dk, dv) f32 from the forward's prepared inputs, its output `out`
    (in its own dtype), lse and tile map (or None): D_i here, then the
    kernels on a CUDA tensor, the plain version on a CPU one."""
    di = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dob = do.to(torch.bfloat16).contiguous()
    args = (qb, kb, vb, dob, m3, slopes, lse, di, scale, softcap)
    if qb.device.type == "cpu":
        return flash_attention_bwd_plain(*args)
    return flash_attention_bwd_kernel(*args, tiles=tiles)


def flash_attention_bwd(q, k, v, mask, out, lse, do, *, scale: float,
                        max_bias: float, logit_softcap: float):
    """-> (dq, dk, dv) in the dtypes of q, k and v. q/out/do (B, Tq, Hq, D),
    k/v (B, Tk, Hkv, D), mask as flash_attention takes it, lse (B, Hq, Tq)
    from the forward (flash_attention(..., want_lse=True))."""
    qb, kb, vb, m3, slopes = _prep(q, k, v, mask, max_bias)
    dq, dk, dv = backward_prepared(qb, kb, vb, m3, slopes, out, lse, do,
                                   float(scale), float(logit_softcap))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
