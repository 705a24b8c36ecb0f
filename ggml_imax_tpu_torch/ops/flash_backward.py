"""Flash-attention backward (counterpart of
ggml_imax_tpu/ops/flash_backward.py; kernels in csrc/flash_backward.cu).

The forward writes the per-row lse = m + log(l); the backward rebuilds
P = exp(S_eff - lse) from it, FlashAttention-2 style:

  dQ kernel     dS = P * (dO V^T - D),  dQ = dS K * scale
  dK/dV kernel  dV = P^T dO,  dK = dS^T Q * scale, summed over each GQA group

with D_i = rowsum(dO * O) computed here in f32 torch ops. Rounding points
as the reference's kernels: q, k, v and dO in bf16; S, P, dP and dS in f32;
dS and P rounded to bf16 before their products, which sum in f32. A fully
masked row gets the uniform P its forward gave it (every score clamps to
NEG, and so does its lse).
"""
from __future__ import annotations

import torch

from .. import _build
from .decode_attention import NEG
from .flash_attention import _prep


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


def _launch_args(qb, kb, vb, dob, m3, slopes, lse, di, scale, softcap):
    B, Tq, Hq, D = qb.shape
    Tk, Hkv = kb.shape[1], kb.shape[2]
    if D % 16 or D > 256:
        raise ValueError(f"flash backward kernels: head dim {D}")
    for t, dt in zip((qb, kb, vb, dob, lse, di), (torch.bfloat16,) * 4
                     + (torch.float32,) * 2):
        if not t.is_contiguous() or t.dtype != dt:
            raise ValueError("the flash backward kernels take contiguous bf16 "
                             "q/k/v/dO and f32 lse/di")
    ins = (qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), dob.data_ptr(),
           lse.data_ptr(), di.data_ptr(), _build.ptr(m3), _build.ptr(slopes))
    dims = (B, Tq, Tk, Hq, Hkv, D, float(scale), float(softcap),
            _build.stream_ptr(qb))
    return ins, dims


def flash_backward_dq(qb, kb, vb, dob, m3, slopes, lse, di, scale, softcap):
    """Launch the dQ kernel -> dq (B, Tq, Hq, D) f32."""
    ins, dims = _launch_args(qb, kb, vb, dob, m3, slopes, lse, di, scale,
                             softcap)
    dq = torch.empty(qb.shape, dtype=torch.float32, device=qb.device)
    rc = _build.lib().ggml_flash_backward_dq(*ins, dq.data_ptr(), *dims)
    _build.check(rc, "flash_backward_dq")
    _build.LAUNCHES["flash_backward_dq"] += 1
    return dq


def flash_backward_dkv(qb, kb, vb, dob, m3, slopes, lse, di, scale, softcap):
    """Launch the dK/dV kernel -> dk, dv (B, Tk, Hkv, D) f32."""
    ins, dims = _launch_args(qb, kb, vb, dob, m3, slopes, lse, di, scale,
                             softcap)
    dk = torch.empty(kb.shape, dtype=torch.float32, device=kb.device)
    dv = torch.empty_like(dk)
    rc = _build.lib().ggml_flash_backward_dkv(*ins, dk.data_ptr(),
                                              dv.data_ptr(), *dims)
    _build.check(rc, "flash_backward_dkv")
    _build.LAUNCHES["flash_backward_dkv"] += 1
    return dk, dv


def flash_attention_bwd_kernel(qb, kb, vb, dob, m3, slopes, lse, di, scale,
                               softcap):
    """csrc/flash_backward.cu's two kernels on the prepared inputs (as the
    plain version takes them)."""
    args = (qb, kb, vb, dob, m3, slopes, lse.contiguous(), di, scale, softcap)
    return (flash_backward_dq(*args), *flash_backward_dkv(*args))


def backward_prepared(qb, kb, vb, m3, slopes, out, lse, do, scale, softcap):
    """(dq, dk, dv) f32 from the forward's prepared inputs, its output `out`
    (in its own dtype) and lse: D_i here, then the kernels on a CUDA tensor,
    the plain version on a CPU one."""
    di = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dob = do.to(torch.bfloat16).contiguous()
    fn = flash_attention_bwd_plain if qb.device.type == "cpu" \
        else flash_attention_bwd_kernel
    return fn(qb, kb, vb, dob, m3, slopes, lse, di, scale, softcap)


def flash_attention_bwd(q, k, v, mask, out, lse, do, *, scale: float,
                        max_bias: float, logit_softcap: float):
    """-> (dq, dk, dv) in the dtypes of q, k and v. q/out/do (B, Tq, Hq, D),
    k/v (B, Tk, Hkv, D), mask as flash_attention takes it, lse (B, Hq, Tq)
    from the forward (flash_attention(..., want_lse=True))."""
    qb, kb, vb, m3, slopes = _prep(q, k, v, mask, max_bias)
    dq, dk, dv = backward_prepared(qb, kb, vb, m3, slopes, out, lse, do,
                                   float(scale), float(logit_softcap))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
