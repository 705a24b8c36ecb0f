"""Mamba's selective state-space ops (counterpart of
ggml_imax_tpu/ops/ssm.py; ggml_ssm_conv and ggml_ssm_scan). The reference
runs the recurrence h_t = dA_t * h_{t-1} + dBx_t as a parallel
lax.associative_scan over the tokens; here it is a loop over the tokens,
as ggml's CPU kernel runs it. The two sum in another order, so they agree
to f32 rounding (the JAX package's tests hold its scan to a sequential
f64 loop at rtol 1e-4, atol 1e-5).

Layouts (ggml's ne reversed):
  ssm_conv:  state (d_inner, d_conv-1), x (T, d_inner), c (d_inner, d_conv)
  ssm_scan:  state (d_inner, d_state),  x/dt (T, d_inner),
             A (d_inner, d_state), B/C (T, d_state)
Both return (y, new_state) in f32; the state carried into the next call
continues the sequence as if the two calls were one.
"""
from __future__ import annotations

import torch


def _softplus20(dt):
    """log1p(exp(dt)), or dt itself above 20 (ggml's cut)."""
    return torch.where(dt <= 20.0, torch.log1p(torch.exp(dt)), dt)


def ssm_conv(state, x, c):
    """Causal depthwise convolution over time with a carried state:
    y[t] = sum_j seq[t + j] * c[:, j] over seq = [state.T; x]. Returns
    y (T, d_inner) and the new state (d_inner, d_conv-1)."""
    d_inner, d_conv = c.shape
    t = x.shape[0]
    seq = torch.cat([state.T.float(), x.float()], dim=0)   # (dc-1+T, d_inner)
    cf = c.float()
    y = torch.zeros((t, d_inner), dtype=torch.float32, device=x.device)
    for j in range(d_conv):
        y = y + seq[j:j + t] * cf[:, j][None, :]
    new_state = seq[t:].T.contiguous() if d_conv > 1 else state
    return y, new_state


def ssm_scan(state, x, dt, a, b, c):
    """Selective scan: per token t and channel i,
      dtsp = softplus(dt[t, i]);  h = h * exp(dtsp A[i]) + B[t] (x[t, i] dtsp)
      y[t, i] = h . C[t]
    state (d_inner, d_state). Returns y (T, d_inner) and the last state."""
    xf = x.float()
    dtsp = _softplus20(dt.float())                            # (T, d_inner)
    da = torch.exp(dtsp[:, :, None] * a.float()[None])        # (T, di, ds)
    dbx = b.float()[:, None, :] * (xf * dtsp)[:, :, None]
    h = state.float()
    hs = []
    for i in range(x.shape[0]):
        h = da[i] * h + dbx[i]
        hs.append(h)
    hs = torch.stack(hs)
    y = torch.einsum("tis,ts->ti", hs, c.float())
    return y, hs[-1]
