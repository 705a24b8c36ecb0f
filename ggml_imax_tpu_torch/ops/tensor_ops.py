"""The rest of ggml's op set (counterpart of ggml_imax_tpu/ops/tensor_ops.py;
enum ggml_op): thin torch expressions. ggml's ne order is the reverse of
the shape order here, so "rows" means the last axis (ne0). `acc` and
`set_` are functional: they return a new tensor and leave `dst` as it
was. Ops that make a tensor from no tensor (`arange`) take `device`, the
card unless "cpu" is passed."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .._device import resolve_device
from .activations import leaky_relu as _leaky_relu


def scale(x, s: float):
    """GGML_OP_SCALE."""
    return x * s


def clamp(x, lo: float, hi: float):
    """ggml_clamp."""
    return torch.clamp(x, lo, hi)


def sqr(x):
    return x * x


def sqrt_(x):
    return torch.sqrt(x)


def log_(x):
    return torch.log(x)


def sum_(x):
    """GGML_OP_SUM: the whole tensor to one f32 value, shape (1,)."""
    return x.float().sum().reshape(1)


def sum_rows(x):
    """GGML_OP_SUM_ROWS: the innermost axis summed in f32, kept."""
    return x.float().sum(dim=-1, keepdim=True).to(x.dtype)


def mean(x):
    """GGML_OP_MEAN: the innermost axis' f32 mean, kept."""
    return x.float().mean(dim=-1, keepdim=True)


def argmax(x):
    """GGML_OP_ARGMAX over the innermost axis (the first of equal maxima),
    int32."""
    return torch.argmax(x, dim=-1).to(torch.int32)


def repeat(x, target_shape):
    """GGML_OP_REPEAT: tile x up to target_shape."""
    reps = tuple(t // s for t, s in zip(target_shape, x.shape))
    return x.repeat(*reps)


def concat(a, b, axis: int = -3):
    """ggml_concat along ne2 (axis -3 of a 4-D tensor) by default."""
    return torch.cat([a, b], dim=axis)


def argsort(x, descending: bool = False):
    """GGML_OP_ARGSORT over the innermost axis, int32: a stable sort (of -x
    when descending, as the reference), so equal values keep index
    order."""
    order = torch.argsort(-x if descending else x, dim=-1, stable=True)
    return order.to(torch.int32)


def top_k(x, k: int):
    """ggml_top_k: the indices of the k largest, largest first."""
    return argsort(x, descending=True)[..., :k]


def _future(x, n_past):
    tq, tk = x.shape[-2:]
    q = torch.arange(tq, device=x.device)[:, None]
    k = torch.arange(tk, device=x.device)[None, :]
    return k > q + n_past


def diag_mask_inf(x, n_past: int):
    """ggml_diag_mask_inf: x (..., Tq, Tk) in f32, -inf where
    k > n_past + q."""
    return torch.where(_future(x, n_past), float("-inf"), x.float())


def diag_mask_zero(x, n_past: int):
    """ggml_diag_mask_zero."""
    return torch.where(_future(x, n_past), 0.0, x.float())


def _view(dst, shape, offsets):
    """The slices of dst at `offsets`, each start clamped so the view lies
    inside dst (lax.dynamic_slice's rule)."""
    return tuple(slice(s, s + n) for s, n in (
        (max(0, min(int(o), d - n)), n)
        for o, d, n in zip(offsets, dst.shape, shape)))


def acc(dst, src, offsets):
    """GGML_OP_ACC: src added into the view of dst at element offsets; a
    new tensor."""
    out = dst.clone()
    v = _view(dst, src.shape, offsets)
    out[v] = dst[v] + src.to(dst.dtype)
    return out


def set_(dst, src, offsets):
    """GGML_OP_SET: the view of dst at offsets overwritten; a new
    tensor."""
    out = dst.clone()
    out[_view(dst, src.shape, offsets)] = src.to(dst.dtype)
    return out


def arange(start: float, stop: float, step: float, *, device=None):
    """ggml_arange, f32."""
    return torch.arange(start, stop, step, dtype=torch.float32,
                        device=resolve_device(device))


def timestep_embedding(timesteps, dim: int, max_period: int = 10000):
    """ggml_timestep_embedding (stable diffusion's): (T, dim), cos in the
    first half, sin in the second, a zero column when dim is odd."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def win_part(x, w: int):
    """ggml_win_part (SAM's windowed attention): x (B, H, W, C) ->
    (B * nWh * nWw, w, w, C), zero-padded to multiples of w."""
    b, h, wdt, c = x.shape
    ph, pw = (-h) % w, (-wdt) % w
    xp = F.pad(x, (0, 0, 0, pw, 0, ph))
    nh, nw = (h + ph) // w, (wdt + pw) // w
    xw = xp.reshape(b, nh, w, nw, w, c).permute(0, 1, 3, 2, 4, 5)
    return xw.reshape(b * nh * nw, w, w, c)


def win_unpart(x, h: int, wdt: int, w: int):
    """ggml_win_unpart: win_part's inverse, the padding cropped."""
    nh, nw = (h + (-h) % w) // w, (wdt + (-wdt) % w) // w
    b = x.shape[0] // (nh * nw)
    c = x.shape[-1]
    xw = x.reshape(b, nh, nw, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return xw.reshape(b, nh * w, nw * w, c)[:, :h, :wdt, :]


def get_rel_pos(rel_pos, qh: int, kh: int):
    """ggml_get_rel_pos (SAM's decomposed relative positions): rel_pos
    (2 max - 1, C) -> (qh, kh, C), gathered at q - k + (kh - 1) in scaled
    coordinates: the arithmetic in f32, then truncated to int as the
    reference's astype(int32)."""
    dev = rel_pos.device
    q = torch.arange(qh, dtype=torch.float32, device=dev)[:, None] \
        * max(kh / qh, 1.0)
    k = torch.arange(kh, dtype=torch.float32, device=dev)[None, :] \
        * max(qh / kh, 1.0)
    coords = (q - k + (kh - 1) * max(qh / kh, 1.0)).to(torch.int32)
    return rel_pos[coords.long()]


def add_rel_pos(attn, rel_w, rel_h):
    """ggml_add_rel_pos: attn (B, qh*qw, kh*kw) + rel_h (B, qh, qw, kh)
    broadcast over kw + rel_w (B, qh, qw, kw) broadcast over kh."""
    b = attn.shape[0]
    _, qh, qw, kh = rel_h.shape
    kw = rel_w.shape[-1]
    a = attn.reshape(b, qh, qw, kh, kw)
    a = a + rel_h[..., :, None] + rel_w[..., None, :]
    return a.reshape(b, qh * qw, kh * kw)


def _log_softmax(x):
    """jax.nn.log_softmax's formula over the last axis."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def cross_entropy_loss(logits, labels):
    """ggml_cross_entropy_loss: the mean over rows of
    -sum(labels * log_softmax(logits)), shape (1,); labels are
    probabilities (often one-hot)."""
    ls = _log_softmax(logits.float())
    per_row = -(labels.float() * ls).sum(dim=-1)
    return per_row.mean().reshape(1)


def leaky_relu(x, negative_slope: float = 0.1):
    return _leaky_relu(x, negative_slope)


def flip(x, axis: int):
    return torch.flip(x, (axis,))


def outer_prod(a, b):
    """GGML_OP_OUT_PROD: a (..., M), b (..., N) -> (..., N, M) in f32
    (ggml: ne = [M, N])."""
    return torch.einsum("...m,...n->...nm", a.float(), b.float())
