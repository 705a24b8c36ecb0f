"""GPT-2 (counterpart of ggml_imax_tpu/models/gpt2.py, the reference ggml's
canonical example): learned position embeddings, pre-LN blocks with a bias
after every matmul, the fused (E, 3E) q/k/v projection as stored, and an LM
head tied to ``wte`` unless ``lm_head`` is set.

Per-layer weights stay in ``params["layers"]``, a Python list. Run
ops.qmm.params_repack on the params before `forward` to reach the kernels:
Q8_0, Q8_1, Q5_0, Q5_1, Q5_K and Q6_K weights become nat8, Q4_0 and Q4_1
natpair, Q2_K and Q3_K block-interleaved planes; F32, F16 and BF16 stay
dense. As in the reference, only weights whose N is a multiple of 128
take them (at GPT-2 XL's n_embd 1600: fc_w; at 117M's 768 every layer
weight); the others, the tied LM head among them, dequantize and
multiply. Attention is flash for a multi-token
step and attention_xla for one token (head_dim 64 is under the decode
kernel's 128).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..ops.activations import gelu
from ..ops.embedding import get_rows
from ..ops.flash_attention import attention
from ..ops.norms import layer_norm
from ..ops.qmatmul import qmatmul
from ..quant.device import LAID_OUT, QTensor, quantize_for_device
from ..quant.formats import GGMLType
from .common import (KVCache, attention_mask, init_kv_cache, read_kv,
                     update_kv, update_kv_cells)


# no fused KV-update route: the decode kernels take head_dim 128 or 256,
# so GPT-2 (64) keeps its decode attention plain
FUSED_KV_UPDATE = False


@dataclass(frozen=True)
class GPT2Config:
    n_vocab: int = 50257
    n_ctx: int = 1024
    n_embd: int = 768
    n_head: int = 12
    n_layer: int = 12

    @property
    def head_dim(self):
        return self.n_embd // self.n_head


def _param_tree(cfg: GPT2Config, q, vec):
    """The reference's params layout; draws in its order."""
    E, V, C = cfg.n_embd, cfg.n_vocab, cfg.n_ctx
    params = {"wte": q((E, V)), "wpe": vec(C * E).reshape(C, E),
              "ln_f_g": vec(E) + 1.0, "ln_f_b": vec(E), "lm_head": None,
              "layers": []}
    for _ in range(cfg.n_layer):
        params["layers"].append({
            "ln_1_g": vec(E) + 1.0, "ln_1_b": vec(E),
            "ln_2_g": vec(E) + 1.0, "ln_2_b": vec(E),
            "attn_w": q((E, 3 * E)), "attn_b": vec(3 * E),
            "proj_w": q((E, E)), "proj_b": vec(E),
            "fc_w": q((E, 4 * E)), "fc_b": vec(4 * E),
            "out_w": q((4 * E, E)), "out_b": vec(E),
        })
    return params


def synthetic_params(cfg: GPT2Config, wtype: GGMLType = GGMLType.F32,
                     seed: int = 0, scale: float = 0.02, *, device=None):
    """Random weights at model geometry, drawn on the host with the same
    numpy stream as the reference's synthetic_params and quantized through
    the port's bit-exact codecs (F32, F16, BF16 and every block format with
    a device layout), so both packages build identical weights from one
    seed. The K-quants need n_embd % 256 == 0 (GPT-2 117M's 768, not XL's
    1600)."""
    if wtype not in (GGMLType.F32, GGMLType.F16, GGMLType.BF16) + LAID_OUT:
        raise NotImplementedError(f"synthetic weights in {wtype.name}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def q(shape_kn):
        w = (rng.standard_normal(shape_kn) * scale).astype(np.float32)
        if wtype == GGMLType.F32:
            return QTensor("dense", torch.from_numpy(w).to(dev), None, None,
                           shape_kn[0], shape_kn[1], wtype)
        return quantize_for_device(w, wtype, device=dev)

    def vec(n):
        return torch.from_numpy(
            (rng.standard_normal(n) * scale).astype(np.float32)).to(dev)

    return _param_tree(cfg, q, vec)


def synthetic_params_device(cfg: GPT2Config, seed: int = 0,
                            scale: float = 0.02, *,
                            wtype: GGMLType = GGMLType.Q8_0, device=None):
    """Like synthetic_params, but drawn on the device with a
    torch.Generator (no multi-GB host-to-device copy), every 2-D weight int8
    with per-32 f32 scales: Q8_0 values uniform in [-127, 127] with
    positive scales that give the weights a standard deviation near
    `scale`; Q5_K (the reference benchmark's structural draw,
    tools/bench_models.py DeviceGen) raw levels uniform in [0, 31], scale
    |N| s / 18 and bias -|N| s / 3. Other numbers than the host stream."""
    if wtype not in (GGMLType.Q8_0, GGMLType.Q5_K):
        raise NotImplementedError(f"device-drawn weights in {wtype.name}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    normal = lambda shape: torch.randn(shape, generator=gen, device=dev)

    def q(shape_kn):
        k, n = shape_kn
        if wtype == GGMLType.Q5_K:
            qs = torch.randint(0, 32, (k, n), dtype=torch.int8,
                               generator=gen, device=dev)
            sc = normal((k // 32, n)).abs_().mul_(scale / 18)
            bias = normal((k // 32, n)).abs_().mul_(-scale / 3)
            return QTensor("int8", qs, sc, bias, k, n, wtype)
        qs = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                           generator=gen, device=dev)
        sc = normal((k // 32, n)).abs_() \
            .mul_(scale / 73.6)                # std of uniform [-127, 127]
        return QTensor("int8", qs, sc, None, k, n, wtype)

    def vec(n):
        return torch.randn(n, generator=gen, device=dev).mul_(scale)

    return _param_tree(cfg, q, vec)


def prepare_fused(params, cfg: GPT2Config | None = None):
    """Nothing to fuse: attn_w already is the fused (E, 3E) q/k/v. Kept for
    the same call sequence as gptj (prepare_fused, then params_repack)."""
    return params


def init_cache(cfg: GPT2Config, batch: int = 1, n_ctx: int | None = None,
               dtype=torch.bfloat16, *, device=None) -> KVCache:
    return init_kv_cache(cfg.n_layer, batch, n_ctx or cfg.n_ctx, cfg.n_head,
                         cfg.head_dim, dtype, device=resolve_device(device))


def forward(cfg: GPT2Config, params, tokens, positions, cache: KVCache,
            n_past: int | torch.Tensor, *, compute_dtype=torch.bfloat16,
            mask=None,
            cells=None, cells_kernel=False, fused_kv_update=False):
    """tokens/positions (B, T) int on the params' device -> (logits
    (B, T, n_vocab) f32, cache). The KV cache is updated in place: rows
    [n_past, n_past + T), or the cells (B, T) of a celled arena with `mask`
    their per-cell mask (continuous batching, runtime/batched.py). n_past:
    an int, or a 0-d int64 tensor on the params' device (a captured decode
    step).

    cells_kernel and fused_kv_update are gptj.forward's route keywords, so
    the engines pass one set to every model. The decode kernels take head
    dims that are multiples of 128, so at GPT-2's 64 every ubatch takes the
    plain route, as in the reference: cells_kernel changes nothing, and
    fused_kv_update, a route GPT-2 does not have, raises."""
    if fused_kv_update:
        raise ValueError("gpt2.forward has no fused KV-update route")
    B, T = tokens.shape
    H, D, E = cfg.n_head, cfg.head_dim, cfg.n_embd

    def mm(x, w):
        return qmatmul(x, w, compute_dtype=compute_dtype,
                       out_dtype=torch.float32)

    x = get_rows(params["wte"], tokens, dtype=torch.float32)
    x = x + params["wpe"][positions]
    if mask is None:
        mask = attention_mask(positions, cache.n_ctx, n_past)

    for li, lp in enumerate(params["layers"]):
        cur = layer_norm(x, lp["ln_1_g"], lp["ln_1_b"])
        qkv = mm(cur, lp["attn_w"]) + lp["attn_b"]
        q, kk, vv = (t.reshape(B, T, H, D) for t in qkv.split(E, dim=-1))
        if cells is None:
            update_kv(cache, li, kk, vv, n_past)
        else:
            update_kv_cells(cache, li, kk, vv, cells)
        attn = attention(q, *read_kv(cache, li, dtype=q.dtype), mask,
                         out_dtype=torch.float32)
        x = x + mm(attn.reshape(B, T, E), lp["proj_w"]) + lp["proj_b"]
        cur = layer_norm(x, lp["ln_2_g"], lp["ln_2_b"])
        cur = gelu(mm(cur, lp["fc_w"]) + lp["fc_b"])
        x = x + mm(cur, lp["out_w"]) + lp["out_b"]

    x = layer_norm(x, params["ln_f_g"], params["ln_f_b"])
    head = params["lm_head"] if params.get("lm_head") is not None \
        else params["wte"]
    logits = mm(x, head)
    if head.n > cfg.n_vocab:                       # padded head columns
        logits = logits[..., :cfg.n_vocab]
    return logits, cache
