"""GPT-J (counterpart of ggml_imax_tpu/models/gptj.py): parallel attention
and MLP residual, partial rotary (n_rot) in ggml's normal mode, untied LM
head with bias.

Per-layer weights stay in ``params["layers"]``, a Python list; the JAX
package's stacked TPU layout (stack_model) is not ported. The decode graph
`prepare_fused` builds is the headline one: split-half rope layout, q/k/v
and fc_in fused into one GEMV (``qkvf_w``), out_proj and fc_out fused into
one (``of_w``), the LM head padded to a multiple of 2048 columns; then
ops.qmm.params_repack puts every weight in the natpair layout.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..io.legacy_bin import read_legacy_bin
from ..ops.activations import gelu
from ..ops.decode_attention import (decode_attention, decode_attention_cells,
                                    decode_attention_update,
                                    decode_attention_update_cells,
                                    select_decode_path)
from ..ops.embedding import get_rows
from ..ops.flash_attention import attention
from ..ops.norms import layer_norm
from ..ops.qmatmul import qmatmul
from ..ops.rope import rope, rope_split, split_rope_permutation
from ..quant.device import (QTensor, concat_qtensors, concat_qtensors_k,
                            pad_qtensor_cols, permute_qtensor_cols,
                            to_device_format)
from ..quant.formats import GGMLType
from ..tokenizer.bpe import GreedyBPETokenizer
from .common import (KVCache, attention_mask, file_vector, hf_vector,
                     hf_weight, init_kv_cache, read_kv, update_kv,
                     update_kv_cells)
from .common import params_from_jax  # noqa: F401  (kept importable here)

HPARAM_NAMES = ["n_vocab", "n_ctx", "n_embd", "n_head", "n_layer", "n_rot",
                "ftype"]


# a single-token step and a decode-only celled ubatch can write their K/V
# inside the attention kernel (fused_kv_update)
FUSED_KV_UPDATE = True


@dataclass(frozen=True)
class GPTJConfig:
    n_vocab: int = 50400
    n_ctx: int = 2048
    n_embd: int = 4096
    n_head: int = 16
    n_layer: int = 28
    n_rot: int = 64

    @property
    def head_dim(self):
        return self.n_embd // self.n_head


def _param_tree(cfg: GPTJConfig, q, vec):
    E, V = cfg.n_embd, cfg.n_vocab
    params = {"wte": q((E, V)), "ln_f_g": vec(E) + 1.0, "ln_f_b": vec(E),
              "lmh_w": q((E, V)), "lmh_b": vec(V), "layers": []}
    for _ in range(cfg.n_layer):
        params["layers"].append({
            "ln_1_g": vec(E) + 1.0, "ln_1_b": vec(E),
            "q_w": q((E, E)), "k_w": q((E, E)), "v_w": q((E, E)),
            "o_w": q((E, E)),
            "fc_in_w": q((E, 4 * E)), "fc_in_b": vec(4 * E),
            "fc_out_w": q((4 * E, E)), "fc_out_b": vec(E),
        })
    return params


def load_legacy(path: str | Path, *, device=None):
    """A reference-format gpt-j .bin -> (config, params, tokenizer): 2-D
    weights in the device layout, 1-D tensors f32, on `device` (the card
    unless "cpu" is passed); the reference's tensor names
    (examples/gpt-j/main.cpp:96-352)."""
    dev = resolve_device(device)
    f = read_legacy_bin(path, HPARAM_NAMES)
    cfg = GPTJConfig(f.hparams["n_vocab"], f.hparams["n_ctx"],
                     f.hparams["n_embd"], f.hparams["n_head"],
                     f.hparams["n_layer"], f.hparams["n_rot"])
    tok = GreedyBPETokenizer(f.vocab)

    def w(name):
        t = f.tensors[name]
        return to_device_format(t.data, t.ggml_type, t.shape, device=dev)

    def vec(name):
        t = f.tensors[name]
        return file_vector(t.data, t.ggml_type, t.shape, device=dev)

    params = {
        "wte": w("transformer.wte.weight"),
        "ln_f_g": vec("transformer.ln_f.weight"),
        "ln_f_b": vec("transformer.ln_f.bias"),
        "lmh_w": w("lm_head.weight"), "lmh_b": vec("lm_head.bias"),
        "layers": [],
    }
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}"
        params["layers"].append({
            "ln_1_g": vec(f"{p}.ln_1.weight"), "ln_1_b": vec(f"{p}.ln_1.bias"),
            "q_w": w(f"{p}.attn.q_proj.weight"),
            "k_w": w(f"{p}.attn.k_proj.weight"),
            "v_w": w(f"{p}.attn.v_proj.weight"),
            "o_w": w(f"{p}.attn.out_proj.weight"),
            "fc_in_w": w(f"{p}.mlp.fc_in.weight"),
            "fc_in_b": vec(f"{p}.mlp.fc_in.bias"),
            "fc_out_w": w(f"{p}.mlp.fc_out.weight"),
            "fc_out_b": vec(f"{p}.mlp.fc_out.bias"),
        })
    return cfg, params, tok


def from_hf_state_dict(cfg: GPTJConfig, sd: dict,
                       wtype: GGMLType = GGMLType.F32, *, device=None):
    """HF GPTJForCausalLM state dict (numpy arrays or CPU torch tensors) ->
    params. HF Linear weights are (out, in); the products take (K = in,
    N = out), the transpose."""
    dev = resolve_device(device)
    q2d = lambda name: hf_weight(sd[name].T, wtype, device=dev)
    arr = lambda name: hf_vector(sd[name], device=dev)
    params = {
        "wte": q2d("transformer.wte.weight"),        # (V, E) -> (E, V)
        "ln_f_g": arr("transformer.ln_f.weight"),
        "ln_f_b": arr("transformer.ln_f.bias"),
        "lmh_w": q2d("lm_head.weight"), "lmh_b": arr("lm_head.bias"),
        "layers": [],
    }
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}"
        params["layers"].append({
            "ln_1_g": arr(f"{p}.ln_1.weight"), "ln_1_b": arr(f"{p}.ln_1.bias"),
            "q_w": q2d(f"{p}.attn.q_proj.weight"),
            "k_w": q2d(f"{p}.attn.k_proj.weight"),
            "v_w": q2d(f"{p}.attn.v_proj.weight"),
            "o_w": q2d(f"{p}.attn.out_proj.weight"),
            "fc_in_w": q2d(f"{p}.mlp.fc_in.weight"),
            "fc_in_b": arr(f"{p}.mlp.fc_in.bias"),
            "fc_out_w": q2d(f"{p}.mlp.fc_out.weight"),
            "fc_out_b": arr(f"{p}.mlp.fc_out.bias"),
        })
    return params


def synthetic_params(cfg: GPTJConfig, wtype: GGMLType = GGMLType.Q4_0,
                     seed: int = 0, scale: float = 0.02, *, device=None):
    """Random Q4_0 weights at full model size, drawn on the host with the
    same numpy stream as the reference's synthetic_params(fast=True), so
    both packages build identical weights from one seed."""
    if wtype != GGMLType.Q4_0:
        raise NotImplementedError(f"synthetic weights in {wtype.name}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def q(shape_kn):
        k, n = shape_kn
        qs = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
        sc = (np.abs(rng.standard_normal((k // 32, n))) * scale / 4.6
              ).astype(np.float32)
        return QTensor("nib4", torch.from_numpy(qs).to(dev),
                       torch.from_numpy(sc).to(dev), None, k, n, wtype, zero=8)

    def vec(n):
        return torch.from_numpy(
            (rng.standard_normal(n) * scale).astype(np.float32)).to(dev)

    return _param_tree(cfg, q, vec)


def synthetic_params_device(cfg: GPTJConfig, wtype: GGMLType = GGMLType.Q4_0,
                            seed: int = 0, scale: float = 0.02, *,
                            device=None):
    """Like synthetic_params, but drawn on the device with a
    torch.Generator: no multi-GB host-to-device copy. Other numbers than
    the host stream, the same distribution."""
    if wtype != GGMLType.Q4_0:
        raise NotImplementedError(f"synthetic weights in {wtype.name}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def q(shape_kn):
        k, n = shape_kn
        qs = torch.randint(0, 256, (k // 2, n), dtype=torch.uint8,
                           generator=gen, device=dev)
        sc = torch.randn((k // 32, n), generator=gen, device=dev).abs_() \
            .mul_(scale / 4.6)
        return QTensor("nib4", qs, sc, None, k, n, wtype, zero=8)

    def vec(n):
        return torch.randn(n, generator=gen, device=dev).mul_(scale)

    return _param_tree(cfg, q, vec)


def split_rope_prep(params, cfg: GPTJConfig):
    """Permute each layer's q/k projection columns so interleaved rope pairs
    (2i, 2i+1) land at split halves (i, D/2 + i), and mark the params
    (``rope_split``) so forward applies rope_split. Exact: attention scores
    are invariant to a consistent permutation of q and k. Idempotent. Call
    before fuse_qkv."""
    if "rope_split" in params:
        return params
    D, H = cfg.head_dim, cfg.n_head
    perm = (np.arange(H)[:, None] * D
            + split_rope_permutation(D)[None, :]).reshape(-1)
    out = dict(params)
    out["layers"] = []
    for lp in params["layers"]:
        lp = dict(lp)
        if "q_w" not in lp or "k_w" not in lp:
            raise ValueError("split_rope_prep before fuse_qkv")
        lp["q_w"] = permute_qtensor_cols(lp["q_w"], perm)
        lp["k_w"] = permute_qtensor_cols(lp["k_w"], perm)
        out["layers"].append(lp)
    out["rope_split"] = None
    return out


def fuse_qkv(params, with_ff: bool = True):
    """Concatenate each layer's q/k/v projections — and, with with_ff,
    fc_in too — along N: attention and MLP read the same normed input, so
    one GEMV feeds them all (``qkvf_w``; ``qkv_w`` without fc_in)."""
    out = dict(params)
    out["layers"] = []
    for lp in params["layers"]:
        lp = dict(lp)
        names = ["q_w", "k_w", "v_w"] + (["fc_in_w"] if with_ff else [])
        lp["qkvf_w" if with_ff else "qkv_w"] = concat_qtensors(
            [lp.pop(n) for n in names])
        out["layers"].append(lp)
    return out


def fuse_out(params):
    """Concatenate out_proj and fc_out along K (``of_w``): their outputs are
    summed into the same residual, so attn @ Wo + ff @ Wfc_out is one GEMV
    over concat([attn, ff])."""
    out = dict(params)
    out["layers"] = []
    for lp in params["layers"]:
        lp = dict(lp)
        lp["of_w"] = concat_qtensors_k([lp.pop("o_w"), lp.pop("fc_out_w")])
        out["layers"].append(lp)
    return out


def pad_lm_head(params, multiple: int | None = None):
    """Pad the LM head's vocab dim (2048 for vocabs >= 16384, else 128) so
    it takes the kernels; padded logits get a -1e30 bias and forward slices
    them off."""
    h = params["lmh_w"]
    if h.kind == "dense":
        return params
    if multiple is None:
        multiple = 2048 if h.n >= 16384 else 128
    h2, npad = pad_qtensor_cols(h, multiple)
    if npad == 0:
        return params
    out = dict(params)
    out["lmh_w"] = h2
    out["lmh_b"] = torch.nn.functional.pad(params["lmh_b"], (0, npad),
                                           value=-1e30)
    return out


def prepare_fused(params, cfg: GPTJConfig):
    """The headline decode graph: split_rope_prep, fuse_qkv (with fc_in),
    fuse_out, pad_lm_head. Call before ops.qmm.params_repack."""
    return pad_lm_head(fuse_out(fuse_qkv(split_rope_prep(params, cfg))))


def init_cache(cfg: GPTJConfig, batch: int = 1, n_ctx: int | None = None,
               dtype=torch.bfloat16, *, device=None) -> KVCache:
    return init_kv_cache(cfg.n_layer, batch, n_ctx or cfg.n_ctx, cfg.n_head,
                         cfg.head_dim, dtype, device=resolve_device(device))


def forward(cfg: GPTJConfig, params, tokens, positions, cache: KVCache,
            n_past: int | torch.Tensor, *, compute_dtype=torch.bfloat16,
            mask=None,
            cells=None, cells_kernel=False, fused_kv_update=False):
    """tokens/positions (B, T) int on the params' device -> (logits
    (B, T, n_vocab) f32, cache). The KV cache is updated in place.

    Takes the fused key sets (qkvf_w / qkv_w, of_w) and the plain ones
    (q_w, k_w, v_w, o_w, fc_in_w, fc_out_w). cells (B, T) are destination
    cells of a celled arena (continuous batching, runtime/batched.py) with
    `mask` their per-cell mask; otherwise rows [n_past, n_past + T) are
    written (n_past an int, or a 0-d int64 tensor on the params' device, as
    a captured decode step passes it: the route depends on shapes only). Each layer's KV write and attention take the route of
    ops.decode_attention.select_decode_path: a decode-only celled ubatch
    (cells_kernel) the cells kernels, a single-token step the decode
    kernel (both fused with fused_kv_update), anything else flash
    attention over the layer's keys."""
    B, T = tokens.shape
    H, D, E = cfg.n_head, cfg.head_dim, cfg.n_embd

    def mm(x, w):
        return qmatmul(x, w, compute_dtype=compute_dtype,
                       out_dtype=torch.float32)

    x = get_rows(params["wte"], tokens, dtype=torch.float32)
    if mask is None:
        mask = attention_mask(positions, cache.n_ctx, n_past)
    if "rope_split" in params:
        _rope = lambda t: rope_split(t, positions, n_dims=cfg.n_rot)
    else:
        _rope = lambda t: rope(t, positions, n_dims=cfg.n_rot)
    path = select_decode_path(T=T, B=B, D=D, cells=cells,
                              cells_kernel=cells_kernel, mask=mask,
                              fused_kv_update=fused_kv_update)
    # a celled ubatch's T rows are the cells kernels' query rows
    rows = lambda t: t.reshape(T, 1, H, D)

    for li, lp in enumerate(params["layers"]):
        cur = layer_norm(x, lp["ln_1_g"], lp["ln_1_b"])
        ff_pre = None
        if "qkvf_w" in lp:
            qkvf = mm(cur, lp["qkvf_w"])
            qkv = qkvf[..., :3 * E].reshape(B, T, 3, H, D)
            ff_pre = qkvf[..., 3 * E:]
        elif "qkv_w" in lp:
            qkv = mm(cur, lp["qkv_w"]).reshape(B, T, 3, H, D)
        else:
            qkv = torch.stack([mm(cur, lp[n]).reshape(B, T, H, D)
                               for n in ("q_w", "k_w", "v_w")], dim=2)
        q, kk, vv = qkv.unbind(2)
        q = _rope(q)
        kk = _rope(kk)
        if path == "cells":
            attn, _ = decode_attention_update_cells(
                cache, li, rows(q), rows(kk), rows(vv), cells[0], mask[0, 0])
        elif path == "cells2":
            update_kv_cells(cache, li, kk, vv, cells)
            attn = decode_attention_cells(cache, li, rows(q), mask[0, 0])
        elif path == "fused":
            attn, _ = decode_attention_update(cache, li, q, kk, vv, n_past,
                                              mask)
        elif path == "kernel":
            update_kv(cache, li, kk, vv, n_past)
            attn = decode_attention(cache, li, q, mask)
        else:
            if cells is None:
                update_kv(cache, li, kk, vv, n_past)
            else:
                update_kv_cells(cache, li, kk, vv, cells)
            attn = attention(q, *read_kv(cache, li, dtype=q.dtype), mask,
                             out_dtype=torch.float32)
        attn = attn.reshape(B, T, E)
        if ff_pre is None:
            ff_pre = mm(cur, lp["fc_in_w"])
        ff = gelu(ff_pre + lp["fc_in_b"])
        if "of_w" in lp:
            y = mm(torch.cat([attn, ff], dim=-1), lp["of_w"])
            x = x + y + lp["fc_out_b"]
        else:
            x = x + mm(attn, lp["o_w"]) + (mm(ff, lp["fc_out_w"])
                                           + lp["fc_out_b"])

    x = layer_norm(x, params["ln_f_g"], params["ln_f_b"])
    logits = mm(x, params["lmh_w"]) + params["lmh_b"]
    if params["lmh_w"].n > cfg.n_vocab:
        logits = logits[..., :cfg.n_vocab]
    return logits, cache
