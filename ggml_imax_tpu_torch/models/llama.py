"""LLaMA (counterpart of ggml_imax_tpu/models/llama.py): RMSNorm, SwiGLU
MLP, grouped-query attention (n_head_kv kv heads, each shared by
n_head / n_head_kv query heads) and rope over the whole head, in ggml's
normal mode (GGUF weights are permuted for it) or NeoX mode (HuggingFace's
half-split pairing).

Per-layer weights stay in ``params["layers"]``, a Python list; the JAX
package's stacked TPU layout (stack_model) is not ported. The decode graph
`prepare_fused` builds is the reference's stacked one: q/k/v fused into one
GEMV (``qkv_w``, split by the GQA widths E, Hkv*D, Hkv*D), gate and up
fused into one (``gu_w``) with F padded to a multiple of 1024 at
production width (the down projection's K padded to match); then
ops.qmm.params_repack puts every weight in the natpair layout. A model whose
q/k/v differ in type (a Q4_K_M file keeps attn_v in Q6_K in half its
layers) is prepared by `fuse_gate_up` alone, as the JAX package runs it:
q/k/v stay unfused, Q4_K weights go natpair and Q6_K ones nat8.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import torch

from .._device import resolve_device
from ..io.gguf import GGUFReader
from ..ops.activations import silu
from ..ops.decode_attention import (decode_attention, decode_attention_cells,
                                    decode_attention_update,
                                    decode_attention_update_cells,
                                    select_decode_path)
from ..ops.embedding import get_rows
from ..ops.flash_attention import attention
from ..ops.norms import rms_norm
from ..ops.qmatmul import qmatmul
from ..ops.rope import ROPE_MODE_NORMAL, rope
from ..quant.device import (QTensor, concat_qtensors, pad_qtensor_cols,
                            pad_qtensor_rows, to_device_format)
from ..quant.codecs import KVALUES_IQ4NL
from ..quant.formats import GGMLType
from ..tokenizer.bpe import ByteLevelBPETokenizer
from .common import (KVCache, attention_mask, file_vector, hf_vector,
                     hf_weight, init_kv_cache, read_kv, update_kv,
                     update_kv_cells)


# the standard deviation of KVALUES_IQ4NL's 16 values (population)
IQ4NL_STD = 67.18


# a single-token step and a decode-only celled ubatch can write their K/V
# inside the attention kernel (fused_kv_update)
FUSED_KV_UPDATE = True


@dataclass(frozen=True)
class LlamaConfig:
    n_vocab: int = 32000
    n_ctx: int = 4096
    n_embd: int = 4096
    n_head: int = 32
    n_head_kv: int = 32
    n_layer: int = 32
    n_ff: int = 11008
    rms_eps: float = 1e-5
    rope_base: float = 10000.0
    rope_scale: float = 1.0
    rope_mode: int = ROPE_MODE_NORMAL   # GGUF weights are pre-permuted for 0

    @property
    def head_dim(self):
        return self.n_embd // self.n_head


def load_gguf(path: str | Path, max_layers: int | None = None, *,
              device=None):
    """A LLaMA-architecture GGUF -> (config, params, tokenizer or None), on
    `device` (the card unless "cpu" is passed): llama.cpp's metadata keys
    and tensor names, the first `max_layers` blocks when given. The
    tokenizer is the byte-level BPE of tokenizer.ggml.tokens and
    tokenizer.ggml.merges when the file holds both. The tensors are read
    through the reader's mapping, one at a time."""
    dev = resolve_device(device)
    with GGUFReader(path) as r:
        md = r.metadata
        arch = md.get("general.architecture", "llama")

        def key(k, default=None):
            return md.get(f"{arch}.{k}", default)

        n_head = int(key("attention.head_count"))
        cfg = LlamaConfig(
            n_vocab=len(md.get("tokenizer.ggml.tokens", []))
            or int(key("vocab_size", 32000)),
            n_ctx=int(key("context_length", 4096)),
            n_embd=int(key("embedding_length")),
            n_head=n_head,
            n_head_kv=int(key("attention.head_count_kv", n_head)),
            n_layer=int(key("block_count")) if max_layers is None
            else min(int(key("block_count")), max_layers),
            n_ff=int(key("feed_forward_length")),
            rms_eps=float(key("attention.layer_norm_rms_epsilon", 1e-5)),
            rope_base=float(key("rope.freq_base", 10000.0)),
            rope_scale=1.0 / float(key("rope.scale_linear", 1.0)),
        )

        def w(name):
            ti = r.tensors[name]
            return to_device_format(r.tensor_data(name), ti.ggml_type, ti.shape,
                               device=dev)

        def vec(name):
            ti = r.tensors[name]
            return file_vector(r.tensor_data(name), ti.ggml_type, ti.shape,
                               device=dev)

        params = {
            "tok_embd": w("token_embd.weight"),
            "out_norm": vec("output_norm.weight"),
            "output": w("output.weight") if "output.weight" in r.tensors
            else None,
            "layers": [],
        }
        for i in range(cfg.n_layer):
            p = f"blk.{i}"
            params["layers"].append({
                "attn_norm": vec(f"{p}.attn_norm.weight"),
                "q_w": w(f"{p}.attn_q.weight"),
                "k_w": w(f"{p}.attn_k.weight"),
                "v_w": w(f"{p}.attn_v.weight"),
                "o_w": w(f"{p}.attn_output.weight"),
                "ffn_norm": vec(f"{p}.ffn_norm.weight"),
                "gate_w": w(f"{p}.ffn_gate.weight"),
                "up_w": w(f"{p}.ffn_up.weight"),
                "down_w": w(f"{p}.ffn_down.weight"),
            })

        tok = None
        if "tokenizer.ggml.tokens" in md and "tokenizer.ggml.merges" in md:
            tok = ByteLevelBPETokenizer(list(md["tokenizer.ggml.tokens"]),
                                        list(md["tokenizer.ggml.merges"]))
    return cfg, params, tok


def from_hf_state_dict(cfg: LlamaConfig, sd: dict,
                       wtype: GGMLType = GGMLType.F32, *, device=None):
    """HF LlamaForCausalLM state dict (numpy arrays or CPU torch tensors)
    -> params. HF Linear weights are (out, in), transposed to (K, N); run
    it with rope_mode ROPE_MODE_NEOX (HF's half-split pairing)."""
    dev = resolve_device(device)
    q2d = lambda name: hf_weight(sd[name].T, wtype, device=dev)
    arr = lambda name: hf_vector(sd[name], device=dev)
    params = {
        "tok_embd": q2d("model.embed_tokens.weight"),
        "out_norm": arr("model.norm.weight"),
        "output": q2d("lm_head.weight") if "lm_head.weight" in sd else None,
        "layers": [],
    }
    for i in range(cfg.n_layer):
        p = f"model.layers.{i}"
        params["layers"].append({
            "attn_norm": arr(f"{p}.input_layernorm.weight"),
            "q_w": q2d(f"{p}.self_attn.q_proj.weight"),
            "k_w": q2d(f"{p}.self_attn.k_proj.weight"),
            "v_w": q2d(f"{p}.self_attn.v_proj.weight"),
            "o_w": q2d(f"{p}.self_attn.o_proj.weight"),
            "ffn_norm": arr(f"{p}.post_attention_layernorm.weight"),
            "gate_w": q2d(f"{p}.mlp.gate_proj.weight"),
            "up_w": q2d(f"{p}.mlp.up_proj.weight"),
            "down_w": q2d(f"{p}.mlp.down_proj.weight"),
        })
    return params


def synthetic_params_device(cfg: LlamaConfig, wtype: GGMLType = GGMLType.Q4_K,
                            seed: int = 0, scale: float = 0.02, *,
                            types=None, device=None):
    """Random weights at full model size, drawn on the device with a
    torch.Generator (no multi-GB host copy), in the reference benchmark's
    structural draw (tools/bench_models.py DeviceGen, llama_params). Each
    2-D weight takes the type `types(name, layer)` gives (name a params key
    such as "v_w" or "output", layer its index or None), `wtype` for every
    one by default:

    - Q4_K: nib4 with uniform bytes, per-32 scale |N| s / 9 and bias
      -|N| s / 3 (the format's min), zero 0;
    - Q6_K: int8 levels uniform in [-32, 31], per-16 scale |N| s / 18.5
      (the levels' standard deviation), no bias;
    - IQ4_XS: int8 levels drawn uniformly from the 16 values of
      KVALUES_IQ4NL (the layout quant.device gives IQ4_XS), per-32 f32
      scale |N| s / 67.18 (67.18: those 16 values' standard deviation), no
      bias.

    Norm weights are N s + 1. Other numbers than the reference's stream,
    the same distribution."""
    types = types or (lambda name, layer: wtype)
    dev = resolve_device(device)
    iq4 = torch.from_numpy(KVALUES_IQ4NL).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    normal = lambda shape: torch.randn(shape, generator=gen, device=dev)

    def q(name, layer, k, n):
        t = types(name, layer)
        if t == GGMLType.Q6_K:
            qs = torch.randint(-32, 32, (k, n), dtype=torch.int8,
                               generator=gen, device=dev)
            sc = normal((k // 16, n)).abs_().mul_(scale / 18.5)
            return QTensor("int8", qs, sc, None, k, n, t)
        if t == GGMLType.IQ4_XS:
            idx = torch.randint(0, 16, (k * n,), dtype=torch.int32,
                                generator=gen, device=dev)
            qs = iq4.index_select(0, idx).reshape(k, n)
            del idx
            sc = normal((k // 32, n)).abs_().mul_(scale / IQ4NL_STD)
            return QTensor("int8", qs, sc, None, k, n, t)
        if t != GGMLType.Q4_K:
            raise NotImplementedError(f"synthetic weights in {t.name}")
        qs = torch.randint(0, 256, (k // 2, n), dtype=torch.uint8,
                           generator=gen, device=dev)
        sc = normal((k // 32, n)).abs_().mul_(scale / 9)
        bias = normal((k // 32, n)).abs_().mul_(-scale / 3)
        return QTensor("nib4", qs, sc, bias, k, n, t, zero=0)

    def norm(n):
        return normal(n).mul_(scale).add_(1.0)

    E, V, F = cfg.n_embd, cfg.n_vocab, cfg.n_ff
    kv = cfg.n_head_kv * cfg.head_dim
    params = {"tok_embd": q("tok_embd", None, E, V), "out_norm": norm(E),
              "output": q("output", None, E, V), "layers": []}
    for li in range(cfg.n_layer):
        params["layers"].append({
            "attn_norm": norm(E),
            "q_w": q("q_w", li, E, E), "k_w": q("k_w", li, E, kv),
            "v_w": q("v_w", li, E, kv), "o_w": q("o_w", li, E, E),
            "ffn_norm": norm(E),
            "gate_w": q("gate_w", li, E, F), "up_w": q("up_w", li, E, F),
            "down_w": q("down_w", li, F, E)})
    return params


def fuse_qkv(params):
    """Concatenate each layer's q/k/v projections ((E, E) + (E, Hkv*D) +
    (E, Hkv*D)) along N into one GEMV (``qkv_w``); forward splits it by
    the GQA widths. Raises ValueError for a layer whose q/k/v differ in
    type (prepare such a model with fuse_gate_up alone)."""
    out = dict(params)
    out["layers"] = []
    for li, lp in enumerate(params["layers"]):
        lp = dict(lp)
        kinds = {(w.kind, w.ggml_type) for w in
                 (lp["q_w"], lp["k_w"], lp["v_w"])}
        if len(kinds) > 1:
            raise ValueError(
                f"fuse_qkv: layer {li} has q/k/v of types "
                f"{[lp[k].ggml_type.name for k in ('q_w', 'k_w', 'v_w')]}; "
                "a mixed model is prepared by fuse_gate_up alone")
        lp["qkv_w"] = concat_qtensors([lp.pop("q_w"), lp.pop("k_w"),
                                       lp.pop("v_w")])
        out["layers"].append(lp)
    return out


def fuse_gate_up(params, pad_multiple: int | None = None):
    """Concatenate gate and up ((E, F) + (E, F)) along N into one GEMV
    (``gu_w``). F is first padded to a multiple of pad_multiple (by default
    1024 for a quantized F >= 8192: LLaMA's 11008 -> 11264): gate and up
    columns by pad_qtensor_cols, down's rows by pad_qtensor_rows. Padded
    columns decode to 0 and silu(0) * 0 = 0, so the padded SwiGLU lanes are
    exactly 0 and meet down's zero rows."""
    out = dict(params)
    out["layers"] = []
    for lp in params["layers"]:
        lp = dict(lp)
        g, u, d = lp.pop("gate_w"), lp.pop("up_w"), lp.pop("down_w")
        mult = pad_multiple
        if mult is None:
            mult = 1024 if g.kind != "dense" and g.n >= 8192 else 1
        if mult > 1:
            g, _ = pad_qtensor_cols(g, mult)
            u, _ = pad_qtensor_cols(u, mult)
            d, _ = pad_qtensor_rows(d, mult)
        lp["gu_w"] = concat_qtensors([g, u])
        lp["down_w"] = d
        out["layers"].append(lp)
    return out


def prepare_fused(params, cfg: LlamaConfig | None = None):
    """The decode graph: fuse_qkv, then fuse_gate_up (the default pad
    rule). Call before ops.qmm.params_repack. Raises ValueError where
    fuse_qkv does (q/k/v of different types)."""
    return fuse_gate_up(fuse_qkv(params))


def init_cache(cfg: LlamaConfig, batch: int = 1, n_ctx: int | None = None,
               dtype=torch.bfloat16, *, device=None) -> KVCache:
    return init_kv_cache(cfg.n_layer, batch, n_ctx or cfg.n_ctx,
                         cfg.n_head_kv, cfg.head_dim, dtype,
                         device=resolve_device(device))


def forward(cfg: LlamaConfig, params, tokens, positions, cache: KVCache,
            n_past: int | torch.Tensor, *, compute_dtype=torch.bfloat16,
            mask=None, cells=None, cells_kernel=False, fused_kv_update=False):
    """tokens/positions (B, T) int on the params' device -> (logits
    (B, T, n_vocab) f32, cache). The KV cache is updated in place.

    Takes the fused key sets (qkv_w, gu_w) and the plain ones (q_w, k_w,
    v_w, gate_w, up_w). cells (B, T) are destination cells of a celled
    arena with `mask` their per-cell mask; otherwise rows [n_past,
    n_past + T) are written (n_past an int, or a 0-d int64 tensor on the
    params' device, as a captured decode step passes it). Each layer's KV
    write and attention take the route of
    ops.decode_attention.select_decode_path, as in models/gptj.forward."""
    B, T = tokens.shape
    H, Hkv, D, E = cfg.n_head, cfg.n_head_kv, cfg.head_dim, cfg.n_embd

    def mm(x, w):
        return qmatmul(x, w, compute_dtype=compute_dtype,
                       out_dtype=torch.float32)

    def _rope(t):
        return rope(t, positions, n_dims=D, mode=cfg.rope_mode,
                    freq_base=cfg.rope_base, freq_scale=cfg.rope_scale)

    x = get_rows(params["tok_embd"], tokens, dtype=torch.float32)
    if mask is None:
        mask = attention_mask(positions, cache.n_ctx, n_past)
    path = select_decode_path(T=T, B=B, D=D, cells=cells,
                              cells_kernel=cells_kernel, mask=mask,
                              fused_kv_update=fused_kv_update)
    # a celled ubatch's T rows are the cells kernels' query rows
    rows = lambda t: t.reshape(T, 1, t.shape[-2], D)

    for li, lp in enumerate(params["layers"]):
        cur = rms_norm(x, lp["attn_norm"], eps=cfg.rms_eps)
        if "qkv_w" in lp:
            qkv = mm(cur, lp["qkv_w"])
            q = qkv[..., :E].reshape(B, T, H, D)
            kk = qkv[..., E:E + Hkv * D].reshape(B, T, Hkv, D)
            vv = qkv[..., E + Hkv * D:].reshape(B, T, Hkv, D)
        else:
            q = mm(cur, lp["q_w"]).reshape(B, T, H, D)
            kk = mm(cur, lp["k_w"]).reshape(B, T, Hkv, D)
            vv = mm(cur, lp["v_w"]).reshape(B, T, Hkv, D)
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
        x = x + mm(attn.reshape(B, T, E), lp["o_w"])

        cur = rms_norm(x, lp["ffn_norm"], eps=cfg.rms_eps)
        if "gu_w" in lp:
            gu = mm(cur, lp["gu_w"])
            F = lp["gu_w"].n // 2
            # the padded lanes are exactly 0 and meet down's zero rows
            ff = (silu(gu[..., :F]) * gu[..., F:])[..., :lp["down_w"].k]
        else:
            ff = silu(mm(cur, lp["gate_w"])) * mm(cur, lp["up_w"])
        x = x + mm(ff, lp["down_w"])

    x = rms_norm(x, params["out_norm"], eps=cfg.rms_eps)
    head = params["output"] if params.get("output") is not None \
        else params["tok_embd"]
    logits = mm(x, head)
    if head.n > cfg.n_vocab:                      # padded head columns
        logits = logits[..., :cfg.n_vocab]
    return logits, cache
