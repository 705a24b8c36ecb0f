"""Whisper, the encoder-decoder speech recognizer (counterpart of
ggml_imax_tpu/models/whisper.py).

- conv frontend: conv1d(k 3, s 1, p 1) + gelu, conv1d(k 3, s 2, p 1) + gelu;
- encoder: + the positional embedding, pre-LN blocks whose K projection
  has no bias, a final LN;
- cross K/V: per decoder layer K = enc @ xk_w (no bias), V = enc @ xv_w +
  xv_b, computed once per audio window;
- decoder: token + learned position embeddings, blocks of causal
  self-attention over the KV cache, cross-attention and an MLP, the LM
  head tied to the token embedding ``d_te``.

Per-layer weights stay in Python lists (``enc_layers``, ``dec_layers``);
the JAX package's stacked decoder (stack_decoder) is not ported. Run
`prepare_fused` (the decoder's q/k/v as one (E, 3E) product) and
ops.qmm.params_repack to reach the kernels: Q5_0 and Q8_0 weights become
nat8 (W8A8 at one row, W8A16 above), Q4_0 natpair. Only weights whose N is
a multiple of 128 take them, as in the reference: the tied head at
n_vocab 51865 dequantizes and multiplies unless its columns are padded
(quant.device.pad_qtensor_cols, before repacking). Attention is flash
for more than one query row (the encoder, the prompt step) and
attention_xla for one (head_dim 64 is under the decode kernel's 128).
decode(return_cross_attn=True) also returns each layer's cross-attention
probabilities, the alignment signal of the DTW token timestamps
(runtime/whisper_pipeline.token_timestamps).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .._device import resolve_device
from ..ops.activations import gelu
from ..ops.conv import conv_1d
from ..ops.embedding import get_rows
from ..ops.flash_attention import attention
from ..ops.norms import layer_norm
from ..ops.qmatmul import qmatmul
from ..quant.device import QTensor, concat_qtensors
from ..quant.formats import GGMLType
from .common import KVCache, attention_mask, init_kv_cache, read_kv, update_kv

@dataclass(frozen=True)
class WhisperConfig:
    """hparams as stored in the ggml checkpoint."""
    n_vocab: int = 51864
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    n_mels: int = 80

    @property
    def is_multilingual(self):
        return self.n_vocab >= 51865

    # special tokens; multilingual ids shift by +1
    @property
    def token_eot(self):
        return 50256 + int(self.is_multilingual)

    @property
    def token_sot(self):
        return 50257 + int(self.is_multilingual)

    @property
    def token_prev(self):
        return 50360 + int(self.is_multilingual)

    @property
    def token_nosp(self):
        return 50361 + int(self.is_multilingual)

    @property
    def token_not(self):
        return 50362 + int(self.is_multilingual)

    @property
    def token_beg(self):
        return 50363 + int(self.is_multilingual)

    @property
    def token_transcribe(self):
        return 50358 + int(self.is_multilingual)

    @property
    def token_translate(self):
        return 50357 + int(self.is_multilingual)


def synthetic_params_device(cfg: WhisperConfig, wtype: GGMLType | None = None,
                            seed: int = 0, scale: float = 0.02, *,
                            device=None):
    """Random weights at the model's geometry, drawn on the device with a
    torch.Generator (nothing crosses from the host), with the reference's
    distribution for each wtype: Q5_0 (the default) int8 levels uniform in
    [-16, 16) with per-32 f32 scales |N| scale / 9.2; Q8_0 levels in
    [-127, 128) with |N| scale / 74; Q4_0 nib4 bytes uniform (zero 8) with
    |N| scale / 4.6; any other wtype dense bf16 N scale. Other numbers than
    the reference's jax.random stream."""
    wtype = wtype or GGMLType.Q5_0
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    normal = lambda shape: torch.randn(shape, generator=gen, device=dev)

    def q(shape_kn):
        k, n = shape_kn
        if wtype in (GGMLType.Q5_0, GGMLType.Q8_0):
            lo, hi, div = (-16, 16, 9.2) if wtype == GGMLType.Q5_0 \
                else (-127, 128, 74)
            qv = torch.randint(lo, hi, (k, n), dtype=torch.int8,
                               generator=gen, device=dev)
            sc = normal((k // 32, n)).abs_().mul_(scale / div)
            return QTensor("int8", qv, sc, None, k, n, wtype)
        if wtype == GGMLType.Q4_0:
            qs = torch.randint(0, 256, (k // 2, n), dtype=torch.uint8,
                               generator=gen, device=dev)
            sc = normal((k // 32, n)).abs_().mul_(scale / 4.6)
            return QTensor("nib4", qs, sc, None, k, n, wtype, zero=8)
        w = normal((k, n)).mul_(scale)
        return QTensor("dense", w.to(torch.bfloat16), None, None, k, n, wtype)

    def vec(*shape):
        return normal(shape).mul_(scale)

    E, Et, V = cfg.n_audio_state, cfg.n_text_state, cfg.n_vocab
    p = {
        "e_pe": vec(cfg.n_audio_ctx, E),
        "e_conv1_w": vec(E, cfg.n_mels, 3),
        "e_conv1_b": vec(1, E, 1),
        "e_conv2_w": vec(E, E, 3),
        "e_conv2_b": vec(1, E, 1),
        "e_ln_g": vec(E) + 1.0, "e_ln_b": vec(E),
        "d_te": q((Et, V)),
        "d_pe": vec(cfg.n_text_ctx, Et),
        "d_ln_g": vec(Et) + 1.0, "d_ln_b": vec(Et),
        "enc_layers": [], "dec_layers": [],
    }
    for _ in range(cfg.n_audio_layer):
        p["enc_layers"].append({
            "ln0_g": vec(E) + 1.0, "ln0_b": vec(E),
            "q_w": q((E, E)), "q_b": vec(E),
            "k_w": q((E, E)),
            "v_w": q((E, E)), "v_b": vec(E),
            "o_w": q((E, E)), "o_b": vec(E),
            "ln1_g": vec(E) + 1.0, "ln1_b": vec(E),
            "mlp0_w": q((E, 4 * E)), "mlp0_b": vec(4 * E),
            "mlp1_w": q((4 * E, E)), "mlp1_b": vec(E),
        })
    for _ in range(cfg.n_text_layer):
        p["dec_layers"].append({
            "ln0_g": vec(Et) + 1.0, "ln0_b": vec(Et),
            "q_w": q((Et, Et)), "q_b": vec(Et),
            "k_w": q((Et, Et)),
            "v_w": q((Et, Et)), "v_b": vec(Et),
            "o_w": q((Et, Et)), "o_b": vec(Et),
            "xln_g": vec(Et) + 1.0, "xln_b": vec(Et),
            "xq_w": q((Et, Et)), "xq_b": vec(Et),
            "xk_w": q((Et, Et)),
            "xv_w": q((Et, Et)), "xv_b": vec(Et),
            "xo_w": q((Et, Et)), "xo_b": vec(Et),
            "ln1_g": vec(Et) + 1.0, "ln1_b": vec(Et),
            "mlp0_w": q((Et, 4 * Et)), "mlp0_b": vec(4 * Et),
            "mlp1_w": q((4 * Et, Et)), "mlp1_b": vec(Et),
        })
    return p


def _mm(x, w, compute_dtype):
    return qmatmul(x, w, compute_dtype=compute_dtype, out_dtype=torch.float32)


def encode(cfg: WhisperConfig, params, mel, *, compute_dtype=torch.bfloat16):
    """mel (B, n_mels, 2 n_audio_ctx) -> encoder states (B, n_audio_ctx, E)
    f32."""
    H, E = cfg.n_audio_head, cfg.n_audio_state
    D = E // H
    mm = lambda x, w: _mm(x, w, compute_dtype)

    cur = gelu(conv_1d(mel, params["e_conv1_w"], 1, 1) + params["e_conv1_b"])
    cur = gelu(conv_1d(cur, params["e_conv2_w"], 2, 1) + params["e_conv2_b"])
    x = cur.transpose(1, 2)                          # (B, T, E)
    B, T, _ = x.shape
    x = x + params["e_pe"][None, :T]

    for lp in params["enc_layers"]:
        cur = layer_norm(x, lp["ln0_g"], lp["ln0_b"])
        q = (mm(cur, lp["q_w"]) + lp["q_b"]).reshape(B, T, H, D)
        k = mm(cur, lp["k_w"]).reshape(B, T, H, D)            # no bias
        v = (mm(cur, lp["v_w"]) + lp["v_b"]).reshape(B, T, H, D)
        a = attention(q, k, v, None, out_dtype=torch.float32).reshape(B, T, E)
        x = x + mm(a, lp["o_w"]) + lp["o_b"]
        cur = layer_norm(x, lp["ln1_g"], lp["ln1_b"])
        ff = gelu(mm(cur, lp["mlp0_w"]) + lp["mlp0_b"])
        x = x + mm(ff, lp["mlp1_w"]) + lp["mlp1_b"]

    return layer_norm(x, params["e_ln_g"], params["e_ln_b"])


def precompute_cross_kv(cfg: WhisperConfig, params, enc, *,
                        compute_dtype=torch.bfloat16):
    """Each decoder layer's K/V of the encoder states enc (B, T, E).
    Returns (K, V), each (n_text_layer, B, T, H, D) f32."""
    H = cfg.n_text_head
    D = cfg.n_text_state // H
    B, T, _ = enc.shape
    ks, vs = [], []
    for lp in params["dec_layers"]:
        ks.append(_mm(enc, lp["xk_w"], compute_dtype).reshape(B, T, H, D))
        vs.append((_mm(enc, lp["xv_w"], compute_dtype)
                   + lp["xv_b"]).reshape(B, T, H, D))
    return torch.stack(ks), torch.stack(vs)


def fuse_dec_qkv(params):
    """Each decoder layer's self-attention q/k/v as one (E, 3E) product
    `qkv_w` (k has no bias: zeros in `qkv_b`). Call before
    ops.qmm.params_repack."""
    out = dict(params)
    out["dec_layers"] = []
    for lp in params["dec_layers"]:
        lp = dict(lp)
        q_b = lp.pop("q_b")
        lp["qkv_w"] = concat_qtensors([lp.pop("q_w"), lp.pop("k_w"),
                                       lp.pop("v_w")])
        lp["qkv_b"] = torch.cat([q_b, torch.zeros_like(q_b), lp.pop("v_b")])
        out["dec_layers"].append(lp)
    return out


def prepare_fused(params, cfg: WhisperConfig | None = None):
    """The decode fast path's preparation (the same call sequence as the
    other models: prepare_fused, then params_repack)."""
    return fuse_dec_qkv(params)


def init_cache(cfg: WhisperConfig, batch: int = 1, n_ctx: int | None = None,
               dtype=torch.bfloat16, *, device=None) -> KVCache:
    return init_kv_cache(cfg.n_text_layer, batch, n_ctx or cfg.n_text_ctx,
                         cfg.n_text_head, cfg.n_text_state // cfg.n_text_head,
                         dtype, device=resolve_device(device))


def decode(cfg: WhisperConfig, params, tokens, positions, cache: KVCache,
           cross_kv, n_past, *, compute_dtype=torch.bfloat16,
           return_cross_attn: bool = False):
    """tokens/positions (B, T) int on the params' device -> (logits
    (B, T, n_vocab) f32, cache); the KV cache's rows [n_past, n_past + T)
    are written in place. n_past: an int, or a 0-d int64 tensor on the
    params' device (a captured decode step reads it there). cross_kv:
    precompute_cross_kv's (K, V) with B rows. Takes the decoder's q/k/v
    fused (prepare_fused) or as three products; padded head columns are
    sliced off. With return_cross_attn, also the cross-attention
    probabilities (n_text_layer, B, H, T, T_audio) f32: softmax over the
    audio axis of q K^T / sqrt(D), computed beside the layer's attention
    (which is unchanged), as the reference computes them outside its
    kernels."""
    if "dec_stack" in params:
        # the reference refuses these with return_cross_attn, and the port
        # has no stacked decoder at all
        raise ValueError("decode takes the unstacked decoder (dec_layers); "
                         "return_cross_attn (DTW token timestamps) needs it "
                         "too: keep a params copy without stack_decoder")
    H, E = cfg.n_text_head, cfg.n_text_state
    D = E // H
    B, T = tokens.shape
    mm = lambda x, w: _mm(x, w, compute_dtype)
    xk, xv = cross_kv
    te = params["d_te"]

    # The reference's gather clamps an id past the table to its last row
    # (JAX's out-of-bounds rule); torch indexing would raise on the host and
    # fault on the card. Prompt ids of a vocabulary smaller than the special
    # tokens' (tiny test models) rely on the clamp.
    x = get_rows(te, tokens.clamp(0, te.n - 1), dtype=torch.float32)
    x = x + params["d_pe"][positions]
    mask = attention_mask(positions, cache.n_ctx, n_past)
    cross_probs = []

    for li, lp in enumerate(params["dec_layers"]):
        cur = layer_norm(x, lp["ln0_g"], lp["ln0_b"])
        if "qkv_w" in lp:
            qkv = mm(cur, lp["qkv_w"]) + lp["qkv_b"]
            q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(E, dim=-1))
        else:
            q = (mm(cur, lp["q_w"]) + lp["q_b"]).reshape(B, T, H, D)
            k = mm(cur, lp["k_w"]).reshape(B, T, H, D)
            v = (mm(cur, lp["v_w"]) + lp["v_b"]).reshape(B, T, H, D)
        update_kv(cache, li, k, v, n_past)
        a = attention(q, *read_kv(cache, li, dtype=q.dtype), mask,
                      out_dtype=torch.float32)
        x = x + mm(a.reshape(B, T, E), lp["o_w"]) + lp["o_b"]

        cur = layer_norm(x, lp["xln_g"], lp["xln_b"])
        q = (mm(cur, lp["xq_w"]) + lp["xq_b"]).reshape(B, T, H, D)
        a = attention(q, xk[li], xv[li], None, out_dtype=torch.float32)
        if return_cross_attn:
            s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                             xk[li].float()) / math.sqrt(D)
            cross_probs.append(torch.softmax(s, dim=-1))
        x = x + mm(a.reshape(B, T, E), lp["xo_w"]) + lp["xo_b"]

        cur = layer_norm(x, lp["ln1_g"], lp["ln1_b"])
        ff = gelu(mm(cur, lp["mlp0_w"]) + lp["mlp0_b"])
        x = x + mm(ff, lp["mlp1_w"]) + lp["mlp1_b"]

    x = layer_norm(x, params["d_ln_g"], params["d_ln_b"])
    logits = mm(x, te)                                  # tied head
    if te.n > cfg.n_vocab:                              # padded head columns
        logits = logits[..., :cfg.n_vocab]
    if return_cross_attn:
        return logits, cache, torch.stack(cross_probs)
    return logits, cache
