"""SAM (Segment Anything, ViT-B), promptable image segmentation
(counterpart of ggml_imax_tpu/models/sam.py; the reference's examples/sam).

- image encoder: patch-embed conv s16, + pos_embed, pre-LN blocks with
  windowed attention (win_part, window 14) except the global layers
  (2, 5, 8, 11 in ViT-B), decomposed relative positions (get_rel_pos /
  add_rel_pos), MLP; neck conv1x1 -> LayerNorm2d -> conv3x3 -> LayerNorm2d.
- prompt encoder: random-Gaussian Fourier point PE (sin | cos), the
  point-label embeddings, the no-mask dense embedding.
- mask decoder: [iou token | 4 mask tokens | sparse prompt] through a
  2-layer two-way transformer (the first layer skips the PE) and a final
  token-to-image attention, a 2x2 transposed-conv upscaling stack, the
  per-token hypernetwork MLPs and the IoU head; the first mask and IoU
  dropped (multimask output).

Attention is einsum + softmax as the reference's (a library attention
would not add the relative-position terms in its order); every product
is f32 (no TF32). Everything runs on the params' device; `predict` moves
the image there.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..io.legacy_bin import read_legacy_bin
from ..ops.activations import gelu, relu
from ..ops.conv import _resize_bilinear, conv_2d, conv_transpose_2d_p0
from ..ops.norms import layer_norm
from ..ops.tensor_ops import add_rel_pos, get_rel_pos, win_part, win_unpart
from .common import file_vector

PIXEL_MEAN = np.asarray([123.675, 116.280, 103.530], np.float32)
PIXEL_STD = np.asarray([58.395, 57.120, 57.375], np.float32)


@dataclass(frozen=True)
class SamConfig:
    n_enc_state: int = 768
    n_enc_layer: int = 12
    n_enc_head: int = 12
    n_enc_out_chans: int = 256
    n_pt_embd: int = 4
    n_dec_heads: int = 8
    n_img_size: int = 1024
    n_window_size: int = 14
    n_patch_size: int = 16
    eps: float = 1e-6
    eps_decoder: float = 1e-5
    global_attn: tuple = (2, 5, 8, 11)      # ViT-B (main.cpp:50-62)

    @property
    def n_img_embd(self):
        return self.n_img_size // self.n_patch_size

    @property
    def head_dim(self):
        return self.n_enc_state // self.n_enc_head


HPARAM_NAMES = ["n_enc_state", "n_enc_layer", "n_enc_head",
                "n_enc_out_chans", "n_pt_embd", "ftype"]


def load_legacy(path: str | Path, *, device=None):
    """A SAM legacy .bin (hparams, no vocab, tensor records) -> (cfg,
    params) on `device` (the card unless "cpu"). The image size is not in
    the header (the reference hardcodes 1024): the grid comes from the
    stored positional embedding, so reduced checkpoints load too."""
    dev = resolve_device(device)
    f = read_legacy_bin(path, HPARAM_NAMES, has_vocab=False)
    cfg = SamConfig(f.hparams["n_enc_state"], f.hparams["n_enc_layer"],
                    f.hparams["n_enc_head"], f.hparams["n_enc_out_chans"],
                    f.hparams["n_pt_embd"])

    def t(name):
        x = f.tensors[name]
        return file_vector(x.data, x.ggml_type, x.shape, device=dev)

    def tt(name):                                 # a (K, N) product weight
        return t(name).T.contiguous()

    E = cfg.n_enc_state
    n_pe = f.tensors["image_encoder.pos_embed"].data.nbytes // 4
    I = int(math.isqrt(n_pe // E))
    cfg = replace(cfg, n_img_size=I * cfg.n_patch_size)
    p = {
        "pe": t("image_encoder.pos_embed").reshape(I, I, E),
        "proj_w": t("image_encoder.patch_embed.proj.weight"),
        "proj_b": t("image_encoder.patch_embed.proj.bias"),
        "neck_conv0": t("image_encoder.neck.0.weight"),
        "neck_n0_g": t("image_encoder.neck.1.weight"),
        "neck_n0_b": t("image_encoder.neck.1.bias"),
        "neck_conv1": t("image_encoder.neck.2.weight"),
        "neck_n1_g": t("image_encoder.neck.3.weight"),
        "neck_n1_b": t("image_encoder.neck.3.bias"),
        "enc_layers": [],
        "pe_gauss": t(
            "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
        "not_a_pt": t("prompt_encoder.not_a_point_embed.weight").reshape(-1),
        "no_mask": t("prompt_encoder.no_mask_embed.weight").reshape(-1),
        "pt_embd": [t(f"prompt_encoder.point_embeddings.{i}.weight")
                    .reshape(-1) for i in range(cfg.n_pt_embd)],
    }
    for i in range(cfg.n_enc_layer):
        pre = f"image_encoder.blocks.{i}"
        p["enc_layers"].append({
            "n1_g": t(f"{pre}.norm1.weight"), "n1_b": t(f"{pre}.norm1.bias"),
            "rel_w": t(f"{pre}.attn.rel_pos_w"),
            "rel_h": t(f"{pre}.attn.rel_pos_h"),
            "qkv_w": tt(f"{pre}.attn.qkv.weight"),
            "qkv_b": t(f"{pre}.attn.qkv.bias"),
            "proj_w": tt(f"{pre}.attn.proj.weight"),
            "proj_b": t(f"{pre}.attn.proj.bias"),
            "n2_g": t(f"{pre}.norm2.weight"), "n2_b": t(f"{pre}.norm2.bias"),
            "mlp1_w": tt(f"{pre}.mlp.lin1.weight"),
            "mlp1_b": t(f"{pre}.mlp.lin1.bias"),
            "mlp2_w": tt(f"{pre}.mlp.lin2.weight"),
            "mlp2_b": t(f"{pre}.mlp.lin2.bias"),
        })
    p["dec"] = _load_decoder(t, tt)
    return cfg, p


def _load_decoder(t, tt):
    def attn(prefix):
        names = [("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                 ("o", "out_proj")]
        return {f"{k}_w": tt(f"{prefix}.{n}.weight") for k, n in names} | \
               {f"{k}_b": t(f"{prefix}.{n}.bias") for k, n in names}

    def mlp3(prefix):
        return {f"w{j}": tt(f"{prefix}.layers.{j}.weight") for j in range(3)} \
            | {f"b{j}": t(f"{prefix}.layers.{j}.bias") for j in range(3)}

    d = {"layers": []}
    base = "mask_decoder.transformer.layers"
    for i in range(2):
        pre = f"{base}.{i}"
        lp = {"self": attn(f"{pre}.self_attn"),
              "t2i": attn(f"{pre}.cross_attn_token_to_image"),
              "i2t": attn(f"{pre}.cross_attn_image_to_token")}
        for j in (1, 2, 3, 4):
            lp[f"n{j}_g"] = t(f"{pre}.norm{j}.weight")
            lp[f"n{j}_b"] = t(f"{pre}.norm{j}.bias")
        lp |= {"mlp1_w": tt(f"{pre}.mlp.lin1.weight"),
               "mlp1_b": t(f"{pre}.mlp.lin1.bias"),
               "mlp2_w": tt(f"{pre}.mlp.lin2.weight"),
               "mlp2_b": t(f"{pre}.mlp.lin2.bias")}
        d["layers"].append(lp)
    d["final_t2i"] = attn("mask_decoder.transformer.final_attn_token_to_image")
    d["nf_g"] = t("mask_decoder.transformer.norm_final_attn.weight")
    d["nf_b"] = t("mask_decoder.transformer.norm_final_attn.bias")
    for k, j in (("up0", 0), ("up3", 3)):
        d[f"{k}_w"] = t(f"mask_decoder.output_upscaling.{j}.weight")
        d[f"{k}_b"] = t(f"mask_decoder.output_upscaling.{j}.bias")
    d["up1_g"] = t("mask_decoder.output_upscaling.1.weight")
    d["up1_b"] = t("mask_decoder.output_upscaling.1.bias")
    d["hyper"] = [mlp3(f"mask_decoder.output_hypernetworks_mlps.{i}")
                  for i in range(4)]
    d["iou"] = mlp3("mask_decoder.iou_prediction_head")
    d["iou_token"] = t("mask_decoder.iou_token.weight")
    d["mask_tokens"] = t("mask_decoder.mask_tokens.weight")
    return d


def synthetic_params(cfg: SamConfig, rng: np.random.Generator, scale=0.05,
                     *, device=None):
    """Random weights drawn from `rng` in the reference's order, so both
    packages build the same weights from one generator."""
    dev = resolve_device(device)
    E, I, C = cfg.n_enc_state, cfg.n_img_embd, cfg.n_enc_out_chans

    def d(*shape):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=dev)

    def attn(dim, kv=None):
        kv = kv or dim
        return {"q_w": d(C, kv), "k_w": d(C, kv), "v_w": d(C, kv),
                "o_w": d(kv, C), "q_b": d(kv), "k_b": d(kv), "v_b": d(kv),
                "o_b": d(C)}

    p = {"pe": d(I, I, E),
         "proj_w": d(E, 3, cfg.n_patch_size, cfg.n_patch_size),
         "proj_b": d(E),
         "neck_conv0": d(C, E, 1, 1), "neck_n0_g": ones(C), "neck_n0_b": d(C),
         "neck_conv1": d(C, C, 3, 3), "neck_n1_g": ones(C), "neck_n1_b": d(C),
         "enc_layers": [],
         "pe_gauss": d(2, C // 2), "not_a_pt": d(C), "no_mask": d(C),
         "pt_embd": [d(C) for _ in range(cfg.n_pt_embd)]}
    maxrel = 2 * max(cfg.n_window_size, I) - 1
    for _ in range(cfg.n_enc_layer):
        p["enc_layers"].append({
            "n1_g": ones(E), "n1_b": d(E),
            "rel_w": d(maxrel, cfg.head_dim), "rel_h": d(maxrel, cfg.head_dim),
            "qkv_w": d(E, 3 * E), "qkv_b": d(3 * E),
            "proj_w": d(E, E), "proj_b": d(E),
            "n2_g": ones(E), "n2_b": d(E),
            "mlp1_w": d(E, 4 * E), "mlp1_b": d(4 * E),
            "mlp2_w": d(4 * E, E), "mlp2_b": d(E),
        })
    dec = {"layers": []}
    for _ in range(2):
        dec["layers"].append({
            "self": attn(C), "t2i": attn(C, C // 2), "i2t": attn(C, C // 2),
            "n1_g": ones(C), "n1_b": d(C), "n2_g": ones(C), "n2_b": d(C),
            "n3_g": ones(C), "n3_b": d(C), "n4_g": ones(C), "n4_b": d(C),
            "mlp1_w": d(C, 8 * C), "mlp1_b": d(8 * C),
            "mlp2_w": d(8 * C, C), "mlp2_b": d(C),
        })
    dec["final_t2i"] = attn(C, C // 2)
    dec["nf_g"], dec["nf_b"] = ones(C), d(C)
    dec["up0_w"] = d(C, C // 4, 2, 2)
    dec["up0_b"] = d(C // 4)
    dec["up1_g"], dec["up1_b"] = ones(C // 4), d(C // 4)
    dec["up3_w"] = d(C // 4, C // 8, 2, 2)
    dec["up3_b"] = d(C // 8)
    dec["hyper"] = [{"w0": d(C, C), "b0": d(C), "w1": d(C, C), "b1": d(C),
                     "w2": d(C, C // 8), "b2": d(C // 8)} for _ in range(4)]
    dec["iou"] = {"w0": d(C, C), "b0": d(C), "w1": d(C, C), "b1": d(C),
                  "w2": d(C, 4), "b2": d(4)}
    dec["iou_token"] = d(1, C)
    dec["mask_tokens"] = d(4, C)
    p["dec"] = dec
    return p


def _ln2d(x, g, b, eps):
    """sam_layer_norm_2d: layer norm over the channels of (B, C, H, W)."""
    mu = x.mean(dim=1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=1, keepdim=True)
    y = (x - mu) / torch.sqrt(var + eps)
    return y * g[None, :, None, None] + b[None, :, None, None]


def encode_image(cfg: SamConfig, params, img):
    """img: (B, 3, n_img_size, n_img_size) preprocessed ->
    (B, n_enc_out_chans, n_img_embd, n_img_embd)."""
    H = cfg.n_enc_head
    D = cfg.head_dim
    E = cfg.n_enc_state
    x = conv_2d(img, params["proj_w"], s0=cfg.n_patch_size,
                s1=cfg.n_patch_size) + params["proj_b"][None, :, None, None]
    x = x.permute(0, 2, 3, 1) + params["pe"][None]          # (B, I, I, E)
    sqrt_d = torch.full((), float(D), dtype=torch.float32,
                        device=x.device).sqrt()

    for il, lp in enumerate(params["enc_layers"]):
        shortcut = x
        h = layer_norm(x, lp["n1_g"], lp["n1_b"], eps=cfg.eps)
        b0, h0, w0, _ = h.shape
        local = il not in cfg.global_attn
        if local:
            h = win_part(h, cfg.n_window_size)
        bw, hh, ww, _ = h.shape

        qkv = (h.reshape(bw, hh * ww, E) @ lp["qkv_w"]) + lp["qkv_b"]
        qkv = qkv.reshape(bw, hh * ww, 3, H, D).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                    # (bw, H, hw, D)
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) / sqrt_d

        rw = get_rel_pos(lp["rel_w"], ww, ww)               # (W, W, D)
        rh = get_rel_pos(lp["rel_h"], hh, hh)
        qr = q.reshape(bw * H, hh, ww, D)
        rel_w = torch.einsum("bhwd,wkd->bhwk", qr, rw)      # (.., hh, ww, W)
        rel_h = torch.einsum("bhwd,hkd->bhwk", qr.transpose(1, 2),
                             rh).transpose(1, 2)
        s = add_rel_pos(s.reshape(bw * H, hh * ww, hh * ww), rel_w, rel_h)
        a = torch.softmax(s, dim=-1).reshape(bw, H, hh * ww, hh * ww)
        o = torch.einsum("bhqk,bhkd->bhqd", a, v)
        o = o.transpose(1, 2).reshape(bw, hh, ww, E)
        o = o @ lp["proj_w"] + lp["proj_b"]
        if local:
            o = win_unpart(o, h0, w0, cfg.n_window_size)
        x = shortcut + o
        m = layer_norm(x, lp["n2_g"], lp["n2_b"], eps=cfg.eps)
        m = gelu(m @ lp["mlp1_w"] + lp["mlp1_b"]) @ lp["mlp2_w"] + lp["mlp2_b"]
        x = x + m

    x = x.permute(0, 3, 1, 2)                               # (B, E, I, I)
    x = conv_2d(x, params["neck_conv0"])
    x = _ln2d(x, params["neck_n0_g"], params["neck_n0_b"], cfg.eps)
    x = conv_2d(x, params["neck_conv1"], p0=1, p1=1)
    return _ln2d(x, params["neck_n1_g"], params["neck_n1_b"], cfg.eps)


def _pe_encode(params, coords01):
    """Fourier point PE: coords in [0, 1] -> (..., C) [sin | cos]."""
    c = 2.0 * coords01 - 1.0
    proj = (c @ params["pe_gauss"]) * (2.0 * np.pi)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def encode_prompt(cfg: SamConfig, params, point01):
    """One foreground point (x, y) in [0, 1] -> (sparse (2, C), dense
    (C, I, I)). Row 1 is the not-a-point pad token."""
    dev = params["pe_gauss"].device
    pt = _pe_encode(params, torch.as_tensor(
        np.asarray(point01, np.float32), device=dev)[None])
    sparse = torch.stack([pt[0] + params["pt_embd"][1], params["not_a_pt"]])
    I = cfg.n_img_embd
    dense = params["no_mask"][:, None, None].expand(cfg.n_enc_out_chans, I, I)
    return sparse, dense


def image_pe(cfg: SamConfig, params):
    """Dense positional encoding of the image grid -> (C, I, I)."""
    I = cfg.n_img_embd
    dev = params["pe_gauss"].device
    ys = (torch.arange(I, dtype=torch.float32, device=dev) + 0.5) / I
    xs = (torch.arange(I, dtype=torch.float32, device=dev) + 0.5) / I
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
    return _pe_encode(params, grid).permute(2, 0, 1)


def _dec_attn(a, q, k, v, n_head):
    def split(x, w, b):
        y = x @ w + b
        t, c = y.shape
        return y.reshape(t, n_head, c // n_head).transpose(0, 1)

    qh = split(q, a["q_w"], a["q_b"])
    kh = split(k, a["k_w"], a["k_b"])
    vh = split(v, a["v_w"], a["v_b"])
    sqrt_d = torch.full((), float(qh.shape[-1]), dtype=torch.float32,
                        device=q.device).sqrt()
    s = torch.einsum("hqd,hkd->hqk", qh, kh) / sqrt_d
    o = torch.einsum("hqk,hkd->hqd", torch.softmax(s, dim=-1), vh)
    o = o.transpose(0, 1).reshape(q.shape[0], -1)
    return o @ a["o_w"] + a["o_b"]


def decode_mask(cfg: SamConfig, params, embd_img, sparse, dense, pe_img):
    """-> (masks (3, 4 I, 4 I) logits, iou (3,)): multimask output with the
    first token dropped."""
    dec = params["dec"]
    nh = cfg.n_dec_heads
    eps = cfg.eps_decoder
    C = cfg.n_enc_out_chans
    I = cfg.n_img_embd

    tokens = torch.cat([dec["iou_token"], dec["mask_tokens"], sparse])
    src = (embd_img[0] + dense).reshape(C, I * I).T         # (hw, C)
    pos = pe_img.reshape(C, I * I).T

    q, keys = tokens, src
    for li, lp in enumerate(dec["layers"]):
        if li == 0:
            # skip_first_layer_pe: the attention replaces the queries
            q = _dec_attn(lp["self"], q, q, q, nh)
        else:
            q0 = q + tokens
            q = q + _dec_attn(lp["self"], q0, q0, q, nh)
        q = layer_norm(q, lp["n1_g"], lp["n1_b"], eps=eps)
        q = q + _dec_attn(lp["t2i"], q + tokens, keys + pos, keys, nh)
        q = layer_norm(q, lp["n2_g"], lp["n2_b"], eps=eps)
        m = relu(q @ lp["mlp1_w"] + lp["mlp1_b"]) @ lp["mlp2_w"] + lp["mlp2_b"]
        q = layer_norm(q + m, lp["n3_g"], lp["n3_b"], eps=eps)
        keys = keys + _dec_attn(lp["i2t"], keys + pos, q + tokens, q, nh)
        keys = layer_norm(keys, lp["n4_g"], lp["n4_b"], eps=eps)

    q = q + _dec_attn(dec["final_t2i"], q + tokens, keys + pos, keys, nh)
    q = layer_norm(q, dec["nf_g"], dec["nf_b"], eps=eps)

    iou_tok, mask_toks = q[0], q[1:5]
    img = keys.T.reshape(1, C, I, I)
    up = conv_transpose_2d_p0(img, dec["up0_w"], 2) \
        + dec["up0_b"][None, :, None, None]
    up = gelu(_ln2d(up, dec["up1_g"], dec["up1_b"], cfg.eps))
    up = conv_transpose_2d_p0(up, dec["up3_w"], 2) \
        + dec["up3_b"][None, :, None, None]
    up = gelu(up)                                           # (1, C/8, 4I, 4I)

    def mlp3(m, x):
        h = relu(x @ m["w0"] + m["b0"])
        h = relu(h @ m["w1"] + m["b1"])
        return h @ m["w2"] + m["b2"]

    hyper = torch.stack([mlp3(dec["hyper"][i], mask_toks[i])
                         for i in range(4)])
    flat = up[0].reshape(up.shape[1], -1)                   # (C/8, 16 I^2)
    masks = (hyper @ flat).reshape(4, 4 * I, 4 * I)
    iou = mlp3(dec["iou"], iou_tok)
    return masks[1:], iou[1:]


def preprocess(img, cfg: SamConfig = SamConfig(), *, device=None):
    """img: (H, W, 3) uint8 or float (numpy or torch) -> ((1, 3, S, S)
    normalized and zero-padded on `device` (img's own device for a tensor,
    else the card unless "cpu"), (nh, nw) the resized size)."""
    if device is None and isinstance(img, torch.Tensor):
        device = img.device
    dev = resolve_device(device)
    h, w = img.shape[:2]
    s = cfg.n_img_size / max(h, w)
    nh, nw = int(round(h * s)), int(round(w * s))
    x = _resize_bilinear(torch.as_tensor(img, device=dev).float(), (nh, nw, 3))
    x = (x - torch.from_numpy(PIXEL_MEAN).to(dev)) \
        / torch.from_numpy(PIXEL_STD).to(dev)
    out = torch.zeros((cfg.n_img_size, cfg.n_img_size, 3), dtype=torch.float32,
                      device=dev)
    out[:nh, :nw] = x
    return out.permute(2, 0, 1)[None], (nh, nw)


def predict(cfg: SamConfig, params, img, point_xy, *,
            mask_threshold: float = 0.0):
    """The whole pipeline on the params' device for one image (H, W, 3)
    and one foreground point (pixel coords). Returns (binary masks
    (3, H, W), iou (3,)) as numpy."""
    h, w = img.shape[:2]
    x, (nh, nw) = preprocess(img, cfg, device=params["pe"].device)
    embd = encode_image(cfg, params, x)
    pt01 = (np.asarray(point_xy, np.float32) * (nh / h, nw / w)
            / cfg.n_img_size)
    sparse, dense = encode_prompt(cfg, params, pt01)
    masks, iou = decode_mask(cfg, params, embd, sparse, dense,
                             image_pe(cfg, params))
    # crop the padding, upscale to the original resolution
    mi = masks.shape[-1]
    crop_h, crop_w = int(mi * nh / cfg.n_img_size), int(mi * nw / cfg.n_img_size)
    m = _resize_bilinear(masks[:, :crop_h, :crop_w], (3, h, w))
    return m.cpu().numpy() > mask_threshold, iou.cpu().numpy()
