"""Magika, file-type identification (counterpart of
ggml_imax_tpu/models/magika.py; the reference's examples/magika).

A 1536-token window of a file's bytes (512 each from its beginning, middle
and end, padded with token 256) -> one-hot(257) dense + gelu -> 4-token
groups (384 x 512) -> layer norm over the position axis -> two dense +
gelu blocks -> global max pool -> layer norm -> the 113-label head +
softmax. The one-hot product is a row gather of dense_w (exact in f32).
Every product is f32 (no TF32).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..io.gguf import GGUFReader
from ..ops.activations import gelu
from ..ops.norms import layer_norm

LABELS = ['ai', 'apk', 'appleplist', 'asm', 'asp', 'batch', 'bmp', 'bzip', 'c', 'cab', 'cat', 'chm', 'coff', 'crx', 'cs', 'css', 'csv', 'deb', 'dex', 'dmg', 'doc', 'docx', 'elf', 'emf', 'eml', 'epub', 'flac', 'gif', 'go', 'gzip', 'hlp', 'html', 'ico', 'ini', 'internetshortcut', 'iso', 'jar', 'java', 'javabytecode', 'javascript', 'jpeg', 'json', 'latex', 'lisp', 'lnk', 'm3u', 'macho', 'makefile', 'markdown', 'mht', 'mp3', 'mp4', 'mscompress', 'msi', 'mum', 'odex', 'odp', 'ods', 'odt', 'ogg', 'outlook', 'pcap', 'pdf', 'pebin', 'pem', 'perl', 'php', 'png', 'postscript', 'powershell', 'ppt', 'pptx', 'python', 'pythonbytecode', 'rar', 'rdf', 'rpm', 'rst', 'rtf', 'ruby', 'rust', 'scala', 'sevenzip', 'shell', 'smali', 'sql', 'squashfs', 'svg', 'swf', 'symlinktext', 'tar', 'tga', 'tiff', 'torrent', 'ttf', 'txt', 'unknown', 'vba', 'wav', 'webm', 'webp', 'winregistry', 'wmf', 'xar', 'xls', 'xlsb', 'xlsx', 'xml', 'xpi', 'xz', 'yaml', 'zip', 'zlibstream']

BEG_SIZE = MID_SIZE = END_SIZE = 512
BLOCK = BEG_SIZE + MID_SIZE + END_SIZE          # 1536
PAD_TOKEN = 256
N_VOCAB = 257
NORM_EPS = 1e-3                                  # hparams.f_norm_eps

# params key -> the GGUF tensor name (examples/magika/main.cpp:111-127)
GGUF_NAMES = {
    "dense_w": "dense/kernel:0", "dense_b": "dense/bias:0",
    "ln_g": "layer_normalization/gamma:0",
    "ln_b": "layer_normalization/beta:0",
    "dense1_w": "dense_1/kernel:0", "dense1_b": "dense_1/bias:0",
    "dense2_w": "dense_2/kernel:0", "dense2_b": "dense_2/bias:0",
    "ln1_g": "layer_normalization_1/gamma:0",
    "ln1_b": "layer_normalization_1/beta:0",
    "label_w": "target_label/kernel:0", "label_b": "target_label/bias:0",
}


def load_gguf(path: str | Path, *, device=None):
    """A Magika GGUF -> params (f32) on `device` (the card unless "cpu")."""
    dev = resolve_device(device)
    with GGUFReader(path) as r:
        return {k: torch.from_numpy(r.tensor_array(n).astype(np.float32))
                .to(dev) for k, n in GGUF_NAMES.items()}


def synthetic_params(rng: np.random.Generator, n_label: int = len(LABELS),
                     *, device=None):
    """Random weights drawn from `rng` in the reference's order, so both
    packages build the same weights from one generator."""
    dev = resolve_device(device)

    def d(i, o):
        return torch.from_numpy(
            (rng.standard_normal((i, o)) * 0.05).astype(np.float32)).to(dev)

    def v(n, fill=0.0):
        return torch.full((n,), fill, dtype=torch.float32, device=dev)

    return {"dense_w": d(N_VOCAB, 128), "dense_b": v(128),
            "ln_g": v(384, 1.0), "ln_b": v(384),
            "dense1_w": d(512, 256), "dense1_b": v(256),
            "dense2_w": d(256, 256), "dense2_b": v(256),
            "ln1_g": v(256, 1.0), "ln1_b": v(256),
            "label_w": d(256, n_label), "label_b": v(n_label)}


def file_tokens(data: bytes) -> np.ndarray:
    """(1536,) int32 token window: beg/mid/end 512-byte reads, padded with
    PAD_TOKEN (main.cpp:276-300)."""
    buf = np.full(BLOCK, PAD_TOKEN, np.int32)
    b = np.frombuffer(data, np.uint8)
    n = len(b)
    beg = b[:BEG_SIZE]
    buf[:len(beg)] = beg
    mid_off = max(0, (n - MID_SIZE) // 2)
    mid = b[mid_off:mid_off + MID_SIZE]
    buf[BEG_SIZE + (MID_SIZE - len(mid)) // 2:
        BEG_SIZE + (MID_SIZE - len(mid)) // 2 + len(mid)] = mid
    end = b[-END_SIZE:] if n else b[:0]
    buf[BLOCK - len(end):] = end
    return buf


def forward(params, tokens):
    """tokens: (N, 1536) int (numpy or torch) -> label probabilities
    (N, n_label) on the params' device."""
    w = params["dense_w"]
    tokens = torch.as_tensor(tokens, device=w.device).long()
    x = gelu(w[tokens] + params["dense_b"])                  # (N, 1536, 128)
    n = x.shape[0]
    x = x.reshape(n, 384, 512)                               # 4-token groups
    # layer norm over the position axis: each feature across positions
    x = x.transpose(1, 2)                                    # (N, 512, 384)
    x = layer_norm(x, params["ln_g"], params["ln_b"], eps=NORM_EPS)
    x = x.transpose(1, 2)                                    # (N, 384, 512)
    x = gelu(x @ params["dense1_w"] + params["dense1_b"])    # (N, 384, 256)
    x = gelu(x @ params["dense2_w"] + params["dense2_b"])
    x = x.amax(dim=1)                                        # global max pool
    x = layer_norm(x, params["ln1_g"], params["ln1_b"], eps=NORM_EPS)
    logits = x @ params["label_w"] + params["label_b"]
    return torch.softmax(logits, dim=-1)


def identify(params, data: bytes, top: int = 5):
    """The `top` most likely labels of a file's bytes, with their
    probabilities, most likely first."""
    probs = forward(params, file_tokens(data)[None])[0].cpu().numpy()
    order = np.argsort(-probs)[:top]
    return [(LABELS[i] if i < len(LABELS) else str(i), float(probs[i]))
            for i in order]
