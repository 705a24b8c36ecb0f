"""YOLOv3-tiny object detection (counterpart of ggml_imax_tpu/models/yolo.py;
the reference's examples/yolo).

13 conv layers with max pools, a stride-1 "same" max pool, upscale + route
concat and two YOLO heads (yolov3-tiny.cpp:368-436); each conv block is
conv -> batch norm -> bias -> leaky_relu 0.1, with the batch norm folded
into the conv's weights and bias at load time, in the reference's order.
The backbone runs on the params' device in f32 (cuDNN's TF32 off); the
letterbox resize is ops.conv's jax.image.resize copy; box decode and NMS
run in numpy on the host, line for line as the reference's."""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..io.gguf import GGUFReader
from ..ops.activations import leaky_relu
from ..ops.conv import _resize_bilinear, conv_2d, pool_2d, upscale

ANCHORS = (10, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319)
MASK_16 = (3, 4, 5)
MASK_23 = (0, 1, 2)
N_CLASSES = 80
NET_W = NET_H = 416

# layer config: (padding, batch_normalize, activate) — yolov3-tiny.cpp:74-82
LAYER_CFG = {i: (1, True, True) for i in range(13)}
LAYER_CFG[7] = (0, True, True)
LAYER_CFG[9] = (0, False, False)
LAYER_CFG[10] = (0, True, True)
LAYER_CFG[12] = (0, False, False)


def load_gguf(path: str | Path, *, device=None):
    """-> params, a list of 13 dicts {w (Cout, Cin, KH, KW) f32 with the
    batch norm folded in, b}, on `device` (the card unless "cpu")."""
    dev = resolve_device(device)
    layers = []
    with GGUFReader(path) as r:
        for i in range(13):
            pad, bn, act = LAYER_CFG[i]
            w = r.tensor_array(f"l{i}_weights").astype(np.float32)
            b = r.tensor_array(f"l{i}_biases").astype(np.float32)
            if bn:
                scales = r.tensor_array(f"l{i}_scales").astype(np.float32)
                mean = r.tensor_array(f"l{i}_rolling_mean").astype(np.float32)
                var = r.tensor_array(f"l{i}_rolling_variance").astype(
                    np.float32)
                g = scales / np.sqrt(var)
                w = w * g[:, None, None, None]
                b = b - mean * g
            layers.append({"w": torch.from_numpy(w).to(dev),
                           "b": torch.from_numpy(b).to(dev)})
    return layers


def synthetic_params(rng: np.random.Generator, n_classes: int = N_CLASSES,
                     width: int = 16, *, device=None):
    """Random weights at channel base `width` (16 is the published 16..1024),
    drawn from `rng` in the reference's order."""
    dev = resolve_device(device)
    chans = [3, width, width * 2, width * 4, width * 8, width * 16,
             width * 32, width * 64]
    seq = [(chans[0], chans[1], 3), (chans[1], chans[2], 3),
           (chans[2], chans[3], 3), (chans[3], chans[4], 3),
           (chans[4], chans[5], 3), (chans[5], chans[6], 3),
           (chans[6], chans[7], 3), (chans[7], chans[5], 1),
           (chans[5], chans[6], 3), (chans[6], 3 * (5 + n_classes), 1),
           (chans[5], chans[4], 1),
           (chans[4] + chans[5], chans[6], 3),
           (chans[6], 3 * (5 + n_classes), 1)]
    out = []
    for cin, cout, k in seq:
        w = (rng.standard_normal((cout, cin, k, k)) * 0.05).astype(np.float32)
        out.append({"w": torch.from_numpy(w).to(dev),
                    "b": torch.zeros(cout, dtype=torch.float32, device=dev)})
    return out


def _block(x, lp, i):
    pad, _bn, act = LAYER_CFG[i]
    y = conv_2d(x, lp["w"], p0=pad, p1=pad) + lp["b"][None, :, None, None]
    return leaky_relu(y, 0.1) if act else y


def forward(params, x):
    """x: (N, 3, H, W) in [0, 1], letterboxed -> (head16, head23) raw
    prediction maps (N, 3 (5 + classes), h, w)."""
    r = _block(x, params[0], 0)
    r = pool_2d(r, "max", 2, 2, 2, 2)
    r = _block(r, params[1], 1)
    r = pool_2d(r, "max", 2, 2, 2, 2)
    r = _block(r, params[2], 2)
    r = pool_2d(r, "max", 2, 2, 2, 2)
    r = _block(r, params[3], 3)
    r = pool_2d(r, "max", 2, 2, 2, 2)
    r = _block(r, params[4], 4)
    layer_8 = r
    r = pool_2d(r, "max", 2, 2, 2, 2)
    r = _block(r, params[5], 5)
    # stride-1 "same" max pool (darknet size 2 / stride 1): pad right and
    # bottom with -inf, pool k 2 s 1
    r = F.pad(r, (0, 1, 0, 1), value=float("-inf"))
    r = pool_2d(r, "max", 2, 2, 1, 1)
    r = _block(r, params[6], 6)
    r = _block(r, params[7], 7)
    layer_13 = r
    r = _block(r, params[8], 8)
    head16 = _block(r, params[9], 9)
    r = _block(layer_13, params[10], 10)
    r = upscale(r, 2)
    r = torch.cat([r, layer_8], dim=1)             # route concat (channels)
    r = _block(r, params[11], 11)
    head23 = _block(r, params[12], 12)
    return head16, head23


# ---- host-side detection decode (get_yolo_detections + NMS) ----

@dataclass
class Detection:
    box: tuple          # (x, y, w, h) normalized to image
    objectness: float
    prob: np.ndarray    # per-class score


def decode_head(pred, mask, *, thresh=0.5, net_w=NET_W, net_h=NET_H,
                im_w=None, im_h=None, n_classes=N_CLASSES):
    """pred: (3*(5+classes), h, w) raw map (numpy) -> detections
    (apply_yolo sigmoids + get_yolo_detections box math)."""
    im_w = im_w or net_w
    im_h = im_h or net_h
    c, h, w = pred.shape
    p = np.asarray(pred, np.float32).reshape(3, 5 + n_classes, h, w)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    dets = []
    for n in range(3):
        tx, ty, tw, th = p[n, 0], p[n, 1], p[n, 2], p[n, 3]
        obj = sig(p[n, 4])
        cls = sig(p[n, 5:])
        aw, ah = ANCHORS[2 * mask[n]], ANCHORS[2 * mask[n] + 1]
        ys, xs = np.nonzero(obj > thresh)
        for yy, xx in zip(ys, xs):
            bx = (xx + sig(tx[yy, xx])) / w
            by = (yy + sig(ty[yy, xx])) / h
            bw = np.exp(tw[yy, xx]) * aw / net_w
            bh = np.exp(th[yy, xx]) * ah / net_h
            b = _correct_box((bx, by, bw, bh), im_w, im_h, net_w, net_h)
            probs = obj[yy, xx] * cls[:, yy, xx]
            probs[probs < thresh] = 0.0
            dets.append(Detection(b, float(obj[yy, xx]), probs))
    return dets


def _correct_box(b, im_w, im_h, net_w, net_h):
    """Undo letterboxing (correct_yolo_box, yolov3-tiny.cpp:181-196)."""
    bx, by, bw, bh = b
    if net_w / im_w < net_h / im_h:
        new_w, new_h = net_w, (im_h * net_w) // im_w
    else:
        new_h, new_w = net_h, (im_w * net_h) // im_h
    bx = (bx - (net_w - new_w) / 2.0 / net_w) / (new_w / net_w)
    by = (by - (net_h - new_h) / 2.0 / net_h) / (new_h / net_h)
    bw *= net_w / new_w
    bh *= net_h / new_h
    return (bx, by, bw, bh)


def _iou_matrix(dets) -> np.ndarray:
    """The IoU of every pair of boxes, (n, n): the reference's scalar
    box_iou (x, y f64, w, h f32 as decode_head makes them) as the same
    operations on the same dtypes, elementwise, so each entry equals the
    scalar's bit for bit."""
    x, y, w, h = (np.asarray([d.box[c] for d in dets]) for c in range(4))

    def inter1d(a, aw, b, bw):
        lo = np.maximum(a[:, None] - aw[:, None] / 2, b[None] - bw[None] / 2)
        hi = np.minimum(a[:, None] + aw[:, None] / 2, b[None] + bw[None] / 2)
        return np.maximum(0.0, hi - lo)

    inter = inter1d(x, w, x, w) * inter1d(y, h, y, h)
    union = (w * h)[:, None] + (w * h)[None] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def nms(dets, iou_thresh=0.45):
    """Per-class greedy NMS (do_nms_sort, yolov3-tiny.cpp:262-300):
    suppressed detections get prob[k] = 0 (kept in the list). The
    reference's loops, with each pair's IoU taken from one matrix and a
    box's suppressions made at once: the same result, bit for bit, in
    O(n^2) array work instead of O(classes n^2) Python calls."""
    if not dets:
        return dets
    probs = np.stack([d.prob for d in dets])                # (n, classes)
    iou = _iou_matrix(dets) > iou_thresh
    for k in range(probs.shape[1]):
        p = probs[:, k]
        if not p.any():
            continue
        order = np.argsort(-p, kind="stable")                # sorted()'s
        for ii, i in enumerate(order):
            if p[i] == 0:
                continue
            rest = order[ii + 1:]
            p[rest[iou[i, rest]]] = 0.0
    for d, row in zip(dets, probs):
        d.prob[:] = row
    return dets


def letterbox(img, net_w=NET_W, net_h=NET_H, *, device=None):
    """img: (3, H, W) float in [0, 1] (numpy or torch) -> (3, net_h, net_w)
    f32 on `device` (img's own device for a tensor, else the card unless
    "cpu"): an aspect-preserving bilinear resize padded with 0.5
    (yolo-image.cpp letterbox_image)."""
    if device is None and isinstance(img, torch.Tensor):
        device = img.device
    x = torch.as_tensor(img, dtype=torch.float32, device=resolve_device(device))
    _, h, w = x.shape
    if net_w / w < net_h / h:
        new_w, new_h = net_w, int(h * net_w / w)
    else:
        new_h, new_w = net_h, int(w * net_h / h)
    resized = _resize_bilinear(x, (3, new_h, new_w))
    out = torch.full((3, net_h, net_w), 0.5, dtype=torch.float32,
                     device=x.device)
    dy, dx = (net_h - new_h) // 2, (net_w - new_w) // 2
    out[:, dy:dy + new_h, dx:dx + new_w] = resized
    return out


def detect(params, img, *, thresh=0.5, nms_thresh=0.45,
           n_classes=N_CLASSES):
    """The whole pipeline on the params' device: letterbox -> backbone ->
    decode both heads on the host -> NMS."""
    _, im_h, im_w = img.shape
    x = letterbox(img, device=params[0]["w"].device)[None]
    h16, h23 = forward(params, x)
    dets = decode_head(h16[0].cpu().numpy(), MASK_16, thresh=thresh,
                       im_w=im_w, im_h=im_h, n_classes=n_classes)
    dets += decode_head(h23[0].cpu().numpy(), MASK_23, thresh=thresh,
                        im_w=im_w, im_h=im_h, n_classes=n_classes)
    return nms(dets, nms_thresh)
