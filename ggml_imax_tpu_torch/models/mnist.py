"""MNIST example family (counterpart of ggml_imax_tpu/models/mnist.py):
the FC net (784 -> 500 + relu -> 10), the CNN ([conv 3x3 + relu + max pool
2] x 2 -> dense), training through optimize.opt, accuracy, and deployment
through io.graph_export.

Forwards are f32 torch ops (the convolutions with cuDNN's TF32 off,
ops/conv.py). `init_*_params` draw from the caller's numpy generator in
the reference's order, so one generator gives both packages the same
weights. `train` updates the params in place (optimize.opt) and returns
the same tree.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..io.graph_export import export_graph, load_graph
from ..ops.conv import conv_2d, pool_2d
from ..ops.tensor_ops import cross_entropy_loss
from ..optimize import AdamParams, default_params, opt


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


def init_fc_params(rng: np.random.Generator, n_input=784, n_hidden=500,
                   n_classes=10, scale=0.05, *, device=None):
    dev = resolve_device(device)
    return {
        "fc1_w": _t(rng.standard_normal((n_input, n_hidden))
                    .astype(np.float32) * scale, dev),
        "fc1_b": torch.zeros(n_hidden, device=dev),
        "fc2_w": _t(rng.standard_normal((n_hidden, n_classes))
                    .astype(np.float32) * scale, dev),
        "fc2_b": torch.zeros(n_classes, device=dev),
    }


def fc_forward(params, x):
    """x: (B, 784) -> logits (B, 10)."""
    h = torch.relu(x @ params["fc1_w"] + params["fc1_b"])
    return h @ params["fc2_w"] + params["fc2_b"]


def init_cnn_params(rng: np.random.Generator, n_classes=10, scale=0.1, *,
                    device=None):
    dev = resolve_device(device)
    draw = lambda shape: _t(rng.standard_normal(shape).astype(np.float32)
                            * scale, dev)
    return {
        "k1": draw((8, 1, 3, 3)),
        "b1": torch.zeros((1, 8, 1, 1), device=dev),
        "k2": draw((16, 8, 3, 3)),
        "b2": torch.zeros((1, 16, 1, 1), device=dev),
        "dense_w": draw((16 * 5 * 5, n_classes)),
        "dense_b": torch.zeros(n_classes, device=dev),
    }


def cnn_forward(params, x):
    """x: (B, 1, 28, 28) -> logits (B, 10): [conv 3x3 + relu + max pool 2]
    x 2, flatten, dense."""
    h = torch.relu(conv_2d(x, params["k1"]) + params["b1"])     # (B,8,26,26)
    h = pool_2d(h, "max", 2, 2, 2, 2)                           # (B,8,13,13)
    h = torch.relu(conv_2d(h, params["k2"]) + params["b2"])     # (B,16,11,11)
    h = pool_2d(h, "max", 2, 2, 2, 2)                           # (B,16,5,5)
    h = h.reshape(h.shape[0], -1)
    return h @ params["dense_w"] + params["dense_b"]


def _on(x, dev, dtype=None) -> torch.Tensor:
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return x.to(dev, dtype)


def train(forward, params, images, labels, *, n_iter=300, lr=1e-2,
          params_opt=None, callback=None):
    """Minimize the full-batch cross-entropy with the reference's Adam
    (alpha lr, eps_f 1e-7, eps_g 1e-4, max_no_improvement 50), or with
    `params_opt` (e.g. optimize.default_params("lbfgs")). images: numpy or
    tensors; labels int class ids. Runs on the params' device; returns
    (result, params), the params updated in place. callback(iter, loss) as
    optimize.opt's."""
    dev = next(iter(params.values())).device
    images = _on(images, dev, torch.float32)
    labels = _on(labels, dev, torch.int64)
    onehot = torch.eye(int(labels.max()) + 1, device=dev)[labels]

    def loss_full(p):
        return cross_entropy_loss(forward(p, images), onehot)[0]

    if params_opt is None:
        params_opt = default_params("adam")
        params_opt.adam = AdamParams(n_iter=n_iter, alpha=lr, eps_f=1e-7,
                                     eps_g=1e-4)
        params_opt.max_no_improvement = 50
    res, params, _ = opt(loss_full, params, params_opt, callback)
    return res, params


@torch.no_grad()
def accuracy(forward, params, images, labels) -> float:
    dev = next(iter(params.values())).device
    pred = forward(params, _on(images, dev, torch.float32)).argmax(-1)
    return float((pred == _on(labels, dev, torch.int64)).float().mean())


def export_model(forward, params, example_x, path: str | Path) -> dict:
    """Freeze the params into the graph (saved in the artifact) and export
    the input -> logits computation at example_x's shape and device.
    Returns export_graph's seconds and bytes."""
    frozen = {k: v.detach() for k, v in params.items()}
    with torch.no_grad():
        return export_graph(lambda x: forward(frozen, x), (example_x,), path)


def load_model(path: str | Path):
    """Re-import the exported model and run it without the model code."""
    return load_graph(path)
