"""MNIST example: train, evaluate, export the graph, re-import it without
the model code (counterpart of the JAX package's examples/mnist.py; the
reference's examples/mnist main.cpp -> main-cpu.cpp deployment flow). Runs
on synthetic data when no dataset path is given.

    python -m ggml_imax_tpu_torch.examples.mnist --arch cnn --iters 60

The exported artifact is io/graph_export's torch.export framing (the JAX
package writes its own graph format under the same default name).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .common import add_device_flag, cli_device


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="MNIST FC/CNN train + deploy demo")
    p.add_argument("--arch", choices=("fc", "cnn"), default="fc")
    p.add_argument("--data", help="npz with images (N,784|1,28,28), labels")
    p.add_argument("--out", default="mnist.gitg", help="exported graph path")
    p.add_argument("--iters", type=int, default=200)
    args = add_device_flag(p).parse_args(argv)
    dev = cli_device(args.device)

    from ..models import mnist

    rng = np.random.default_rng(0)
    if args.data:
        d = np.load(args.data)
        images, labels = d["images"].astype(np.float32), d["labels"]
    else:
        templates = rng.standard_normal((10, 784)).astype(np.float32)
        labels = rng.integers(0, 10, 2048)
        images = templates[labels] + 0.3 * rng.standard_normal((2048, 784)).astype(np.float32)

    if args.arch == "fc":
        fwd, params = mnist.fc_forward, mnist.init_fc_params(rng, device=dev)
        x = images
    else:
        fwd, params = mnist.cnn_forward, mnist.init_cnn_params(rng, device=dev)
        x = images.reshape(-1, 1, 28, 28)

    res, params = mnist.train(fwd, params, x, labels, n_iter=args.iters)
    acc = mnist.accuracy(fwd, params, x, labels)
    print(f"train: {res.name}, accuracy {acc:.3f}")

    x0 = torch.from_numpy(np.ascontiguousarray(x[:1])).to(dev)
    mnist.export_model(fwd, params, x0, args.out)
    run = mnist.load_model(args.out)             # no model code needed
    pred = int(run(x0).argmax())
    print(f"exported to {args.out}; re-imported prediction for sample 0: "
          f"{pred} (label {labels[0]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
