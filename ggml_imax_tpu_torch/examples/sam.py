"""SAM segmentation CLI, the sam example analog (counterpart of the JAX
package's examples/sam.py; the reference's examples/sam/main.cpp): prints
mask stats per output.

    python -m ggml_imax_tpu_torch.examples.sam -m sam.bin -i img.npy -p x,y
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .common import add_device_flag, cli_device


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="SAM point-prompt segmentation")
    p.add_argument("-m", "--model", required=True, help="sam ggml .bin")
    p.add_argument("-i", "--inp", required=True,
                   help="image: .npy (H,W,3) array (no image codecs in-box)")
    p.add_argument("-p", "--point", default="0.5,0.5",
                   help="prompt point as x,y pixels or fractions")
    p.add_argument("-o", "--out", default="masks.npy")
    args = add_device_flag(p).parse_args(argv)
    dev = cli_device(args.device)

    from ..models import sam
    cfg, params = sam.load_legacy(args.model, device=dev)
    img = np.load(args.inp)
    x, y = (float(v) for v in args.point.split(","))
    if x <= 1.0 and y <= 1.0:
        x, y = x * img.shape[1], y * img.shape[0]
    masks, iou = sam.predict(cfg, params, img, (x, y))
    for i in range(masks.shape[0]):
        print(f"mask {i}: iou={iou[i]:.3f} area={int(masks[i].sum())} px")
    np.save(args.out, masks)
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
