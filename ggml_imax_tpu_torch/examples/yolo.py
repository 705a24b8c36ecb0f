"""YOLOv3-tiny detection CLI, the yolo example analog (counterpart of the
JAX package's examples/yolo.py; the reference's examples/yolo): prints
detections.

    python -m ggml_imax_tpu_torch.examples.yolo -m yolov3-tiny.gguf -i img.npy
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .common import add_device_flag, cli_device

COCO80 = ("person bicycle car motorbike aeroplane bus train truck boat "
          "traffic-light fire-hydrant stop-sign parking-meter bench bird cat "
          "dog horse sheep cow elephant bear zebra giraffe backpack umbrella "
          "handbag tie suitcase frisbee skis snowboard sports-ball kite "
          "baseball-bat baseball-glove skateboard surfboard tennis-racket "
          "bottle wine-glass cup fork knife spoon bowl banana apple sandwich "
          "orange broccoli carrot hot-dog pizza donut cake chair sofa "
          "pottedplant bed diningtable toilet tvmonitor laptop mouse remote "
          "keyboard cell-phone microwave oven toaster sink refrigerator book "
          "clock vase scissors teddy-bear hair-drier toothbrush").split()


def detection_lines(dets) -> list[str]:
    """The CLI's line for each detection with a class over the threshold."""
    out = []
    for d in dets:
        k = int(np.argmax(d.prob))
        if d.prob[k] > 0:
            x, y, w, h = d.box
            out.append(f"{COCO80[k]}: {100*d.prob[k]:.0f}%  "
                       f"box=({x:.3f},{y:.3f},{w:.3f},{h:.3f})")
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="YOLOv3-tiny object detection")
    p.add_argument("-m", "--model", required=True, help="yolov3-tiny.gguf")
    p.add_argument("-i", "--inp", required=True,
                   help="image: .npy (3,H,W) float [0,1]")
    p.add_argument("--thresh", type=float, default=0.5)
    args = add_device_flag(p).parse_args(argv)
    dev = cli_device(args.device)

    from ..models import yolo
    params = yolo.load_gguf(args.model, device=dev)
    img = np.load(args.inp).astype(np.float32)
    dets = yolo.detect(params, img, thresh=args.thresh)
    for line in detection_lines(dets):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
