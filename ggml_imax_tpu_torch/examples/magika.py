"""Magika file-type identification CLI, the magika example analog
(counterpart of the JAX package's examples/magika.py; the reference's
examples/magika/main.cpp):

    python -m ggml_imax_tpu_torch.examples.magika magika.gguf file1 [file2 ...]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .common import add_device_flag, cli_device


def label_line(name: str, top) -> str:
    """The CLI's line for one file: its three most likely labels."""
    pretty = " ".join(f"{n}:{100*s:.0f}%" for n, s in top[:3])
    return f"{name}: {pretty}"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Identify file types")
    p.add_argument("model", help="magika.gguf")
    p.add_argument("files", nargs="+")
    args = add_device_flag(p).parse_args(argv)
    dev = cli_device(args.device)

    from ..models import magika
    params = magika.load_gguf(args.model, device=dev)
    for f in args.files:
        top = magika.identify(params, Path(f).read_bytes())
        print(label_line(f, top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
