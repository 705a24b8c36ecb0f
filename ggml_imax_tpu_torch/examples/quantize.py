"""Model quantization CLI, the per-model quantize.cpp analog (counterpart
of the JAX package's examples/quantize.py; the reference's
examples/gpt-2/quantize.cpp driving common-ggml.cpp):

    python -m ggml_imax_tpu_torch.examples.quantize f16.gguf q4_0.gguf q4_0

Requantizing runs on the host (the C++ codecs); --device is checked as the
other CLIs check it.
"""
from __future__ import annotations

import argparse
import sys

from .common import add_device_flag, cli_device


def main(argv: list[str] | None = None) -> int:
    from ..quant.formats import GGMLType
    names = {t.name.lower(): t for t in GGMLType}
    p = argparse.ArgumentParser(description="Requantize a GGUF model")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("type", choices=sorted(names),
                   help="target type, e.g. q4_0 q4_k q8_0")
    args = add_device_flag(p).parse_args(argv)
    cli_device(args.device)

    from ..tools.quantize import requantize_gguf
    stats = requantize_gguf(args.src, args.dst, names[args.type], verbose=True)
    n_in = sum(s[2] for s in stats.values())
    n_out = sum(s[3] for s in stats.values())
    print(f"total: {n_in/1e6:.1f} MB -> {n_out/1e6:.1f} MB "
          f"({n_out/max(1,n_in)*100:.1f}%)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
