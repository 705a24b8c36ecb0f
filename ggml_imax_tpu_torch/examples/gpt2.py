"""GPT-2 text generation CLI, the gpt-2-backend example analog (counterpart
of the JAX package's examples/gpt2.py; the reference's
examples/gpt-2/main-backend.cpp):

    python -m ggml_imax_tpu_torch.examples.gpt2 -m ggml-model.bin -p "..."
"""
from __future__ import annotations

import sys

from .common import cli_device, gpt_argparser, run_generation


def main(argv: list[str] | None = None) -> int:
    args = gpt_argparser("GPT-2 inference (legacy ggml .bin)").parse_args(argv)
    args.device = cli_device(args.device)
    from ..models import gpt2
    cfg, params, tok = gpt2.load_legacy(args.model, device=args.device)
    run_generation(gpt2, cfg, params, tok, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
