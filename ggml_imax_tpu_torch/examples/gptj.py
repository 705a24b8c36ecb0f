"""GPT-J text generation CLI, the gpt-j example analog (counterpart of the
JAX package's examples/gptj.py; the reference's examples/gpt-j/main.cpp):

    python -m ggml_imax_tpu_torch.examples.gptj -m ggml-model.bin -p "..."
"""
from __future__ import annotations

import sys

from .common import cli_device, gpt_argparser, run_generation


def main(argv: list[str] | None = None) -> int:
    args = gpt_argparser("GPT-J inference (legacy ggml .bin)").parse_args(argv)
    args.device = cli_device(args.device)
    from ..models import gptj
    cfg, params, tok = gptj.load_legacy(args.model, device=args.device)
    run_generation(gptj, cfg, params, tok, args, eos_id=50256)
    return 0


if __name__ == "__main__":
    sys.exit(main())
