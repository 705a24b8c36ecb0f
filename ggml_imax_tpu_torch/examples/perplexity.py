"""Perplexity evaluation CLI, the PPL quality measure of BASELINE.md
(counterpart of the JAX package's examples/perplexity.py):

    python -m ggml_imax_tpu_torch.examples.perplexity -m model.gguf -f t.txt

The weights run as loaded (no residency is applied, as in the JAX CLI): a
layout the kernels take reaches them, any other the plain dequantize +
matmul route.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from .common import add_device_flag, cli_device


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Compute perplexity on a text file")
    p.add_argument("-m", "--model", required=True, help="GGUF (llama) model")
    p.add_argument("-f", "--file", required=True, help="UTF-8 text file")
    p.add_argument("-c", "--ctx_size", type=int, default=512)
    p.add_argument("--f32", action="store_true")
    args = add_device_flag(p).parse_args(argv)
    dev = cli_device(args.device)

    from ..models import llama
    from ..tools.perplexity import perplexity

    cfg, params, tok = llama.load_gguf(args.model, device=dev)
    if tok is None:
        raise SystemExit(f"{args.model}: no tokenizer.ggml.tokens / merges "
                         "in the file")
    text = Path(args.file).read_text()
    toks = tok.encode(text)
    print(f"{len(toks)} tokens", file=sys.stderr)
    res = perplexity(llama, cfg, params, toks, n_ctx=args.ctx_size,
                     compute_dtype=torch.float32 if args.f32
                     else torch.bfloat16,
                     progress=lambda i, n, ppl: print(
                         f"[{i}/{n}] ppl={ppl:.4f}", file=sys.stderr))
    print(f"perplexity: {res['ppl']:.4f} over {res['n_tokens']} tokens")
    return 0


if __name__ == "__main__":
    sys.exit(main())
