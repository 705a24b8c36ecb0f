"""LLaMA text generation CLI for GGUF models (counterpart of the JAX
package's examples/llama.py):

    python -m ggml_imax_tpu_torch.examples.llama -m model.gguf -p "..."

The default residency, "q4-fused", fuses each layer's q/k/v into one
product; a file whose q/k/v differ in type in some layer (llama.cpp's
Q4_K_M mix gives attn_v Q6_K where attn_q and attn_k are Q4_K) cannot be
fused, and the CLI stops with one line that says so and names the
residency that runs such a file. It never switches residency on its own.
"""
from __future__ import annotations

import sys

from .common import cli_device, gpt_argparser, run_generation


def mixed_qkv_layers(params) -> list[tuple[int, list[str]]]:
    """(layer, [q, k, v type names]) of each layer whose q/k/v differ in
    layout or type."""
    out = []
    for i, lp in enumerate(params["layers"]):
        ws = [lp[k] for k in ("q_w", "k_w", "v_w")]
        if len({(w.kind, w.ggml_type) for w in ws}) > 1:
            out.append((i, [w.ggml_type.name for w in ws]))
    return out


def main(argv: list[str] | None = None) -> int:
    args = gpt_argparser("LLaMA inference (GGUF)").parse_args(argv)
    args.device = cli_device(args.device)
    from ..models import llama
    cfg, params, tok = llama.load_gguf(args.model, device=args.device)
    if tok is None:
        raise SystemExit(f"{args.model}: no tokenizer.ggml.tokens / merges "
                         "in the file")
    if not args.f32 and args.resident in ("q4-fused", "q4-stacked"):
        mixed = mixed_qkv_layers(params)
        if mixed:
            i, types = mixed[0]
            raise SystemExit(
                f"llama: --resident {args.resident} fuses each layer's q/k/v "
                f"into one product, but {len(mixed)} of {cfg.n_layer} layers "
                f"hold q/k/v of different types (layer {i}: "
                f"{'/'.join(types)}); pass --resident as-is")
    run_generation(llama, cfg, params, tok, args, eos_id=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
