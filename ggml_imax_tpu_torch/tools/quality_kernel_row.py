"""Quality gate, kernel-path rows (counterpart of the JAX package's
tools/quality_tpu_row.py): run the decode kernels over the gate's scoring
window and hold their numerics to the W4A8 value-level simulation, for
every production kernel family:

  Q4_0  natpair W4A8 (the GPT-J path)
  Q4_K  natpair W4A8 with the affine (d·sub_scale / dmin·sub_min) bias
        term (the LLaMA-2 7B path)
  Q5_0  nat8 W8A8 (the Whisper path)

The gate (tools/quality_gate.py) measures ggml's W4A8 math as a value-level
sim on the plain route; decode runs the kernels (an m = 1 GEMV a product)
on weights repacked with bf16 scales and biases. This tool closes that
loop: a teacher-forced token-by-token decode (T = 1, the route decode
takes) over the same held-out window, then the window's PPL and the mean
KL(sim || kernels), held to KL_GATE.

Run quality_gate.py first (it leaves the bundles in its --dir), then

    python -m ggml_imax_tpu_torch.tools.quality_kernel_row [Q4_0 Q4_K Q5_0]

It appends its section to the gate's table (--out) and prints it; the exit
code is 1 when a row fails.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..models import gpt2
from ..ops.qmm import params_repack
from ..quant.formats import GGMLType
from .quality_gate import DEFAULT_DIR, KERNEL_SECTION, bundle_path, log_softmax

KL_GATE = 5e-3
KERNEL_NOTE = {
    "Q4_0": "natpair W4A8",
    "Q4_K": "natpair W4A8 + affine bias",
    "Q5_0": "nat8 W8A8",
}


def window_ppl(logits: torch.Tensor, toks: torch.Tensor) -> float:
    """Teacher-forced PPL over the window: positions 0..T-2 predict 1..T-1."""
    lp = log_softmax(logits[:-1]).gather(1, toks[1:, None])
    return float(torch.exp(-lp.mean()))


def mean_kl(p_logits: torch.Tensor, q_logits: torch.Tensor) -> float:
    """Mean over positions of KL(p || q)."""
    lp, lq = log_softmax(p_logits), log_softmax(q_logits)
    return float((lp.exp() * (lp - lq)).sum(-1).mean())


@torch.no_grad()
def decode_window(cfg, params, toks: torch.Tensor) -> torch.Tensor:
    """A teacher-forced T=1 decode over the window through gpt2.forward
    (bf16 KV cache, bf16 compute) on toks' device: every quantized product
    is an m = 1 GEMV. -> logits (T, V) f32."""
    dev = toks.device
    cache = gpt2.init_cache(cfg, 1, len(toks), device=dev)
    out = []
    for i in range(len(toks)):
        lg, _ = gpt2.forward(cfg, params, toks[i].view(1, 1),
                             torch.full((1, 1), i, device=dev), cache, i)
        out.append(lg[0, 0])
    return torch.stack(out).float()


def kernel_row(cfg, prepared, toks: torch.Tensor,
               sim_logits: torch.Tensor) -> dict:
    """The row of repacked params: {"ppl": the window's PPL through the
    kernels, "kl": mean KL(sim || kernels), "pass": kl < KL_GATE,
    "logits": the kernels' (T, V) logits}."""
    logits = decode_window(cfg, prepared, toks)
    kl = mean_kl(sim_logits.to(logits.device), logits)
    return {"ppl": window_ppl(logits, toks), "kl": kl, "pass": kl < KL_GATE,
            "logits": logits}


def load_bundle(d: Path, fmt: str, mid: bool, device):
    """(cfg, params, held-out tokens, sim logits, bf16 baseline PPL) of the
    gate's bundle for fmt, or None when there is none."""
    path = bundle_path(d, GGMLType[fmt], mid)
    if not path.exists():
        print(f"# {fmt}: no bundle at {path}: run tools/quality_gate.py",
              file=sys.stderr)
        return None
    ref = np.load(path)
    v, c, e, h, n = (int(x) for x in ref["cfg"])
    cfg = gpt2.GPT2Config(n_vocab=v, n_ctx=c, n_embd=e, n_head=h, n_layer=n)
    params = torch.load(path.with_suffix(".params.pt"), map_location=device,
                        weights_only=False)
    return (cfg, params, ref["heldout"], torch.from_numpy(ref["sim_logits"]),
            float(ref["ppl_bf16"]))


def run_row(d: Path, fmt: str, mid: bool, device) -> dict | None:
    b = load_bundle(d, fmt, mid, device)
    if b is None:
        return None
    cfg, params, heldout, sim, ppl_bf16 = b
    t0 = time.time()
    # bf16 scale/bias storage: the production default
    prepared = params_repack(params, scale_dtype=torch.bfloat16)
    toks = torch.from_numpy(heldout[:cfg.n_ctx].astype(np.int64)).to(device)
    row = kernel_row(cfg, prepared, toks, sim)
    print(f"# {fmt}: {cfg.n_ctx}-step decode in {time.time()-t0:.2f} s on "
          f"{device}", file=sys.stderr)
    return dict(row, ppl_bf16=ppl_bf16)


def section_text(rows, ppl_bf16, device) -> str:
    out = (f"{KERNEL_SECTION} (tools/quality_kernel_row.py, {device})\n\n"
           "Teacher-forced T=1 decode over the same scoring window through "
           "the decode kernels (an m = 1 GEMV a product, bf16 scale/bias "
           "storage), vs the W4A8 value-level sim:\n\n"
           "| format (kernel family) | PPL (window) | mean KL vs sim | "
           f"gate (<{KL_GATE:.0e}) |\n|---|---|---|---|\n")
    for fmt, r in rows:
        out += (f"| {fmt} ({KERNEL_NOTE.get(fmt, '?')}) | {r['ppl']:.4f} | "
                f"{r['kl']:.2e} | **{'PASS' if r['pass'] else 'FAIL'}** |\n")
    out += ("\n- the kernels' integer dots realize the same numerics class as "
            "the value-level simulation; the residual is bf16 KV + bf16 "
            "scale storage + f32 reassociation\n"
            f"- window PPLs vs the bf16-baseline full-corpus PPL "
            f"{ppl_bf16:.4f} (different estimator supports, shown for "
            "scale)\n")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Quality gate kernel-path rows")
    ap.add_argument("formats", nargs="*", default=list(KERNEL_NOTE))
    ap.add_argument("--mid", action="store_true",
                    help="the bundles of quality_gate.py --geometry mid")
    ap.add_argument("--dir", default=str(DEFAULT_DIR),
                    help="quality_gate.py's --dir")
    ap.add_argument("--out", default=None,
                    help="the gate's table to append to (default: "
                         "DIR/QUALITY.md, or QUALITY_117M.md with --mid)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    d = Path(args.dir)
    rows, ppl_bf16 = [], None
    for fmt in args.formats:
        r = run_row(d, fmt, args.mid, dev)
        if r is None:
            continue
        ppl_bf16 = r["ppl_bf16"]
        rows.append((fmt, r))
        print(f"# {fmt}: ppl {r['ppl']:.4f} KL {r['kl']:.2e} "
              f"{'PASS' if r['pass'] else 'FAIL'}", file=sys.stderr)
    if not rows:
        raise SystemExit("no bundles found: run tools/quality_gate.py first")
    section = section_text(rows, ppl_bf16, dev)
    out = Path(args.out) if args.out else \
        d / ("QUALITY_117M.md" if args.mid else "QUALITY.md")
    txt = out.read_text() if out.exists() else ""
    if KERNEL_SECTION in txt:
        txt = txt[:txt.index(KERNEL_SECTION)]
    out.write_text(txt + section)
    print(section)
    print(f"updated {out}")
    return 0 if all(r["pass"] for _, r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
