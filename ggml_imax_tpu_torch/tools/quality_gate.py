"""Quantization quality gate: whole-model PPL delta + logits KL per format
(counterpart of the JAX package's tools/quality_gate.py).

BASELINE.md's north star includes "PPL delta <= ggml's Q4_0-vs-F16 gap".
No real checkpoint is at hand, so this is the documented proxy:

1. Train a small GPT-2 on a deterministic synthetic language (order-2 sparse
   Markov chain) until it has real predictive structure (PPL far below the
   uniform baseline), so quantization damage is measurable. Training runs
   through models.gpt2.forward and autograd (on the card: the flash forward
   with its lse and the flash backward kernels), with AdamW and the
   warmup-cosine schedule at optax's defaults, written out below.
2. Requantize the trained weights to every encodable format with the
   port's bit-exact encoders (identical weight distortion to ggml by
   construction).
3. Measure held-out PPL and mean logits-KL vs the F16 baseline through:
     - the port's kernel path (the weights repacked by ops.qmm.params_repack:
       natpair W4A16, nat8 W8A16 or the plane-split kernels, bf16
       activations, f32 sums), and
     - a simulation of ggml's W4A8 integer-dot math (per-32 Q8_0 activation
       quantization before every quantized matmul, quantize_row_q8_0) on
       the loaded layout's plain route in f32.
   Same weights + the gate: our PPL delta must be <= the ggml-sim delta
   plus NOISE_TOL.

The trained params are cached under --dir (build/qgate/ by default) with
torch.save; the Q4_0, Q4_K and Q5_0 rows leave reference bundles there
(.npz + .params.pt) for tools/quality_kernel_row.py. The table goes to
--out (build/qgate/QUALITY.md by default) and to stdout; the exit code is 1
when a format fails the gate.

    python -m ggml_imax_tpu_torch.tools.quality_gate [--fast]
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..models import gpt2
from ..ops import qmatmul as qmm
from ..ops.qmm import params_repack
from ..optimize import float_leaves
from ..quant.device import QTensor, to_device_format
from ..quant.formats import GGMLType
from ..quant.imatrix import quantize_rows
from .perplexity import params_device, perplexity

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_DIR = ROOT / "build" / "qgate"
KERNEL_SECTION = "\n## Kernel-path rows"

VOCAB, CTX = 64, 256

# Gate noise floor: PPL measured through two *equivalent-quality* compute
# paths differs by O(1e-3) here from operand-ordering alone (the committed
# table's F32-vs-bf16 span is 0.0016 PPL on a lossless change). 0.01 PPL
# (~0.3% relative) separates real quantization damage from path noise.
NOISE_TOL = 0.01


# per-context successor distribution; the mid geometry uses a wider, flatter
# profile (8 successors, ideal PPL ~6.4) so the 117M-scale proxy has real
# structure left to lose under quantization
SUCC_PROBS = np.array([0.6, 0.25, 0.1, 0.05])

# successor-TOKEN distribution: None = uniform over the vocab (the small
# geometry's language). The mid geometry sets a Zipf(1) vector instead:
# with uniform successor draws the token marginals carry no structure at
# all, so learning the language is pure sparse memorization of VOCAB²
# context tables and a 117M model sits at the uniform-PPL plateau for
# thousands of steps. Zipf-drawn successors give the language graded
# structure (unigram ≪ uniform, order-2 below that), so the loss moves
# early and the format deltas measure a model that actually predicts.
SUCC_ZIPF = None

FORMATS = (GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q5_K, GGMLType.Q5_0,
           GGMLType.Q4_K, GGMLType.Q4_1, GGMLType.Q4_0, GGMLType.IQ4_NL,
           GGMLType.Q3_K, GGMLType.Q2_K)
FAST_FORMATS = (GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q2_K)
# the formats whose rows leave a bundle for the kernel-path rows: Q4_0 the
# natpair W4A8 path (GPT-J), Q4_K natpair W4A8 with its bias (LLaMA), Q5_0
# the nat8 W8A8 path (Whisper)
BUNDLED = (GGMLType.Q4_0, GGMLType.Q4_K, GGMLType.Q5_0)


def set_language(geometry: str):
    """The language and model of a geometry: "small" (2L x 128E, vocab 64,
    4 successors from a uniform draw) or "mid" (12L x 768E, vocab 128, 8
    successors from a Zipf(1) draw). Sets VOCAB, SUCC_PROBS and SUCC_ZIPF;
    returns (config, steps by default, peak learning rate)."""
    global VOCAB, SUCC_PROBS, SUCC_ZIPF
    if geometry == "mid":
        # NOT 512: an order-2 table over 512² = 262k random contexts gives
        # ~6 corpus occurrences per context and no exploitable marginal
        # structure, so the loss never moves. 128² = 16k contexts ≈ 94
        # occurrences each plus Zipf marginals give the model a gradient at
        # every scale while still exercising every 117M-geometry weight.
        VOCAB = 128
        SUCC_PROBS = np.array(
            [0.35, 0.2, 0.15, 0.1, 0.08, 0.06, 0.04, 0.02])
        zipf = 1.0 / np.arange(1, VOCAB + 1)
        SUCC_ZIPF = zipf / zipf.sum()
        return gpt2.GPT2Config(n_vocab=VOCAB, n_ctx=CTX, n_embd=768,
                               n_head=12, n_layer=12), 3000, 6e-4
    VOCAB = 64
    SUCC_PROBS = np.array([0.6, 0.25, 0.1, 0.05])
    SUCC_ZIPF = None
    # 2L/128E learns the synthetic language in a few thousand steps
    return gpt2.GPT2Config(n_vocab=VOCAB, n_ctx=CTX, n_embd=128, n_head=4,
                           n_layer=2), 1500, 5e-3


def markov_corpus(n_tokens: int, seed: int = 0) -> np.ndarray:
    """Order-2 sparse Markov language: each (a, b) context allows
    len(SUCC_PROBS) successors with a shared Zipf-ish profile. The transition
    table (the *language*) is pinned to lang-seed 0 so train and held-out
    corpora sample the same distribution; `seed` varies only the sampled
    trajectory. Ideal PPL = exp(H); uniform = VOCAB."""
    ns = len(SUCC_PROBS)
    lang = np.random.default_rng(0)
    if SUCC_ZIPF is None:
        succ = lang.integers(0, VOCAB, size=(VOCAB, VOCAB, ns))
    else:
        succ = lang.choice(VOCAB, size=(VOCAB, VOCAB, ns), p=SUCC_ZIPF)
    rng = np.random.default_rng(seed + 1)
    toks = np.empty(n_tokens, np.int64)
    toks[0], toks[1] = rng.integers(0, VOCAB), rng.integers(0, VOCAB)
    choices = rng.choice(ns, size=n_tokens, p=SUCC_PROBS)
    for i in range(2, n_tokens):
        toks[i] = succ[toks[i - 2], toks[i - 1], choices[i]]
    return toks.astype(np.int32)


def language_baselines(heldout: np.ndarray) -> tuple[float, float]:
    """(unigram PPL, oracle PPL) of the pinned language on this corpus.

    Unigram = corpus cross-entropy under its own token-frequency fit (the
    best any context-free predictor can do); oracle = the true per-context
    successor distribution (duplicate draws merged). A trained proxy should
    land between them; at/above uniform (=VOCAB) it learned nothing and the
    format deltas are noise."""
    ns = len(SUCC_PROBS)
    lang = np.random.default_rng(0)
    if SUCC_ZIPF is None:
        succ = lang.integers(0, VOCAB, size=(VOCAB, VOCAB, ns))
    else:
        succ = lang.choice(VOCAB, size=(VOCAB, VOCAB, ns), p=SUCC_ZIPF)
    cnt = np.bincount(heldout, minlength=VOCAB).astype(np.float64)
    p = cnt / cnt.sum()
    nz = p > 0
    unigram_ppl = math.exp(-(p[nz] * np.log(p[nz])).sum())
    tbl = np.zeros((VOCAB, VOCAB, VOCAB))
    A, B = np.meshgrid(np.arange(VOCAB), np.arange(VOCAB), indexing="ij")
    for i in range(ns):
        np.add.at(tbl, (A, B, succ[:, :, i]), SUCC_PROBS[i])
    p_next = tbl[heldout[:-2], heldout[1:-1], heldout[2:]]
    oracle_ppl = math.exp(-float(np.log(p_next).mean()))
    return unigram_ppl, oracle_ppl


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float):
    """optax.warmup_cosine_decay_schedule (exponent 1): a linear ramp from
    init_value to peak_value over warmup_steps, then a cosine from
    peak_value to end_value over the remaining decay_steps - warmup_steps.
    Returns count -> learning rate."""
    def sched(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        span = decay_steps - warmup_steps
        t = min(count - warmup_steps, span)
        alpha = end_value / peak_value
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
        return peak_value * ((1.0 - alpha) * cosine + alpha)
    return sched


class AdamW:
    """optax.adamw(schedule) at its defaults: b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0, weight decay 1e-4 on every leaf, the schedule read at the
    update's count (0 first). Updates `leaves` in place from `grads`."""

    def __init__(self, leaves, schedule, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=1e-4):
        self.leaves, self.schedule = list(leaves), schedule
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.mu = [torch.zeros_like(x) for x in self.leaves]
        self.nu = [torch.zeros_like(x) for x in self.leaves]
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        lr = self.schedule(self.count)
        self.count += 1
        f32 = np.float32
        c1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        c2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        for x, g, mu, nu in zip(self.leaves, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (mu / c1) / ((nu / c2).sqrt() + self.eps) + self.wd * x
            x.sub_(lr * upd)


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.log_softmax's formula in f32."""
    z = x.float() - x.float().amax(dim=-1, keepdim=True)
    return z - torch.log(torch.exp(z).sum(dim=-1, keepdim=True))


def train_model(cfg, steps: int, seed: int = 0, peak_lr: float = 5e-3, *,
                device=None, callback=None):
    """F32 params drawn as gpt2.synthetic_params(seed), trained `steps`
    AdamW steps on batches of 8 x CTX tokens of the training corpus; the
    loss is the mean NLL of log_softmax over a fresh f32 KV cache per step,
    compute f32. callback(step, loss tensor), if given, sees each step's
    loss before the update. Returns the params (updated in place)."""
    dev = resolve_device(device)
    params = gpt2.synthetic_params(cfg, GGMLType.F32, seed=seed, device=dev)
    corpus = markov_corpus(steps * 8 * CTX // 4 + 10 * CTX, seed=1)
    sched = warmup_cosine_decay_schedule(0.0, peak_lr, max(40, steps // 20),
                                         steps, peak_lr / 20)
    leaves = float_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    opt = AdamW(leaves, sched)

    B = 8

    def batch(i):
        # overlapping windows, cycling through the corpus
        starts = (np.arange(B) * 977 + i * 4099) % (len(corpus) - CTX - 1)
        toks = np.stack([corpus[s:s + CTX] for s in starts])
        tgts = np.stack([corpus[s + 1:s + CTX + 1] for s in starts])
        return (torch.from_numpy(toks.astype(np.int64)).to(dev),
                torch.from_numpy(tgts.astype(np.int64)).to(dev))

    pos = torch.arange(CTX, device=dev)[None].expand(B, CTX)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    for i in range(steps):
        toks, tgts = batch(i)
        cache = gpt2.init_cache(cfg, batch=B, n_ctx=CTX, dtype=torch.float32,
                                device=dev)
        logits, _ = gpt2.forward(cfg, params, toks, pos, cache, 0,
                                 compute_dtype=torch.float32)
        loss = -log_softmax(logits).gather(-1, tgts[..., None]).mean()
        grads = torch.autograd.grad(loss, leaves)
        if callback is not None:
            callback(i, loss.detach())
        opt.step(grads)
        if i % 50 == 0 or i == steps - 1:
            lv = float(loss.detach())
            print(f"# train step {i}: loss {lv:.3f} "
                  f"(ppl {math.exp(lv):.1f}, uniform {VOCAB}) "
                  f"[{time.time()-t0:.0f}s]", file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.time() - t0
    print(f"# trained {steps} steps in {secs:.2f} s, "
          f"{1e3 * secs / max(1, steps):.3f} ms a step on {dev}",
          file=sys.stderr)
    for x in leaves:
        x.requires_grad_(False)
    return params


def requantize_params(params, t: GGMLType, imatrix: dict | None = None):
    """All 2-D qmatmul weights -> format t via the bit-exact encoders
    (block-size permitting), laid out by to_device_format on their device;
    everything else stays f32."""
    def conv(path, x):
        if not isinstance(x, QTensor) or x.kind != "dense":
            return x
        w = x.q.detach().float().cpu().numpy()          # (K, N)
        if w.shape[0] % 256 and t.name.endswith(("_K", "XS", "XXS", "_S", "_M")):
            return x
        imx = None if imatrix is None else imatrix.get(path)
        # quantize_rows takes w.T (N rows of K): the raw layout equals
        # ggml's (ne0 = K, ne1 = N)
        enc = quantize_rows(np.ascontiguousarray(w.T), t, imatrix=imx)
        return to_device_format(enc, t, (w.shape[0], w.shape[1]),
                                device=x.q.device)

    def walk(d, path=""):
        if isinstance(d, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in d.items()}
        if isinstance(d, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(d)]
        return conv(path, d)

    return walk(params)


@torch.no_grad()
def window_logits(cfg, params, toks: np.ndarray, compute_dtype):
    """One forward of a CTX-token window (KV cache in compute_dtype) ->
    logits (CTX, V)."""
    dev = params_device(params)
    t = torch.from_numpy(np.asarray(toks[:CTX], np.int64)).to(dev)[None]
    pos = torch.arange(CTX, device=dev)[None]
    cache = gpt2.init_cache(cfg, batch=1, n_ctx=CTX, dtype=compute_dtype,
                            device=dev)
    logits, _ = gpt2.forward(cfg, params, t, pos, cache, 0,
                             compute_dtype=compute_dtype)
    return logits[0]


def eval_paths(cfg, params, corpus, *, compute_dtype, label, ref_logits=None):
    """(held-out PPL, mean KL(ref || this) over the first window, or None
    without ref_logits)."""
    res = perplexity(gpt2, cfg, params, corpus, n_ctx=CTX,
                     compute_dtype=compute_dtype)
    kl = None
    if ref_logits is not None:
        lp = log_softmax(window_logits(cfg, params, corpus, compute_dtype))
        rp = log_softmax(ref_logits.to(lp.device))
        kl = float((torch.exp(rp) * (rp - lp)).sum(-1).mean())
    return res["ppl"], kl


def sim_eval(cfg, qp, corpus, ref_logits):
    """eval_paths under the ggml W4A8 activation sim, f32 compute."""
    qmm.set_activation_sim("w4a8")
    try:
        return eval_paths(cfg, qp, corpus, compute_dtype=torch.float32,
                          label="ggml-sim", ref_logits=ref_logits)
    finally:
        qmm.set_activation_sim(None)


def params_cache_path(d: Path, cfg, steps: int) -> Path:
    """The cache key names the LANGUAGE too (vocab + marginal shape), not
    just the geometry: a vocab-128 eval must never load params trained at
    another vocab."""
    lang_tag = f"V{VOCAB}" + ("z" if SUCC_ZIPF is not None else "")
    return d / f"qgate_params_{cfg.n_layer}L{cfg.n_embd}E_{lang_tag}_{steps}.pt"


def load_cached_params(path: Path, cfg, device):
    """The cached trained params; SystemExit when their vocab is not cfg's
    (a stale or misplaced file)."""
    params = torch.load(path, map_location=device, weights_only=False)
    wte = params["wte"]
    got_v = (wte.q if isinstance(wte, QTensor) else wte).shape[-1]
    if got_v != cfg.n_vocab:
        raise SystemExit(f"{path}: wte vocab {got_v} != cfg {cfg.n_vocab}; "
                         "delete it or --retrain")
    return params


def bundle_path(d: Path, t: GGMLType, mid: bool) -> Path:
    """The kernel-path rows' reference bundle of format t (.npz; the
    quantized params beside it as .params.pt)."""
    suffix = "" if t == GGMLType.Q4_0 else f"_{t.name}"
    return d / f"qgate_kernel_ref{suffix}{'_mid' if mid else ''}.npz"


def write_bundle(path: Path, cfg, qp, heldout, ppl_bf16):
    """The W4A8-sim logits of the first window (f32 compute and KV, the
    loaded layout's plain route) and the params, for
    tools/quality_kernel_row.py."""
    qmm.set_activation_sim("w4a8")
    try:
        sim = window_logits(cfg, qp, heldout, torch.float32)
    finally:
        qmm.set_activation_sim(None)
    np.savez(path, heldout=heldout,
             sim_logits=sim.float().cpu().numpy(), ppl_bf16=ppl_bf16,
             cfg=np.array([cfg.n_vocab, cfg.n_ctx, cfg.n_embd, cfg.n_head,
                           cfg.n_layer]))
    torch.save(qp, path.with_suffix(".params.pt"))


def gate_verdicts(rows, sim_rows) -> list[tuple[str, float, float, bool]]:
    """(format, our delta, sim delta, pass) per simulated format."""
    ours = {n.split(" ")[0]: d for n, _, d, _ in rows}
    sims = {n.split(" ")[0]: d for n, _, d, _ in sim_rows}
    return [(k, ours[k], sims[k], ours[k] <= sims[k] + NOISE_TOL)
            for k in sims]


def table_text(cfg, steps, heldout, rows, sim_rows, ppl_f32, device) -> str:
    out = (
        "# Quantization quality gate: whole-model PPL delta / logits KL\n\n"
        "Produced by `python -m ggml_imax_tpu_torch.tools.quality_gate` "
        f"(deterministic seeds; trained and evaluated on {device}).\n\n"
        f"Proxy model: GPT-2 geometry {cfg.n_layer}L x {cfg.n_embd}E x "
        f"{cfg.n_head}H, vocab {VOCAB}, trained {steps} steps on an "
        "order-2 sparse Markov language"
        + (" with Zipf-skewed successor marginals"
           if SUCC_ZIPF is not None else "")
        + " (no real checkpoint: see the module docstring). "
        f"Held-out corpus: {len(heldout)} tokens, scoring window "
        f"{CTX} (llama.cpp convention).\n\n"
        "Weight distortion is identical to ggml by construction (the "
        "encoders are bit-exact to the reference's). The gate compares the "
        "remaining compute-path error: the port's kernel path (bf16 "
        "activations, f32 sums) vs a simulation of ggml's W4A8 integer-dot "
        "math (Q8_0 activation round-trip before every quantized matmul, "
        "quantize_row_q8_0).\n\n"
        "| configuration | PPL | delta vs bf16 baseline | mean KL vs f32 |\n"
        "|---|---|---|---|\n")
    for name, ppl, d, kl in rows + sim_rows:
        kls = "—" if kl is None else f"{kl:.2e}"
        out += f"| {name} | {ppl:.4f} | {d:+.4f} | {kls} |\n"
    out += "\n## Gate\n\n"
    for k, ours, sim, ok in gate_verdicts(rows, sim_rows):
        out += (f"- {k}: our PPL delta {ours:+.4f} vs ggml-W4A8-sim "
                f"{sim:+.4f} -> **{'PASS' if ok else 'FAIL'}** "
                f"(gate: ours <= ggml's gap + {NOISE_TOL} path-noise "
                "floor, at the same weights)\n")
    uni_ppl, oracle_ppl = language_baselines(heldout)
    out += (f"\nLanguage baselines on this held-out corpus: uniform PPL "
            f"{VOCAB}, best context-free (unigram) PPL {uni_ppl:.1f}, "
            f"oracle (true transition table) PPL {oracle_ppl:.1f}.\n")
    if ppl_f32 < 0.9 * min(VOCAB, uni_ppl):
        out += (f"The trained model's F32 PPL of {ppl_f32:.1f} is below "
                "the context-free bound — it learned real transition "
                "structure, so the format deltas are meaningful.\n")
    elif ppl_f32 < 0.9 * VOCAB:
        out += (f"The trained model's F32 PPL of {ppl_f32:.1f} beats "
                "uniform but not the context-free bound — it has only "
                "learned token marginals; treat the deltas as coarse.\n")
    else:
        out += ("\n**WARNING**: the proxy's F32 PPL is within 10% of "
                f"the uniform baseline ({VOCAB}) — the model carries "
                "little structure and the format deltas above are "
                "noise-dominated. Retrain with more steps / a lower "
                "peak lr before citing this table.\n")
    return out


def carried_kernel_rows(out: Path, trained_fresh: bool) -> str:
    """The kernel-path section of an earlier table at `out` (appended by
    quality_kernel_row.py), flagged stale once the params are retrained."""
    if not out.exists():
        return ""
    old = out.read_text()
    if KERNEL_SECTION not in old:
        return ""
    rows = old[old.index(KERNEL_SECTION):]
    if trained_fresh and "**STALE**" not in rows:
        nl = rows.index("\n", 1)
        rows = (rows[:nl] + "\n\n**STALE**: these kernel-path rows were "
                "measured against a previous proxy model; the table above "
                "was just retrained. Run tools/quality_kernel_row.py again."
                + rows[nl:])
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Quantization quality gate")
    ap.add_argument("--fast", action="store_true",
                    help="2-layer model, fewer steps and formats (smoke)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--retrain", action="store_true",
                    help="ignore the cached trained params")
    ap.add_argument("--geometry", choices=("small", "mid"), default="small",
                    help="small = 2L/128E/64V; mid = 12L/768E/128V "
                         "(GPT-2-117M scale)")
    ap.add_argument("--train-only", action="store_true",
                    help="train + cache the proxy model, skip the evals")
    ap.add_argument("--dir", default=str(DEFAULT_DIR),
                    help="the trained params' cache and the bundles")
    ap.add_argument("--out", default=None,
                    help="the table (default: DIR/QUALITY.md, or "
                         "QUALITY_117M.md for --geometry mid)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    mid = args.geometry == "mid"
    cfg, default_steps, peak_lr = set_language(args.geometry)
    steps = args.steps or (60 if args.fast and not mid else default_steps)
    d = Path(args.dir)
    d.mkdir(parents=True, exist_ok=True)
    out = Path(args.out) if args.out else \
        d / ("QUALITY_117M.md" if mid else "QUALITY.md")

    cache_f = params_cache_path(d, cfg, steps)
    trained_fresh = args.retrain or not cache_f.exists()
    if not trained_fresh:
        print(f"# loading trained params from {cache_f}", file=sys.stderr)
        params = load_cached_params(cache_f, cfg, dev)
    else:
        print(f"# training {cfg.n_layer}L/{cfg.n_embd}E model, {steps} steps",
              file=sys.stderr)
        params = train_model(cfg, steps, peak_lr=peak_lr, device=dev)
        torch.save(params, cache_f)
    if args.train_only:
        print(f"# trained params saved to {cache_f}", file=sys.stderr)
        return 0
    heldout = markov_corpus(8 * CTX, seed=99)

    # reference logits for KL: f32 dense
    ref_logits = window_logits(cfg, params, heldout, torch.float32)

    rows = []
    ppl_f32, _ = eval_paths(cfg, params, heldout,
                            compute_dtype=torch.float32, label="f32")
    ppl_bf16, kl_bf16 = eval_paths(cfg, params, heldout,
                                   compute_dtype=torch.bfloat16, label="bf16",
                                   ref_logits=ref_logits)
    rows.append(("F32 dense (reference)", ppl_f32, ppl_f32 - ppl_bf16, None))
    rows.append(("F16/bf16 compute (baseline)", ppl_bf16, ppl_bf16 - ppl_f32,
                 kl_bf16))

    sim_rows = []
    for t in FAST_FORMATS if args.fast else FORMATS:
        try:
            qp = requantize_params(params, t)
        except (NotImplementedError, ValueError) as e:
            print(f"# {t.name}: skipped ({e})", file=sys.stderr)
            continue
        ppl, kl = eval_paths(cfg, params_repack(qp), heldout,
                             compute_dtype=torch.bfloat16, label=t.name,
                             ref_logits=ref_logits)
        rows.append((f"{t.name} (our W4A16 path)", ppl, ppl - ppl_bf16, kl))
        print(f"# {t.name}: ppl {ppl:.3f} (delta {ppl-ppl_bf16:+.3f}, "
              f"KL {kl:.2e})", file=sys.stderr)
        # ggml W4A8-sim comparison + PASS/FAIL for EVERY format (the
        # reference's activation-quant path applies to all of them)
        ppl_s, kl_s = sim_eval(cfg, qp, heldout, ref_logits)
        sim_rows.append((f"{t.name} (ggml W4A8 sim)", ppl_s,
                         ppl_s - ppl_bf16, kl_s))
        print(f"# {t.name} ggml-sim: ppl {ppl_s:.3f} "
              f"(delta {ppl_s-ppl_bf16:+.3f})", file=sys.stderr)
        if t in BUNDLED:
            path = bundle_path(d, t, mid)
            write_bundle(path, cfg, qp, heldout, ppl_bf16)
            print(f"# wrote kernel-row reference bundle {path}",
                  file=sys.stderr)

    text = table_text(cfg, steps, heldout, rows, sim_rows, ppl_f32, dev) \
        + carried_kernel_rows(out, trained_fresh)
    out.write_text(text)
    print(text)
    print(f"wrote {out}")
    failed = [k for k, _, _, ok in gate_verdicts(rows, sim_rows) if not ok]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
