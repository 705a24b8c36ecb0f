"""Continuous-batching demo, the main-batched example analog (counterpart
of the JAX package's examples/serve.py; the reference's
examples/gpt-2/main-batched.cpp): decode -np parallel sequences from one
prompt through the celled KV cache.

    python -m ggml_imax_tpu_torch.examples.serve -m ggml-model.bin -np 4
    python -m ggml_imax_tpu_torch.examples.serve --bench [--steady]

--bench is the serving benchmark at GPT-J-6B Q4_0 geometry on synthetic
weights; it prints one JSON line. GGML_SERVE_BENCH_TINY=1 shrinks it to
2 layers of 256 (a smoke run on the host).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .common import cli_device, gpt_argparser


def bench(args):
    """Serving benchmark: mixed prefill/decode continuous batching at
    GPT-J-6B Q4_0 geometry (synthetic weights drawn on the device),
    staggered arrivals. Prints ONE JSON line: aggregate decode tok/s and
    the per-request p50 TTFT. The JAX package's BatchedEngine(stacked=True)
    prepares the weights for its kernels; here that is prepare_fused, then
    ops.qmm.params_repack."""
    from ..models import gptj
    from ..ops.qmm import params_repack
    from ..quant.formats import GGMLType
    from ..runtime.batched import BatchedEngine

    dev = args.device
    n_req = args.n_parallel
    tiny = os.environ.get("GGML_SERVE_BENCH_TINY") == "1"   # host smoke run
    n_ctx = args.ctx_size or (256 if tiny else 2048)
    if args.steady and not args.ctx_size and not tiny:
        # the cell pool must hold every request's prompt + full decode +
        # the pipeline's pre-registered chunk cells at once (long decodes,
        # no early frees): size it to the workload
        need = n_req * (128 + args.n_predict + 2 * args.chunk) + 64
        while n_ctx < need:
            n_ctx *= 2
    cfg = gptj.GPTJConfig(n_vocab=256 if tiny else 50400, n_ctx=n_ctx,
                          n_embd=256 if tiny else 4096,
                          n_head=8 if tiny else 16,
                          n_layer=2 if tiny else 28,
                          n_rot=32 if tiny else 64)
    t0 = time.time()
    params = params_repack(gptj.prepare_fused(
        gptj.synthetic_params_device(cfg, GGMLType.Q4_0, seed=0, device=dev),
        cfg))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"# staged 6B params in {time.time()-t0:.0f}s", file=sys.stderr)

    rng = np.random.default_rng(0)

    def workload(be):
        """n_req staggered requests: 64-128-token prompts, `npred` new
        tokens each. Arrivals every 4 engine steps so prefill chunks and
        decode rows mix in the same ubatches (continuous batching, not a
        static batch). In --steady mode, once every request is past its
        prompt the loop hands off to run_pipelined (double-buffered
        chunks) and the post-ramp phase is timed separately."""
        t_start = time.perf_counter()
        ttft, t_add = {}, {}
        chunk = args.chunk
        plo, phi, npred = (8, 17, 6) if tiny else (64, 128, 32)
        if args.steady:
            npred = 6 if tiny else args.n_predict
        queue = [(4 * i, int(rng.integers(plo, phi)), npred)
                 for i in range(n_req)]
        step_no = 0
        t_steady = gen_ramp = None
        while queue or any(not be.requests[rid].done for rid in t_add):
            if args.steady and not queue and all(
                    r.done or r.n_prompt_done >= len(r.prompt)
                    for r in be.requests.values()):
                # every arrival is prefilled: note TTFTs, then drain the
                # whole decode tail through the double-buffered pipeline
                for rid, t_a in t_add.items():
                    r = be.requests[rid]
                    if rid not in ttft and (r.out or r.next_tok is not None):
                        ttft[rid] = time.perf_counter() - t_a
                gen_ramp = sum(len(be.requests[rid].out) for rid in t_add)
                t_steady = time.perf_counter()
                be.run_pipelined(chunk)
                break
            while queue and queue[0][0] <= step_no:
                _, plen, np_ = queue.pop(0)
                rid = be.add_request(
                    list(rng.integers(0, cfg.n_vocab - 1, plen)), np_,
                    temp=0.8, top_k=40, top_p=0.95, seed=step_no)
                t_add[rid] = time.perf_counter()
            if chunk > 1 and not args.steady:
                # a chunked iteration advances every decode stream by up to
                # `chunk` tokens: advance the arrival clock by the same
                # amount, else arrivals (scheduled in step units) overlap
                # far less than in the per-token loop
                live = [r for r in be.requests.values() if not r.done]
                decode_only = live and all(
                    r.n_prompt_done >= len(r.prompt) for r in live)
                be.step_chunk(chunk)
                step_no += chunk if decode_only else 1
            else:
                be.step()
                step_no += 1
            for rid, t_a in t_add.items():
                r = be.requests[rid]
                if rid not in ttft and (r.out or r.next_tok is not None):
                    ttft[rid] = time.perf_counter() - t_a
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t_start
        gen = sum(len(be.requests[rid].out) for rid in t_add)
        steady = None
        if t_steady is not None:
            steady = (gen - gen_ramp, time.perf_counter() - t_steady)
        return gen, wall, sorted(ttft.values()), steady

    be = BatchedEngine(gptj, cfg, params, n_ctx=n_ctx, kv_dtype="q8_0",
                       on_device_sampling=True, seed=1, device=dev)
    t0 = time.time()
    workload(be)                       # warm-up: the chunks' CUDA graphs
    print(f"# warmup (capture) {time.time()-t0:.0f}s", file=sys.stderr)
    for rid in list(be.requests):
        del be.requests[rid]
    gen, wall, ttfts, steady = workload(be)
    p50 = ttfts[len(ttfts) // 2] if ttfts else float("nan")
    out = {
        "metric": "serve_gptj6b_q4_0_tok_s",
        "value": round(gen / wall, 2), "unit": "tok/s aggregate",
        "n_requests": n_req, "generated": gen,
        "p50_ttft_ms": round(p50 * 1e3, 1),
        "chunk": args.chunk,
        "wall_s": round(wall, 2)}
    if steady is not None:
        sg, sw = steady
        out["steady_tok_s"] = round(sg / sw, 2)     # post-ramp, pipelined
        out["steady_generated"] = sg
        out["n_predict"] = args.n_predict
    print(json.dumps(out))


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = gpt_argparser("Parallel generation via continuous batching (GPT-2)")
    ap.add_argument("-np", "--n_parallel", type=int, default=None)
    ap.add_argument("--bench", action="store_true",
                    help="serving benchmark at GPT-J-6B geometry "
                         "(synthetic weights); prints one JSON line")
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per captured dispatch once every live "
                         "request is past its prompt (BatchedEngine"
                         ".step_chunk): amortizes the per-step host round "
                         "trip; 1 = the reference's per-token loop")
    ap.add_argument("--steady", action="store_true",
                    help="steady-state serving bench: decode --n_predict "
                         "tokens per request and, once every arrival is "
                         "prefilled, drain the decode tail through the "
                         "double-buffered pipeline (run_pipelined); "
                         "reports steady_tok_s separately from the ramp")
    if "--bench" in argv and not {"-m", "--model"} & set(argv):
        argv += ["-m", "synthetic"]                # --bench needs no file
    args = ap.parse_args(argv)
    args.device = cli_device(args.device)
    if args.bench:
        args.n_parallel = args.n_parallel or 8
        bench(args)
        return 0
    args.n_parallel = args.n_parallel or 4

    from ..models import gpt2
    from ..runtime.batched import BatchedEngine

    cfg, params, tok = gpt2.load_legacy(args.model, device=args.device)
    dtype = torch.float32 if args.f32 else torch.bfloat16
    be = BatchedEngine(gpt2, cfg, params, compute_dtype=dtype, kv_dtype=dtype,
                       n_ctx=args.ctx_size or None, device=args.device)
    prompt = tok.encode(args.prompt)
    rid0 = be.add_request(prompt, args.n_predict, temp=args.temp,
                          top_k=args.top_k, top_p=args.top_p, seed=args.seed)
    be.step()                                    # shared prefill
    rids = [rid0] + [be.fork(rid0, seed=args.seed + i)
                     for i in range(1, args.n_parallel)]
    outs = be.run()
    for i, rid in enumerate(rids):
        print(f"--- sequence {i} ---")
        print(args.prompt + tok.decode(outs[rid]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
