"""Perplexity over non-overlapping windows (counterpart of
ggml_imax_tpu/tools/perplexity.py): llama.cpp's perplexity recipe, each
window of n_ctx tokens one forward with a fresh KV cache, -log p(t_i |
t_<i) summed over the tokens whose visible context is at least
min_context (n_ctx // 2 by default).

The forward runs on the params' device; each window's NLL sum is taken
there and read back once.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..quant.device import QTensor


def params_device(params) -> torch.device:
    """The device of the first tensor in a params tree."""
    stack = [params]
    while stack:
        d = stack.pop()
        if isinstance(d, torch.Tensor):
            return d.device
        if isinstance(d, QTensor):
            return d.q.device
        if isinstance(d, dict):
            stack.extend(reversed(list(d.values())))
        elif isinstance(d, (list, tuple)):
            stack.extend(reversed(d))
    raise ValueError("params hold no tensor")


def perplexity(model_module, cfg, params, tokens, *, n_ctx: int = 512,
               compute_dtype=torch.bfloat16, min_context: int | None = None,
               progress=None) -> dict:
    """tokens: 1-D int array. Returns {"ppl", "nll", "n_tokens"}: the
    perplexity, the mean NLL and the count of scored tokens. progress, if
    given, is called as progress(window, n_windows, ppl so far)."""
    tokens = np.asarray(tokens, np.int32)
    min_context = n_ctx // 2 if min_context is None else min_context
    n_windows = len(tokens) // n_ctx
    if n_windows == 0:
        raise ValueError(f"need at least n_ctx={n_ctx} tokens, "
                         f"got {len(tokens)}")
    dev = params_device(params)
    pos = torch.arange(n_ctx, device=dev)[None]
    # token i + 1 is predicted from the logits at i
    scored = (torch.arange(n_ctx - 1, device=dev) + 1) >= min_context
    per_window = int(sum(i + 1 >= min_context for i in range(n_ctx - 1)))

    nll, count = 0.0, 0
    for wi in range(n_windows):
        chunk = torch.from_numpy(
            tokens[wi * n_ctx:(wi + 1) * n_ctx].astype(np.int64)).to(dev)
        cache = model_module.init_cache(cfg, batch=1, n_ctx=n_ctx,
                                        dtype=compute_dtype, device=dev)
        with torch.no_grad():
            logits, _ = model_module.forward(cfg, params, chunk[None], pos,
                                             cache, 0,
                                             compute_dtype=compute_dtype)
            # log-softmax by jax.nn's formula, in f32
            z = logits[0].float()
            z = z - z.amax(dim=-1, keepdim=True)
            logp = z - torch.log(torch.exp(z).sum(dim=-1, keepdim=True))
            lp = logp[:-1].gather(1, chunk[1:, None])[:, 0]
            s = -(lp * scored).sum()
        nll += float(s)
        count += per_window
        del cache, logits, logp
        if progress:
            progress(wi + 1, n_windows, math.exp(nll / max(1, count)))
    return {"ppl": math.exp(nll / max(1, count)),
            "nll": nll / max(1, count), "n_tokens": count}
