"""Token sampling (counterpart of ggml_imax_tpu/ops/sampling.py):
temperature, top-k, top-p nucleus (inclusive of the crossing token), then
a draw — the reference CLI flow.

- `sample_host`, `sample_greedy`: numpy, on the host.
- `sample_device`: batched tensors on the logits' device with per-row
  temp/top_k/top_p and a Gumbel-max draw from a torch.Generator;
  `sample_gumbel` is the same function with the noise given, so a test can
  feed the JAX package and the port the same noise (a JAX key and a torch
  generator never give the same bits), and a captured decode step reads
  noise drawn before its replay (`gumbel`).
"""
from __future__ import annotations

import numpy as np
import torch


def sample_host(logits: np.ndarray, *, top_k: int = 40, top_p: float = 0.9,
                temp: float = 0.9, rng: np.random.Generator | None = None,
                repeat_penalty: float = 1.0, last_tokens=()) -> int:
    rng = rng or np.random.default_rng()
    logits = np.asarray(logits, dtype=np.float64)
    n = len(logits)
    scale = 1.0 / temp if temp > 0 else 1.0

    scaled = logits * scale
    if repeat_penalty != 1.0 and len(last_tokens):
        for t in set(int(t) for t in last_tokens):
            if logits[t] < 0.0:
                scaled[t] = logits[t] * scale * repeat_penalty
            else:
                scaled[t] = logits[t] * scale / repeat_penalty

    top_k = min(top_k, n)
    idx = np.argpartition(-scaled, top_k - 1)[:top_k]
    idx = idx[np.argsort(-scaled[idx], kind="stable")]
    vals = scaled[idx]

    probs = np.exp(vals - vals.max())
    probs /= probs.sum()

    if top_p < 1.0:
        cumsum = np.cumsum(probs)
        cut = min(int(np.searchsorted(cumsum, top_p) + 1), len(probs))
        probs = probs[:cut] / cumsum[cut - 1]
        idx = idx[:cut]

    choice = rng.choice(len(probs), p=probs / probs.sum())
    return int(idx[choice])


def sample_greedy(logits) -> int:
    return int(np.argmax(np.asarray(logits)))


def sample_gumbel(logits, noise, *, top_k, top_p, temp):
    """logits (nb, V); noise (nb, k_max) standard Gumbel; top_k (nb, 1) int,
    top_p and temp (nb, 1) f32, or scalars. Keeps the k_max largest scaled
    logits (torch.topk, sorted), masks ranks >= top_k (top_k <= 0 keeps the
    whole window), softmax, keeps the top-p nucleus up to and including the
    crossing token (the top token always: top_p <= 0 is greedy), then
    argmax(log p + noise). Returns (nb,) int64 token ids."""
    lf = logits.float() / torch.clamp(torch.as_tensor(temp, dtype=torch.float32,
                                                      device=logits.device),
                                      min=1e-6)
    k_max = min(noise.shape[-1], lf.shape[-1])
    vals, idx = torch.topk(lf, k_max, dim=-1)                 # sorted desc
    rank = torch.arange(k_max, device=lf.device)
    top_k = torch.as_tensor(top_k, device=lf.device)
    vals = torch.where((rank < top_k) | (top_k <= 0), vals, float("-inf"))
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < torch.as_tensor(top_p, dtype=torch.float32,
                                           device=lf.device)
    probs = torch.where(keep | (rank == 0), probs, 0.0)
    z = torch.log(torch.clamp(probs, min=1e-30)) + noise[..., :k_max]
    return torch.gather(idx, -1, z.argmax(-1, keepdim=True))[..., 0]


def gumbel(u):
    """Standard Gumbel noise from uniform draws u in [0, 1): -log(-log(u)),
    u clamped to [tiny, 1)."""
    u = torch.clamp(u, min=float(np.finfo(np.float32).tiny))
    return -torch.log(-torch.log(u))


def sample_device(logits, generator: torch.Generator, *, top_k, top_p, temp,
                  k_max: int = 64):
    """sample_gumbel with (nb, k_max) Gumbel noise drawn from `generator`
    on the logits' device. A captured decode step draws no numbers: its
    uniform draws are made before the replay into a buffer it reads, and it
    calls sample_gumbel on gumbel(buffer)."""
    u = torch.rand((logits.shape[0], k_max), generator=generator,
                   device=logits.device)
    return sample_gumbel(logits, gumbel(u), top_k=top_k, top_p=top_p,
                         temp=temp)
