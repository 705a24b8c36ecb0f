"""Pipeline parallelism over the ranks of a process group (counterpart of
ggml_imax_tpu/parallel/pipeline.py).

Reference: the multi-backend scheduler's micro-batch pipelining — layer
ranges assigned per backend (-ngl, gpt-2/main-sched.cpp:307-400) with
n_copies=4 in-flight input copies + events (ggml-backend.c:1066-1071,
1633-1716).

GPipe: rank i of the group owns stage i (a contiguous range of layers);
every step each rank applies its stage to its current micro-batch and
sends the activations to the next rank (`distributed.ring_shift`, the
ppermute of the JAX version). Total steps = n_micro + n_stages - 1 (the
bubble); the last stage's outputs are broadcast to every rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .distributed import ring_shift


def pipeline_forward(stage_fn, stage_params, x, group=None, *,
                     n_microbatch: int | None = None):
    """Run x through a layer pipeline over the ranks of `group`.

    stage_fn(params, micro) -> micro : applies ONE stage (the same
        computation on every rank; params differ per stage).
    stage_params: one entry a stage, in stage order (stack_stage_params);
        each rank reads only its own entry, so the others may be None.
    x: (n_microbatch * B, ...) global batch, the same on every rank; split
        into micro-batches (default: one a stage).

    Returns y with x's shape on every rank. stage_fn must keep the
    activations' shape and dtype (classic pipeline contract)."""
    n_stages = dist.get_world_size(group)
    idx = dist.get_rank(group)
    n_micro = n_microbatch or n_stages
    total = x.shape[0]
    if total % n_micro:
        raise ValueError(f"batch {total} into {n_micro} micro-batches")
    micros = x.reshape(n_micro, total // n_micro, *x.shape[1:])
    params = stage_params[idx]
    buf = torch.zeros_like(micros[0])
    outs = torch.zeros_like(micros)
    n_steps = n_micro + n_stages - 1
    for t in range(n_steps):
        cur = micros[min(t, n_micro - 1)] if idx == 0 else buf
        live = 0 <= t - idx < n_micro
        y = stage_fn(params, cur) if live else cur
        if idx == n_stages - 1 and live:
            outs[t - (n_stages - 1)] = y
        if t < n_steps - 1:
            (buf,) = ring_shift([y], group)
    last = n_stages - 1 if group is None else dist.get_global_rank(
        group, n_stages - 1)
    dist.broadcast(outs, src=last, group=group)
    return outs.reshape(total, *x.shape[1:])


def stack_stage_params(per_stage: list) -> list:
    """[stage0_params, stage1_params, ...] -> the per-stage list
    pipeline_forward takes (each rank reads its own entry)."""
    return list(per_stage)
