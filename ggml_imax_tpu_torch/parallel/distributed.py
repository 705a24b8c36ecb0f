"""Multi-process execution on torch.distributed — the RPC backend's
replacement (counterpart of ggml_imax_tpu/parallel/distributed.py).

Reference: src/ggml-rpc.cpp (SURVEY §2.9) — a TCP client/server that
ships serialized tensors and graphs to one remote device at a time; no
collectives, no sharded execution.

Here every rank is one process driving one device. `init` joins the
process group (torchrun's environment, or explicit arguments); the
parallel modules then run plain collectives (`all_reduce`, `all_gather`,
`broadcast`, `batch_isend_irecv`) over a group their caller names.

The backend is an explicit choice: `None` means "nccl" for a CUDA device
and "gloo" for the CPU. NCCL refuses two ranks on one device, so ranks
that share one card pass "gloo", whose collectives take CUDA tensors and
stage them through host memory; its point-to-point messages do not, so
`ring_shift` copies them through the host itself (`p2p_route`). The NCCL
route is written but unverified: no machine with several cards has run
it.
"""
from __future__ import annotations

import os
import queue
import time
import traceback
import uuid
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device


@dataclass
class ClusterInfo:
    process_index: int
    process_count: int
    local_devices: int
    global_devices: int      # one device a rank (ranks may share a card)
    platform: str


def init(init_method: str | None = None, world_size: int | None = None,
         rank: int | None = None, backend: str | None = None,
         device=None) -> ClusterInfo:
    """Join the process group (ggml-rpc's server start + client connect,
    but symmetric: every rank calls this once). Arguments left None are
    read from torchrun's environment (MASTER_ADDR with "env://",
    WORLD_SIZE, RANK, LOCAL_RANK); with neither arguments nor that
    environment it does nothing (a single process). backend None: "nccl"
    for a CUDA device, "gloo" for the CPU. A CUDA rank is bound to
    `device`'s index, else to LOCAL_RANK (or rank) modulo the cards."""
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    dev = resolve_device(device)
    if (init_method or world_size) and not dist.is_initialized():
        if dev.type == "cuda":
            idx = dev.index if dev.index is not None else int(
                env.get("LOCAL_RANK", rank or 0)) % torch.cuda.device_count()
            torch.cuda.set_device(idx)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size or 1, rank=rank or 0)
    return info(dev)


def info(device=None) -> ClusterInfo:
    dev = resolve_device(device)
    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    return ClusterInfo(
        process_index=dist.get_rank() if up else 0,
        process_count=world,
        local_devices=torch.cuda.device_count() if dev.type == "cuda" else 1,
        global_devices=world,
        platform=dev.type,
    )


def global_mesh(axes: dict[str, int] | None = None, device=None):
    """A DeviceMesh over all ranks. axes: ordered {name: size}; default one
    data axis spanning everything. Sizes must multiply to the world size
    (-1 means 'fill')."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size() if dist.is_initialized() else 1
    axes = dict(axes or {"dp": n})
    fill = [k for k, v in axes.items() if v == -1]
    if fill:
        known = int(np.prod([v for v in axes.values() if v != -1]))
        axes[fill[0]] = n // known
    shape = tuple(axes.values())
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh {axes} does not cover the {n} ranks")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=tuple(axes))


def p2p_route(group, device) -> str:
    """How `ring_shift` moves a tensor of `device` over `group`: "host"
    (through a host copy: gloo sends and receives host memory only) or
    "device"."""
    gloo = dist.get_backend(group) == "gloo"
    return "host" if gloo and torch.device(device).type == "cuda" else "device"


def _peer(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def ring_shift(tensors: list, group=None) -> list:
    """One hop of the ring (jax.lax.ppermute i -> i + 1): send each tensor
    to the group's next rank and return the previous rank's, as fresh
    tensors on the inputs' devices. Every rank passes tensors of the same
    shapes and dtypes; one rank returns its own."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    me = dist.get_rank(group)
    nxt, prv = _peer(group, (me + 1) % n), _peer(group, (me - 1) % n)
    host = p2p_route(group, tensors[0].device) == "host"
    send = [t.cpu() if host else t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, nxt, group, tag=i)
           for i, t in enumerate(send)]
    ops += [dist.P2POp(dist.irecv, t, prv, group, tag=i)
            for i, t in enumerate(recv)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(t.device) if host else r for r, t in zip(recv, tensors)]


def _rank_main(fn, rank, world_size, init_method, backend, device, args,
               results):
    try:
        init(init_method, world_size, rank, backend, device)
        results.put((rank, True, fn(rank, world_size, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world_size: int, args=(), *, rendezvous_dir, timeout: float,
          backend: str | None = None, device=None) -> list:
    """Run fn(rank, world_size, *args) in world_size processes on one host
    (torch.multiprocessing, "spawn"), each joined to one process group by
    `init` through a file:// rendezvous under rendezvous_dir; returns the
    ranks' results in rank order. fn is a module-level function; args and
    results are pickled (pass numpy arrays, not tensors). Raises with the
    traceback if a rank raises, and raises if a rank exits without a result
    or the ranks outlive `timeout` seconds; the other ranks are killed."""
    ctx = torch.multiprocessing.get_context("spawn")
    Path(rendezvous_dir).mkdir(parents=True, exist_ok=True)
    store = Path(rendezvous_dir).resolve() / f"rendezvous-{uuid.uuid4().hex}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world_size, f"file://{store}", backend, device, tuple(args),
        results)) for r in range(world_size)]
    for p in procs:
        p.start()
    out, quiet = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            try:
                rank, ok, res = results.get(timeout=1.0)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r in out or p.exitcode is None:
                        continue
                    # a clean exit's result may still be in the pipe
                    quiet[r] = quiet.get(r, 0) + 1
                    if p.exitcode != 0 or quiet[r] > 5:
                        raise RuntimeError(f"rank {r} exited with code "
                                           f"{p.exitcode} without a result")
                if time.monotonic() > deadline:
                    late = sorted(set(range(world_size)) - set(out))
                    raise TimeoutError(f"ranks {late} gave no result in "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{res}")
            out[rank] = res
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        store.unlink(missing_ok=True)
    return [out[r] for r in range(world_size)]
