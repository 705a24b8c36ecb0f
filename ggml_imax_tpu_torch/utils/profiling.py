"""Tracing / profiling — the GGML_PERF counter analog (counterpart of
ggml_imax_tpu/utils/profiling.py).

Reference (SURVEY §5): per-tensor perf_runs/cycles/time_us (ggml.h:589-592)
printed by ggml_graph_print; per-phase timers in whisper (whisper.cpp:
790-803); graphviz dump ggml_graph_dump_dot.

- `trace(logdir)`: torch.profiler over the host and, where there is one,
  the card (CUDA activity); writes a Chrome trace into logdir.
- `annotate(name)`: a named region (torch.profiler.record_function).
- `GraphTimers`: named host wall timers with a ggml_graph_print-style
  report; a section given a CUDA tensor synchronizes its device before
  the clock stops (a launch returns before the card finishes).
- `dump_graph(fn, *args)`: the ggml_graph_dump_dot analog — the code of
  the torch.export graph of fn at args (io/graph_export's tracer).
  `dump_hlo` is the JAX package's name for it.
- `memory_stats()`: per device live, peak and total bytes.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Profile the block (torch.profiler: CPU activity, and CUDA activity
    when a card is present) and write its Chrome trace to
    logdir/trace.json. Yields the profiler (key_averages() for the sums by
    op)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


def annotate(name: str):
    """Named region visible in profiler traces."""
    return torch.profiler.record_function(name)


class GraphTimers:
    """Accumulating named wall timers (whisper.cpp:790-803 style)."""

    def __init__(self):
        self.total_us = defaultdict(float)
        self.runs = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync: torch.Tensor | None = None):
        """Time a block; pass sync=tensor to wait for its device (a CUDA
        tensor: torch.cuda.synchronize) before the clock stops."""
        t0 = time.perf_counter()
        yield
        if sync is not None and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        self.total_us[name] += (time.perf_counter() - t0) * 1e6
        self.runs[name] += 1

    def report(self) -> str:
        """ggml_graph_print-style per-section summary."""
        lines = ["perf (per section):"]
        for name in self.total_us:
            us = self.total_us[name]
            n = self.runs[name]
            lines.append(f"  {name:<24} {n:>6} runs  {us/1e3:>10.2f} ms total"
                         f"  {us/max(1,n)/1e3:>8.3f} ms/run")
        return "\n".join(lines)


def dump_graph(fn, *args) -> str:
    """Graph dump (ggml_graph_dump_dot analog): the Python code of the
    torch.export graph of fn(*args), traced as io/graph_export traces (the
    kernels as ops/library's ops, QTensor and KVCache arguments)."""
    from ..io.graph_export import trace_graph
    return trace_graph(fn, args).graph_module.code


dump_hlo = dump_graph


def memory_stats() -> dict:
    """ggml_used_mem / buffer-size reporting analog: per CUDA device the
    bytes allocated now and at peak (torch.cuda.memory_stats) and the
    device's total; {"cpu": None} on a host without a card."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
    return out
