"""Port parity: LLaMA served by the continuous-batching engine
(runtime/batched.py) against the JAX package's BatchedEngine, on the host.

The 2-layer LLaMA of tests/test_torch_q4km.py in llama.cpp's Q4_K_M mix
(vocab 512, n_embd 256, 2 query heads of 128 over 1 kv head, n_ff 768;
layer 1's v_w and down_w and the head Q6_K), the JAX package's weights
carried over by params_from_jax. The reference runs its unstacked forward
(the mix's q/k/v do not fuse, so it cannot stack) with its kernels in
interpret mode; the port runs fuse_gate_up + params_repack with its plain
versions, on both cells routes: decode-only ubatches through the cells
attention ("cells2") or the fused KV update in cells mode
(fused_kv_update). Both engines serve the same greedy requests in lockstep
(two prompts in a mixed ubatch, then a fork and a third prompt joining the
decode rows, q8_0 arena): after every step the cell registries are equal,
every ubatch's logits agree within ATOL (the prompt rows' attention is
bf16 flash in the port and f32 XLA attention in the reference, as in
tests/test_torch_q4km.py; seen: 5.9e-2 of a largest |logit| of 5.2), and
the tokens are equal.
"""
import importlib

import numpy as np
import pytest

from ggml_imax_tpu.models import llama as jllama
from ggml_imax_tpu.ops import pallas_qmm as jpq
from ggml_imax_tpu.runtime.batched import BatchedEngine as JBatched
from ggml_imax_tpu_torch.models import llama as tllama
from ggml_imax_tpu_torch.runtime.batched import BatchedEngine

import test_torch_q4km as q4km

jqmatmul = importlib.import_module("ggml_imax_tpu.ops.qmatmul")

ATOL = 0.1
N_CTX, N_PREDICT = 96, 6


def recording_port(logs):
    """tllama with a forward that appends each ubatch's real rows' logits
    (pad rows go to the trash cell, n_ctx - 1)."""
    import types

    def forward(cfg, params, tokens, positions, cache, n_past, **kw):
        lg, cache = tllama.forward(cfg, params, tokens, positions, cache,
                                   n_past, **kw)
        logs.append(lg[0][kw["cells"][0] != cache.n_ctx - 1].float().numpy())
        return lg, cache
    return types.SimpleNamespace(forward=forward, init_cache=tllama.init_cache,
                                 __name__=tllama.__name__)


def recording_jax(j, logs):
    """The reference engine's jitted ubatch step, its logits' real rows
    appended to logs."""
    real = j._step

    def step(params, tokens, positions, seqs, cells, cell_pos, cell_seq,
             cache, ck=False):
        lg, cache = real(params, tokens, positions, seqs, cells, cell_pos,
                         cell_seq, cache, ck=ck)
        keep = np.asarray(cells)[0] != N_CTX - 1
        logs.append(np.asarray(lg, np.float32)[0][keep])
        return lg, cache
    j._step = step


def _prompts():
    rng = np.random.default_rng(11)
    return [list(map(int, rng.integers(0, q4km.CFG["n_vocab"], n)))
            for n in (9, 5, 12)]


def run_pair(fused):
    cfg, raw = q4km.jax_raw()
    jlogs, tlogs = [], []
    jqmatmul.set_force_fused(True)
    try:
        j = JBatched(jllama, cfg, jpq.params_repack_device(raw), n_ctx=N_CTX,
                     kv_dtype="q8_0")
        recording_jax(j, jlogs)
        tcfg, tp = q4km.port_params()
        t = BatchedEngine(recording_port(tlogs), tcfg, tp, n_ctx=N_CTX,
                          kv_dtype="q8_0", fused_kv_update=fused,
                          device="cpu")
        p = _prompts()
        rids = [(j.add_request(q, N_PREDICT, temp=0.0),
                 t.add_request(q, N_PREDICT, temp=0.0)) for q in p[:2]]
        regs = []
        for n in range(100):
            if n == 1:
                rids.append((j.fork(rids[0][0]), t.fork(rids[0][1])))
                rids.append((j.add_request(p[2], N_PREDICT, temp=0.0),
                             t.add_request(p[2], N_PREDICT, temp=0.0)))
            more = j.step()
            assert t.step() == more
            regs.append((np.array_equal(t.cell_pos, j.cell_pos),
                         np.array_equal(t.cell_seq, j.cell_seq)))
            if not more:
                break
    finally:
        jqmatmul.set_force_fused(False)
    outs = ([j.requests[a].out for a, _ in rids],
            [t.requests[b].out for _, b in rids])
    return jlogs, tlogs, outs, regs, t


@pytest.mark.parametrize("fused", [False, True], ids=["cells2", "cells"])
def test_llama_q4km_serving_matches_reference(fused, monkeypatch):
    calls = []
    route = "decode_attention_update_cells" if fused else \
        "decode_attention_cells"
    real = getattr(tllama, route)
    monkeypatch.setattr(tllama, route,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jlogs, tlogs, (jout, tout), regs, t = run_pair(fused)
    assert all(a and b for a, b in regs)
    assert tout == jout
    assert [len(o) for o in tout] == [N_PREDICT] * 4
    assert tout[2] == tout[0]                          # the fork
    assert len(tlogs) == len(jlogs) == t.n_ubatches["mixed"] \
        + t.n_ubatches["decode"]
    assert t.n_ubatches["mixed"] >= 2 and t.n_ubatches["decode"] >= 3
    scale = max(float(np.abs(r).max()) for r in jlogs)
    assert scale > 1.0                                 # not degenerate
    for r, g in zip(jlogs, tlogs):
        assert g.shape == r.shape
        assert float(np.abs(g - r).max()) <= ATOL
    # the decode-only ubatches took the cells route, one call a layer
    assert len(calls) == q4km.CFG["n_layer"] * t.n_ubatches["decode"]
    assert (t.cell_pos[:-1] == -1).all()               # every cell freed
