"""Port parity: the continuous-batching engine (runtime/batched.py) against
the JAX package's BatchedEngine, mirroring tests/test_batched.py.

The tiny F32 GPT-2 of that file's fixture (head_dim 16: the plain "xla"
route) drives the engine's semantics: the port's engine and the reference's
run the same requests in lockstep, and after every step their cell
registries (cell_pos, cell_seq) are equal; greedy tokens are identical. A
tiny GPT-J (head_dim 128) in Q4_0 with bf16 and q8_0 KV takes the cells
kernels' routes ("cells2", and "cells" with fused_kv_update) and must give
the greedy tokens of the reference's stacked engine with its kernels in
interpret mode. The port runs the plain versions of its kernels here.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.models import gpt2 as jgpt2
from ggml_imax_tpu.models import gptj as jgptj
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu.runtime.batched import BatchedEngine as JBatched
from ggml_imax_tpu_torch.models import gpt2 as tgpt2
from ggml_imax_tpu_torch.models import gptj as tgptj
from ggml_imax_tpu_torch.ops.qmm import params_repack
from ggml_imax_tpu_torch.quant.formats import GGMLType
from ggml_imax_tpu_torch.runtime.batched import BatchedEngine
from ggml_imax_tpu_torch.runtime.engine import Engine

jqmatmul = importlib.import_module("ggml_imax_tpu.ops.qmatmul")

GPT2 = dict(n_vocab=96, n_ctx=128, n_embd=64, n_head=4, n_layer=2)
GPTJ = dict(n_vocab=640, n_ctx=64, n_embd=256, n_head=2, n_layer=2, n_rot=32)


@pytest.fixture(scope="module")
def tiny():
    return (jgpt2.synthetic_params(jgpt2.GPT2Config(**GPT2), JType.F32, seed=7),
            tgpt2.synthetic_params(tgpt2.GPT2Config(**GPT2), GGMLType.F32,
                                   seed=7, device="cpu"))


def pair(tiny, **kw):
    """The reference's engine and the port's on the same F32 weights."""
    jp, tp = tiny
    jkv, tkv = kw.pop("jkv", jnp.float32), kw.pop("tkv", torch.float32)
    j = JBatched(jgpt2, jgpt2.GPT2Config(**GPT2), jp,
                 compute_dtype=jnp.float32, kv_dtype=jkv, **kw)
    t = BatchedEngine(tgpt2, tgpt2.GPT2Config(**GPT2), tp,
                      compute_dtype=torch.float32, kv_dtype=tkv, device="cpu",
                      **kw)
    return j, t


def lockstep(j, t, step=lambda e: e.step(), limit=200):
    """Drive both engines to the end; the registries agree after each step."""
    for _ in range(limit):
        more = step(j)
        assert step(t) == more
        np.testing.assert_array_equal(t.cell_pos, j.cell_pos)
        np.testing.assert_array_equal(t.cell_seq, j.cell_seq)
        if not more:
            return
    raise AssertionError("engines did not finish")


def outs(e, rids):
    return [e.requests[r].out for r in rids]


def test_single_request_matches_engine(tiny):
    prompt = [3, 14, 15, 92, 6]
    j, t = pair(tiny)
    rj, rt = j.add_request(prompt, 8, temp=0.0), t.add_request(prompt, 8,
                                                                temp=0.0)
    lockstep(j, t)
    ref = Engine(tgpt2, tgpt2.GPT2Config(**GPT2), tiny[1],
                 compute_dtype=torch.float32, kv_dtype=torch.float32,
                 device="cpu").generate(prompt, 8, temp=0.0)
    assert t.requests[rt].out == j.requests[rj].out == ref
    assert t.n_ubatches == {"mixed": 1, "decode": 7}


@pytest.mark.parametrize("kv", ["f32", "q8_0"])
def test_parallel_sequences(tiny, kv):
    prompts = [[3, 14, 15], [92, 6, 53, 35], [8]]
    kw = {} if kv == "f32" else {"jkv": "q8_0", "tkv": "q8_0"}
    j, t = pair(tiny, **kw)
    rids = [(j.add_request(p, 6, temp=0.0), t.add_request(p, 6, temp=0.0))
            for p in prompts]
    lockstep(j, t)
    assert outs(t, [b for _, b in rids]) == outs(j, [a for a, _ in rids])


def test_fork_shares_prefix(tiny):
    prompt = [3, 14, 15, 92]
    j, t = pair(tiny)
    rj, rt = j.add_request(prompt, 5, temp=0.0), t.add_request(prompt, 5,
                                                                temp=0.0)
    j.step(), t.step()                       # prefill the prompt
    used = int((t.cell_pos >= 0).sum())
    assert used == len(prompt)
    fj, ft = j.fork(rj), t.fork(rt)
    assert int((t.cell_pos >= 0).sum()) == used      # no new cells
    np.testing.assert_array_equal(t.cell_seq, j.cell_seq)
    lockstep(j, t)
    assert outs(t, [rt, ft]) == outs(j, [rj, fj])
    assert t.requests[ft].out == t.requests[rt].out


def test_cells_recycled_and_seq_reuse(tiny):
    j, t = pair(tiny, n_ctx=64)
    for round_ in range(3):
        rj = j.add_request([5 + round_, 9], 4, temp=0.0)
        rt = t.add_request([5 + round_, 9], 4, temp=0.0)
        lockstep(j, t)
        assert t.requests[rt].out == j.requests[rj].out
        assert t.requests[rt].seq == j.requests[rj].seq == 0
    assert int((t.cell_pos >= 0).sum()) == 0 and len(t.requests) == 3


def test_ubatch_chunked_prefill(tiny):
    prompts = [list(np.random.default_rng(3).integers(0, 90, 13)), [8, 9]]
    j, t = pair(tiny, n_ubatch=4)
    rids = [(j.add_request(p, 6, temp=0.0), t.add_request(p, 6, temp=0.0))
            for p in prompts]
    lockstep(j, t)
    assert outs(t, [b for _, b in rids]) == outs(j, [a for a, _ in rids])
    assert t.n_ubatches["mixed"] >= 4         # 15 prompt tokens at <= 4 a step


def test_on_device_sampling_greedy_and_per_request_params(tiny):
    prompt = [3, 14, 15, 92, 6]
    j, t = pair(tiny, on_device_sampling=True)
    reqs = [dict(temp=0.0), dict(temp=3.0, top_k=1), dict(temp=0.9)]
    rids = [(j.add_request(prompt, 6, **kw), t.add_request(prompt, 6, **kw))
            for kw in reqs]
    lockstep(j, t)
    greedy = j.requests[rids[0][0]].out
    assert t.requests[rids[0][1]].out == greedy
    assert t.requests[rids[1][1]].out == greedy      # top_k 1 at temp 3
    sampled = t.requests[rids[2][1]].out
    assert len(sampled) == 6 and all(0 <= x < GPT2["n_vocab"] for x in sampled)


def test_step_chunk_matches_reference(tiny):
    prompts = [[3, 14, 15], [92, 6, 53, 35], [8, 44]]
    j, t = pair(tiny, on_device_sampling=True)
    rids = [(j.add_request(p, 11, temp=0.0), t.add_request(p, 11, temp=0.0))
            for p in prompts]
    lockstep(j, t, step=lambda e: e.step_chunk(4))
    assert outs(t, [b for _, b in rids]) == outs(j, [a for a, _ in rids])
    # one upload and one fetch per chunk; each chunk step is one ubatch
    assert t.n_ubatches["decode"] >= 4 * 2


def test_step_chunk_eos_and_cell_reuse(tiny):
    j, t = pair(tiny, on_device_sampling=True, n_ctx=64)
    probes = [e.add_request([5, 9, 3], 8, temp=0.0) for e in (j, t)]
    lockstep(j, t, step=lambda e: e.step_chunk(4))
    eos = t.requests[probes[1]].out[1]            # EOS inside the first chunk
    for e, rid in zip((j, t), probes):
        del e.requests[rid]
    rj = j.add_request([5, 9, 3], 8, temp=0.0, eos_id=eos)
    rt = t.add_request([5, 9, 3], 8, temp=0.0, eos_id=eos)
    lockstep(j, t, step=lambda e: e.step_chunk(4))
    assert t.requests[rt].out == j.requests[rj].out
    assert t.requests[rt].out[-1] == eos
    assert (t.cell_pos[:-1] == -1).all()           # all cells freed


def test_find_slot_head_cursor_and_wraparound(tiny):
    _, t = pair(tiny, n_ctx=17)                # 16 usable cells + trash
    assert (t._find_slot(4), t._find_slot(4), t.head) == (0, 4, 8)
    t.cell_pos[:8] = np.arange(8)
    t.cell_seq[:8] = np.uint32(1)
    assert t._find_slot(8) == 8 and t.head == 16
    t.cell_pos[8:16] = 9
    with pytest.raises(RuntimeError):
        t._find_slot(1)                        # pool full
    t.cell_pos[0:4] = -1
    assert t._find_slot(3) == 0 and t.head == 3
    t.cell_pos[:] = 5
    t.cell_pos[t.trash_cell] = -1
    with pytest.raises(RuntimeError):
        t._find_slot(1)                        # the trash cell is never given


def test_batched_engine_defaults_to_the_card(tiny):
    if torch.cuda.is_available():
        be = BatchedEngine(tgpt2, tgpt2.GPT2Config(**GPT2), tiny[1])
        assert be.device.type == be.cache.k.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchedEngine(tgpt2, tgpt2.GPT2Config(**GPT2), tiny[1])
    be = BatchedEngine(tgpt2, tgpt2.GPT2Config(**GPT2), tiny[1], device="cpu",
                       fused_kv_update=True)
    be.add_request([3, 14], 2)
    with pytest.raises(ValueError, match="fused KV-update"):
        be.step()


def _gptj_port(kv):
    cfg = tgptj.GPTJConfig(**GPTJ)
    p = params_repack(tgptj.prepare_fused(
        tgptj.synthetic_params(cfg, seed=17, device="cpu"), cfg))
    return cfg, p


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_gptj_cells_routes_match_stacked_reference(kv, fused, monkeypatch):
    prompts = [[3, 5, 7, 11], [13, 17]]
    jkv, tkv = (jnp.bfloat16, torch.bfloat16) if kv == "bf16" else ("q8_0",) * 2
    if fused:
        monkeypatch.setenv("GGML_FUSED_KV_UPDATE", "1")
    cfg = jgptj.GPTJConfig(**GPTJ)
    jqmatmul.set_force_fused(True)
    try:
        j = JBatched(jgptj, cfg, jgptj.synthetic_params(cfg, JType.Q4_0,
                                                        seed=17),
                     kv_dtype=jkv, stacked=True)
        rj = [j.add_request(p, 5, temp=0.0) for p in prompts]
        want = j.run()
    finally:
        jqmatmul.set_force_fused(False)
    route = "decode_attention_update_cells" if fused else \
        "decode_attention_cells"
    calls = _count_calls(monkeypatch, tgptj, route)
    tcfg, tp = _gptj_port(kv)
    t = BatchedEngine(tgptj, tcfg, tp, kv_dtype=tkv, fused_kv_update=fused,
                      device="cpu")
    rt = [t.add_request(p, 5, temp=0.0) for p in prompts]
    got = t.run()
    assert [got[r] for r in rt] == [want[r] for r in rj]
    assert t.n_ubatches == {"mixed": 1, "decode": 4}
    assert len(calls) == GPTJ["n_layer"] * t.n_ubatches["decode"]


def test_gptj_engine_fused_kv_update_matches_two_step(monkeypatch):
    tcfg, tp = _gptj_port("bf16")
    prompt = [3, 5, 7, 11, 13]
    want = Engine(tgptj, tcfg, tp, device="cpu").generate(prompt, 6, temp=0)
    calls = _count_calls(monkeypatch, tgptj, "decode_attention_update")
    eng = Engine(tgptj, tcfg, tp, device="cpu", fused_kv_update=True)
    assert eng.generate(prompt, 6, temp=0) == want
    assert len(calls) == GPTJ["n_layer"] * 5        # every decode step
    gpt2_fused = Engine(tgpt2, tgpt2.GPT2Config(**GPT2), {}, device="cpu",
                        fused_kv_update=True)
    with pytest.raises(ValueError, match="fused KV-update"):
        gpt2_fused.generate([3, 14], 2, temp=0)
