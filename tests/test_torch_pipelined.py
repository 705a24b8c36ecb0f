"""Port parity: the serving engine's k-step decode chunks
(runtime/batched.py: step_chunk on a chunk run, _dispatch_chunk and
run_pipelined) against the JAX package's BatchedEngine, mirroring
tests/test_batched.py's run_pipelined tests.

On the card a chunk is captured into a CUDA graph and chunk j + 1 runs
from chunk j's last picks on the card before the host reads chunk j; here
on the CPU the same chunk function runs eagerly and the carry is the same
copy into the next chunk's packed input. Greedy tokens must equal the
reference's step loop; every cell must be freed at the end.
"""
import jax.numpy as jnp
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

# the tiny GPT-2 of tests/test_batched.py, its weights at scale 0.3 so that
# greedy decoding does not settle on one token
GPT2 = dict(n_vocab=96, n_ctx=128, n_embd=64, n_head=4, n_layer=2)
SCALE = 0.3
GPTJ = dict(n_vocab=640, n_ctx=64, n_embd=256, n_head=2, n_layer=2, n_rot=32)


@pytest.fixture(scope="module")
def tiny():
    return (jgpt2.synthetic_params(jgpt2.GPT2Config(**GPT2), JType.F32,
                                   seed=7, scale=SCALE),
            tgpt2.synthetic_params(tgpt2.GPT2Config(**GPT2), GGMLType.F32,
                                   seed=7, scale=SCALE, device="cpu"))


def jbatched(jp, **kw):
    return JBatched(jgpt2, jgpt2.GPT2Config(**GPT2), jp,
                    compute_dtype=jnp.float32, kv_dtype=jnp.float32,
                    on_device_sampling=True, **kw)


def tbatched(tp, **kw):
    return BatchedEngine(tgpt2, tgpt2.GPT2Config(**GPT2), tp,
                         compute_dtype=torch.float32, kv_dtype=torch.float32,
                         on_device_sampling=True, device="cpu", **kw)


def step_loop(e):
    while e.step():
        pass
    return {rid: r.out for rid, r in e.requests.items()}


def freed(e):
    return bool((e.cell_pos[:-1] == -1).all())


@pytest.mark.parametrize("k", [2, 4])
def test_run_pipelined_matches_reference_step_loop(tiny, k):
    prompts = [[3, 14, 15], [92, 6, 53, 35], [8, 44]]
    npreds = [11, 7, 18]
    ref, t, own = jbatched(tiny[0]), tbatched(tiny[1]), tbatched(tiny[1])
    rr = [ref.add_request(p, n, temp=0.0) for p, n in zip(prompts, npreds)]
    rt = [t.add_request(p, n, temp=0.0) for p, n in zip(prompts, npreds)]
    ro = [own.add_request(p, n, temp=0.0) for p, n in zip(prompts, npreds)]
    want, got, mine = step_loop(ref), t.run_pipelined(k), step_loop(own)
    assert [got[r] for r in rt] == [want[r] for r in rr] == \
        [mine[r] for r in ro]
    assert [len(got[r]) for r in rt] == npreds
    assert len({x for r in rt for x in got[r]}) > 3
    assert freed(t)
    # each step of a chunk is one decode-only ubatch, discarded chunks too
    assert t.n_ubatches["decode"] >= own.n_ubatches["decode"]
    assert t.n_ubatches["mixed"] == own.n_ubatches["mixed"] == 1


def test_run_pipelined_eos_discard_and_cell_reuse(tiny):
    """EOS while a successor chunk is in flight: the successor's tokens for
    that row are discarded, its cells (the chunk's pre-registered ones
    too) freed after the drain, and the pool stays usable."""
    ref, t = jbatched(tiny[0], n_ctx=64), tbatched(tiny[1], n_ctx=64)
    probe = t.add_request([5, 9, 3], 12, temp=0.0)
    t.run_pipelined(3)
    out = t.requests[probe].out
    del t.requests[probe]
    i = next(i for i in range(4, len(out)) if out[i] not in out[:i])
    eos = out[i]                                # inside a later chunk
    rid = t.add_request([5, 9, 3], 12, temp=0.0, eos_id=eos)
    t.run_pipelined(3)
    want = out[:out.index(eos) + 1]
    rj = ref.add_request([5, 9, 3], 12, temp=0.0, eos_id=eos)
    assert t.requests[rid].out == want == step_loop(ref)[rj]
    assert freed(t)
    rid2 = t.add_request([7, 2], 6, temp=0.0)
    t.run_pipelined(3)
    assert len(t.requests[rid2].out) == 6 and freed(t)


def test_run_pipelined_at_the_arena_edge_keeps_valid_tokens(tiny):
    """A chunk that lands at the arena's edge keeps its tokens: the retire
    loop checks each token's own feed position."""
    prompt, n_ctx = [5, 9, 3], 24
    ref = jbatched(tiny[0], n_ctx=n_ctx)
    r0 = ref.add_request(prompt, 100, temp=0.0)
    want = step_loop(ref)[r0]
    assert len(want) > 8                          # bounded by the arena
    ck = tbatched(tiny[1], n_ctx=n_ctx)
    r1 = ck.add_request(prompt, 100, temp=0.0)
    while ck.step_chunk(8):
        pass
    pp = tbatched(tiny[1], n_ctx=n_ctx)
    r2 = pp.add_request(prompt, 100, temp=0.0)
    assert ck.requests[r1].out == pp.run_pipelined(8)[r2] == want
    assert freed(ck) and freed(pp)


def test_run_pipelined_needs_on_device_sampling(tiny):
    e = BatchedEngine(tgpt2, tgpt2.GPT2Config(**GPT2), tiny[1],
                      compute_dtype=torch.float32, kv_dtype=torch.float32,
                      device="cpu")
    with pytest.raises(ValueError, match="on_device_sampling"):
        e.run_pipelined(4)


def test_chunks_are_cached_per_k_and_nb(tiny):
    t = tbatched(tiny[1])
    for p in ([3, 14, 15], [92, 6]):
        t.add_request(p, 9, temp=0.0)
    t.run_pipelined(4)
    assert set(t._chunks) == {(4, 8)}             # two rows: bucket 8
    assert t._chunks[(4, 8)][1].graph is None     # the CPU runs it eagerly


def test_sampled_pipelined_run_is_reproducible(tiny):
    outs = []
    for _ in range(2):
        t = tbatched(tiny[1], seed=5)
        rids = [t.add_request(p, 10, temp=0.9, top_p=0.95, seed=1)
                for p in ([3, 14, 15], [8, 44])]
        got = t.run_pipelined(4)
        outs.append([got[r] for r in rids])
    assert outs[0] == outs[1]
    assert all(len(o) == 10 and all(0 <= x < GPT2["n_vocab"] for x in o)
               for o in outs[0])


@pytest.mark.parametrize("fused", [False, True])
def test_gptj_cells_routes_pipelined_match_reference(fused, monkeypatch):
    """Tiny GPT-J, q8_0 arena: the decode-only chunks take the cells
    kernels' routes ("cells2", or "cells" with fused_kv_update) and give
    the reference's greedy tokens."""
    prompts = [[3, 5, 7, 11], [13, 17]]
    cfg = jgptj.GPTJConfig(**GPTJ)
    j = JBatched(jgptj, cfg, jgptj.synthetic_params(cfg, JType.Q4_0, seed=17),
                 kv_dtype="q8_0", on_device_sampling=True)
    rj = [j.add_request(p, 9, temp=0.0) for p in prompts]
    want = step_loop(j)
    tcfg = tgptj.GPTJConfig(**GPTJ)
    tp = params_repack(tgptj.prepare_fused(
        tgptj.synthetic_params(tcfg, seed=17, device="cpu"), tcfg))
    route = "decode_attention_update_cells" if fused else \
        "decode_attention_cells"
    calls = []
    real = getattr(tgptj, route)
    monkeypatch.setattr(tgptj, route,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    t = BatchedEngine(tgptj, tcfg, tp, kv_dtype="q8_0", device="cpu",
                      on_device_sampling=True, fused_kv_update=fused)
    rt = [t.add_request(p, 9, temp=0.0) for p in prompts]
    got = t.run_pipelined(4)
    assert [got[r] for r in rt] == [want[r] for r in rj]
    assert len(calls) == GPTJ["n_layer"] * t.n_ubatches["decode"]
    assert freed(t)


def test_a_dropped_engine_is_freed_without_the_cycle_collector(tiny):
    import gc
    import weakref
    t = tbatched(tiny[1])
    t.add_request([3, 14, 15], 9, temp=0.0)
    t.run_pipelined(4)
    assert t._chunks
    gone = weakref.ref(t)
    was = gc.isenabled()
    gc.disable()
    try:
        del t
        assert gone() is None
    finally:
        if was:
            gc.enable()
