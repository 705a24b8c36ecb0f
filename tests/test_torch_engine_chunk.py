"""Port parity: chunked decode (runtime/engine.py: Engine.generate(chunk >
1), its decode spans, PerfCounters.report) against the port's own chunk-1
loop and the JAX package's generate(chunk=k).

On the card a decode span is captured into a CUDA graph and replayed; here
on the CPU the same span function runs eagerly, so these tests hold what
the graph records: the k-step loop with the token and n_past carried in
tensors, KV writes and masks at a tensor n_past (models/common.py), the
fused route's rows from that tensor, and the on-device draws. Greedy tokens
must equal the reference's; sampled ones cannot (a torch generator and a
JAX key give other bits), so a sampled run is held to its own seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.models import gpt2 as jgpt2
from ggml_imax_tpu.models import gptj as jgptj
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu.runtime.engine import Engine as JEngine
from ggml_imax_tpu.runtime.engine import PerfCounters as JPerf
from ggml_imax_tpu_torch import _build
from ggml_imax_tpu_torch.models import gpt2 as tgpt2
from ggml_imax_tpu_torch.models import gptj as tgptj
from ggml_imax_tpu_torch.models.common import (attention_mask, init_kv_cache,
                                                update_kv)
from ggml_imax_tpu_torch.ops.decode_attention import decode_attention_update
from ggml_imax_tpu_torch.ops.qmm import params_repack
from ggml_imax_tpu_torch.quant.formats import GGMLType
from ggml_imax_tpu_torch.runtime.engine import (CapturedStep, Engine,
                                                PerfCounters)

# the tiny GPT-2 of tests/test_batched.py, its weights at scale 0.3 so that
# greedy decoding does not settle on one token
GPT2 = dict(n_vocab=96, n_ctx=128, n_embd=64, n_head=4, n_layer=2)
SCALE = 0.3
GPTJ = dict(n_vocab=640, n_ctx=64, n_embd=256, n_head=2, n_layer=2, n_rot=32)
PROMPT = [3, 14, 15, 92, 6]


@pytest.fixture(scope="module")
def gpt2_pair():
    return (jgpt2.synthetic_params(jgpt2.GPT2Config(**GPT2), JType.F32,
                                   seed=7, scale=SCALE),
            tgpt2.synthetic_params(tgpt2.GPT2Config(**GPT2), GGMLType.F32,
                                   seed=7, scale=SCALE, device="cpu"))


def jengine(jp, **kw):
    return JEngine(jgpt2, jgpt2.GPT2Config(**GPT2), jp,
                   compute_dtype=jnp.float32, kv_dtype=jnp.float32, **kw)


def tengine(tp, **kw):
    return Engine(tgpt2, tgpt2.GPT2Config(**GPT2), tp,
                  compute_dtype=torch.float32, kv_dtype=torch.float32,
                  device="cpu", **kw)


@pytest.mark.parametrize("chunk", [2, 4, 5])
def test_gpt2_chunked_generate_matches_chunk1_and_reference(gpt2_pair, chunk):
    jp, tp = gpt2_pair
    ref = jengine(jp).generate(PROMPT, 9, temp=0.0, chunk=chunk)
    eng = tengine(tp)
    one = eng.generate(PROMPT, 9, temp=0.0)
    got = eng.generate(PROMPT, 9, temp=0.0, chunk=chunk)
    assert got == one == ref
    assert len(set(got)) > 2                    # not one repeated token
    assert eng.perf.n_decode == 2 * 8 and eng.perf.n_prefill == 2 * 5


def test_chunked_generate_leaves_the_arena_as_chunk1(gpt2_pair):
    """The span's in-place KV writes at a tensor n_past put the same bits
    in the same rows as the single steps at an int n_past."""
    _, tp = gpt2_pair
    one, spans = tengine(tp), tengine(tp)
    assert one.generate(PROMPT, 10, temp=0.0) == \
        spans.generate(PROMPT, 10, temp=0.0, chunk=4)
    assert torch.equal(one.arena.k, spans.arena.k)
    assert torch.equal(one.arena.v, spans.arena.v)
    assert set(spans._spans) == {(4, 1, 64)}      # spans 4, 4, then a step


def _first_new(ref, lo):
    """The first index >= lo whose token did not occur before it."""
    return next(i for i in range(lo, len(ref)) if ref[i] not in ref[:i])


def test_chunked_generate_eos_and_ctx(gpt2_pair):
    jp, tp = gpt2_pair
    prompt = [3, 14, 15]
    eng = tengine(tp)
    ref = eng.generate(prompt, 12, temp=0.0)
    eos = ref[_first_new(ref, 3)]                 # inside the first span
    want = ref[:ref.index(eos) + 1]
    got = eng.generate(prompt, 12, temp=0.0, chunk=5, eos_id=eos)
    assert got == want == jengine(jp).generate(prompt, 12, temp=0.0, chunk=5,
                                               eos_id=eos)
    # the arena's edge: spans of min(chunk, n_ctx - n_past), the last a step
    edge = tengine(tp, n_ctx=12)
    one = edge.generate(prompt, 30, temp=0.0)
    got = edge.generate(prompt, 30, temp=0.0, chunk=4)
    assert got == one == jengine(jp, n_ctx=12).generate(prompt, 30, temp=0.0,
                                                        chunk=4)
    assert len(got) == 12 - len(prompt) + 1


def _gptj_pair(kv):
    jcfg, tcfg = jgptj.GPTJConfig(**GPTJ), tgptj.GPTJConfig(**GPTJ)
    jp = jgptj.synthetic_params(jcfg, JType.Q4_0, seed=17)
    tp = params_repack(tgptj.prepare_fused(
        tgptj.synthetic_params(tcfg, seed=17, device="cpu"), tcfg))
    jkv, tkv = (jnp.bfloat16, torch.bfloat16) if kv == "bf16" else ("q8_0",) * 2
    return (JEngine(jgptj, jcfg, jp, kv_dtype=jkv),
            lambda **kw: Engine(tgptj, tcfg, tp, kv_dtype=tkv, device="cpu",
                                **kw))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_gptj_chunked_generate_matches_reference(kv, fused):
    """The kernels' routes ("kernel", or "fused" with a tensor n_past: the
    rows of the fused write come from it) through decode spans."""
    jeng, make = _gptj_pair(kv)
    prompt = [3, 5, 7, 11, 13]
    ref = jeng.generate(prompt, 10, temp=0.0, chunk=4)
    eng = make(fused_kv_update=fused)
    assert eng.generate(prompt, 10, temp=0.0, chunk=4) == \
        eng.generate(prompt, 10, temp=0.0) == ref


def test_sampled_chunked_run_is_reproducible(gpt2_pair):
    _, tp = gpt2_pair
    eng = tengine(tp)
    kw = dict(temp=0.9, top_k=20, top_p=0.95, chunk=4)
    a = eng.generate(PROMPT, 13, seed=3, **kw)
    b = eng.generate(PROMPT, 13, seed=3, **kw)
    assert a == b and len(a) == 13
    assert all(0 <= t < GPT2["n_vocab"] for t in a)
    # top_k 1 is greedy at any temperature
    assert eng.generate(PROMPT, 13, seed=4, temp=2.0, top_k=1, chunk=4) == \
        eng.generate(PROMPT, 13, temp=0.0)


def test_decode_span_fetches_span_rows(gpt2_pair):
    """decode_span: (span, B) ids from the arena at n_past; the greedy
    picks of a span equal the chunk-1 tokens that follow its input."""
    _, tp = gpt2_pair
    eng = tengine(tp)
    want = eng.generate(PROMPT, 8, temp=0.0)
    eng.generate(PROMPT, 1, temp=0.0)               # prefill the arena
    ids = eng.decode_span([want[0]], len(PROMPT), 7)
    assert ids.shape == (7, 1) and list(ids[:, 0]) == want[1:]


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
@pytest.mark.parametrize("n_past,t", [(0, 1), (5, 1), (7, 3), (15, 1),
                                      (14, 3), (30, 3)])
def test_update_kv_and_mask_take_a_tensor_n_past(kv, n_past, t):
    """Bit-equal to the int form, the clamp at n_past > n_ctx - T too."""
    rng = np.random.default_rng(n_past * 7 + t)
    k, v = (torch.from_numpy(rng.standard_normal((2, t, 2, 64))
                             .astype(np.float32)) for _ in range(2))
    caches = [init_kv_cache(2, 2, 16, 2, 64, kv, device="cpu")
              for _ in range(2)]
    update_kv(caches[0], 1, k, v, n_past)
    update_kv(caches[1], 1, k, v, torch.tensor(n_past))
    for a, b in zip(*(tuple(t_ for t_ in (c.k, c.v, c.ks, c.vs)
                            if t_ is not None) for c in caches)):
        assert torch.equal(a, b)
    assert (caches[0].k != 0).any()
    pos = torch.from_numpy(rng.integers(0, 16, (2, t)))
    assert torch.equal(attention_mask(pos, 16, n_past),
                       attention_mask(pos, 16, torch.tensor(n_past)))


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
def test_fused_route_takes_a_tensor_n_past(kv):
    """The plain fused route (flat mode): rows from a 0-d tensor n_past give
    the int form's output and arena bit for bit."""
    rng = np.random.default_rng(11)
    B, H, D, n_ctx, n_past = 2, 2, 128, 32, 9
    q, k, v = (torch.from_numpy(rng.standard_normal((B, 1, H, D))
                                .astype(np.float32)) for _ in range(3))
    outs, caches = [], []
    for npast in (n_past, torch.tensor(n_past)):
        cache = init_kv_cache(1, B, n_ctx, H, D, kv, device="cpu")
        arena = np.random.default_rng(12)       # the same arena both times
        for t_ in (cache.k, cache.v):
            t_.copy_(torch.from_numpy(arena.standard_normal(t_.shape)
                                      .astype(np.float32)).to(t_.dtype)
                     if t_.dtype != torch.int8 else
                     torch.from_numpy(arena.integers(-127, 128, t_.shape,
                                                     dtype=np.int8)))
        for t_ in (cache.ks, cache.vs):
            if t_ is not None:
                t_.fill_(0.01)
        pos = torch.full((B, 1), n_past)
        out, cache = decode_attention_update(cache, 0, q, k, v, npast,
                                             attention_mask(pos, n_ctx, npast))
        outs.append(out)
        caches.append(cache)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(caches[0].k, caches[1].k)
    assert torch.equal(caches[0].v, caches[1].v)


@pytest.mark.parametrize("counters", [
    dict(), dict(n_prefill=448, prefill_us=51234.5),
    dict(n_decode=63, decode_us=345678.9),
    dict(load_us=12.0, n_prefill=5, prefill_us=999.4, n_decode=1,
         decode_us=0.4)])
def test_perf_report_is_the_reference_text(counters):
    assert PerfCounters(**counters).report() == JPerf(**counters).report()


def test_captured_launches_add_the_capture_delta_per_replay():
    _build.reset_launches()
    _build.LAUNCHES["w4a8_gemv"] = 3
    rec = _build.CapturedLaunches()
    with rec.capture():
        _build.LAUNCHES["w4a8_gemv"] += 57        # what the wrappers count
        _build.LAUNCHES["decode_attention"] += 28
    assert _build.LAUNCHES["w4a8_gemv"] == 3       # a capture launches nothing
    assert rec.delta == {"w4a8_gemv": 57, "decode_attention": 28}
    for _ in range(4):
        rec.replayed()
    assert _build.LAUNCHES["w4a8_gemv"] == 3 + 4 * 57
    assert _build.LAUNCHES["decode_attention"] == 4 * 28
    _build.reset_launches()


def test_captured_step_runs_its_function_eagerly_on_the_cpu():
    calls = []
    step = CapturedStep(lambda: calls.append(1), torch.device("cpu"))
    step()
    step()
    assert calls == [1, 1] and step.graph is None and step.capture_s == 0.0


def test_a_dropped_engine_is_freed_without_the_cycle_collector(gpt2_pair):
    """No reference cycle through a span: dropping the engine frees it (and
    on the card its graphs and pool) at once."""
    import gc
    import weakref
    _, tp = gpt2_pair
    eng = tengine(tp)
    eng.generate(PROMPT, 9, temp=0.0, chunk=4)
    assert eng._spans
    gone = weakref.ref(eng)
    was = gc.isenabled()
    gc.disable()
    try:
        del eng
        assert gone() is None
    finally:
        if was:
            gc.enable()
