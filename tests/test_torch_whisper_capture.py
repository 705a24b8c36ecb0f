"""The Whisper pipeline's captured decode loop (graphs=True) against its
eager route (graphs=False), on the host.

On the CPU a CapturedStep runs its function eagerly, so what this file
holds is the captured route's static-buffer logic: the KV cache, cross K/V,
inputs and outputs allocated once per batch width, the cache zeroed for
each attempt and reordered in place (KVCache.reorder_), n_past a 0-d
tensor. A tiny Q5_0 Whisper runs for real, so every step writes the KV
cache; its logits are then replaced by a script drawn from a seed made of
each batch row's KV cache rows [0, n_past + T), so a row that reads or
writes the wrong cache rows, or follows the wrong beam, gets other logits
and the beam search takes another path. Both routes must give equal
tokens, temperatures and avg_logprob, and an equal KV cache after every
attempt, bit for bit. A planted fault (the captured step's n_past and
positions left at their first value) must fail that check. The in-place
reorder equals select_batch for permutations and for orders that repeat a
row, and keeps every tensor's address.
"""
import zlib

import numpy as np
import pytest
import torch

from ggml_imax_tpu_torch.audio.mel import mel_filterbank
from ggml_imax_tpu_torch.models import whisper as TW
from ggml_imax_tpu_torch.models.common import KVCache, init_kv_cache
from ggml_imax_tpu_torch.ops.qmm import params_repack
from ggml_imax_tpu_torch.runtime import whisper_pipeline as twp

SR = 16000
# multilingual (the prompt has language and task tokens, the specials are
# suppressed), everything else tiny
CFG = dict(n_vocab=51865, n_audio_ctx=16, n_audio_state=64, n_audio_head=2,
           n_audio_layer=1, n_text_ctx=48, n_text_state=64, n_text_head=2,
           n_text_layer=2, n_mels=16)


@pytest.fixture(scope="module")
def tiny():
    cfg = TW.WhisperConfig(**CFG)
    raw = TW.synthetic_params_device(cfg, seed=3, device="cpu")
    return cfg, params_repack(TW.prepare_fused(raw))


def scripted(real):
    """TW.decode run for real, its last row's logits replaced by a draw
    seeded by each batch row's KV cache rows [0, n_past + T) (as
    log-probabilities, so the log-softmax after it changes little)."""
    def decode(cfg, params, tokens, positions, cache, cross, n_past, **kw):
        logits, cache = real(cfg, params, tokens, positions, cache, cross,
                             n_past, **kw)
        end = int(n_past) + tokens.shape[1]
        out = logits.clone()
        for b in range(tokens.shape[0]):
            rows = torch.cat([cache.k[:, b, :end], cache.v[:, b, :end]])
            rng = np.random.default_rng(zlib.crc32(
                rows.float().numpy().tobytes()))
            lg = rng.standard_normal(cfg.n_vocab) * 2
            lg[:300] += 4
            lg[rng.integers(8)] += rng.uniform(8, 20)
            lg[cfg.token_eot] += rng.uniform(0, 9)
            lg -= np.log(np.exp(lg).sum())
            out[b, -1] = torch.from_numpy(lg.astype(np.float32))
        return out, cache
    return decode


def transcribe(tiny, graphs, fp, seconds=35):
    """The pipeline on one route: its segments and a copy of the KV cache
    after every attempt."""
    cfg, params = tiny
    pipe = twp.WhisperPipeline(cfg, params, mel_filterbank(cfg.n_mels),
                               device="cpu", graphs=graphs)
    caches = []
    real = pipe._run_beam

    def run_beam(*a, **kw):
        out = real(*a, **kw)
        c = pipe.last_cache
        caches.append([t.clone() for t in (c.k, c.v, c.ks, c.vs)
                       if t is not None])
        return out
    pipe._run_beam = run_beam
    rng = np.random.default_rng(int(seconds))
    samples = (rng.standard_normal(seconds * SR) * 0.1).astype(np.float32)
    return pipe.transcribe(samples, twp.FullParams(**fp)), caches, pipe


def same(a, b):
    """(segments, caches) of two runs equal, bit for bit."""
    (sa, ca), (sb, cb) = a, b
    segs = [(s.tokens, s.temperature, s.avg_logprob) for s in sa] == \
        [(s.tokens, s.temperature, s.avg_logprob) for s in sb]
    kv = len(ca) == len(cb) and all(
        len(x) == len(y) and all(torch.equal(u, w) for u, w in zip(x, y))
        for x, y in zip(ca, cb))
    return segs and kv


CASES = {
    "beam5": dict(beam_size=5, temperatures=(0.0,), max_tokens=12),
    "beam3_to_ctx": dict(beam_size=3, temperatures=(0.0,)),
    # a gate no attempt passes: every window runs the beam attempt, then
    # the sampled ones, and keeps the last
    "fallback": dict(beam_size=5, max_tokens=8, logprob_thold=0.0,
                     temperatures=(0.0, 0.4, 1.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_captured_route_equals_eager(tiny, monkeypatch, case):
    monkeypatch.setattr(TW, "decode", scripted(TW.decode))
    fp = CASES[case]
    eager = transcribe(tiny, False, fp)
    reorders = []
    real = KVCache.reorder_
    monkeypatch.setattr(KVCache, "reorder_", lambda self, idx: (
        reorders.append(idx.tolist()), real(self, idx))[1])
    captured = transcribe(tiny, True, fp)
    assert same(eager[:2], captured[:2])
    segs, caches, pipe = captured
    assert len(segs) == 2 and all(s.tokens for s in segs)
    assert len(caches) >= 2
    # one static set a batch width, made once and kept over the windows
    widths = {k[0] for k in pipe._static}
    assert widths <= {fp["beam_size"], 1} and fp["beam_size"] in widths
    if case == "fallback":
        assert all(s.temperature == 1.0 for s in segs)
        assert 1 in widths
    # the beams were reordered in place, some order repeating a row
    assert reorders and any(len(set(o)) < len(o) for o in reorders)


def test_frozen_n_past_fails_the_check(tiny, monkeypatch):
    """Control: the captured step's n_past and positions never advanced
    past their first value (each step writes and reads one cache row)."""
    monkeypatch.setattr(TW, "decode", scripted(TW.decode))
    fp = CASES["beam5"]
    eager = transcribe(tiny, False, fp)
    real_fill = twp.WhisperPipeline._fill

    def frozen(self, st, nxt, n_past):
        first = getattr(st, "first_n_past", None)
        if first is None or n_past < first:
            st.first_n_past = first = n_past
        real_fill(self, st, nxt, first)
    monkeypatch.setattr(twp.WhisperPipeline, "_fill", frozen)
    captured = transcribe(tiny, True, fp)
    assert not same(eager[:2], captured[:2])


ORDERS = [[4, 3, 2, 1, 0], [0, 0, 2, 1, 1], [1, 1, 1, 1, 1], [2, 0, 4, 3, 1],
          [0, 1, 2, 3, 4]]


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
def test_reorder_in_place_equals_select_batch(kv):
    cache = init_kv_cache(2, 5, 12, 2, 32, kv, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for t in (cache.k, cache.v, cache.ks, cache.vs):
        if t is None:
            continue
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen))
        else:
            t.copy_(torch.randn(t.shape, generator=gen))
    ptrs = [t.data_ptr() for t in (cache.k, cache.v, cache.ks, cache.vs)
            if t is not None]
    for order in ORDERS:
        idx = torch.tensor(order)
        want = cache.select_batch(idx)
        assert cache.reorder_(idx) is cache
        for a, b in ((cache.k, want.k), (cache.v, want.v), (cache.ks, want.ks),
                     (cache.vs, want.vs)):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)
    assert ptrs == [t.data_ptr() for t in (cache.k, cache.v, cache.ks,
                                           cache.vs) if t is not None]


def test_static_buffers_are_made_once(tiny, monkeypatch):
    """A second transcribe reuses the captured steps' tensors (a graph holds
    their addresses) and gives the same segments."""
    monkeypatch.setattr(TW, "decode", scripted(TW.decode))
    fp = CASES["beam5"]
    segs, _, pipe = transcribe(tiny, True, fp, seconds=20)
    st = dict(pipe._static)
    ptrs = {k: (s.cache.k.data_ptr(), s.xk.data_ptr(), s.vals.data_ptr())
            for k, s in st.items()}
    rng = np.random.default_rng(20)
    samples = (rng.standard_normal(20 * SR) * 0.1).astype(np.float32)
    again = pipe.transcribe(samples, twp.FullParams(**fp))
    assert [s.tokens for s in again] == [s.tokens for s in segs]
    assert pipe._static == st
    assert ptrs == {k: (s.cache.k.data_ptr(), s.xk.data_ptr(),
                        s.vals.data_ptr()) for k, s in pipe._static.items()}
