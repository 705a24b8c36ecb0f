"""Port parity: Whisper's DTW token timestamps against the JAX package's, on
the host.

- `_median_filter` and `_dtw_path` are host numpy copies of the
  reference's and must be bit-equal to it: over seeded inputs with ties
  (values on a coarse grid, constant costs whose moves tie), single rows
  and columns, and paths that run along the first and the last column.
- `decode(return_cross_attn=True)`: the cross-attention probabilities of
  the 2 + 2-layer Q5_0 Whisper of tests/test_torch_whisper.py against the
  JAX decode on its unstacked params (its flash in interpret mode, as that
  file runs it), both fed the reference's cross K/V and one teacher-forced
  pass over the prompt and 8 tokens. Held within PROB_RTOL of each
  probability (seen: 3.5e-7), where random weights spread a row's
  probabilities by ~10% around 1/75 (the signal the check must resolve).
- `token_timestamps`: both packages fed the same scripted probabilities
  (decode replaced in both modules), with a known diagonal alignment of
  broad peaks and narrow decoys that a 7-wide median removes: the times
  are equal bit for bit and follow the diagonal. Two planted faults must
  fail that check: a median width of 5 (the decoys survive) and the
  normalization taken over the text axis.
- `transcribe(FullParams(token_timestamps=True))` under the scripted
  logits of tests/test_torch_whisper_pipeline.py plus scripted
  probabilities: equal `Segment.token_times` in both pipelines, and in
  `transcribe_parallel` offset by each span's start.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.models import whisper as JW
from ggml_imax_tpu.runtime import whisper_pipeline as jwp
from ggml_imax_tpu_torch.models import whisper as TW
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.runtime import whisper_pipeline as twp

import test_torch_whisper as tw
from test_torch_whisper_pipeline import FALLBACK, SCFG, audio, pipelines

PROB_RTOL = 1e-5
TA = 300                       # audio columns of the scripted windows


# -- the host numpy: bit-equal ----------------------------------------------

def _median_inputs():
    rng = np.random.default_rng(0)
    yield rng.standard_normal((3, 5, 40)).astype(np.float32)
    yield (np.round(rng.standard_normal((4, 6, 31)) * 2) / 2).astype(
        np.float32)                                       # many ties
    yield np.ones((2, 3, 9), np.float32)                  # all tied
    yield rng.standard_normal((1, 1, 1)).astype(np.float32)
    yield rng.standard_normal((2, 4, 5)).astype(np.float32)  # under width
    yield rng.random((6, 17)).astype(np.float64)


@pytest.mark.parametrize("width", [7, 5, 3, 1])
def test_median_filter_bit_equal(width):
    for w in _median_inputs():
        got = twp._median_filter(w, width)
        ref = jwp._median_filter(w, width)
        assert got.dtype == ref.dtype and got.shape == ref.shape == w.shape
        np.testing.assert_array_equal(got, ref)


def _dtw_inputs():
    rng = np.random.default_rng(1)
    yield rng.standard_normal((12, 60))
    yield np.round(rng.standard_normal((9, 40)))          # ties on a grid
    yield np.zeros((5, 7))                                # every move ties
    yield np.ones((1, 1))
    yield rng.standard_normal((1, 8))
    yield rng.standard_normal((8, 1))
    yield rng.standard_normal((20, 20)).astype(np.float32)
    c = np.ones((6, 30))
    c[:, 0] = -5.0                                        # the first column
    yield c
    c = np.ones((6, 30))
    c[:, -1] = -5.0                                       # the last column
    yield c
    yield -np.eye(10, 50, k=3) + 0.1 * rng.standard_normal((10, 50))


def test_dtw_path_bit_equal():
    for cost in _dtw_inputs():
        got, ref = twp._dtw_path(cost), jwp._dtw_path(cost)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
        assert (np.diff(got) >= 0).all()                  # monotone


# -- decode(return_cross_attn=True) -----------------------------------------

def test_cross_attention_probabilities_match_reference(monkeypatch):
    """The port's probabilities, unfused params (the reference's
    unstacked decoder takes no other), against the reference's."""
    monkeypatch.setattr(JW, "attention", tw.tpu_attention)
    jp = tw.jax_params(False, False)
    tp = params_from_jax(jp, device="cpu")
    mel, prompt, feed = tw.inputs()
    toks = np.concatenate([prompt[0], feed]).astype(np.int32)[None]
    T = toks.shape[1]
    tw.jqmatmul.set_force_fused(True)
    try:
        enc = JW.encode(tw.JCFG, jp, jnp.asarray(mel))
        cross = JW.precompute_cross_kv(tw.JCFG, jp, enc)
        dec = jax.jit(lambda p, t, pos, c, x: JW.decode(
            tw.JCFG, p, t, pos, c, x, 0, return_cross_attn=True))
        lg, _, probs = dec(jp, jnp.asarray(toks),
                           jnp.arange(T, dtype=jnp.int32)[None],
                           JW.init_cache(tw.JCFG, batch=1), cross)
    finally:
        tw.jqmatmul.set_force_fused(False)
    ref = np.asarray(probs)
    cross_t = tuple(torch.from_numpy(np.asarray(c)) for c in cross)
    glg, _, got = TW.decode(tw.TCFG, tp, torch.from_numpy(toks).long(),
                            torch.arange(T)[None],
                            TW.init_cache(tw.TCFG, device="cpu"), cross_t, 0,
                            return_cross_attn=True)
    L, H, TA_ = tw.CFG["n_text_layer"], tw.CFG["n_text_head"], \
        tw.CFG["n_audio_ctx"]
    assert got.shape == ref.shape == (L, 1, H, T, TA_)
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    spread = np.log(ref.max(-1) / ref.min(-1))
    assert float(spread.min()) > 0.05                     # not uniform
    np.testing.assert_allclose(got, ref, rtol=PROB_RTOL, atol=0)
    # the logits of the same pass, as test_torch_whisper holds them
    scale = float(np.abs(np.asarray(lg)).max())
    assert float(np.abs(glg.numpy() - np.asarray(lg)).max()) \
        <= tw.LOGIT_TOL * scale


def test_return_cross_attn_leaves_the_pass_unchanged():
    """The logits and KV cache of a pass with return_cross_attn equal the
    same pass without it, bit for bit, fused params too."""
    tp = params_from_jax(tw.jax_params(True, True), device="cpu")
    mel, prompt, feed = tw.inputs()
    cross = TW.precompute_cross_kv(tw.TCFG, tp, TW.encode(
        tw.TCFG, tp, torch.from_numpy(mel)))
    toks = torch.from_numpy(np.concatenate([prompt[0], feed])[None]).long()
    pos = torch.arange(toks.shape[1])[None]
    c0, c1 = (TW.init_cache(tw.TCFG, device="cpu") for _ in range(2))
    a, _ = TW.decode(tw.TCFG, tp, toks, pos, c0, cross, 0)
    b, _, probs = TW.decode(tw.TCFG, tp, toks, pos, c1, cross, 0,
                            return_cross_attn=True)
    assert torch.equal(a, b) and torch.equal(c0.k, c1.k) \
        and torch.equal(c0.v, c1.v)
    assert probs.shape[:4] == (2, 1, 2, toks.shape[1])


# -- token_timestamps on scripted probabilities -------------------------------

def scripted_probs(n_layer, n_head, n_tok, seed=0):
    """(L, 1, H, T, TA) f32: token i's mass in a broad peak (11 columns)
    around its diagonal column, plus, for every third token, a narrower
    decoy (3 columns, twice as high) well off the diagonal, which a median
    over 7 columns removes and one over 5 keeps. Returns (probs, the
    diagonal columns)."""
    rng = np.random.default_rng(seed)
    cols = (np.arange(n_tok) + 0.5) * (TA - 20) / n_tok + 10
    diag = np.round(cols).astype(int)
    a = np.arange(TA)
    w = np.zeros((n_layer, 1, n_head, n_tok, TA))
    for i, c in enumerate(diag):
        w[..., i, :] = np.exp(-0.5 * ((a - c) / 4.0) ** 2)
        if i % 3 == 1:
            d = (c + TA // 2) % (TA - 10) + 5
            w[..., i, d - 1:d + 2] += 2.0
    w += 0.05 * rng.random(w.shape)
    w = w / w.sum(-1, keepdims=True)
    return w.astype(np.float32), diag


def _patch_decode(monkeypatch, probs_of):
    """decode in both modules replaced by one returning probs_of(tokens)
    (and zero logits); the cache passes through."""
    def fake(lib):
        def decode(cfg, params, tokens, positions, cache, cross, n_past,
                   **kw):
            assert kw.get("return_cross_attn")
            toks = np.asarray(tokens)
            p = probs_of(toks[0].tolist())
            lg = np.zeros(toks.shape + (cfg.n_vocab,), np.float32)
            return lib(lg), cache, lib(p)
        return decode
    monkeypatch.setattr(JW, "decode", fake(jnp.asarray))
    monkeypatch.setattr(TW, "decode", fake(torch.from_numpy))


def _fresh_pair(cfg_kw):
    return (jwp.WhisperPipeline(JW.WhisperConfig(**cfg_kw), None),
            twp.WhisperPipeline(TW.WhisperConfig(**cfg_kw), None,
                                device="cpu"))


TS_CFG = dict(SCFG, n_audio_ctx=TA, n_text_layer=4, n_text_head=3)
N_TOK = 24


def _times(monkeypatch, port_fn=None, heads=None):
    probs, diag = scripted_probs(4, 3, N_TOK)
    _patch_decode(monkeypatch, lambda toks: probs)
    jp, tp = _fresh_pair(TS_CFG)
    toks = list(range(N_TOK))
    kw = dict(t_offset=30.0, alignment_heads=heads)
    ref = jwp.token_timestamps(jp, None, toks, **kw)
    got = (port_fn or twp.token_timestamps)(tp, None, toks, **kw)
    return got, ref, diag


@pytest.mark.parametrize("heads", [None, [(3, 0), (2, 2), (3, 1), (0, 1)]],
                         ids=["default_heads", "named_heads"])
def test_token_timestamps_equal_reference(monkeypatch, heads):
    got, ref, diag = _times(monkeypatch, heads=heads)
    assert got.dtype == ref.dtype == np.float64 and len(got) == N_TOK
    np.testing.assert_array_equal(got, ref)
    assert (np.diff(got) >= 0).all()
    # a token's time is where the path enters its row: between the previous
    # token's peak and its own
    cols = np.round((got - 30.0) / 0.02).astype(int)
    assert (cols <= diag).all() and (cols[1:] >= diag[:-1]).all(), cols


def _faulty_timestamps(width=7, axis=-1):
    """token_timestamps with a planted fault: another median width, or the
    normalization over another axis."""
    def fn(pipe, cross, tokens, *, alignment_heads=None, t_offset=0.0):
        w = twp.alignment_weights(pipe, cross, tokens, alignment_heads)
        w = twp._median_filter(w, width)
        std = w.std(axis=axis, keepdims=True)
        w = (w - w.mean(axis=axis, keepdims=True)) / np.where(std > 0, std,
                                                              1.0)
        match = twp._dtw_path(-w.mean(axis=0))
        return t_offset + match.astype(np.float64) * 0.02
    return fn


@pytest.mark.parametrize("fault", ["median_width_5", "text_axis_norm"])
def test_timestamp_check_catches_a_planted_fault(monkeypatch, fault):
    fn = _faulty_timestamps(width=5) if fault == "median_width_5" else \
        _faulty_timestamps(axis=-2)
    # the sound copy passes the check the faults must fail
    got, ref, _ = _times(monkeypatch, _faulty_timestamps())
    np.testing.assert_array_equal(got, ref)
    got, ref, _ = _times(monkeypatch, fn)
    assert not np.array_equal(got, ref)


# -- transcribe(token_timestamps=True) ----------------------------------------

def _probs_by_tokens(cfg_kw):
    """Scripted probabilities drawn from a seed made of the tokens."""
    def probs_of(toks):
        rng = np.random.default_rng(zlib.crc32(np.asarray(toks).tobytes()))
        p = rng.random((cfg_kw["n_text_layer"], 1, cfg_kw["n_text_head"],
                        len(toks), cfg_kw["n_audio_ctx"])) ** 4
        return (p / p.sum(-1, keepdims=True)).astype(np.float32)
    return probs_of


PIPE_CFG = dict(SCFG, n_audio_ctx=64, n_text_layer=2, n_text_head=2)


def _scripted_pipelines(monkeypatch):
    """The pipelines of test_torch_whisper_pipeline (their steps scripted)
    with decode, which only the timestamp pass calls, scripted too."""
    _patch_decode(monkeypatch, _probs_by_tokens(PIPE_CFG))
    return pipelines(PIPE_CFG)


@pytest.mark.parametrize("params", [
    dict(beam_size=5, temperatures=(0.0,), max_tokens=16),
    dict(beam_size=3, max_tokens=10, logprob_thold=-0.45, **FALLBACK),
], ids=["beam5", "fallback"])
def test_transcribe_token_times_equal_reference(monkeypatch, params):
    (jp, js), (tp, ts) = _scripted_pipelines(monkeypatch)
    fp = dict(params, token_timestamps=True)
    samples = audio(65)
    ref = jp.transcribe(samples, jwp.FullParams(**fp))
    got = tp.transcribe(samples, twp.FullParams(**fp))
    assert len(got) == len(ref) == 3
    assert ts.calls == js.calls
    for g, r in zip(got, ref):
        assert g.tokens == r.tokens and g.token_times is not None
        assert len(g.token_times) == len(g.tokens)
        assert g.token_times == r.token_times
        assert all(g.t0 <= t < g.t0 + 30 for t in g.token_times)
        assert g.token_times == sorted(g.token_times)


def test_transcribe_parallel_token_times_equal_reference(monkeypatch):
    (jp, _), (tp, _) = _scripted_pipelines(monkeypatch)
    fp = dict(beam_size=5, max_tokens=8, temperatures=(0.0,),
              token_timestamps=True)
    samples = audio(65)
    ref = jp.transcribe_parallel(samples, jwp.FullParams(**fp), 2)
    got = tp.transcribe_parallel(samples, twp.FullParams(**fp), 2)
    assert [g.token_times for g in got] == [r.token_times for r in ref]
    assert any(g.t0 > 0 and g.token_times[0] >= g.t0 for g in got)
