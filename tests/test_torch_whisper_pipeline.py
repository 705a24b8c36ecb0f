"""Port parity: runtime/whisper_pipeline.py against the JAX package's
WhisperPipeline, on the host.

Scripted logits. On a JAX and a port pipeline alike, the three device
steps (`_encode_window`, `_decode`, `_decode_topk`) are replaced by one
script of numpy tables: each step's values are drawn from a seed made of
the audio window and every token its batch row was fed so far (the
script's stand-in for the KV cache follows the beam reorder through
select_batch), so the tables answer only what the host loop asks. The
host logic (the seek loop, the prompt, the candidate ranking and its
ties, the finished list, the beam reorder, the fallback's sampling on one
numpy Generator, the quality gates, the segments) then has to take the
same path in both: the calls it makes, and the tokens, temperature, t0
and t1 of every segment, are equal, and avg_logprob within 1e-6 (the
temperature path's log-softmax runs in each library).

The golden transcript. The JAX package's own tiny pair (a random 2-layer
transformers Whisper, vocab 128, through the JAX from_hf_state_dict),
carried over by params_from_jax, transcribes the tone signal through the
port's pipeline (mel, encoder, greedy decode) to the JAX test's pinned
tokens, avg_logprob within 1e-3 of its pinned value.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.models import whisper as JW
from ggml_imax_tpu.runtime import whisper_pipeline as jwp
from ggml_imax_tpu_torch.models import whisper as TW
from ggml_imax_tpu_torch.runtime import whisper_pipeline as twp

SR = 16000
# a multilingual vocabulary (so the prompt has language and task tokens,
# and the special ids are suppressed), everything else tiny
SCFG = dict(n_vocab=51865, n_audio_ctx=4, n_audio_state=8, n_audio_head=1,
            n_audio_layer=1, n_text_ctx=448, n_text_state=8, n_text_head=1,
            n_text_layer=1, n_mels=16)


class Hist:
    """The script's stand-in for the KV cache: each batch row's window
    mark and fed tokens."""

    def __init__(self, rows):
        self.rows = rows

    def select_batch(self, idx):
        return Hist([self.rows[int(i)] for i in np.asarray(idx)])


class Script:
    """The device steps of one pipeline as numpy tables; `lib` converts a
    numpy array to the pipeline's library."""

    def __init__(self, lib, n_vocab, eot):
        self.lib, self.V, self.eot = lib, n_vocab, eot
        self.calls = []

    def encode_window(self, samples, seek):
        mark = np.full((1, 1, 1, 1, 1), seek / SR + float(
            np.asarray(samples[seek:seek + 100]).sum()), np.float32)
        return self.lib(mark), self.lib(mark)

    def _rows(self, toks, cache, cross, n_past):
        toks = np.asarray(toks)
        if not isinstance(cache, Hist):          # the prompt step
            mark = float(np.asarray(cross[0]).ravel()[0])
            cache = Hist([(mark,)] * toks.shape[0])
        rows = [r + tuple(int(t) for t in toks[b])
                for b, r in enumerate(cache.rows)]
        self.calls.append((int(n_past), toks.tolist()))
        return Hist(rows)

    @staticmethod
    def _rng(row):
        return np.random.default_rng(zlib.crc32(np.asarray(row).tobytes()))

    def decode_topk(self, params, toks, pos, cache, cross, n_past, k):
        hist = self._rows(toks, cache, cross, n_past)
        vals, idx = [], []
        for row in hist.rows:
            rng = self._rng(row)
            ids = rng.choice(300, k, replace=False)
            if rng.random() < 0.3:               # the end token now and then
                ids[rng.integers(k)] = self.eot
            # log-probs on a 0.25 grid, so candidates of different rows tie
            v = -np.round(np.cumsum(rng.exponential(0.6, k)) * 4) / 4
            vals.append(v)
            idx.append(ids)
        return (self.lib(np.asarray(vals, np.float32)),
                self.lib(np.asarray(idx, np.int32)), hist)

    def decode(self, params, toks, pos, cache, cross, n_past):
        hist = self._rows(toks, cache, cross, n_past)
        T = np.asarray(toks).shape[1]
        out = np.zeros((len(hist.rows), T, self.V), np.float32)
        for b, row in enumerate(hist.rows):
            rng = self._rng(row)
            out[b, -1] = rng.standard_normal(self.V) * 2
            out[b, -1, :300] += 4                # a plausible vocabulary
            out[b, -1, rng.integers(8)] += rng.uniform(8, 20)    # a favourite
            out[b, -1, self.eot] += rng.uniform(0, 9)
        # as log-probabilities: the pipelines' log-softmax then subtracts a
        # log-sum-exp of ~0, which each library sums to a few f32 ulps
        lse = np.log(np.exp(out[:, -1].astype(np.float64)).sum(-1))
        out[:, -1] = out[:, -1] - lse[:, None]
        return self.lib(out), hist


def pipelines(cfg_kw=SCFG):
    """A JAX and a port pipeline with the same script in place of their
    device steps. The port's is its eager route (graphs=False), whose
    steps hand the cache on as the script's stand-in does; the captured
    route, which keeps its cache in place, is held to the eager one in
    tests/test_torch_whisper_capture.py."""
    jcfg, tcfg = JW.WhisperConfig(**cfg_kw), TW.WhisperConfig(**cfg_kw)
    jp = jwp.WhisperPipeline(jcfg, None)
    tp = twp.WhisperPipeline(tcfg, None, device="cpu", graphs=False)
    out = []
    for pipe, lib in ((jp, jnp.asarray), (tp, torch.from_numpy)):
        s = Script(lib, jcfg.n_vocab, jcfg.token_eot)
        pipe._encode_window = s.encode_window
        pipe._decode = s.decode
        pipe._decode_topk = s.decode_topk
        out.append((pipe, s))
    return out


def audio(seconds):
    rng = np.random.default_rng(int(seconds * 10))
    return (rng.standard_normal(int(seconds * SR)) * 0.1).astype(np.float32)


def assert_same_segments(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.tokens == r.tokens
        assert g.temperature == r.temperature
        assert (g.t0, g.t1) == (r.t0, r.t1)
        assert g.text == r.text
        assert abs(g.avg_logprob - r.avg_logprob) <= 1e-6, \
            (g.avg_logprob, r.avg_logprob)
        assert g.token_times is None


FALLBACK = dict(temperatures=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0))


@pytest.mark.parametrize("seconds,windows", [(65, 3), (60.5, 2)])
@pytest.mark.parametrize("params", [
    dict(beam_size=5, temperatures=(0.0,), max_tokens=24),
    dict(beam_size=5, max_tokens=0, temperatures=(0.0,)),
    dict(beam_size=5, max_tokens=12, logprob_thold=-0.45, **FALLBACK),
    dict(beam_size=5, max_tokens=12, logprob_thold=0.0, seed=7, **FALLBACK),
    dict(beam_size=3, max_tokens=12, entropy_thold=1.5, language="de",
         translate=True, **FALLBACK),
], ids=["beam5", "beam5_to_ctx", "fallback", "fallback_forced",
        "fallback_entropy_de_translate"])
def test_transcribe_takes_the_reference_path(seconds, windows, params):
    """beam5: beam search alone; beam5_to_ctx: no max_tokens (half the
    text context); fallback: a log-prob gate some beam attempts fail, over
    six temperatures; fallback_forced: a gate no attempt passes, so every
    window runs every temperature and keeps the last; and an entropy gate
    some attempts fail, with another language and task."""
    (jp, js), (tp, ts) = pipelines()
    fp_j, fp_t = jwp.FullParams(**params), twp.FullParams(**params)
    assert tp.initial_tokens(fp_t) == jp.initial_tokens(fp_j)
    samples = audio(seconds)
    ref = jp.transcribe(samples, fp_j)
    got = tp.transcribe(samples, fp_t)
    assert len(ref) == windows
    assert_same_segments(got, ref)
    assert ts.calls == js.calls
    if params.get("logprob_thold") == 0.0:
        assert all(s.temperature == 1.0 for s in got)
    elif len(params["temperatures"]) > 1 and seconds == 65:
        # at 65 s some window falls back (at 60.5 s none may)
        assert any(s.temperature > 0 for s in got)


@pytest.mark.parametrize("n_processors", [1, 2, 3])
def test_transcribe_parallel_takes_the_reference_path(n_processors):
    (jp, js), (tp, ts) = pipelines()
    fp = dict(beam_size=5, max_tokens=10, **FALLBACK)
    samples = audio(65)
    ref = jp.transcribe_parallel(samples, jwp.FullParams(**fp), n_processors)
    got = tp.transcribe_parallel(samples, twp.FullParams(**fp), n_processors)
    assert_same_segments(got, ref)
    assert ts.calls == js.calls


@pytest.mark.parametrize("multilingual", [True, False])
def test_detect_language_takes_the_reference_path(multilingual):
    kw = SCFG if multilingual else dict(SCFG, n_vocab=51864)
    (jp, js), (tp, ts) = pipelines(kw)
    samples = audio(3)
    got, ref = tp.detect_language(samples), jp.detect_language(samples)
    assert got == ref
    assert ts.calls == js.calls
    assert (got != "en") or not multilingual or len(js.calls) == 1


def test_top_k_puts_the_lower_index_first_among_ties():
    """The device top-k's order, lax.top_k's: equal values by index."""
    import jax
    rng = np.random.default_rng(0)
    x = np.round(rng.standard_normal((5, 400)) * 2) / 2   # many ties
    x[:, 10:20] = -np.inf
    vals, idx = twp.top_k_lower_index_first(torch.from_numpy(x), 10)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 10)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


def test_token_entropy_and_text_equal():
    for toks in ([], [1], [1, 1, 2], list(range(20)) + [3] * 7):
        assert twp._token_entropy(toks) == jwp._token_entropy(toks)
    assert twp.LANGUAGES == jwp.LANGUAGES
    vocab = [f"<{i}>".encode() for i in range(51864)]
    jcfg, tcfg = JW.WhisperConfig(n_vocab=51864), TW.WhisperConfig(n_vocab=51864)
    toks = [5, 50256, 7, 50300, 9]
    assert twp.WhisperPipeline(tcfg, None, None, vocab, device="cpu") \
        .decode_text(toks) == jwp.WhisperPipeline(jcfg, None, None, vocab) \
        .decode_text(toks)


# ---- the golden transcript, end to end ----

GOLDEN_TOKENS = [127, 127, 127, 127, 127, 127, 127, 127]
GOLDEN_AVG_LP = -4.299748


def _tone_signal(seconds=2.5):
    """Two tones and a chirp, deterministic."""
    t = np.arange(int(seconds * 16000)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.2 * np.sin(2 * np.pi * 880 * t)
            + 0.1 * np.sin(2 * np.pi * (200 + 300 * t) * t)).astype(np.float32)


def tiny_pair(seed=4):
    """The JAX package's tiny Whisper pair: a random transformers model and
    its params through the JAX from_hf_state_dict."""
    transformers = pytest.importorskip("transformers")
    from ggml_imax_tpu.quant.formats import GGMLType as JType
    torch.manual_seed(seed)
    hf_cfg = transformers.WhisperConfig(
        vocab_size=128, num_mel_bins=16, d_model=32,
        encoder_layers=2, encoder_attention_heads=4,
        decoder_layers=2, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64,
        max_source_positions=32, max_target_positions=24,
        pad_token_id=0, bos_token_id=1, eos_token_id=2,
        decoder_start_token_id=3, suppress_tokens=None,
        begin_suppress_tokens=None, forced_decoder_ids=None)
    model = transformers.WhisperForConditionalGeneration(hf_cfg).eval()
    sd = {k.removeprefix("model."): v.numpy()
          for k, v in model.state_dict().items()}
    kw = dict(n_vocab=128, n_audio_ctx=32, n_audio_state=32, n_audio_head=4,
              n_audio_layer=2, n_text_ctx=24, n_text_state=32, n_text_head=4,
              n_text_layer=2, n_mels=16)
    return kw, JW.from_hf_state_dict(JW.WhisperConfig(**kw), sd, JType.F32)


def test_golden_transcript():
    """The port's pipeline on the JAX test's tiny pair and tone signal:
    greedy (beam 1, one temperature, 8 tokens), the JAX test's tokens and
    avg_logprob."""
    from ggml_imax_tpu_torch.audio.mel import mel_filterbank
    from ggml_imax_tpu_torch.models.common import params_from_jax
    kw, jparams = tiny_pair()
    cfg = TW.WhisperConfig(**kw)
    vocab = [f"<{i}>".encode() for i in range(cfg.n_vocab)]
    pipe = twp.WhisperPipeline(cfg, params_from_jax(jparams, device="cpu"),
                               mel_filterbank(cfg.n_mels), vocab,
                               compute_dtype=torch.float32, device="cpu")
    fp = twp.FullParams(beam_size=1, max_tokens=8, temperatures=(0.0,),
                        logprob_thold=-1e9, entropy_thold=1e9)
    segs = pipe.transcribe(_tone_signal(), fp)
    assert len(segs) == 1
    assert segs[0].tokens == GOLDEN_TOKENS, segs[0].tokens
    assert abs(segs[0].avg_logprob - GOLDEN_AVG_LP) < 1e-3, \
        segs[0].avg_logprob
    assert segs[0].text == "<127>" * 8
    assert (segs[0].t0, segs[0].t1) == (0.0, 2.5)


def test_pipeline_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twp.WhisperPipeline(TW.WhisperConfig(**SCFG), None)
