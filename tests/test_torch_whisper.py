"""Port parity: models/whisper.py against the JAX package's Whisper, on the
host, at a small size: n_vocab 1000, 75 audio positions (150 mel frames,
a key count off every block size, as 1500 is at full size), width 128 in
2 heads of 64 (Whisper's head_dim), 2 encoder and 2 decoder layers, 32
text positions. Every 2-D weight Q5_0 from the JAX package's
synthetic_params_device; the LM head padded to 1024 columns (as
tools/bench_models.py measure_whisper pads it) or left at 1000 (as
measure_whisper_rtf leaves it); prepare_fused (or not) and
params_repack_device, carried over by params_from_jax.

The JAX side runs with its kernels in interpret mode (set_force_fused)
and its attention dispatched as on the TPU: flash (interpret mode) for
more than one query row, attention_xla for one. Its decoder is the
benchmark's stacked one (stack_decoder) for fused params and the
unstacked one otherwise. The port runs its plain versions on the CPU.

Held: the encoder states and cross K/V within 1e-2 of their largest
|value| (seen: 2.3e-3 and 3.2e-3), the prompt's logits (4 tokens, two of
them ids past the table) and 8 decode steps fed the same tokens within
3e-2 of the largest |logit| (seen: 1.2e-2; the two libraries sum each
product in another order, which flips a bf16 or int8 rounding of an
activation here and there, and the flips add up over layers and steps).
Under that noise a fault could hide, so every op of the same passes is
also teacher-forced on the reference's output (TeacherForced) and held
within 1e-5 of the reference's largest |value| (seen: 4.6e-7, a product),
and two planted faults must fail that check.
"""
import importlib
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.models import whisper as JW
from ggml_imax_tpu.ops import flash_attention as jfa
from ggml_imax_tpu.ops import pallas_qmm as jpq
from ggml_imax_tpu.ops.attention import attention_xla as jattention_xla
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.models import common as tcommon
from ggml_imax_tpu_torch.models import whisper as TW
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.ops.qmm import params_repack
from ggml_imax_tpu_torch.quant.device import QTensor, pad_qtensor_cols
from ggml_imax_tpu_torch.quant.formats import GGMLType

jqmatmul = importlib.import_module("ggml_imax_tpu.ops.qmatmul")
jembedding = importlib.import_module("ggml_imax_tpu.ops.embedding")

CFG = dict(n_vocab=1000, n_audio_ctx=75, n_audio_state=128, n_audio_head=2,
           n_audio_layer=2, n_text_ctx=32, n_text_state=128, n_text_head=2,
           n_text_layer=2, n_mels=16)
SEED, STEPS = 3, 8
ENC_TOL, LOGIT_TOL, OP_TOL = 1e-2, 3e-2, 1e-5
JCFG, TCFG = JW.WhisperConfig(**CFG), TW.WhisperConfig(**CFG)


def tpu_attention(q, k, v, mask=None, **kw):
    """The JAX package's attention as it dispatches on the TPU: flash
    (interpret mode here) for more than one query row."""
    kw.pop("precision", None)
    if q.shape[1] > 1:
        return jfa.flash_attention(q, k, v, mask, interpret=True, **kw)
    return jattention_xla(q, k, v, mask, **kw)


def pad_head_jax(params):
    """measure_whisper's padding of the tied head to a multiple of 128."""
    te = params["d_te"]
    vpad = (-te.n) % 128
    return dict(params, d_te=replace(
        te, q=jnp.pad(te.q, ((0, 0), (0, vpad))),
        scale=jnp.pad(te.scale, ((0, 0), (0, vpad))), n=te.n + vpad))


def jax_params(fused, padded):
    """The JAX package's raw draw, padded and fused as asked, repacked."""
    raw = JW.synthetic_params_device(JCFG, JType.Q5_0, seed=SEED)
    if padded:
        raw = pad_head_jax(raw)
    return jpq.params_repack_device(JW.prepare_fused(raw) if fused else raw)


def inputs():
    rng = np.random.default_rng(SEED)
    mel = rng.standard_normal((1, CFG["n_mels"], 2 * CFG["n_audio_ctx"])) \
        .astype(np.float32)
    prompt = np.array([[JCFG.token_sot, JCFG.token_not, 5, 7]], np.int32)
    feed = rng.integers(0, CFG["n_vocab"], STEPS)
    return mel, prompt, feed


def run_jax(p, fused, mel, prompt, feed):
    """-> (encoder states, cross K/V, logits of the prompt and each step).
    stack_decoder takes the decoder's leaves apart, so it runs after the
    encoder and the cross K/V."""
    enc_fn = jax.jit(lambda p, mel: (lambda e: (
        e, JW.precompute_cross_kv(JCFG, p, e)))(JW.encode(JCFG, p, mel)))
    dec_fn = jax.jit(lambda p, t, pos, c, cross, n: JW.decode(
        JCFG, p, t, pos, c, cross, n))
    jqmatmul.set_force_fused(True)
    try:
        enc, cross = enc_fn(p, jnp.asarray(mel))
        dec_p = JW.stack_decoder(p) if fused else p
        cache = JW.init_cache(JCFG, batch=1)
        T = prompt.shape[1]
        lg, cache = dec_fn(dec_p, jnp.asarray(prompt),
                           jnp.arange(T, dtype=jnp.int32)[None], cache,
                           cross, 0)
        logits = [np.asarray(lg[0])]
        for i, tok in enumerate(feed):
            lg, cache = dec_fn(dec_p, jnp.asarray([[tok]], jnp.int32),
                               jnp.asarray([[T + i]], jnp.int32), cache,
                               cross, T + i)
            logits.append(np.asarray(lg[0]))
    finally:
        jqmatmul.set_force_fused(False)
    cross = tuple(np.asarray(c) for c in cross)
    return np.asarray(enc), cross, logits


def run_port(p, mel, prompt, feed):
    enc = TW.encode(TCFG, p, torch.from_numpy(mel))
    cross = TW.precompute_cross_kv(TCFG, p, enc)
    cache = TW.init_cache(TCFG, batch=1, device="cpu")
    T = prompt.shape[1]
    lg, cache = TW.decode(TCFG, p, torch.from_numpy(prompt).long(),
                          torch.arange(T)[None], cache, cross, 0)
    logits = [lg[0].numpy()]
    for i, tok in enumerate(feed):
        lg, cache = TW.decode(TCFG, p, torch.tensor([[int(tok)]]),
                              torch.tensor([[T + i]]), cache, cross, T + i)
        logits.append(lg[0].numpy())
    return enc.numpy(), tuple(c.numpy() for c in cross), logits


def rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(autouse=True)
def _tpu_dispatch(monkeypatch):
    monkeypatch.setattr(JW, "attention", tpu_attention)


class TeacherForced:
    """Op-by-op teacher forcing of the port's Whisper on the JAX package's.
    The reference's pass records the output of each op it calls (conv_1d,
    get_rows, layer_norm, the products, attention, gelu), in program order,
    through ordered jax.debug callbacks; the port's pass, run next on the
    same inputs, holds each of its ops' output to the reference's output of
    the same op and goes on with the reference's value. Every op then
    starts from the reference's bits and its own difference stands alone.
    The glue between the ops (biases, residuals, the qkv split, the KV
    writes and reads, the id clamp, the head's slice) is not forced: it
    runs on forced values and a fault there shows at the next op."""

    OPS = ("conv_1d", "get_rows", "layer_norm", "mm", "attention", "gelu")

    def __init__(self):
        self.recs, self.err = {}, {}

    def _record(self, name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            jax.debug.callback(lambda v: self.recs.setdefault(name, []).append(
                np.asarray(v, np.float32)), out, ordered=True)
            return out
        return wrapped

    def jax_patches(self):
        pairs = [(JW, "conv_1d", "conv_1d"), (JW, "layer_norm", "layer_norm"),
                 (JW, "gelu", "gelu"), (JW, "attention", "attention"),
                 (JW, "qmatmul", "mm"), (jqmatmul, "qmatmul_stacked", "mm"),
                 (jembedding, "get_rows", "get_rows")]
        return [(m, a, self._record(n, getattr(m, a))) for m, a, n in pairs]

    def _force(self, name, fn):
        def wrapped(*a, **kw):
            got = fn(*a, **kw)
            ref = self.recs[name].pop(0)
            assert ref.shape == tuple(got.shape), (name, ref.shape, got.shape)
            e = float(np.abs(got.float().numpy() - ref).max()
                      / max(float(np.abs(ref).max()), 1e-30))
            self.err[name] = max(self.err.get(name, 0.0), e)
            return torch.from_numpy(ref.copy()).to(got.dtype)
        return wrapped

    def port_patches(self):
        pairs = [("conv_1d", "conv_1d"), ("get_rows", "get_rows"),
                 ("layer_norm", "layer_norm"), ("qmatmul", "mm"),
                 ("attention", "attention"), ("gelu", "gelu")]
        return [(TW, a, self._force(n, getattr(TW, a))) for a, n in pairs]

    def check(self, tol):
        """Every record taken, each op within tol of the reference's
        largest |value|."""
        assert not any(self.recs.values()), \
            {k: len(v) for k, v in self.recs.items() if v}
        assert set(self.err) == set(self.OPS)
        worst = {k: v for k, v in self.err.items() if not v <= tol}
        assert not worst, worst


VARIANTS = [(True, True), (False, False)]
_REFERENCE = {}


def reference(fused, padded):
    """The reference's pass of one variant with every op recorded (once per
    module: the recording does not change its values), with the port's
    params carried over before stack_decoder takes the leaves apart."""
    if (fused, padded) not in _REFERENCE:
        mel, prompt, feed = inputs()
        jp = jax_params(fused, padded)
        tp = params_from_jax(jp, device="cpu")
        tf = TeacherForced()
        with pytest.MonkeyPatch.context() as m:
            m.setattr(JW, "attention", tpu_attention)
            for mod, attr, fn in tf.jax_patches():
                m.setattr(mod, attr, fn)
            out = run_jax(jp, fused, mel, prompt, feed)
            jax.effects_barrier()
        _REFERENCE[fused, padded] = (tp, tf.recs, out, (mel, prompt, feed))
    return _REFERENCE[fused, padded]


@pytest.mark.parametrize("fused,padded", VARIANTS)
def test_forward_matches_reference(fused, padded):
    """Encoder, cross K/V, the prompt and 8 fed steps; the padded head
    takes the nat8 route (W8A8 at one row), the unpadded one dequantizes.
    The argmax is equal wherever the reference's top-2 margin exceeds
    twice the row's difference."""
    tp, _, ref, args = reference(fused, padded)
    assert tp["d_te"].n == (1024 if padded else 1000)
    # nat8 either way; only the padded head passes the N % 128 gate
    assert tp["d_te"].q4_layout == 4
    assert (tp["d_te"].n % 128 == 0) == padded
    assert ("qkv_w" in tp["dec_layers"][0]) == fused
    got = run_port(tp, *args)
    assert got[0].shape == ref[0].shape == (1, CFG["n_audio_ctx"], 128)
    assert rel(got[0], ref[0]) <= ENC_TOL, rel(got[0], ref[0])
    for g, r in zip(got[1], ref[1]):
        assert g.shape == r.shape == (2, 1, CFG["n_audio_ctx"], 2, 64)
        assert rel(g, r) <= ENC_TOL, rel(g, r)
    scale = max(float(np.abs(r).max()) for r in ref[2])
    assert scale > 0.5                                   # not degenerate
    assert [g.shape for g in got[2]] == [r.shape for r in ref[2]]
    assert got[2][0].shape == (4, CFG["n_vocab"])
    diffs = [float(np.abs(g - r).max()) for g, r in zip(got[2], ref[2])]
    assert max(diffs) <= LOGIT_TOL * scale, diffs
    for g, r, d in zip(got[2], ref[2], diffs):
        top2 = np.sort(r, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * d
        assert (g.argmax(-1) == r.argmax(-1))[clear].all()


def forced_port(variant, monkeypatch, faults=()):
    tp, recs, ref, args = reference(*variant)
    tf = TeacherForced()
    tf.recs = {k: list(v) for k, v in recs.items()}
    for mod, attr, fn in tf.port_patches() + list(faults):
        monkeypatch.setattr(mod, attr, fn)
    return tf, ref, run_port(tp, *args)


@pytest.mark.parametrize("variant", VARIANTS)
def test_teacher_forced_every_op_matches_reference(variant, monkeypatch):
    """Each op of the port's pass, fed the reference's inputs, within 1e-5
    of the reference's largest |value| (seen: at most 4.6e-7, a product;
    conv_1d 4.1e-7, attention 3.0e-7, layer_norm 2.6e-7, gelu 1.5e-7,
    get_rows exact)."""
    tf, ref, got = forced_port(variant, monkeypatch)
    tf.check(OP_TOL)
    for g, r in zip(got[2], ref[2]):
        assert rel(g, r) <= OP_TOL


@pytest.mark.parametrize("fault", ["position_off_by_one", "cross_v_for_k"])
def test_teacher_forced_check_catches_a_planted_fault(monkeypatch, fault):
    """The op-by-op check fails on a fault in the glue: the decoder's
    position embedding read one row late, or the cross-attention fed V in
    place of K."""
    faults = []
    if fault == "position_off_by_one":
        tp = reference(*VARIANTS[0])[0]
        pe = tp["d_pe"]
        monkeypatch.setitem(tp, "d_pe", torch.cat([pe[1:], pe[-1:]]))
    else:
        real_decode = TW.decode

        def swapped(cfg, params, tokens, positions, cache, cross_kv, n_past,
                    **kw):
            return real_decode(cfg, params, tokens, positions, cache,
                               (cross_kv[1], cross_kv[1]), n_past, **kw)
        faults = [(TW, "decode", swapped)]
    tf, _, _ = forced_port(VARIANTS[0], monkeypatch, faults)
    with pytest.raises(AssertionError):
        tf.check(OP_TOL)


# ---- the parts around the forward ----

def test_prepare_and_repack_match_the_reference_bytes():
    """The port's own prepare_fused and params_repack on the carried-over
    raw draw give the reference's prepared bytes; pad_qtensor_cols pads
    the head as measure_whisper does."""
    raw = JW.synthetic_params_device(JCFG, JType.Q5_0, seed=SEED)
    ref = params_from_jax(jpq.params_repack_device(
        JW.prepare_fused(pad_head_jax(raw))), device="cpu")
    got = params_from_jax(raw, device="cpu")
    got["d_te"] = pad_qtensor_cols(got["d_te"], 128)[0]
    got = params_repack(TW.prepare_fused(got))

    def same(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(b, QTensor):
            for f in ("kind", "k", "n", "ggml_type", "interleaved_bk",
                      "q4_layout"):
                assert getattr(a, f) == getattr(b, f), f
            for f in ("q", "scale", "bias"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None)
                if x is not None:
                    assert torch.equal(x, y), f
        else:
            assert torch.equal(a, b)
    same(got, ref)
    lp = got["dec_layers"][0]
    assert lp["qkv_w"].n == 3 * 128 and "q_w" not in lp
    assert torch.equal(lp["qkv_b"][128:256], torch.zeros(128))


def test_ids_past_the_table_are_clamped_to_its_last_row():
    """The reference's gather reads an id past the table as its last row;
    the port's decode does so too instead of raising."""
    tp = params_from_jax(jax_params(True, False), device="cpu")
    enc = TW.encode(TCFG, tp, torch.from_numpy(inputs()[0]))
    cross = TW.precompute_cross_kv(TCFG, tp, enc)
    out = []
    for ids in ([[JCFG.token_sot, 50000, 7]], [[999, 999, 7]]):
        cache = TW.init_cache(TCFG, device="cpu")
        out.append(TW.decode(TCFG, tp, torch.tensor(ids),
                             torch.arange(3)[None], cache, cross, 0)[0])
    assert torch.equal(out[0], out[1])
    with pytest.raises(IndexError):
        from ggml_imax_tpu_torch.ops.embedding import get_rows
        get_rows(tp["d_te"], torch.tensor([[50000]]))


def test_params_from_jax_refuses_a_stacked_decoder():
    jp = jax_params(True, False)
    with pytest.raises(ValueError, match="stack_decoder"):
        params_from_jax(JW.stack_decoder(jp), device="cpu")


def test_token_timestamps_raise_not_implemented():
    """Token timestamps are ported (ROADMAP Queue 1 item 1b):
    return_cross_attn and FullParams(token_timestamps=True) no longer
    raise NotImplementedError (tests/test_torch_whisper_timestamps.py holds
    them to the reference); a stacked decoder is refused, as the
    reference refuses it with return_cross_attn."""
    from ggml_imax_tpu_torch.runtime.whisper_pipeline import FullParams
    tp = params_from_jax(jax_params(True, False), device="cpu")
    cache = TW.init_cache(TCFG, device="cpu")
    cross = [torch.zeros(2, 1, 75, 2, 64)] * 2
    lg, _, probs = TW.decode(TCFG, tp, torch.tensor([[1]]),
                             torch.tensor([[0]]), cache, cross, 0,
                             return_cross_attn=True)
    assert probs.shape == (2, 1, 2, 1, 75) and probs.dtype == torch.float32
    assert lg.shape == (1, 1, TCFG.n_vocab)
    assert FullParams(token_timestamps=True).token_timestamps
    with pytest.raises(ValueError, match="stack_decoder"):
        TW.decode(TCFG, dict(tp, dec_stack={}), torch.tensor([[1]]),
                  torch.tensor([[0]]), cache, cross, 0,
                  return_cross_attn=True)


@pytest.mark.parametrize("kv", [torch.bfloat16, "q8_0"])
def test_select_batch_copies_and_reorders(kv):
    """The beam reorder gathers rows into fresh tensors: the next in-place
    write goes to the new cache's tensors and leaves the old cache as it
    was; rows as the JAX package's select_batch orders them."""
    from ggml_imax_tpu.models import common as jcommon
    cache = tcommon.init_kv_cache(2, 3, 8, 2, 32, kv, device="cpu")
    rng = np.random.default_rng(0)
    for li in range(2):
        tcommon.update_kv(cache, li, torch.randn(3, 5, 2, 32),
                          torch.randn(3, 5, 2, 32), 0)
    before = [t.clone() for t in (cache.k, cache.v, cache.ks, cache.vs)
              if t is not None]
    order = [2, 2, 0]
    new = cache.select_batch(torch.tensor(order))
    for a, b in zip((new.k, new.v, new.ks, new.vs),
                    (cache.k, cache.v, cache.ks, cache.vs)):
        if b is None:
            assert a is None
            continue
        assert a.data_ptr() != b.data_ptr()
        assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
        ref = jcommon.KVCache(jnp.asarray(b.float().numpy()),
                              jnp.asarray(b.float().numpy())).select_batch(
            jnp.asarray(order)).k
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(ref))
    tcommon.update_kv(new, 1, torch.ones(3, 1, 2, 32),
                      torch.ones(3, 1, 2, 32), 5)
    after = [t for t in (cache.k, cache.v, cache.ks, cache.vs)
             if t is not None]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert new.heads == cache.heads and new.quantized == cache.quantized
    assert rng is not None


@pytest.mark.parametrize("wtype", ["Q5_0", "Q8_0", "Q4_0", "F16"])
def test_synthetic_params_device_draw(wtype):
    """The port's draw on the device: the reference's tree, shapes, layouts
    and value ranges for each wtype (other numbers than jax.random)."""
    cfg = dict(CFG, n_audio_layer=1, n_text_layer=1)
    ref = JW.synthetic_params_device(JW.WhisperConfig(**cfg), JType[wtype],
                                     seed=1)
    got = TW.synthetic_params_device(TW.WhisperConfig(**cfg),
                                     GGMLType[wtype], seed=1, device="cpu")
    again = TW.synthetic_params_device(TW.WhisperConfig(**cfg),
                                       GGMLType[wtype], seed=1, device="cpu")

    pooled, scales = ([], []), ([], [])

    def walk(a, b, c):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                walk(a[k], b[k], c[k])
        elif isinstance(b, list):
            for x, y, z in zip(a, b, c):
                walk(x, y, z)
        elif hasattr(b, "kind"):
            assert (a.kind, a.k, a.n, a.zero, int(a.ggml_type)) == \
                (b.kind, b.k, b.n, b.zero, int(b.ggml_type))
            assert tuple(a.q.shape) == b.q.shape
            assert str(a.q.dtype)[6:] == str(b.q.dtype)
            assert torch.equal(a.q, c.q)
            lo, hi = int(np.asarray(b.q).min()), int(np.asarray(b.q).max())
            if a.kind != "dense":
                assert (int(a.q.min()), int(a.q.max())) == (lo, hi)
                assert tuple(a.scale.shape) == b.scale.shape
                scales[0].append(a.scale.ravel().numpy())
                scales[1].append(np.ravel(np.asarray(b.scale)))
        else:
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
            assert torch.equal(a, c)
            pooled[0].append((a - a.mean()).ravel().numpy())
            pooled[1].append(np.ravel(np.asarray(b) - np.asarray(b).mean()))
    walk(got, ref, again)
    std = [float(np.concatenate(p).std()) for p in pooled]
    assert abs(std[0] / std[1] - 1) < 0.05, std
    if scales[0]:
        mean = [float(np.concatenate(s).mean()) for s in scales]
        assert abs(mean[0] / mean[1] - 1) < 0.05, mean


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.synthetic_params_device(TCFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.init_cache(TCFG)
