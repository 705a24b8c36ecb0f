"""Port parity: the LLaMA slice as a whole, at a small size (vocab 512,
n_embd 256, 2 query heads of 128 over 1 kv head (GQA 2:1), 2 layers, n_ff
768 padded to 1024), every 2-D weight Q4_K through the JAX package's
quantize_for_device, carried over by params_from_jax.

The JAX package's stacked forward (its kernels in interpret mode through
set_force_fused) against the port's forward (plain versions on the CPU),
teacher-forced: a 16-token prefill, then 4 decode steps, with bf16 and
with q8_0 KV, on the default and the fused KV-update route. Logits within
atol 0.1 (the largest |logit| is ~5.2; the prefill attention is bf16 flash
in the port and f32 XLA attention in the reference, which alone parts them
by up to 0.067: with an f32 attention in its place the port agrees to
2e-6, and is held to 1e-4 so), argmax equal wherever the reference's
top-2 margin exceeds 0.2. The same for the unfused keys against the
reference's unstacked forward, and for a decode-only celled ubatch of 2
rows through both cells routes. Also: prepare_fused's keys,
shapes and zero pad lanes, the Engine's greedy loop and generate(chunk=4),
and the device defaults.
"""
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.models import llama as jllama
from ggml_imax_tpu.ops import pallas_qmm as jpq
from ggml_imax_tpu.quant import device as jdev
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.models import llama as tllama
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.ops.qmatmul import qmatmul
from ggml_imax_tpu_torch.ops.qmm import params_repack
from ggml_imax_tpu_torch.quant.device import QTensor
from ggml_imax_tpu_torch.quant.formats import GGMLType
from ggml_imax_tpu_torch.runtime.engine import Engine

jqmatmul = importlib.import_module("ggml_imax_tpu.ops.qmatmul")

CFG = dict(n_vocab=512, n_ctx=256, n_embd=256, n_head=2, n_head_kv=1,
           n_layer=2, n_ff=768)
SEED, PROMPT, STEPS, PAD = 11, 16, 4, 1024
ATOL, MARGIN = 0.1, 0.2


def _jax_raw():
    """Natural-layout JAX params: Q4_K weights of std 0.08, norms near 1."""
    cfg = jllama.LlamaConfig(**CFG)
    rng = np.random.default_rng(SEED)
    E, V, F = cfg.n_embd, cfg.n_vocab, cfg.n_ff
    kv = cfg.n_head_kv * cfg.head_dim

    def q(k, n):
        w = (rng.standard_normal((k, n)) * 0.08).astype(np.float32)
        return jdev.quantize_for_device(w, JType.Q4_K)

    def norm(n):
        return jnp.asarray((1 + 0.1 * rng.standard_normal(n))
                           .astype(np.float32))

    p = {"tok_embd": q(E, V), "out_norm": norm(E), "output": q(E, V),
         "layers": []}
    for _ in range(cfg.n_layer):
        p["layers"].append({
            "attn_norm": norm(E), "q_w": q(E, E), "k_w": q(E, kv),
            "v_w": q(E, kv), "o_w": q(E, E), "ffn_norm": norm(E),
            "gate_w": q(E, F), "up_w": q(E, F), "down_w": q(F, E)})
    return cfg, p


_RAW = {}


def jax_raw():
    if not _RAW:
        _RAW["v"] = _jax_raw()
    return _RAW["v"]


def port_params(fused=True):
    cfg = tllama.LlamaConfig(**CFG)
    p = params_from_jax(jax_raw()[1], device="cpu")
    if fused:
        p = tllama.fuse_gate_up(tllama.fuse_qkv(p), pad_multiple=PAD)
    return cfg, params_repack(p)


class _env:
    """GGML_FUSED_KV_UPDATE for the block (the reference's fused route)."""

    def __init__(self, fused):
        self.fused = fused

    def __enter__(self):
        self.old = os.environ.get("GGML_FUSED_KV_UPDATE")
        os.environ["GGML_FUSED_KV_UPDATE"] = "1" if self.fused else "0"
        jqmatmul.set_force_fused(True)

    def __exit__(self, *exc):
        jqmatmul.set_force_fused(False)
        if self.old is None:
            os.environ.pop("GGML_FUSED_KV_UPDATE")
        else:
            os.environ["GGML_FUSED_KV_UPDATE"] = self.old


def _jax_stacked():
    cfg, p = jax_raw()
    p = jllama.fuse_gate_up(jllama.fuse_qkv(p), pad_multiple=PAD)
    return cfg, jllama.stack_model(jpq.params_repack_device(p))


def _kv(kv, jax_side):
    if kv == "q8_0":
        return kv
    return jnp.bfloat16 if jax_side else torch.bfloat16


def _jax_logits(kv, fused, prompt, feed, stacked=True):
    """The reference's logits: its stacked forward over the fused graph,
    or (stacked False) its unstacked forward over the unfused keys, repacked
    to natpair so its products take the same kernels."""
    cfg, p = _jax_stacked() if stacked else (
        jax_raw()[0], jpq.params_repack_device(jax_raw()[1]))
    cache = jllama.init_cache(cfg, dtype=_kv(kv, True), flat=stacked)
    out = []
    with _env(fused):
        fwd = jax.jit(lambda p, t, pos, c, n: jllama.forward(cfg, p, t, pos,
                                                             c, n))
        lg, cache = fwd(p, jnp.asarray(prompt[None]),
                        jnp.arange(PROMPT, dtype=jnp.int32)[None], cache, 0)
        out.append(np.asarray(lg[0]))
        for i, tok in enumerate(feed):
            n = PROMPT + i
            lg, cache = fwd(p, jnp.asarray([[tok]], jnp.int32),
                            jnp.asarray([[n]], jnp.int32), cache, n)
            out.append(np.asarray(lg[0]))
    return out


def _port_logits(kv, fused, prompt, feed, fused_keys=True):
    cfg, p = port_params(fused_keys)
    cache = tllama.init_cache(cfg, dtype=_kv(kv, False), device="cpu")
    kw = dict(fused_kv_update=fused)
    lg, cache = tllama.forward(cfg, p, torch.as_tensor(prompt[None]).long(),
                               torch.arange(PROMPT)[None], cache, 0, **kw)
    out = [lg[0].numpy()]
    for i, tok in enumerate(feed):
        n = PROMPT + i
        lg, cache = tllama.forward(cfg, p, torch.tensor([[int(tok)]]),
                                   torch.tensor([[n]]), cache, n, **kw)
        out.append(lg[0].numpy())
    return out


def assert_close_logits(ref, got, atol=ATOL):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert g.shape == r.shape and r.shape[-1] == CFG["n_vocab"]
        np.testing.assert_allclose(g, r, rtol=0, atol=atol)
        for rr, gg in zip(r.reshape(-1, r.shape[-1]),
                          g.reshape(-1, g.shape[-1])):
            top2 = np.sort(rr)[-2:]
            if top2[1] - top2[0] > MARGIN:
                assert int(np.argmax(gg)) == int(np.argmax(rr))


def _tokens():
    rng = np.random.default_rng(0)
    return (rng.integers(0, CFG["n_vocab"], PROMPT).astype(np.int32),
            rng.integers(0, CFG["n_vocab"], STEPS).astype(np.int32))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_slice_matches_reference_forward(kv, fused):
    prompt, feed = _tokens()
    ref = _jax_logits(kv, fused, prompt, feed)
    got = _port_logits(kv, fused, prompt, feed)
    assert len(got) == STEPS + 1
    assert max(float(np.abs(r).max()) for r in ref) > 0.5    # not degenerate
    assert_close_logits(ref, got)


def _f32_attention(q, k, v, mask=None, **kw):
    """Prefill attention in f32, as the reference's XLA attention computes
    it (GQA by repeated kv heads)."""
    rep = q.shape[2] // k.shape[2]
    k, v = (t.float().repeat_interleave(rep, 2) for t in (k, v))
    s = torch.einsum("bthd,bshd->bhts", q.float(), k) / q.shape[-1] ** 0.5
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s + mask, -1), v)


class TeacherForced:
    """Op-by-op teacher forcing of the port's LLaMA forward on the JAX
    package's. The reference's forward records the output of each op it
    calls (get_rows, rms_norm, the products, rope, attention and the
    decode attention routes, silu), in program order, through ordered
    jax.debug callbacks; the port's forward, run next on the same inputs,
    holds each of its ops' output to the reference's output of the same op
    and goes on with the reference's value. So every op starts from the
    reference's bits and the largest difference of each op stands alone.

    Without the forcing, an f32 ulp between the two libraries' rms_norm
    (XLA:CPU's vector code differs from host to host) flips the bf16
    rounding of one activation of a product's input, and that one flip
    parts every logit of its row by up to ~1e-2 (seen on one host, not on
    another). The glue between the ops (the GQA split of qkv, the
    residuals, the SwiGLU product and its pad lanes) is not forced: it
    runs on forced values and a fault there shows at the next op.

    The port's fused gate/up product (N = 2 * F padded) meets the
    reference's unfused gate and up products: both are taken, each padded
    with zeros to F padded (the pad columns decode to exactly 0), and so
    are silu's pad lanes."""

    def __init__(self):
        self.recs = {}
        self.err = {}

    def _record(self, name, fn, first=False):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            val = out[0] if first else out
            jax.debug.callback(
                lambda v: self.recs.setdefault(name, []).append(
                    np.asarray(v, np.float32)), val, ordered=True)
            return out
        return wrapped

    def jax_patches(self):
        jda = importlib.import_module("ggml_imax_tpu.ops.decode_attention")
        pairs = [(jllama, n, n) for n in ("get_rows", "rms_norm", "rope",
                                          "silu")]
        pairs += [(jllama, "attention", "attn"), (jllama, "qmatmul", "mm"),
                  (jqmatmul, "qmatmul_stacked", "mm"),
                  (jda, "decode_attention_stacked", "attn")]
        out = [(m, a, self._record(n, getattr(m, a))) for m, a, n in pairs]
        return out + [(jda, "decode_attention_update_stacked",
                       self._record("attn", jda.decode_attention_update_stacked,
                                    first=True))]

    def _take(self, name, got):
        recs = self.recs[name]
        ref = recs.pop(0)
        if ref.size != got.numel():
            half = got.shape[-1] // 2
            pad = lambda r, n: np.pad(r, [(0, 0)] * (r.ndim - 1)
                                      + [(0, n - r.shape[-1])])
            if name == "mm":           # the reference's gate and up
                ref = np.concatenate([pad(ref, half), pad(recs.pop(0), half)],
                                     -1)
            else:                      # silu's pad lanes
                ref = pad(ref, got.shape[-1])
        return torch.from_numpy(np.array(ref.reshape(got.shape)))

    def _force(self, name, fn, first=False):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            got = out[0] if first else out
            ref = self._take(name, got)
            self.err[name] = max(self.err.get(name, 0.0),
                                 float((got.float() - ref).abs().max()))
            ref = ref.to(got.dtype)
            return (ref, *out[1:]) if first else ref
        return wrapped

    def port_patches(self):
        pairs = [(n, n) for n in ("get_rows", "rms_norm", "rope", "silu")]
        pairs += [("attention", "attn"), ("qmatmul", "mm"),
                  ("decode_attention", "attn")]
        out = [(tllama, a, self._force(n, getattr(tllama, a)))
               for a, n in pairs]
        return out + [(tllama, "decode_attention_update",
                       self._force("attn", tllama.decode_attention_update,
                                   first=True))]

    def check(self, atol):
        """Every record taken, each op within atol of the reference."""
        assert not any(self.recs.values()), \
            {k: len(v) for k, v in self.recs.items() if v}
        assert set(self.err) == {"get_rows", "rms_norm", "rope", "silu",
                                 "attn", "mm"}
        worst = {k: v for k, v in self.err.items() if not v <= atol}
        assert not worst, worst


def teacher_forced(monkeypatch, jax_run, port_run):
    """jax_run() with the reference's ops recorded, then port_run() with
    the port's ops forced on them; returns (reference logits, port logits,
    the TeacherForced)."""
    tf = TeacherForced()
    with monkeypatch.context() as m:
        for mod, attr, fn in tf.jax_patches():
            m.setattr(mod, attr, fn)
        ref = jax_run()
        jax.effects_barrier()
    for mod, attr, fn in tf.port_patches():
        monkeypatch.setattr(mod, attr, fn)
    return ref, port_run(), tf


@pytest.mark.parametrize("fused", [False, True])
def test_slice_matches_reference_with_f32_prefill_attention(fused,
                                                            monkeypatch):
    """The GQA split, rope, norms, SwiGLU, the Q4_K products and the decode
    routes agree with the reference to float rounding once the prefill
    attention is computed alike (bf16 KV: a q8_0 arena rounds K and V to
    1/127 steps of their row's max, where the two libraries' sin and cos,
    an ulp apart, flip a level here and there and part the logits by
    ~1e-2): every op, teacher-forced on the reference's input
    (TeacherForced), within 1e-4 of the reference's (seen: 3.2e-6, a
    product), and so the logits."""
    prompt, feed = _tokens()
    monkeypatch.setattr(tllama, "attention", _f32_attention)
    ref, got, tf = teacher_forced(
        monkeypatch, lambda: _jax_logits("bf16", fused, prompt, feed),
        lambda: _port_logits("bf16", fused, prompt, feed))
    tf.check(1e-4)
    assert_close_logits(ref, got, atol=1e-4)


@pytest.mark.parametrize("fault", ["rope_position", "decode_layer"])
def test_teacher_forced_check_catches_a_planted_fault(fault, monkeypatch):
    """The op-by-op check above fails on a fault planted in the port:
    rope fed positions shifted by one, or the decode route reading the
    other layer's KV rows."""
    prompt, feed = _tokens()
    monkeypatch.setattr(tllama, "attention", _f32_attention)
    if fault == "rope_position":
        rope = tllama.rope
        monkeypatch.setattr(tllama, "rope", lambda t, pos, **kw:
                            rope(t, pos + 1, **kw))
    else:
        dec = tllama.decode_attention
        monkeypatch.setattr(tllama, "decode_attention", lambda c, li, q, m:
                            dec(c, CFG["n_layer"] - 1 - li, q, m))
    _, _, tf = teacher_forced(
        monkeypatch, lambda: _jax_logits("bf16", False, prompt, feed),
        lambda: _port_logits("bf16", False, prompt, feed))
    with pytest.raises(AssertionError):
        tf.check(1e-4)


def test_unfused_forward_matches_reference():
    prompt, feed = _tokens()
    ref = _jax_logits("bf16", False, prompt, feed, stacked=False)
    got = _port_logits("bf16", False, prompt, feed, fused_keys=False)
    assert_close_logits(ref, got)
    # and the fused graph computes the same function
    assert_close_logits(got, _port_logits("bf16", False, prompt, feed))


def test_prepare_fused_matches_reference():
    _, jp = _jax_stacked()
    cfg, p = port_params()
    _, jraw = jax_raw()
    jf = jllama.fuse_gate_up(jllama.fuse_qkv(jraw), pad_multiple=PAD)
    tf = tllama.fuse_gate_up(tllama.fuse_qkv(params_from_jax(
        jraw, device="cpu")), pad_multiple=PAD)
    assert sorted(tf["layers"][0]) == sorted(jf["layers"][0]) == [
        "attn_norm", "down_w", "ffn_norm", "gu_w", "o_w", "qkv_w"]
    for jl, tl in zip(jf["layers"], tf["layers"]):
        for key, jw in jl.items():
            tw = tl[key]
            if isinstance(tw, QTensor):
                assert (tw.k, tw.n) == (jw.k, jw.n), key
                for attr in ("q", "scale", "bias"):
                    np.testing.assert_array_equal(
                        getattr(tw, attr).numpy(),
                        np.asarray(getattr(jw, attr)), err_msg=key)
    lp = p["layers"][0]
    E, Hkv, D = cfg.n_embd, cfg.n_head_kv, cfg.head_dim
    assert (lp["qkv_w"].k, lp["qkv_w"].n) == (E, E + 2 * Hkv * D)
    assert (lp["gu_w"].n, lp["down_w"].k) == (2 * PAD, PAD)
    # the padded SwiGLU lanes are exactly 0 on both kernel routes' plain
    # versions (W4A8 at m 1, W4A16 above)
    F = cfg.n_ff
    for m in (1, 5):
        x = torch.randn(1, m, E, generator=torch.Generator().manual_seed(m))
        gu = qmatmul(x, lp["gu_w"], out_dtype=torch.float32)
        ff = tllama.silu(gu[..., :PAD]) * gu[..., PAD:]
        assert bool((gu[..., F:PAD] == 0).all())
        assert bool((gu[..., PAD + F:] == 0).all())
        assert bool((ff[..., F:] == 0).all()) and bool(ff[..., :F].abs()
                                                       .sum() > 0)


def test_default_pad_rule_at_llama_width():
    def qt(k, n):
        return QTensor("nib4", torch.zeros(k // 2, n, dtype=torch.uint8),
                       torch.ones(k // 32, n), -torch.ones(k // 32, n), k, n,
                       GGMLType.Q4_K)
    lp = {"gate_w": qt(64, 11008), "up_w": qt(64, 11008),
          "down_w": qt(11008, 64)}
    out = tllama.fuse_gate_up({"layers": [lp]})["layers"][0]
    assert (out["gu_w"].k, out["gu_w"].n) == (64, 2 * 11264)
    assert (out["down_w"].k, out["down_w"].n) == (11264, 64)
    assert bool((out["down_w"].scale[11008 // 32:] == 0).all())
    assert bool((out["down_w"].bias[11008 // 32:] == 0).all())
    small = {"gate_w": qt(64, 768), "up_w": qt(64, 768), "down_w": qt(768, 64)}
    out = tllama.fuse_gate_up({"layers": [small]})["layers"][0]
    assert (out["gu_w"].n, out["down_w"].k) == (1536, 768)    # no pad


def _cells_case():
    """A prompt ubatch (sequence 0: 10 tokens, sequence 1: 6, into cells
    0-15 of the shared arena), then a decode-only ubatch of 2 rows (one
    token each, cells 16 and 17). Returns per ubatch (tokens, positions,
    cells, mask) as numpy."""
    n_ctx = CFG["n_ctx"]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, CFG["n_vocab"], 18).astype(np.int32)
    pos = np.array(list(range(10)) + list(range(6)) + [10, 6], np.int32)
    seq = np.array([0] * 10 + [1] * 6 + [0, 1])
    cells = np.arange(18, dtype=np.int32)

    def mask(idx):
        cell_pos = np.full(n_ctx, -1)
        cell_seq = np.zeros(n_ctx, np.int64)
        upto = idx[-1] + 1
        cell_pos[:upto], cell_seq[:upto] = pos[:upto], seq[:upto]
        vis = (cell_seq[None] == seq[idx][:, None]) & (cell_pos[None] >= 0) \
            & (cell_pos[None] <= pos[idx][:, None])
        return np.where(vis, 0.0, -np.inf).astype(np.float32)[None, None]

    pre, dec = np.arange(16), np.arange(16, 18)
    return [(toks[i][None], pos[i][None], cells[i][None], mask(i))
            for i in (pre, dec)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_decode_only_celled_ubatch_matches_reference(kv, fused):
    ubatches = _cells_case()
    cfg, jp = _jax_stacked()
    jcache = jllama.init_cache(cfg, dtype=_kv(kv, True), flat=True)
    ref = []
    with _env(fused):
        for i, (t, pos, cells, m) in enumerate(ubatches):
            lg, jcache = jllama.forward(
                cfg, jp, jnp.asarray(t), jnp.asarray(pos), jcache, 0,
                cells=jnp.asarray(cells), mask=jnp.asarray(m),
                cells_kernel=i == 1)
            ref.append(np.asarray(lg[0]))
    tcfg, tp = port_params()
    cache = tllama.init_cache(tcfg, dtype=_kv(kv, False), device="cpu")
    got = []
    for i, (t, pos, cells, m) in enumerate(ubatches):
        lg, cache = tllama.forward(
            tcfg, tp, torch.from_numpy(t).long(), torch.from_numpy(pos).long(),
            cache, 0, cells=torch.from_numpy(cells).long(),
            mask=torch.from_numpy(m), cells_kernel=i == 1,
            fused_kv_update=fused)
        got.append(lg[0].numpy())
    assert_close_logits(ref, got)
    # the two rows' K/V landed in cells 16 and 17 of every layer
    assert bool(cache.k[:, 0, 16:18].float().abs().sum(-1).gt(0).all())
    assert bool((cache.k[:, 0, 18:].float() == 0).all())


def test_engine_generate_matches_forward_loop():
    cfg, p = port_params()
    prompt = list(range(3, 3 + PROMPT))            # exactly one bucket
    eng = Engine(tllama, cfg, p, n_ctx=128, device="cpu")
    got = eng.generate(prompt, 6, temp=0)
    assert eng.perf.n_prefill == PROMPT and eng.perf.n_decode == 5

    cache = tllama.init_cache(cfg, n_ctx=128, device="cpu")
    lg, cache = tllama.forward(cfg, p, torch.tensor([prompt]),
                               torch.arange(PROMPT)[None], cache, 0)
    want = [int(lg[0, -1].argmax())]
    while len(want) < 6:
        n = PROMPT + len(want) - 1
        lg, cache = tllama.forward(cfg, p, torch.tensor([[want[-1]]]),
                                   torch.tensor([[n]]), cache, n)
        want.append(int(lg[0, -1].argmax()))
    assert got == want
    assert eng.generate(prompt, 6, temp=0, chunk=4) == want   # spans 4, 1
    fused = Engine(tllama, cfg, p, n_ctx=128, device="cpu",
                   fused_kv_update=True, kv_dtype="q8_0")
    assert fused.generate(prompt, 9, temp=0, chunk=4) \
        == fused.generate(prompt, 9, temp=0)
    sampled = eng.generate(prompt, 4, temp=0.8, seed=1)
    assert len(sampled) == 4 and all(0 <= t < cfg.n_vocab for t in sampled)


def test_synthetic_params_device_draw():
    cfg = tllama.LlamaConfig(**dict(CFG, n_ff=1024))
    p = tllama.synthetic_params_device(cfg, seed=3, device="cpu")
    again = tllama.synthetic_params_device(cfg, seed=3, device="cpu")
    lp = p["layers"][1]
    kv = cfg.n_head_kv * cfg.head_dim
    assert (lp["k_w"].k, lp["k_w"].n) == (cfg.n_embd, kv)
    assert (lp["down_w"].k, lp["down_w"].n) == (1024, cfg.n_embd)
    assert lp["q_w"].ggml_type == GGMLType.Q4_K and lp["q_w"].zero == 0
    assert bool((lp["q_w"].scale >= 0).all() and (lp["q_w"].bias <= 0).all())
    assert torch.equal(lp["gate_w"].q, again["layers"][1]["gate_w"].q)
    assert abs(float(p["out_norm"].mean()) - 1.0) < 0.01
    assert p["output"].n == cfg.n_vocab
    with pytest.raises(NotImplementedError):
        tllama.synthetic_params_device(cfg, GGMLType.Q4_0, device="cpu")
    # it runs: the fused, repacked graph on the CPU
    pp = params_repack(tllama.prepare_fused(p))
    cache = tllama.init_cache(cfg, n_ctx=32, device="cpu")
    lg, _ = tllama.forward(cfg, pp, torch.tensor([[1, 2, 3]]),
                           torch.arange(3)[None], cache, 0)
    assert lg.shape == (1, 3, cfg.n_vocab) and bool(torch.isfinite(lg).all())


def test_entry_points_default_to_the_card():
    cfg = tllama.LlamaConfig(**CFG)
    if torch.cuda.is_available():
        assert tllama.init_cache(cfg, n_ctx=8).k.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tllama.init_cache(cfg, n_ctx=8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tllama.synthetic_params_device(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(tllama, cfg, {}, n_ctx=8)
