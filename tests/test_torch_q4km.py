"""Port parity: a LLaMA in llama.cpp's Q4_K_M mix, at a small size (vocab
512, n_embd 256, 2 query heads of 128 over 1 kv head, 2 layers, n_ff 768).

The mix (llama.cpp llama_tensor_get_type / use_more_bits, mid-2024): the
LM head `output` Q6_K; attn_v and ffn_down Q6_K in the layers use_more_bits
picks (i < n/8, i >= 7n/8, or (i - n/8) % 3 == 2; at n 32 16 of 32, at n 2
layer 1 alone); every other weight, tok_embd included, Q4_K. The JAX
package builds the weights (quantize_for_device per tensor type) and the
port takes them over by params_from_jax.

q/k/v of a mixed layer differ in type, so neither package fuses them: the
port's prepare_fused raises ValueError (the JAX package's concat asserts),
and the model is prepared by fuse_gate_up alone (n_ff padded to 1024: the
Q6_K down projection's per-16 int8 rows and the Q4_K gate/up columns),
byte-identical in both packages. The JAX package's unstacked forward takes
gate and up unfused, so it runs the unfused graph (its kernels in
interpret mode through set_force_fused, params_repack_device); the port
runs fuse_gate_up + params_repack (Q4_K natpair, Q6_K nat8 at g 16) with
its plain versions on the CPU. Teacher-forced: a 16-token prefill, then 4
decode steps, the port on the reference's routes (attention, not the
decode kernels, at a decode step). Logits within atol 0.1, argmax equal
wherever the reference's top-2 margin exceeds 0.2 (as
tests/test_torch_llama.py: the largest |logit| is ~5; the prefill attention
is bf16 flash in the port and f32 XLA attention in the reference); with an
f32 prefill attention patched in, every op teacher-forced on the
reference's input within 1e-4 (bf16 KV, see the test). Also: the rule,
synthetic_params_device's per-tensor types and its Q6_K draw, and the
Engine's greedy loop on the mix.
"""
import importlib

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
from ggml_imax_tpu_torch.ops.qmm import params_repack
from ggml_imax_tpu_torch.quant.device import dequantize_qtensor
from ggml_imax_tpu_torch.quant.formats import GGMLType
from ggml_imax_tpu_torch.runtime.engine import Engine

from test_torch_cuda import q4_k_m_types as q4_k_m
from test_torch_cuda import use_more_bits
from test_torch_llama import (_f32_attention, assert_close_logits,
                              teacher_forced)

jqmatmul = importlib.import_module("ggml_imax_tpu.ops.qmatmul")

CFG = dict(n_vocab=512, n_ctx=256, n_embd=256, n_head=2, n_head_kv=1,
           n_layer=2, n_ff=768)
SEED, PROMPT, STEPS, PAD = 13, 16, 4, 1024
ATOL = 0.1


def test_q4_k_m_rule():
    at32 = [li for li in range(32) if use_more_bits(li, 32)]
    assert at32 == [0, 1, 2, 3, 6, 9, 12, 15, 18, 21, 24, 27, 28, 29, 30, 31]
    types = q4_k_m(2)
    assert [types("v_w", li) for li in (0, 1)] == [GGMLType.Q4_K,
                                                   GGMLType.Q6_K]
    assert types("down_w", 1) == types("output", None) == GGMLType.Q6_K
    assert {types(k, li) for k in ("q_w", "k_w", "o_w", "gate_w", "up_w")
            for li in (0, 1)} == {GGMLType.Q4_K}
    assert types("tok_embd", None) == GGMLType.Q4_K


def _jax_raw():
    cfg = jllama.LlamaConfig(**CFG)
    rng = np.random.default_rng(SEED)
    types = q4_k_m(cfg.n_layer)
    E, V, F = cfg.n_embd, cfg.n_vocab, cfg.n_ff
    kv = cfg.n_head_kv * cfg.head_dim

    def q(name, layer, k, n):
        w = (rng.standard_normal((k, n)) * 0.08).astype(np.float32)
        return jdev.quantize_for_device(w, JType(int(types(name, layer))))

    def norm(n):
        return jnp.asarray((1 + 0.1 * rng.standard_normal(n))
                           .astype(np.float32))

    p = {"tok_embd": q("tok_embd", None, E, V), "out_norm": norm(E),
         "output": q("output", None, E, V), "layers": []}
    for li in range(cfg.n_layer):
        p["layers"].append({
            "attn_norm": norm(E), "q_w": q("q_w", li, E, E),
            "k_w": q("k_w", li, E, kv), "v_w": q("v_w", li, E, kv),
            "o_w": q("o_w", li, E, E), "ffn_norm": norm(E),
            "gate_w": q("gate_w", li, E, F), "up_w": q("up_w", li, E, F),
            "down_w": q("down_w", li, F, E)})
    return cfg, p


_RAW = {}


def jax_raw():
    if not _RAW:
        _RAW["v"] = _jax_raw()
    return _RAW["v"]


def port_params(gate_up=True):
    cfg = tllama.LlamaConfig(**CFG)
    p = params_from_jax(jax_raw()[1], device="cpu")
    if gate_up:
        p = tllama.fuse_gate_up(p, pad_multiple=PAD)
    return cfg, params_repack(p)


def _kv(kv, jax_side):
    if kv == "q8_0":
        return kv
    return jnp.bfloat16 if jax_side else torch.bfloat16


def _tokens():
    rng = np.random.default_rng(1)
    return (rng.integers(0, CFG["n_vocab"], PROMPT).astype(np.int32),
            rng.integers(0, CFG["n_vocab"], STEPS).astype(np.int32))


def _jax_logits(kv, prompt, feed):
    cfg, raw = jax_raw()
    p = jpq.params_repack_device(raw)
    cache = jllama.init_cache(cfg, dtype=_kv(kv, True))
    out = []
    jqmatmul.set_force_fused(True)
    try:
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
    finally:
        jqmatmul.set_force_fused(False)
    return out


def _port_logits(kv, prompt, feed, gate_up=True):
    cfg, p = port_params(gate_up)
    cache = tllama.init_cache(cfg, dtype=_kv(kv, False), device="cpu")
    lg, cache = tllama.forward(cfg, p, torch.as_tensor(prompt[None]).long(),
                               torch.arange(PROMPT)[None], cache, 0)
    out = [lg[0].numpy()]
    for i, tok in enumerate(feed):
        n = PROMPT + i
        lg, cache = tllama.forward(cfg, p, torch.tensor([[int(tok)]]),
                                   torch.tensor([[n]]), cache, n)
        out.append(lg[0].numpy())
    return out


_REF = {}


def jax_logits(kv):
    if kv not in _REF:
        _REF[kv] = _jax_logits(kv, *_tokens())
    return _REF[kv]


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_mix_matches_reference_forward(kv, monkeypatch):
    """The port on the routes the reference's unstacked forward takes
    (attention for the decode steps too; the decode kernels' route is held
    to the reference's decode kernels in tests/test_torch_llama.py)."""
    ref = jax_logits(kv)
    monkeypatch.setattr(tllama, "select_decode_path", lambda **kw: "xla")
    got = _port_logits(kv, *_tokens())
    assert len(got) == STEPS + 1
    assert max(float(np.abs(r).max()) for r in ref) > 0.5    # not degenerate
    assert_close_logits(ref, got, atol=ATOL)


@pytest.mark.parametrize("gate_up", [True, False])
def test_mix_matches_reference_with_f32_prefill_attention(gate_up,
                                                          monkeypatch):
    """The Q4_K and Q6_K products, the pads and the norms agree with the
    reference to float rounding once the prefill attention is computed
    alike (f32, bf16 KV) on the reference's routes: every op, teacher-forced
    on the reference's input (test_torch_llama.TeacherForced: without it,
    one activation's bf16 rounding flips between the two libraries on some
    hosts and parts its row's logits by up to 4e-3), within 1e-4 of the
    reference's (seen: 4.3e-6), and so every logit. The unfused graph and
    fuse_gate_up's alike (the fused gate/up product held to the reference's
    two)."""
    monkeypatch.setattr(tllama, "attention", _f32_attention)
    monkeypatch.setattr(tllama, "select_decode_path", lambda **kw: "xla")
    ref, got, tf = teacher_forced(
        monkeypatch, lambda: _jax_logits("bf16", *_tokens()),
        lambda: _port_logits("bf16", *_tokens(), gate_up))
    tf.check(1e-4)
    assert_close_logits(ref, got, atol=1e-4)


def test_fuse_gate_up_on_the_mix_matches_reference():
    cfg, jraw = jax_raw()
    jf = jllama.fuse_gate_up(jraw, pad_multiple=PAD)
    tf = tllama.fuse_gate_up(params_from_jax(jraw, device="cpu"),
                             pad_multiple=PAD)
    assert sorted(tf["layers"][1]) == sorted(jf["layers"][1]) == [
        "attn_norm", "down_w", "ffn_norm", "gu_w", "k_w", "o_w", "q_w", "v_w"]
    for jl, tl in zip(jf["layers"], tf["layers"]):
        for key, jw in jl.items():
            tw = tl[key]
            if not hasattr(jw, "kind"):
                continue
            assert (tw.k, tw.n, tw.kind) == (jw.k, jw.n, jw.kind), key
            for attr in ("q", "scale", "bias"):
                a, b = getattr(tw, attr), getattr(jw, attr)
                assert (a is None) == (b is None), (key, attr)
                if a is not None:
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                                  err_msg=key)
    down = tf["layers"][1]["down_w"]
    assert (down.ggml_type, down.kind, down.k) == (GGMLType.Q6_K, "int8", PAD)
    assert down.scale.shape == (PAD // 16, cfg.n_embd)
    assert bool((down.q[cfg.n_ff:] == 0).all())
    assert bool((down.scale[cfg.n_ff // 16:] == 0).all())


def test_prepare_fused_refuses_the_mix():
    _, jraw = jax_raw()
    p = params_from_jax(jraw, device="cpu")
    with pytest.raises(ValueError, match="layer 1 has q/k/v of types"):
        tllama.prepare_fused(p)
    with pytest.raises(ValueError, match="fuse_gate_up alone"):
        tllama.fuse_qkv(p)
    with pytest.raises(AssertionError):                 # the reference
        jllama.prepare_fused(jraw)
    # the uniform layer 0 alone would fuse; the model is refused whole
    one = dict(p, layers=p["layers"][:1])
    assert "qkv_w" in tllama.fuse_qkv(one)["layers"][0]


def test_repacked_mix_routes():
    cfg, p = port_params()
    l0, l1 = p["layers"]
    for lp in (l0, l1):
        for key in ("q_w", "k_w", "o_w", "gu_w"):
            assert (lp[key].kind, lp[key].q4_layout) == ("nib4", 3), key
    assert (l0["v_w"].q4_layout, l0["down_w"].q4_layout) == (3, 3)
    for w in (l1["v_w"], l1["down_w"], p["output"]):
        assert (w.kind, w.q4_layout, w.k // w.scale.shape[0]) == \
            ("int8", 4, 16)
        assert w.bias is None and w.n % 128 == 0
    assert l1["down_w"].k == l0["down_w"].k == PAD
    # every product of a decode step takes a kernel: 5 a layer + the head
    n_q4k = sum(w.q4_layout == 3 for lp in p["layers"]
                for w in lp.values() if hasattr(w, "q4_layout"))
    n_q6k = sum(w.q4_layout == 4 for lp in p["layers"]
                for w in lp.values() if hasattr(w, "q4_layout")) + 1
    assert (n_q4k, n_q6k) == (5 * 2 - 2 + 2, 3)


def test_synthetic_params_device_types():
    cfg = tllama.LlamaConfig(**CFG)
    types = q4_k_m(cfg.n_layer)
    p = tllama.synthetic_params_device(cfg, seed=4, types=types, device="cpu")
    for name, layer, w in ([("output", None, p["output"]),
                            ("tok_embd", None, p["tok_embd"])]
                           + [(k, li, lp[k]) for li, lp in enumerate(p["layers"])
                              for k in ("q_w", "k_w", "v_w", "o_w", "gate_w",
                                        "up_w", "down_w")]):
        assert w.ggml_type == types(name, layer), (name, layer)
    v = p["layers"][1]["v_w"]
    assert (v.kind, v.q.dtype, v.bias) == ("int8", torch.int8, None)
    assert v.scale.shape == (cfg.n_embd // 16, v.n)
    assert int(v.q.min()) == -32 and int(v.q.max()) == 31
    assert bool((v.scale >= 0).all())
    # the Q6_K weights' spread is near the Q4_K draw's scale of 0.02
    w = dequantize_qtensor(p["output"])
    assert 0.5 * 0.02 < float(w.std()) < 1.5 * 0.02
    # the default stays uniform Q4_K on the same stream (the first draw,
    # tok_embd, is Q4_K either way)
    u = tllama.synthetic_params_device(cfg, seed=4, device="cpu")
    assert torch.equal(u["tok_embd"].q, p["tok_embd"].q)
    assert u["output"].ggml_type == GGMLType.Q4_K
    with pytest.raises(NotImplementedError):
        tllama.synthetic_params_device(
            cfg, types=lambda n, li: GGMLType.Q5_0, device="cpu")
    # fuse_gate_up + repack, then it runs
    pp = params_repack(tllama.fuse_gate_up(p))
    cache = tllama.init_cache(cfg, n_ctx=32, device="cpu")
    lg, _ = tllama.forward(cfg, pp, torch.tensor([[1, 2, 3]]),
                           torch.arange(3)[None], cache, 0)
    assert lg.shape == (1, 3, cfg.n_vocab) and bool(torch.isfinite(lg).all())


def test_engine_greedy_on_the_mix():
    cfg, p = port_params()
    eng = Engine(tllama, cfg, p, n_ctx=64, device="cpu")
    prompt = list(range(5, 5 + PROMPT))
    toks = eng.generate(prompt, 6, temp=0)
    again = eng.generate(prompt, 6, temp=0, chunk=2)
    assert toks == again and len(toks) == 6
    # the first pick is the forward's argmax
    lg, _ = tllama.forward(cfg, p, torch.tensor([prompt]),
                           torch.arange(PROMPT)[None],
                           tllama.init_cache(cfg, n_ctx=64, device="cpu"), 0)
    assert toks[0] == int(lg[0, -1].argmax())
