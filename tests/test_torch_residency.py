"""Port parity: Engine(residency="q4-fused" | "q4-stacked") against the JAX
package's Engine with the same residency, on the host.

Each residency builds its graph from unprepared params: "q4-fused" the
model's prepare_fused (or fuse_qkv), then params_repack; "q4-stacked" the
same with the fused KV-update route (the JAX package stacks the layers,
keeps a flat arena and, with GGML_FUSED_KV_UPDATE=1, writes each step's
K/V inside its attention kernel). The two packages' prepare_fused build
different graphs (the port's GPT-J also fuses fc_in and out/fc_out), so
logits are held, not parameter keys: teacher-forced, a 16-token prefill and
4 decode steps fed the same tokens, on a tiny GPT-J Q4_0, LLaMA Q4_K and
GPT-2 Q8_0, the JAX side with its kernels in interpret mode
(set_force_fused). Logits within ATOL of each other, as
tests/test_torch_gptj.py and tests/test_torch_llama.py hold the same
models (the prefill attention is bf16 flash in the port and f32 XLA
attention in the reference; seen: GPT-J 1.2e-2, LLaMA 6.1e-2, GPT-2
1.1e-2 of largest logits 1.4, 5.2, 1.2), and the argmax
equal wherever the reference's top-2 margin clears twice the forward's
difference. The reference's LLaMA "q4-fused" raises (its unstacked
forward cannot read the fused gate/up), so the port's is held to its
stacked engine with the fused KV update off. Also: the decode attention
each residency takes, GPT-2's
q4-stacked equal to its q4-fused bit for bit (it has no fused route), and
the ValueError for params already repacked.
"""
import importlib
import os

import numpy as np
import pytest

from ggml_imax_tpu.models import gpt2 as jgpt2
from ggml_imax_tpu.models import gptj as jgptj
from ggml_imax_tpu.models import llama as jllama
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu.runtime.engine import Engine as JEngine
from ggml_imax_tpu_torch.models import gpt2 as tgpt2
from ggml_imax_tpu_torch.models import gptj as tgptj
from ggml_imax_tpu_torch.models import llama as tllama
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.ops.qmm import params_repack
from ggml_imax_tpu_torch.runtime.engine import Engine

import test_torch_llama

jqmatmul = importlib.import_module("ggml_imax_tpu.ops.qmatmul")

PROMPT, STEPS = 16, 4
GPTJ = dict(n_vocab=512, n_ctx=64, n_embd=256, n_head=2, n_layer=2, n_rot=64)
GPT2 = dict(n_vocab=640, n_ctx=64, n_embd=256, n_head=4, n_layer=2)
# the largest |logit diff| allowed, by model
ATOL = {"gptj": 5e-2, "llama": 0.1, "gpt2": 5e-2}


def _raw(name):
    if name == "gptj":
        cfg = jgptj.GPTJConfig(**GPTJ)
        return cfg, jgptj.synthetic_params(cfg, JType.Q4_0, seed=9)
    if name == "gpt2":
        cfg = jgpt2.GPT2Config(**GPT2)
        return cfg, jgpt2.synthetic_params(cfg, JType.Q8_0, seed=9)
    return test_torch_llama.jax_raw()


# model -> (JAX module, port module, port config class, config)
MODELS = {"gptj": (jgptj, tgptj, tgptj.GPTJConfig, GPTJ),
          "gpt2": (jgpt2, tgpt2, tgpt2.GPT2Config, GPT2),
          "llama": (jllama, tllama, tllama.LlamaConfig, test_torch_llama.CFG)}
_RAW = {}


def raw(name):
    if name not in _RAW:
        _RAW[name] = _raw(name)
    return _RAW[name]


def _tokens(n_vocab):
    rng = np.random.default_rng(2)
    return (rng.integers(0, n_vocab, PROMPT).astype(np.int32),
            rng.integers(0, n_vocab, STEPS).astype(np.int32))


def teacher_forced(eng, prompt, feed):
    """A prefill and len(feed) decode steps fed `feed`: every forward's
    logits (V,) as numpy."""
    cache = eng.new_cache()
    lg, cache = eng.prefill(cache, prompt[None])
    out = [np.asarray(lg[0], np.float32)]
    for i, tok in enumerate(feed):
        lg, cache = eng.decode_step(cache, np.asarray([tok], np.int32),
                                    PROMPT + i)
        out.append(np.asarray(lg[0], np.float32))
    return out


class _fused_env:
    """The reference's fused KV-update route and kernels for the block."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.old = os.environ.get("GGML_FUSED_KV_UPDATE")
        os.environ["GGML_FUSED_KV_UPDATE"] = "1" if self.on else "0"
        jqmatmul.set_force_fused(True)

    def __exit__(self, *exc):
        jqmatmul.set_force_fused(False)
        if self.old is None:
            os.environ.pop("GGML_FUSED_KV_UPDATE")
        else:
            os.environ["GGML_FUSED_KV_UPDATE"] = self.old


def jax_logits(name, residency):
    """The reference's logits. Its LLaMA "q4-fused" cannot run: its
    unstacked forward reads gate_w/up_w, which its prepare_fused has fused
    into gu_w (KeyError; ROADMAP Queue 3). There the reference is its
    stacked engine over the same graph with the fused KV update off, which
    takes the decode attention kernel, as the port's "q4-fused" does."""
    jmod, _, _, kw = MODELS[name]
    cfg, p = raw(name)
    fused = residency == "q4-stacked"
    if name == "llama":
        residency = "q4-stacked"
    with _fused_env(fused):
        eng = JEngine(jmod, cfg, p, residency=residency, n_ctx=64)
        return teacher_forced(eng, *_tokens(kw["n_vocab"]))


def port_engine(name, residency):
    _, tmod, tcfg, kw = MODELS[name]
    cfg = tcfg(**kw)
    p = params_from_jax(raw(name)[1], device="cpu")
    return Engine(tmod, cfg, p, residency=residency, n_ctx=64, device="cpu")


def assert_close(ref, got, atol):
    diffs = [float(np.abs(g - r).max()) for g, r in zip(got, ref)]
    assert max(diffs) <= atol, diffs
    for r, g, d in zip(ref, got, diffs):
        top2 = np.sort(r)[-2:]
        if top2[1] - top2[0] > 2 * d:
            assert int(np.argmax(g)) == int(np.argmax(r))
    return diffs


@pytest.mark.parametrize("residency", ["q4-fused", "q4-stacked"])
@pytest.mark.parametrize("name", ["gptj", "llama", "gpt2"])
def test_residency_matches_reference(name, residency, monkeypatch):
    ref = jax_logits(name, residency)
    eng = port_engine(name, residency)
    fused_route = residency == "q4-stacked" and name != "gpt2"
    assert eng.fused_kv_update == fused_route
    _, tmod, _, kw = MODELS[name]
    # every QTensor the products read is repacked; the graph is prepared
    layer = eng.params["layers"][0]
    assert all(w.interleaved_bk > 0 for w in layer.values()
               if hasattr(w, "interleaved_bk") and w.kind != "dense")
    if name == "gptj":
        assert "qkvf_w" in layer and "of_w" in layer
    if name == "llama":
        assert "qkv_w" in layer and "gu_w" in layer
    calls = {"decode_attention": 0, "decode_attention_update": 0}
    if name != "gpt2":
        for route in calls:
            real = getattr(tmod, route)

            def counted(*a, _route=route, _real=real, **k):
                calls[_route] += 1
                return _real(*a, **k)
            monkeypatch.setattr(tmod, route, counted)
    got = teacher_forced(eng, *_tokens(kw["n_vocab"]))
    assert len(got) == len(ref) == STEPS + 1
    assert max(float(np.abs(r).max()) for r in ref) > 0.2   # not degenerate
    assert_close(ref, got, ATOL[name])
    L = kw["n_layer"]
    if name != "gpt2":
        want = "decode_attention_update" if fused_route else \
            "decode_attention"
        assert calls == {k: (STEPS * L if k == want else 0) for k in calls}


def test_gpt2_stacked_equals_fused():
    """GPT-2 has no fused KV-update route (head_dim 64): its q4-stacked is
    its q4-fused, bit for bit."""
    toks = _tokens(GPT2["n_vocab"])
    a = teacher_forced(port_engine("gpt2", "q4-fused"), *toks)
    b = teacher_forced(port_engine("gpt2", "q4-stacked"), *toks)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["gptj", "llama", "gpt2"])
def test_residency_refuses_repacked_params(name):
    _, tmod, tcfg, kw = MODELS[name]
    cfg = tcfg(**kw)
    p = params_from_jax(raw(name)[1], device="cpu")
    prepared = params_repack(tmod.prepare_fused(p, cfg))
    for residency in ("q4-fused", "q4-stacked"):
        with pytest.raises(ValueError, match="already repacked"):
            Engine(tmod, cfg, prepared, residency=residency, device="cpu")
    # the raw params are left as they were
    assert all(w.interleaved_bk == 0 for w in p["layers"][0].values()
               if hasattr(w, "interleaved_bk"))


def test_residency_equals_the_prepared_engine():
    """q4-fused on unprepared params is the engine on prepare_fused +
    params_repack: equal logits, bit for bit (GPT-J)."""
    _, tmod, tcfg, kw = MODELS["gptj"]
    cfg = tcfg(**kw)
    p = params_from_jax(raw("gptj")[1], device="cpu")
    toks = _tokens(kw["n_vocab"])
    a = teacher_forced(port_engine("gptj", "q4-fused"), *toks)
    b = teacher_forced(Engine(tmod, cfg, params_repack(tmod.prepare_fused(
        p, cfg)), n_ctx=64, device="cpu"), *toks)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
