"""Port parity: the GPT-2 slices as a whole.

A small GPT-2 (n_embd 320, 5 heads of head_dim 64 as in GPT-2 XL, 2 layers,
vocab 1000, n_ctx 64) in Q8_0 and in Q4_0: the JAX package's forward with
its kernels in interpret mode (set_force_fused) against the port's forward
(plain versions on the CPU), teacher-forced: a 16-token prefill, then 3
decode steps. At this width, as at n_embd 1600, only fc_w (N = 4 * n_embd)
passes the N % 128 kernel gate; attn_w, proj_w, out_w and the tied LM
head dequantize. Logits within atol 2e-2 (seen: 7e-3; logits are ~1 in
magnitude; the prefill attention is bf16 flash in the port and f32 XLA
attention in the reference), argmax equal wherever the reference's top-2
margin exceeds 0.1.
The K-quant slice the same way at n_embd 256 (K-quants need K % 256 ==
0), 4 heads of 64: in Q3_K and Q2_K every layer product (attn_w, proj_w,
fc_w, out_w: N 768, 256, 1024, 256) takes the plane-split kernel, as at
117M's n_embd 768; the tied head (N 1000) dequantizes. Same tolerances
(seen: 5.6e-3 with Q3_K, 5.9e-3 with Q2_K).
Also: synthetic_params byte-identical to the reference's, the Engine's
greedy loop, the device default.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.models import gpt2 as jgpt2
from ggml_imax_tpu.ops import pallas_qmm as jpq
from ggml_imax_tpu.quant.device import QTensor as JQTensor
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.models import gpt2 as tgpt2
from ggml_imax_tpu_torch.ops import qmatmul as tqmatmul
from ggml_imax_tpu_torch.ops.qmm import params_repack
from ggml_imax_tpu_torch.quant.formats import GGMLType
from ggml_imax_tpu_torch.runtime.engine import Engine

jqmatmul = importlib.import_module("ggml_imax_tpu.ops.qmatmul")

CFG = dict(n_vocab=1000, n_ctx=64, n_embd=320, n_head=5, n_layer=2)
KCFG = dict(CFG, n_embd=256, n_head=4)
SEED, PROMPT, STEPS = 11, 16, 3


def cfg_for(wtype):
    return KCFG if wtype.endswith("_K") else CFG


def to_np(t):
    if isinstance(t, torch.Tensor):
        return t.numpy()
    return np.asarray(t)


def assert_same_tree(t, j):
    if isinstance(j, dict):
        assert set(t) == set(j)
        for k in j:
            assert_same_tree(t[k], j[k])
    elif isinstance(j, list):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            assert_same_tree(a, b)
    elif isinstance(j, JQTensor):
        for f in ("kind", "k", "n", "zero", "interleaved_bk", "q4_layout"):
            assert getattr(t, f) == getattr(j, f), f
        assert int(t.ggml_type) == int(j.ggml_type)
        for attr in ("q", "scale", "bias"):
            a, b = getattr(t, attr), getattr(j, attr)
            assert (a is None) == (b is None), attr
            if a is not None:
                np.testing.assert_array_equal(to_np(a), to_np(b), err_msg=attr)
    elif j is None:
        assert t is None
    else:
        np.testing.assert_array_equal(to_np(t), to_np(j))


@pytest.mark.parametrize("wtype", ["F32", "Q4_0", "Q8_0", "Q2_K", "Q3_K"])
def test_synthetic_params_bit_exact(wtype):
    cfg = dict(cfg_for(wtype), n_layer=1)
    ref = jgpt2.synthetic_params(jgpt2.GPT2Config(**cfg), JType[wtype], seed=3)
    got = tgpt2.synthetic_params(tgpt2.GPT2Config(**cfg), GGMLType[wtype],
                                 seed=3, device="cpu")
    assert_same_tree(got, ref)


def _jax_logits(wtype, prompt, feed):
    cfg = jgpt2.GPT2Config(**cfg_for(wtype))
    p = jpq.params_repack_device(jgpt2.prepare_fused(
        jgpt2.synthetic_params(cfg, JType[wtype], seed=SEED)))
    cache = jgpt2.init_cache(cfg, dtype=jnp.bfloat16)
    fwd = jax.jit(lambda p, t, pos, c, n: jgpt2.forward(cfg, p, t, pos, c, n))
    jqmatmul.set_force_fused(True)
    try:
        lg, cache = fwd(p, jnp.asarray(prompt[None]),
                        jnp.arange(PROMPT, dtype=jnp.int32)[None], cache, 0)
        out = [np.asarray(lg[0])]
        for i, tok in enumerate(feed):
            n = PROMPT + i
            lg, cache = fwd(p, jnp.asarray([[tok]], jnp.int32),
                            jnp.asarray([[n]], jnp.int32), cache, n)
            out.append(np.asarray(lg[0]))
    finally:
        jqmatmul.set_force_fused(False)
    return out


def _port_params(wtype):
    cfg = tgpt2.GPT2Config(**cfg_for(wtype))
    raw = tgpt2.synthetic_params(cfg, GGMLType[wtype], seed=SEED, device="cpu")
    return cfg, params_repack(tgpt2.prepare_fused(raw, cfg))


def _port_logits(wtype, prompt, feed):
    cfg, p = _port_params(wtype)
    cache = tgpt2.init_cache(cfg, device="cpu")
    lg, cache = tgpt2.forward(cfg, p, torch.as_tensor(prompt[None]).long(),
                              torch.arange(PROMPT)[None], cache, 0)
    out = [lg[0].numpy()]
    for i, tok in enumerate(feed):
        n = PROMPT + i
        lg, cache = tgpt2.forward(cfg, p, torch.tensor([[int(tok)]]),
                                  torch.tensor([[n]]), cache, n)
        out.append(lg[0].numpy())
    return out


@pytest.mark.parametrize("wtype", ["Q8_0", "Q4_0", "Q3_K", "Q2_K"])
def test_slice_matches_reference_forward(wtype, monkeypatch):
    cfg = cfg_for(wtype)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg["n_vocab"], PROMPT).astype(np.int32)
    feed = rng.integers(0, cfg["n_vocab"], STEPS).astype(np.int32)
    # record which weights reach the kernel dispatch
    gated = []
    for name in ("qmatmul_nat8", "qmatmul_natpair", "qmatmul_permuted"):
        real = getattr(tqmatmul, name)
        monkeypatch.setattr(tqmatmul, name, lambda x, qt, real=real:
                            gated.append((qt.k, qt.n)) or real(x, qt))
    ref = _jax_logits(wtype, prompt, feed)
    got = _port_logits(wtype, prompt, feed)
    E = cfg["n_embd"]
    per_layer = [(E, 3 * E), (E, E), (E, 4 * E), (4 * E, E)] \
        if wtype.endswith("_K") else [(E, 4 * E)]
    assert gated == per_layer * cfg["n_layer"] * (STEPS + 1)
    assert len(ref) == len(got) == STEPS + 1
    for r, g in zip(ref, got):
        assert g.shape == r.shape and r.shape[-1] == cfg["n_vocab"]
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-2)
        for rr, gg in zip(r.reshape(-1, r.shape[-1]), g.reshape(-1, g.shape[-1])):
            top2 = np.sort(rr)[-2:]
            if top2[1] - top2[0] > 0.1:
                assert int(np.argmax(gg)) == int(np.argmax(rr))


def test_engine_generate_matches_forward_loop():
    cfg, p = _port_params("Q8_0")
    prompt = list(range(5, 5 + PROMPT))            # exactly one bucket
    eng = Engine(tgpt2, cfg, p, device="cpu")
    got = eng.generate(prompt, 6, temp=0)
    assert eng.perf.n_prefill == PROMPT and eng.perf.n_decode == 5

    cache = tgpt2.init_cache(cfg, device="cpu")
    lg, cache = tgpt2.forward(cfg, p, torch.tensor([prompt]),
                              torch.arange(PROMPT)[None], cache, 0)
    want = [int(lg[0, -1].argmax())]
    while len(want) < 6:
        n = PROMPT + len(want) - 1
        lg, cache = tgpt2.forward(cfg, p, torch.tensor([[want[-1]]]),
                                  torch.tensor([[n]]), cache, n)
        want.append(int(lg[0, -1].argmax()))
    assert got == want


def test_entry_points_default_to_the_card():
    cfg = tgpt2.GPT2Config(**CFG)
    if torch.cuda.is_available():
        assert tgpt2.init_cache(cfg, n_ctx=8).k.device.type == "cuda"
    else:
        for fn in (lambda: tgpt2.init_cache(cfg, n_ctx=8),
                   lambda: tgpt2.synthetic_params(cfg),
                   lambda: tgpt2.synthetic_params_device(cfg)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()
