"""Port parity: the importance matrix (quant/imatrix.py), the weighted
codec helpers and the qmatmul activation hooks.

- The eleven imatrix quantizers bit-equal to the compiled reference's bytes
  (tests/fixtures/golden_imatrix.npz, 4 x 1024) and to the JAX package's
  functions on other random inputs.
- The weighted helpers (_make_qx_quants, _make_qp_quants, quantize_q6_K,
  quantize_iq4_nl with both ntry paths, quantize_iq4_xs) bit-equal to the
  JAX ones with and without qw; qw = None is the x^2 weighting.
- quantize_rows' routing, quantize_requires_imatrix, name_params' names.
- ImatrixCollector on a tiny GPT-2 and a tiny LLaMA, eager, f32, against
  the JAX package's eager collector: every row within 1e-5 relative (both
  prefill attentions f32: the port's is pointed at attention_xla, as the
  reference computes it on the host), the same keys and counts.
- _q8_0_sim bit-equal to the JAX one (ties at half steps included).
- The capture guard: qmatmul refuses an observer or a sim while a stream
  captures, and so does a captured step on the card.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.models import gpt2 as jgpt2
from ggml_imax_tpu.models import llama as jllama
from ggml_imax_tpu.quant import codecs as jcodecs
from ggml_imax_tpu.quant import device as jdev
from ggml_imax_tpu.quant import imatrix as jimx
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.models import gpt2 as tgpt2
from ggml_imax_tpu_torch.models import llama as tllama
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.ops import qmatmul as tqmm
from ggml_imax_tpu_torch.ops.attention import attention_xla
from ggml_imax_tpu_torch.quant import codecs as tcodecs
from ggml_imax_tpu_torch.quant import imatrix as timx
from ggml_imax_tpu_torch.quant.device import QTensor
from ggml_imax_tpu_torch.quant.formats import GGMLType
from ggml_imax_tpu_torch.runtime.engine import CapturedStep

jqmm = importlib.import_module("ggml_imax_tpu.ops.qmatmul")
GOLD = np.load(__file__.rsplit("/", 1)[0] + "/fixtures/golden_imatrix.npz")
CASES = {"Q4_0": "q4_0", "Q4_1": "q4_1", "Q5_0": "q5_0", "Q5_1": "q5_1",
         "Q2_K": "q2_K", "Q3_K": "q3_K", "Q4_K": "q4_K", "Q5_K": "q5_K",
         "Q6_K": "q6_K", "IQ4_NL": "iq4_nl", "IQ4_XS": "iq4_xs"}
RTOL = 1e-5


@pytest.mark.parametrize("fmt", list(CASES))
def test_imatrix_quantizers_match_golden_bytes(fmt):
    got = timx.quantize_rows(GOLD["x"], GGMLType[fmt], GOLD["qw"])
    np.testing.assert_array_equal(got, GOLD[f"{CASES[fmt]}_bytes"])


@pytest.mark.parametrize("fmt", list(CASES))
def test_imatrix_quantizers_equal_the_jax_ones(fmt):
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((3, 512)) * rng.uniform(0.01, 3, (3, 1))) \
        .astype(np.float32)
    x[1, :40] = 0.0                                  # a dead block
    qw = rng.exponential(1.0, 512).astype(np.float32)
    qw[100:140] = 0.0
    got = timx._IMATRIX_QUANTIZERS[GGMLType[fmt]](x, qw)
    ref = np.asarray(jimx._IMATRIX_QUANTIZERS[JType[fmt]](x, qw))
    np.testing.assert_array_equal(got, ref.reshape(-1))


@pytest.mark.parametrize("nmax", [4, 16, 32])
def test_weighted_make_qx_quants(nmax):
    rng = np.random.default_rng(nmax)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    qw = rng.exponential(1.0, (64, 16)).astype(np.float32)
    for w in (None, qw):
        for a, b in zip(tcodecs._make_qx_quants(x, nmax, w),
                        jcodecs._make_qx_quants(x, nmax, w)):
            np.testing.assert_array_equal(a, b)
    # qw = None is the x^2 weighting
    for a, b in zip(tcodecs._make_qx_quants(x, nmax),
                    tcodecs._make_qx_quants(x, nmax, x * x)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nmax", [15, 63])
def test_make_qp_quants(nmax):
    rng = np.random.default_rng(nmax)
    x = np.abs(rng.standard_normal((64, 8))).astype(np.float32)
    x[3] = 0.0
    qw = rng.exponential(1.0, (64, 8)).astype(np.float32)
    for a, b in zip(tcodecs._make_qp_quants(x, nmax, qw),
                    jcodecs._make_qp_quants(x, nmax, qw)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn,kw", [
    ("quantize_q6_K", {}), ("quantize_iq4_xs", {}),
    ("quantize_iq4_nl", {}), ("quantize_iq4_nl", {"ntry": -1})],
    ids=["q6_K", "iq4_xs", "iq4_nl", "iq4_nl-reference"])
def test_weighted_codecs_equal_the_jax_ones(fn, kw):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(256 * 8).astype(np.float32)
    x[64:160] = 0.0                                  # dead blocks in a row
    qw = rng.exponential(1.0, x.size).astype(np.float32)
    tf, jf = getattr(tcodecs, fn), getattr(jcodecs, fn)
    for w in (None, qw):
        np.testing.assert_array_equal(tf(x, qw=w, **kw),
                                      np.asarray(jf(x, qw=w, **kw)))


def test_iq4_block_scale_weights():
    rng = np.random.default_rng(6)
    xb = rng.standard_normal((40, 32)).astype(np.float32)
    w = rng.exponential(1.0, (40, 32)).astype(np.float32)
    np.testing.assert_array_equal(tcodecs._iq4_block_scale(xb, 7, w),
                                  jcodecs._iq4_block_scale(xb, 7, w))
    np.testing.assert_array_equal(tcodecs._iq4_block_scale(xb),
                                  tcodecs._iq4_block_scale(xb, 7, xb * xb))


def test_quantize_rows_routing():
    x, qw = GOLD["x"], GOLD["qw"]
    # no imatrix path (Q8_0), or no imatrix: the plain codec
    np.testing.assert_array_equal(timx.quantize_rows(x, GGMLType.Q8_0, qw),
                                  tcodecs.quantize(x, GGMLType.Q8_0))
    np.testing.assert_array_equal(timx.quantize_rows(x, GGMLType.Q4_K),
                                  tcodecs.quantize(x, GGMLType.Q4_K))
    # a codebook kind: the grid-search encoder
    from ggml_imax_tpu_torch.quant.iq_encode import quantize_iq
    np.testing.assert_array_equal(
        timx.quantize_rows(x, GGMLType.IQ3_S, qw),
        quantize_iq(x, GGMLType.IQ3_S, qw).reshape(-1))
    for t in GGMLType:
        assert timx.quantize_requires_imatrix(t) == \
            jimx.quantize_requires_imatrix(JType(int(t))), t
    assert [t.name for t in GGMLType if timx.quantize_requires_imatrix(t)] \
        == ["IQ2_XXS", "IQ2_XS", "IQ1_S"]


# ---- the collector on tiny models

GCFG = dict(n_vocab=64, n_ctx=32, n_embd=32, n_head=2, n_layer=2)
LCFG = dict(n_vocab=96, n_ctx=32, n_embd=64, n_head=2, n_head_kv=1,
            n_layer=2, n_ff=96)


def _names(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _names(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _names(v, out)
    elif hasattr(tree, "kind") and hasattr(tree, "name"):
        out.append(tree.name)
    return out


def tiny_gpt2():
    cfg = jgpt2.GPT2Config(**GCFG)
    return cfg, tgpt2.GPT2Config(**GCFG), \
        jgpt2.synthetic_params(cfg, JType.Q4_0, seed=3)


def tiny_llama():
    cfg = jllama.LlamaConfig(**LCFG)
    rng = np.random.default_rng(8)
    E, V, F, kv = cfg.n_embd, cfg.n_vocab, cfg.n_ff, cfg.n_head_kv * 32

    def q(k, n):
        return jdev.quantize_for_device(
            (rng.standard_normal((k, n)) * 0.1).astype(np.float32),
            JType.Q8_0)

    def norm(n):
        return jnp.asarray((1 + 0.1 * rng.standard_normal(n))
                           .astype(np.float32))
    p = {"tok_embd": q(E, V), "out_norm": norm(E), "output": q(E, V),
         "layers": [{"attn_norm": norm(E), "q_w": q(E, E), "k_w": q(E, kv),
                     "v_w": q(E, kv), "o_w": q(E, E), "ffn_norm": norm(E),
                     "gate_w": q(E, F), "up_w": q(E, F), "down_w": q(F, E)}
                    for _ in range(cfg.n_layer)]}
    return cfg, tllama.LlamaConfig(**LCFG), p


def test_name_params_equal_the_jax_names():
    for make in (tiny_gpt2, tiny_llama):
        _, _, jp = make()
        jnamed = jimx.name_params(jp)
        tnamed = timx.name_params(params_from_jax(jp, device="cpu"))
        assert _names(tnamed, []) == _names(jnamed, [])
        assert "layers[1].attn_w" in _names(tnamed, []) \
            or "layers[1].q_w" in _names(tnamed, [])


@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_collector_equals_the_jax_collector(model, monkeypatch):
    jmod, tmod, make = {"gpt2": (jgpt2, tgpt2, tiny_gpt2),
                        "llama": (jllama, tllama, tiny_llama)}[model]
    jcfg, tcfg, jp = make()
    jp = jimx.name_params(jp)
    tp = params_from_jax(jp, device="cpu")
    monkeypatch.setattr(tmod, "attention", attention_xla)
    T = 12
    toks = np.random.default_rng(2).integers(0, jcfg.n_vocab, (1, T))
    pos = np.arange(T)[None]
    with jimx.ImatrixCollector() as jcol:
        jmod.forward(jcfg, jp, jnp.asarray(toks, jnp.int32),
                     jnp.asarray(pos, jnp.int32),
                     jmod.init_cache(jcfg, batch=1, dtype=jnp.float32), 0,
                     compute_dtype=jnp.float32)
    with timx.ImatrixCollector() as tcol:
        tmod.forward(tcfg, tp, torch.as_tensor(toks), torch.as_tensor(pos),
                     tmod.init_cache(tcfg, batch=1, dtype=torch.float32,
                                     device="cpu"), 0,
                     compute_dtype=torch.float32)
    assert tqmm._activation_observer is None
    want, got = jcol.matrices(), tcol.matrices()
    assert sorted(got) == sorted(want) and len(got) >= 8
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0,
                                   err_msg=k)
    w = tp["layers"][0][list(tp["layers"][0])[4]]
    assert isinstance(w, QTensor) and tcol.count(w) == T
    np.testing.assert_array_equal(tcol.matrix(w), got[w.name])


def test_collector_without_names_keys_by_object():
    _, tcfg, jp = tiny_gpt2()
    tp = params_from_jax(jp, device="cpu")
    w = tp["layers"][0]["fc_w"]
    x = torch.randn(5, w.k)
    with timx.ImatrixCollector() as col:
        tqmm.qmatmul(x, w)
        tqmm.qmatmul(x[:2], w)
    np.testing.assert_allclose(
        col.matrix(w), (torch.cat([x, x[:2]]) ** 2).mean(0).numpy(),
        rtol=RTOL)
    assert col.count(w) == 7 and list(col.matrices()) == [id(w)]
    assert col.matrix(tp["layers"][0]["out_w"]) is None


def test_q8_0_sim_equals_the_jax_one():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    x[0, 0, :32] = 0.0                                    # d == 0
    x[1, 1, :32] = (np.arange(32) - 15.5) * (127 / 31.5) / 127 * 2
    x[2, 2, 32:64] = np.linspace(-127, 127, 32) / 50      # ties in q
    got = tqmm._q8_0_sim(torch.from_numpy(x))
    ref = np.asarray(jqmm._q8_0_sim(jnp.asarray(x)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    # bf16 inputs go through f32 as in the reference
    xb = torch.from_numpy(x).bfloat16()
    np.testing.assert_array_equal(
        tqmm._q8_0_sim(xb).numpy(),
        np.asarray(jqmm._q8_0_sim(jnp.asarray(xb.float().numpy(),
                                              jnp.bfloat16))))


def test_activation_sim_applies_to_quantized_weights_only():
    _, tcfg, jp = tiny_gpt2()
    tp = params_from_jax(jp, device="cpu")
    w = tp["layers"][0]["fc_w"]
    dense = QTensor("dense", torch.randn(w.k, 16), None, None, w.k, 16,
                    GGMLType.F32)
    x = torch.randn(4, w.k)
    tqmm.set_activation_sim("w4a8")
    try:
        got_q = tqmm.qmatmul(x, w, compute_dtype=torch.float32)
        got_d = tqmm.qmatmul(x, dense, compute_dtype=torch.float32)
    finally:
        tqmm.set_activation_sim(None)
    torch.testing.assert_close(
        got_q, tqmm.qmatmul(tqmm._q8_0_sim(x), w,
                            compute_dtype=torch.float32), rtol=0, atol=0)
    torch.testing.assert_close(
        got_d, tqmm.qmatmul(x, dense, compute_dtype=torch.float32),
        rtol=0, atol=0)
    with pytest.raises(ValueError):
        tqmm.set_activation_sim("w8a8")


def test_capture_guard(monkeypatch):
    _, _, jp = tiny_gpt2()
    w = params_from_jax(jp, device="cpu")["layers"][0]["fc_w"]
    x = torch.randn(1, w.k)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    tqmm.qmatmul(x, w)                       # no hook: nothing to refuse
    ran = []
    step = CapturedStep(lambda: ran.append(1), torch.device("cuda"))
    step.graph = type("G", (), {"replay": lambda self: ran.append(2)})()
    for on, off in ((lambda: tqmm.set_activation_sim("w4a8"),
                     lambda: tqmm.set_activation_sim(None)),
                    (timx.ImatrixCollector().__enter__,
                     lambda: tqmm.set_activation_observer(None))):
        on()
        try:
            with pytest.raises(RuntimeError, match="CUDA graph"):
                tqmm.qmatmul(x, w)
            with pytest.raises(RuntimeError, match="captured step"):
                step()
        finally:
            off()
    assert ran == []
