"""Port parity: the quantization quality gate
(ggml_imax_tpu_torch/tools/quality_gate.py and quality_kernel_row.py)
against the JAX package's tools/quality_gate.py, loaded as
tests/test_quality_gate.py loads it.

- markov_corpus (both geometries, several seeds) and language_baselines
  bit-equal;
- AdamW and the warmup-cosine schedule against optax to 1e-6;
- requantize_params' bytes equal for Q4_0, Q4_K and Q2_K;
- eval_paths' PPL and KL within 1e-4 on seeded untrained params, with and
  without the w4a8 sim;
- the first 3 training losses of the 2-layer model within 1e-4;
- the cache refuses params of another vocab;
- quality_kernel_row on the host against the bundle the gate leaves.
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ggml_imax_tpu.models import gpt2 as jgpt2
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.models import gpt2 as tgpt2
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.ops.attention import attention_xla
from ggml_imax_tpu_torch.quant.formats import GGMLType
from ggml_imax_tpu_torch.tools import quality_gate as tqg
from ggml_imax_tpu_torch.tools import quality_kernel_row as tqr

from test_quality_gate import set_mid_language
from test_torch_loaders import assert_same

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def jqg(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["quality_gate.py"])
    spec = importlib.util.spec_from_file_location(
        "qg_under_test", ROOT / "tools" / "quality_gate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def small():
    """The small geometry's language, put back after the test."""
    cfg = tqg.set_language("small")[0]
    yield cfg
    tqg.set_language("small")


@pytest.mark.parametrize("geometry", ["small", "mid"])
def test_language_bit_equal(jqg, small, geometry):
    if geometry == "mid":
        set_mid_language(jqg)
    tqg.set_language(geometry)
    assert tqg.VOCAB == jqg.VOCAB
    np.testing.assert_array_equal(tqg.SUCC_PROBS, jqg.SUCC_PROBS)
    for seed in (0, 1, 3, 99):
        a, b = tqg.markov_corpus(777, seed), jqg.markov_corpus(777, seed)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    held = tqg.markov_corpus(8 * tqg.CTX, seed=99)
    assert tqg.language_baselines(held) == jqg.language_baselines(held)


@pytest.mark.parametrize("steps", [60, 1500, 3000])
def test_schedule_matches_optax(steps):
    peak = 5e-3
    want = optax.warmup_cosine_decay_schedule(0.0, peak, max(40, steps // 20),
                                              steps, peak / 20)
    got = tqg.warmup_cosine_decay_schedule(0.0, peak, max(40, steps // 20),
                                           steps, peak / 20)
    for c in sorted({0, 1, 39, 40, 41, steps // 2, steps - 1, steps,
                     steps + 5} | set(range(0, steps + 1, 7))):
        assert abs(got(c) - float(want(c))) <= 1e-6 * peak, c


def test_adamw_matches_optax():
    """20 steps of AdamW on a small tree, a schedule that warms up over 5
    steps and decays over the rest: every leaf within 1e-6."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b": rng.standard_normal(16).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in tree.items()} for _ in range(20)]
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 5, 20, 5e-4)
    opt = optax.adamw(sched)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    state = opt.init(jp)
    leaves = [torch.from_numpy(tree[k].copy()) for k in ("w", "b")]
    mine = tqg.AdamW(leaves, tqg.warmup_cosine_decay_schedule(
        0.0, 1e-2, 5, 20, 5e-4))
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        mine.step([torch.from_numpy(g[k]) for k in ("w", "b")])
        for x, k in zip(leaves, ("w", "b")):
            np.testing.assert_allclose(x.numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("t", ["Q4_0", "Q4_K", "Q2_K"])
def test_requantize_params_bytes_equal(jqg, small, t):
    cfg = small
    jcfg = jgpt2.GPT2Config(**{k: getattr(cfg, k) for k in
                               ("n_vocab", "n_ctx", "n_embd", "n_head",
                                "n_layer")})
    jp = jgpt2.synthetic_params(jcfg, JType.F32, seed=4)
    tp = tgpt2.synthetic_params(cfg, GGMLType.F32, seed=4, device="cpu")
    got = tqg.requantize_params(tp, GGMLType[t])
    want = params_from_jax(jqg.requantize_params(jp, JType[t]),
                           device="cpu")
    assert_same(got, want)
    # Q4_0 takes every weight; the K-quants only K % 256 == 0 (out_w)
    kinds = {lp["out_w"].ggml_type for lp in got["layers"]}
    assert kinds == {GGMLType[t]}


def jax_eval(jqg, jcfg, params, corpus, dtype, ref, sim):
    if sim:
        jqg.qmm.set_activation_sim("w4a8")
    try:
        return jqg.eval_paths(jcfg, params, corpus, compute_dtype=dtype,
                              label="", ref_logits=ref)
    finally:
        jqg.qmm.set_activation_sim(None)


@pytest.mark.parametrize("sim", [False, True])
def test_eval_paths_match_jax(jqg, small, monkeypatch, sim):
    """Seeded untrained params requantized to Q4_0 (the loaded layout: the
    plain route on both sides), f32 compute: PPL within 1e-4 relative,
    KL(f32 dense || this) within 1e-4. The port's gpt2 attention is
    attention_xla, the reference's host attention, as
    tests/test_torch_quant_tools.py holds perplexity."""
    monkeypatch.setattr(tgpt2, "attention", attention_xla)
    cfg = small
    jcfg = jgpt2.GPT2Config(**{k: getattr(cfg, k) for k in
                               ("n_vocab", "n_ctx", "n_embd", "n_head",
                                "n_layer")})
    jp = jgpt2.synthetic_params(jcfg, JType.F32, seed=2)
    tp = tgpt2.synthetic_params(cfg, GGMLType.F32, seed=2,
                                device="cpu")
    held = tqg.markov_corpus(4 * tqg.CTX, seed=99)
    toks = jnp.asarray(held[:tqg.CTX])[None]
    jref, _ = jgpt2.forward(jcfg, jp, toks, jnp.arange(tqg.CTX)[None],
                            jgpt2.init_cache(jcfg, 1, tqg.CTX, jnp.float32),
                            0, compute_dtype=jnp.float32)
    tref = tqg.window_logits(cfg, tp, held, torch.float32)
    jq = jqg.requantize_params(jp, JType.Q4_0)
    tq = tqg.requantize_params(tp, GGMLType.Q4_0)
    want = jax_eval(jqg, jcfg, jq, held, jnp.float32, jref[0], sim)
    if sim:
        got = tqg.sim_eval(cfg, tq, held, tref)
    else:
        got = tqg.eval_paths(cfg, tq, held, compute_dtype=torch.float32,
                             label="", ref_logits=tref)
    assert abs(got[0] - want[0]) <= 1e-4 * want[0], (got, want)
    assert abs(got[1] - want[1]) <= 1e-4, (got, want)
    assert want[1] > 1e-4                  # the quantization shows in KL


class Stop(Exception):
    pass


class JitRecorder:
    """Stands in for the JAX gate module's `jax`: every jitted function's
    third output (the training step's loss) is appended to `losses`; the
    run stops (Stop) once `n` are in."""

    def __init__(self, losses, n):
        self.losses, self.n = losses, n

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        jitted = jax.jit(fn, **kw)

        def run(*args):
            out = jitted(*args)
            self.losses.append(float(out[2]))
            if len(self.losses) == self.n:
                raise Stop
            return out
        return run


def test_first_training_losses_match_jax(jqg, small, monkeypatch):
    """The 2-layer model's first 3 steps of a 60-step run (--fast: F32
    params from seed 0, batches of 8 x 256, AdamW on the warmup-cosine
    schedule): each step's loss within 1e-4 relative. The JAX side's
    attention is its host attention, the port's its plain flash in f32."""
    want, got = [], []
    monkeypatch.setattr(jqg, "jax", JitRecorder(want, 3))
    with pytest.raises(Stop):
        jqg.train_model(jgpt2.GPT2Config(n_vocab=64, n_ctx=256, n_embd=128,
                                         n_head=4, n_layer=2), 60)

    def seen(i, loss):
        got.append(float(loss))
        if len(got) == 3:
            raise Stop
    with pytest.raises(Stop):
        tqg.train_model(small, 60, device="cpu", callback=seen)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0]


def test_cache_refuses_another_vocab(small, tmp_path):
    """Params trained at vocab 64, planted under the mid geometry's key
    (vocab 128): the gate stops instead of scoring them."""
    bad = tgpt2.synthetic_params(tgpt2.GPT2Config(
        n_vocab=64, n_ctx=256, n_embd=64, n_head=2, n_layer=1),
        GGMLType.F32, seed=0, device="cpu")
    cfg, steps, _ = tqg.set_language("mid")
    torch.save(bad, tqg.params_cache_path(tmp_path, cfg, steps))
    with pytest.raises(SystemExit, match="wte vocab 64 != cfg 128"):
        tqg.main(["--geometry", "mid", "--dir", str(tmp_path),
                  "--device", "cpu"])


def test_kernel_row_on_the_host(small, tmp_path, capsys):
    """The gate at --fast (3 steps) leaves the Q4_0 bundle; the kernel row
    decodes the window through the plain versions of the W4A8 route and
    passes its KL gate; its section lands in the gate's table."""
    rc = tqg.main(["--fast", "--steps", "3", "--dir", str(tmp_path),
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert "| Q4_0 (our W4A16 path) |" in out and rc in (0, 1)
    bundle = tqg.bundle_path(tmp_path, GGMLType.Q4_0, False)
    assert bundle.exists() and bundle.with_suffix(".params.pt").exists()
    assert tqr.main(["Q4_0", "--dir", str(tmp_path), "--device",
                     "cpu"]) == 0
    out = capsys.readouterr().out
    assert "| Q4_0 (natpair W4A8) |" in out and "**PASS**" in out
    table = (tmp_path / "QUALITY.md").read_text()
    assert table.count("## Kernel-path rows") == 1
    # the row itself: the window's logits through the repacked weights
    ref = np.load(bundle)
    cfg, params, held, sim, _ = tqr.load_bundle(tmp_path, "Q4_0", False,
                                                torch.device("cpu"))
    toks = torch.from_numpy(held[:cfg.n_ctx].astype(np.int64))
    from ggml_imax_tpu_torch.ops.qmm import params_repack
    row = tqr.kernel_row(cfg, params_repack(params, scale_dtype=torch.bfloat16),
                         toks, sim)
    assert row["pass"] and row["kl"] < tqr.KL_GATE
    assert row["logits"].shape == (cfg.n_ctx, cfg.n_vocab)
    np.testing.assert_array_equal(ref["sim_logits"], sim.numpy())
