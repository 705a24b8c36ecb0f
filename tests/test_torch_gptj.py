"""Port parity: the GPT-J slice as a whole.

The JAX package's stacked forward (its kernels in interpret mode through
set_force_fused) against the port's forward (plain versions on the CPU),
teacher-forced: a 16-token prefill, then 4 decode steps, with bf16 and with
q8_0 KV. Logits within atol 5e-2 (logits are ~1 in magnitude; the prefill
attention is bf16 flash in the port and f32 XLA attention in the
reference), argmax equal wherever the reference's top-2 margin exceeds 0.1.
Also: the Engine's greedy loop, the device default, and that the port
imports nothing of JAX or the JAX package (nor `regex` or `transformers`).
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.models import gptj as jgptj
from ggml_imax_tpu.ops import pallas_qmm as jpq
from ggml_imax_tpu.quant.formats import GGMLType
from ggml_imax_tpu_torch.models import gptj as tgptj
from ggml_imax_tpu_torch.ops.qmm import params_repack
from ggml_imax_tpu_torch.runtime.engine import Engine

jqmatmul = importlib.import_module("ggml_imax_tpu.ops.qmatmul")

CFG = dict(n_vocab=512, n_ctx=256, n_embd=256, n_head=2, n_layer=2, n_rot=64)
SEED, PROMPT, STEPS = 9, 16, 4
REPO = Path(__file__).resolve().parent.parent


def _jax_logits(kv, prompt, feed):
    cfg = jgptj.GPTJConfig(**CFG)
    old = os.environ.get("GGML_FUSE_FF")
    os.environ["GGML_FUSE_FF"] = "1"
    try:
        p = jgptj.synthetic_params(cfg, GGMLType.Q4_0, seed=SEED)
        p = jgptj.fuse_out(jgptj.fuse_qkv(jgptj.split_rope_prep(p, cfg)))
    finally:
        if old is None:
            os.environ.pop("GGML_FUSE_FF")
        else:
            os.environ["GGML_FUSE_FF"] = old
    p = jgptj.stack_model(jpq.params_repack_device(jgptj.pad_lm_head(p)))
    cache = jgptj.init_cache(cfg, dtype=jnp.bfloat16 if kv == "bf16" else kv,
                             flat=True)
    fwd = jax.jit(lambda p, t, pos, c, n: jgptj.forward(cfg, p, t, pos, c, n))
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


def _port_params():
    cfg = tgptj.GPTJConfig(**CFG)
    raw = tgptj.synthetic_params(cfg, seed=SEED, device="cpu")
    return cfg, params_repack(tgptj.prepare_fused(raw, cfg))


def _port_logits(kv, prompt, feed):
    cfg, p = _port_params()
    cache = tgptj.init_cache(cfg, dtype=torch.bfloat16 if kv == "bf16" else kv,
                             device="cpu")
    lg, cache = tgptj.forward(cfg, p, torch.as_tensor(prompt[None]).long(),
                              torch.arange(PROMPT)[None], cache, 0)
    out = [lg[0].numpy()]
    for i, tok in enumerate(feed):
        n = PROMPT + i
        lg, cache = tgptj.forward(cfg, p, torch.tensor([[int(tok)]]),
                                  torch.tensor([[n]]), cache, n)
        out.append(lg[0].numpy())
    return out


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_slice_matches_reference_forward(kv):
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, CFG["n_vocab"], PROMPT).astype(np.int32)
    feed = rng.integers(0, CFG["n_vocab"], STEPS).astype(np.int32)
    ref = _jax_logits(kv, prompt, feed)
    got = _port_logits(kv, prompt, feed)
    assert len(ref) == len(got) == STEPS + 1
    for r, g in zip(ref, got):
        assert g.shape == r.shape and r.shape[-1] == CFG["n_vocab"]
        np.testing.assert_allclose(g, r, rtol=0, atol=5e-2)
        for rr, gg in zip(r.reshape(-1, r.shape[-1]), g.reshape(-1, g.shape[-1])):
            top2 = np.sort(rr)[-2:]
            if top2[1] - top2[0] > 0.1:
                assert int(np.argmax(gg)) == int(np.argmax(rr))


def test_engine_generate_matches_forward_loop():
    cfg, p = _port_params()
    prompt = list(range(3, 3 + PROMPT))            # exactly one bucket
    eng = Engine(tgptj, cfg, p, n_ctx=128, device="cpu")
    got = eng.generate(prompt, 6, temp=0)
    assert eng.perf.n_prefill == PROMPT and eng.perf.n_decode == 5

    cache = tgptj.init_cache(cfg, n_ctx=128, device="cpu")
    lg, cache = tgptj.forward(cfg, p, torch.tensor([prompt]),
                              torch.arange(PROMPT)[None], cache, 0)
    want = [int(lg[0, -1].argmax())]
    while len(want) < 6:
        n = PROMPT + len(want) - 1
        lg, cache = tgptj.forward(cfg, p, torch.tensor([[want[-1]]]),
                                  torch.tensor([[n]]), cache, n)
        want.append(int(lg[0, -1].argmax()))
    assert got == want
    assert eng.generate(prompt, 6, temp=0, chunk=4) == want   # spans 4, 1
    sampled = eng.generate(prompt, 4, temp=0.8, seed=1)
    assert len(sampled) == 4 and all(0 <= t < cfg.n_vocab for t in sampled)


def test_entry_points_default_to_the_card():
    cfg = tgptj.GPTJConfig(**CFG)
    if torch.cuda.is_available():
        assert tgptj.init_cache(cfg, n_ctx=8).k.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tgptj.init_cache(cfg, n_ctx=8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(tgptj, cfg, {}, n_ctx=8)


def test_port_imports_no_jax():
    mods = sorted(
        "ggml_imax_tpu_torch." + ".".join(f.relative_to(
            REPO / "ggml_imax_tpu_torch").with_suffix("").parts)
        for f in (REPO / "ggml_imax_tpu_torch").rglob("*.py")
        if f.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ggml_imax_tpu', 'regex', 'transformers')]\n"
            "assert not bad, bad\nprint(len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 20
    assert {"ggml_imax_tpu_torch.models.gpt2",
            "ggml_imax_tpu_torch.models.llama",
            "ggml_imax_tpu_torch.quant.codecs",
            "ggml_imax_tpu_torch.runtime.batched",
            "ggml_imax_tpu_torch.ops.decode_attention",
            "ggml_imax_tpu_torch.ops.sampling",
            "ggml_imax_tpu_torch.ops.flash_backward",
            "ggml_imax_tpu_torch.optimize",
            "ggml_imax_tpu_torch._build",
            "ggml_imax_tpu_torch.quant.formats",
            "ggml_imax_tpu_torch.quant.device",
            "ggml_imax_tpu_torch.ops.qmm",
            "ggml_imax_tpu_torch.ops.qmatmul",
            "ggml_imax_tpu_torch.ops.embedding",
            "ggml_imax_tpu_torch.audio.wav",
            "ggml_imax_tpu_torch.audio.mel",
            "ggml_imax_tpu_torch.ops.conv",
            "ggml_imax_tpu_torch.models.whisper",
            "ggml_imax_tpu_torch.runtime.whisper_pipeline",
            "ggml_imax_tpu_torch.io.gguf",
            "ggml_imax_tpu_torch.io.legacy_bin",
            "ggml_imax_tpu_torch.tokenizer.bpe",
            "ggml_imax_tpu_torch.ops.softmax",
            "ggml_imax_tpu_torch.ops.tensor_ops",
            "ggml_imax_tpu_torch.ops.ssm",
            "ggml_imax_tpu_torch.ops.moe",
            "ggml_imax_tpu_torch.models.magika",
            "ggml_imax_tpu_torch.models.yolo",
            "ggml_imax_tpu_torch.models.sam"} <= set(mods)
