"""Port parity: the GPT-2 training slice as a whole.

A small GPT-2 (vocab 256, n_ctx 64, n_embd 128, 2 heads of 64, 2 layers),
F32 synthetic params from one seed in both packages, batch 2 x 32 tokens,
an f32 KV cache made fresh in each loss call, the mean NLL of
log_softmax(logits) at the targets, compute_dtype f32: the loss of
tools/quality_gate.py's train_model. The JAX side runs `gpt2.forward` with
its module-level `attention` patched (in this test only) to the Pallas
flash attention in interpret mode, so jax.grad goes through the reference's
flash backward kernels; the port runs its plain versions on the CPU. Loss
within 1e-4 relative, every float leaf's gradient within 1e-2 of its
largest magnitude, then 3 Adam steps through each package's `opt` with
per-step losses within 1e-3 relative.

Also: the gradient reaches every float leaf through the in-place writes
into the shared KV arena, with an f32 and with a bf16 arena.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu import optimize as jopt
from ggml_imax_tpu.models import gpt2 as jgpt2
from ggml_imax_tpu.ops import flash_attention as jfa
from ggml_imax_tpu.quant.device import QTensor as JQTensor
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch import optimize as topt
from ggml_imax_tpu_torch.models import gpt2 as tgpt2
from ggml_imax_tpu_torch.quant.formats import GGMLType

CFG = dict(n_vocab=256, n_ctx=64, n_embd=128, n_head=2, n_layer=2)
B, T, SEED = 2, 32, 4


def batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, CFG["n_vocab"], (B, T)),
            rng.integers(0, CFG["n_vocab"], (B, T)))


def port_loss_fn(cfg, toks, tgts, kv_dtype=torch.float32, n_ctx=T):
    toks, tgts = torch.as_tensor(toks), torch.as_tensor(tgts)
    pos = torch.arange(T)[None].expand(B, T)

    def loss(p):
        cache = tgpt2.init_cache(cfg, batch=B, n_ctx=n_ctx, dtype=kv_dtype,
                                 device="cpu")
        logits, _ = tgpt2.forward(cfg, p, toks, pos, cache, 0,
                                  compute_dtype=torch.float32)
        lp = torch.log_softmax(logits, dim=-1)
        return -lp.gather(-1, tgts[..., None]).mean()
    return loss


def jax_loss_fn(cfg, toks, tgts):
    toks, tgts = jnp.asarray(toks, jnp.int32), jnp.asarray(tgts, jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))

    def loss(p):
        cache = jgpt2.init_cache(cfg, batch=B, n_ctx=T, dtype=jnp.float32)
        logits, _ = jgpt2.forward(cfg, p, toks, pos, cache, 0,
                                  compute_dtype=jnp.float32)
        lp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(lp, tgts[..., None], axis=-1).mean()
    return loss


def jax_leaves(tree, like):
    """The JAX tree's float leaves in the order of the port's float_leaves
    over `like` (the same structure)."""
    out = []

    def walk(j, t):
        if isinstance(t, dict):
            for key in t:
                walk(j[key], t[key])
        elif isinstance(t, list):
            for a, b in zip(j, t):
                walk(a, b)
        elif isinstance(j, JQTensor):
            out.append(np.asarray(j.q))
        elif t is not None:
            out.append(np.asarray(j))
    walk(tree, like)
    return out


@pytest.fixture
def flash_in_reference(monkeypatch):
    monkeypatch.setattr(jgpt2, "attention",
                        functools.partial(jfa.attention, impl="flash"))


def test_training_slice_matches_reference(flash_in_reference):
    toks, tgts = batch()
    jcfg, tcfg = jgpt2.GPT2Config(**CFG), tgpt2.GPT2Config(**CFG)
    jp = jgpt2.synthetic_params(jcfg, JType.F32, seed=SEED)
    tp = tgpt2.synthetic_params(tcfg, GGMLType.F32, seed=SEED, device="cpu")
    jloss, tloss = jax_loss_fn(jcfg, toks, tgts), port_loss_fn(tcfg, toks, tgts)

    lj, gj = jax.value_and_grad(jloss)(jp)
    leaves = topt.float_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    lt = tloss(tp)
    gt = torch.autograd.grad(lt, leaves)
    assert abs(float(lt.detach()) - float(lj)) <= 1e-4 * abs(float(lj))
    want = jax_leaves(gj, tp)
    assert len(want) == len(gt) == 4 + 12 * CFG["n_layer"]
    for i, (g, w) in enumerate(zip(gt, want)):
        assert g.shape == w.shape, i
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-2, (i, err)

    losses = {}
    for name, mod, loss, p in (("jax", jopt, jloss, jp),
                               ("port", topt, tloss, tp)):
        po = mod.default_params("adam")
        po.adam = mod.AdamParams(n_iter=3, alpha=1e-3, eps_f=0.0, eps_g=0.0)
        seen = []
        res, _, ctx = mod.opt(loss, p, po,
                              callback=lambda it, f: seen.append(f))
        assert res.name == "DID_NOT_CONVERGE" and ctx.iter == 3
        losses[name] = np.array(seen)
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-3)
    assert losses["port"][-1] < losses["port"][0]


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_grads_reach_every_leaf_through_the_arena(kv_dtype):
    """Each layer writes its k/v into the shared (L, B, n_ctx, H*D) arena
    in place and reads them back for flash attention; the next layer's
    write must not spoil what the backward kept (a bf16 arena's view enters
    the kernel as itself), and every float leaf gets a gradient."""
    cfg = tgpt2.GPT2Config(**CFG)
    p = tgpt2.synthetic_params(cfg, GGMLType.F32, seed=SEED, device="cpu")
    leaves = topt.float_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = port_loss_fn(cfg, *batch(), kv_dtype=kv_dtype, n_ctx=48)(p)
    grads = torch.autograd.grad(loss, leaves)
    assert len(grads) == 4 + 12 * CFG["n_layer"]
    for g in grads:
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    # q, k and v of every layer: the attention columns of attn_w
    E = CFG["n_embd"]
    for lp in p["layers"]:
        (g,) = torch.autograd.grad(port_loss_fn(cfg, *batch(), kv_dtype,
                                                48)(p), lp["attn_w"].q)
        for part in range(3):
            assert float(g[:, part * E:(part + 1) * E].abs().max()) > 0
