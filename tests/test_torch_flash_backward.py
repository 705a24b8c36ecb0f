"""Port parity: gradients through flash attention and the kernel matmul
routes.

- `torch.autograd.grad` through the port's `flash_attention` on the CPU
  (its plain forward and backward) against `jax.grad` through the JAX
  package's, whose Pallas forward and backward kernels run in interpret
  mode: the cases of tests/test_flash_backward.py plus GPT-2-like (D 64) and
  GPT-J-like (D 256) causal ones, loss sum(sin(o)). Both round at the same
  points (bf16 q/k/v/dO, bf16 P and dS before their products, f32 sums), so
  each of dq, dk and dv agrees within 1e-2 of its largest magnitude, tighter
  than the reference suite's 3e-2 against XLA attention. The forward's lse
  agrees within 1e-4.
- Central differences on the port's backward (the counterpart of
  test_flash_grad_central_difference, same tolerance).
- The dequantized-weight VJP of the kernel matmul routes (natpair Q4_0,
  nat8 Q8_0) against jax.grad of the reference's `_qmm_fused`, within 1e-2;
  the frozen weights get no gradient.
- Inference through flash launches nothing more: without grad, no lse.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.ops import flash_attention as jfa
from ggml_imax_tpu.ops import pallas_qmm as jpq
from ggml_imax_tpu.quant import device as jdev
from ggml_imax_tpu.quant.formats import GGMLType
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.ops import flash_attention as tfa
from ggml_imax_tpu_torch.ops import flash_backward as tfb
from ggml_imax_tpu_torch.ops import qmm as tqmm
from ggml_imax_tpu_torch.ops.qmatmul import dequantize, qmatmul

jqmatmul = importlib.import_module("ggml_imax_tpu.ops.qmatmul")

CASES = [
    # B, Tq, Tk, Hq, Hkv, D, causal, softcap, max_bias
    (2, 16, 16, 4, 4, 32, False, 0.0, 0.0),
    (1, 24, 40, 4, 2, 64, True, 0.0, 0.0),    # GQA + rectangular + causal
    (1, 16, 16, 4, 4, 32, True, 5.0, 0.0),    # logit softcap
    (1, 16, 16, 8, 8, 32, True, 0.0, 8.0),    # ALiBi
    (2, 8, 128, 4, 1, 16, False, 0.0, 0.0),   # MQA, long KV
    (2, 32, 32, 4, 4, 64, True, 0.0, 0.0),    # GPT-2-like
    (1, 24, 24, 2, 2, 256, True, 0.0, 0.0),   # GPT-J-like
]
IDS = ["plain", "gqa", "softcap", "alibi", "mqa", "gpt2", "gptj"]


def causal(B, Tq, Tk):
    qp = np.arange(Tq)[:, None] + (Tk - Tq)
    m = np.where(np.arange(Tk)[None, :] <= qp, 0.0, -1e9).astype(np.float32)
    return np.broadcast_to(m[None, None], (B, 1, Tq, Tk)).copy()


def inputs(case, seed):
    B, Tq, Tk, Hq, Hkv, D, is_causal, _, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32)
    return q, k, v, causal(B, Tq, Tk) if is_causal else None


def port_grads(q, k, v, mask, kw):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    mt = None if mask is None else torch.from_numpy(mask)
    o = tfa.flash_attention(qt, kt, vt, mt, out_dtype=torch.float32, **kw)
    return torch.autograd.grad(torch.sin(o).sum(), (qt, kt, vt))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_grads_match_reference_kernels(case):
    softcap, max_bias = case[7], case[8]
    kw = dict(scale=0.25, logit_softcap=softcap, max_bias=max_bias)
    q, k, v, mask = inputs(case, seed=20240816)
    mj = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        o = jfa.flash_attention(q, k, v, mj, out_dtype=jnp.float32, **kw)
        return jnp.sum(jnp.sin(o))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = port_grads(q, k, v, mask, kw)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-2, f"d{name}: {err:.3e}"


@pytest.mark.parametrize("case", CASES[1:4], ids=IDS[1:4])
def test_lse_matches_reference_kernel(case):
    B, Tq, Tk, Hq, Hkv, D, _, softcap, max_bias = case
    q, k, v, mask = inputs(case, seed=3)
    _, lse_j = jfa._flash(*map(jnp.asarray, (q, k, v, mask)), scale=0.25,
                          max_bias=max_bias, logit_softcap=softcap,
                          out_dtype=jnp.float32, block_q=256, block_k=512,
                          interpret=True, want_lse=True)
    lse_j = np.asarray(lse_j)[:, :Tq, 0].reshape(B, Hq, Tq)
    _, lse = tfa.flash_attention(*map(torch.from_numpy, (q, k, v, mask)),
                                 scale=0.25, max_bias=max_bias,
                                 logit_softcap=softcap, want_lse=True)
    assert lse.shape == (B, Hq, Tq)
    np.testing.assert_allclose(lse.numpy(), lse_j, rtol=0, atol=1e-4)


def test_flash_grad_central_difference():
    """Directional central differences along the gradient (a random
    direction's projection drowns in the bf16 forward's noise), as the
    reference's test."""
    rng = np.random.default_rng(20240817)
    B, T, H, D = 1, 16, 2, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, D))
                                .astype(np.float32)) for _ in range(3))
    mask = torch.from_numpy(causal(B, T, T))

    def loss(q, k, v):
        o = tfa.flash_attention(q, k, v, mask, out_dtype=torch.float32)
        return (o * o).sum()

    args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(loss(*args), args)
    eps = 0.125
    with torch.no_grad():
        for i, g in enumerate(grads):
            u = g / g.norm()
            plus = [t + eps * u if j == i else t for j, t in enumerate((q, k, v))]
            minus = [t - eps * u if j == i else t for j, t in enumerate((q, k, v))]
            num = float(loss(*plus) - loss(*minus)) / (2 * eps)
            got = float((g * u).sum())
            assert abs(num - got) / max(1.0, abs(num)) < 5e-2, (i, num, got)


def test_backward_needs_nothing_of_the_forward_but_lse_and_out():
    """flash_attention_bwd (the public entry) on the forward's out and lse
    gives what autograd gives, in the inputs' dtypes."""
    case = CASES[1]
    q, k, v, mask = inputs(case, seed=5)
    qt, kt, vt, mt = map(torch.from_numpy, (q, k, v, mask))
    out, lse = tfa.flash_attention(qt, kt, vt, mt, scale=0.25,
                                   out_dtype=torch.float32, want_lse=True)
    do = torch.from_numpy(np.random.default_rng(6).standard_normal(out.shape)
                          .astype(np.float32))
    got = tfb.flash_attention_bwd(qt.bfloat16(), kt, vt, mt, out, lse, do,
                                  scale=0.25, max_bias=0.0, logit_softcap=0.0)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    args = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    o = tfa.flash_attention(*args, mt, scale=0.25, out_dtype=torch.float32)
    want = torch.autograd.grad(o, args, do)
    torch.testing.assert_close(got[0].float(), want[0].bfloat16().float())
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w)


def test_inference_does_not_take_the_differentiable_forward(monkeypatch):
    calls = []
    real = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a: calls.append(a[-1]) or real(*a))
    q, k, v, mask = map(torch.from_numpy, inputs(CASES[1], seed=1))
    tfa.flash_attention(q, k, v, mask)
    tfa.flash_attention(q.requires_grad_(True), k, v, mask)
    with torch.no_grad():
        tfa.flash_attention(q, k, v, mask)
    assert calls == [False, True, False]          # want_lse only for grad


def qt_pair(fmt, k, n, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    raw = jdev.quantize_for_device(w, GGMLType[fmt])
    j = jpq.params_repack_device({"w": raw})["w"]
    t = tqmm.params_repack({"w": params_from_jax(raw, device="cpu")})["w"]
    return j, t


@pytest.mark.parametrize("fmt,layout,m", [("Q4_0", 3, 4), ("Q4_0", 3, 1),
                                          ("Q8_0", 4, 4), ("Q8_0", 4, 1)])
def test_kernel_route_vjp_matches_reference(fmt, layout, m):
    j, t = qt_pair(fmt, 512, 256, seed=11)
    assert t.q4_layout == layout == j.q4_layout
    x = np.random.default_rng(12).standard_normal((m, 512)).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jnp.sin(
        jqmatmul._qmm_fused(x, j))))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = [a for a in (t.q, t.scale, t.bias) if a is not None]
    y = qmatmul(xt, t, out_dtype=torch.float32)
    assert y.grad_fn is not None
    (got,) = torch.autograd.grad(torch.sin(y).sum(), xt)
    assert not any(a.requires_grad for a in leaves)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-2, err
    # the VJP itself: bf16(dy) @ dequantize(W, bf16)^T with f32 sums
    dy = torch.cos(y.detach())
    ref = dy.bfloat16().float() @ dequantize(t, torch.bfloat16).float().T
    torch.testing.assert_close(got, ref)
