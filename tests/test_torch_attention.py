"""Port parity: attention. The port's plain decode-attention and flash
versions against the JAX package's Pallas kernels in interpret mode, and
its attention_xla against the reference's, on the same numpy inputs.
Tolerances are the JAX package's own: atol 2e-2 for decode attention
(tests/test_stacked_decode.py), NMSE < 5e-5 for flash
(tests/test_flash_attention.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.models import common as jcommon
from ggml_imax_tpu.ops import attention as jattn
from ggml_imax_tpu.ops import decode_attention as jdec
from ggml_imax_tpu.ops import flash_attention as jflash
from ggml_imax_tpu_torch.models import common as tcommon
from ggml_imax_tpu_torch.ops import attention as tattn
from ggml_imax_tpu_torch.ops import decode_attention as tdec
from ggml_imax_tpu_torch.ops import flash_attention as tflash

T = torch.from_numpy


def nmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2) / (np.mean(a * a) + 1e-30))


def bf16_inputs(rng, *shapes):
    """Random inputs already on the bf16 grid, as numpy f32."""
    return [np.array(jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
                       .astype(jnp.float32)) for s in shapes]


# hq, hkv, D, and a batch row that sees no key (the mean of V), or None
DECODE_CASES = {"": (2, 2, 128, None), "gqa-8-2-d256": (8, 2, 256, None),
                "masked-row": (2, 2, 128, 1)}


@pytest.mark.parametrize("kv,case", [
    pytest.param(kv, case, id=f"{kv}-{case}" if case else kv)
    for case in DECODE_CASES for kv in ("bf16", "q8_0")])
def test_decode_attention_plain_matches_kernel(kv, case):
    Hq, H, D, masked_row = DECODE_CASES[case]
    L, B, N = 2, 2, 256
    n_past = 200
    rng = np.random.default_rng(0)
    jd, td = (jnp.bfloat16, torch.bfloat16) if kv == "bf16" else ("q8_0",) * 2
    jc = jcommon.init_kv_cache(L, B, N, H, D, jd, flat=True)
    tc = tcommon.init_kv_cache(L, B, N, H, D, td, device="cpu")
    k, v = (rng.standard_normal((B, n_past + 1, H, D)).astype(np.float32) * 0.5
            for _ in range(2))
    for li in range(L):
        jc = jcommon.update_kv(jc, li, jnp.asarray(k), jnp.asarray(v), 0)
        tcommon.update_kv(tc, li, T(k), T(v), 0)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    pos = np.full((B, 1), n_past, np.int32)
    jmask = jcommon.attention_mask(jnp.asarray(pos), N, n_past)
    tmask = tcommon.attention_mask(T(pos).long(), N, n_past)
    if masked_row is not None:
        jmask = jmask.at[masked_row].set(-jnp.inf)
        tmask[masked_row] = float("-inf")
    for li in range(L):
        ref = jdec.decode_attention_stacked(jc, li, jnp.asarray(q), jmask,
                                            interpret=True)
        got = tdec.decode_attention(tc, li, T(q), tmask)
        assert got.shape == (B, 1, Hq, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=2e-2)


CASES = [
    # b, tq, tk, hq, hkv, d, extra
    (1, 16, 48, 4, 4, 64, {}),
    (2, 32, 64, 8, 2, 64, {}),                    # GQA 4x
    (1, 130, 130, 2, 2, 128, {}),                 # ragged blocks
    (1, 64, 256, 2, 2, 256, {}),                  # GPT-J head size
    (1, 16, 32, 2, 2, 64, {"logit_softcap": 30.0}),
    (1, 16, 16, 8, 8, 64, {"max_bias": 8.0}),
]


@pytest.mark.parametrize("b,tq,tk,hq,hkv,d,extra", CASES)
def test_flash_plain_matches_kernel(b, tq, tk, hq, hkv, d, extra):
    rng = np.random.default_rng(1)
    q, k, v = bf16_inputs(rng, (b, tq, hq, d), (b, tk, hkv, d), (b, tk, hkv, d))
    if extra.get("max_bias"):
        dist = (np.arange(tk)[None, :] - np.arange(tq)[:, None]
                - (tk - tq)).astype(np.float32)
        mask = np.where(dist > 0, -np.inf, dist)[None, None]
    else:
        mask = np.array(jattn.causal_mask(tq, tk, tk - tq))[None, None]
    mask = mask.astype(np.float32)
    ref = jflash.flash_attention(jnp.asarray(q, jnp.bfloat16),
                                 jnp.asarray(k, jnp.bfloat16),
                                 jnp.asarray(v, jnp.bfloat16),
                                 jnp.asarray(mask), out_dtype=jnp.float32,
                                 block_q=64, block_k=128, interpret=True,
                                 **extra)
    got = tflash.flash_attention(T(q), T(k), T(v), T(mask),
                                 out_dtype=torch.float32, **extra)
    assert got.shape == (b, tq, hq, d)
    assert nmse(ref, got.numpy()) < 5e-5


def test_flash_lse_matches_kernel():
    rng = np.random.default_rng(2)
    q, k, v = bf16_inputs(rng, (1, 24, 2, 64), (1, 40, 2, 64), (1, 40, 2, 64))
    mask = np.array(jattn.causal_mask(24, 40, 16))[None, None]
    _, ref_lse = jflash._flash(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(mask), scale=0.125,
        max_bias=0.0, logit_softcap=0.0, out_dtype=jnp.float32, block_q=64,
        block_k=128, interpret=True, want_lse=True)
    _, lse = tflash.flash_attention(T(q), T(k), T(v), T(mask), scale=0.125,
                                    want_lse=True)
    ref = np.asarray(ref_lse)[:, :24, 0].reshape(1, 2, 24)
    np.testing.assert_allclose(lse.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tq", [1, 8])
def test_attention_xla_and_dispatch_match_reference(tq):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, tq, 4, 64), (1, 32, 2, 64), (1, 32, 2, 64)))
    mask = np.array(jattn.causal_mask(tq, 32, 32 - tq))[None, None]
    ref = jattn.attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), precision="highest")
    got = tattn.attention_xla(T(q), T(k), T(v), T(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    # the dispatcher: attention_xla for one query, flash for several
    via = tflash.attention(T(q), T(k), T(v), T(mask), out_dtype=torch.float32)
    want = got if tq == 1 else tflash.flash_attention(
        T(q), T(k), T(v), T(mask), out_dtype=torch.float32)
    np.testing.assert_array_equal(via.numpy(), want.numpy())
