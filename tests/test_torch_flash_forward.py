"""The flash forward's padded keys and tile skip (ops/flash_attention.py,
csrc/flash_attention.cu), on the CPU.

- `padded_keys` is the JAX `_flash`'s tk at its default block_k of 512.
- A query row that sees no key, at a ragged Tk: the port's `flash_attention`
  (its plain forward) against the JAX package's `flash_attention` (out) and
  `_flash` (lse) at block_k 512, whose Pallas kernel runs in interpret mode,
  with and without ALiBi and with GQA. The reference averages such a row's
  v over its tk padded keys. NMSE < 5e-5 on out (whole and the masked row;
  tests/test_flash_attention.py's tolerance), 1e-5 on lse.
- The kernel's walk on the plain side: the scores of the tiles the kernel
  skips (`skipped_tiles_plain`) removed, then each row brought to its final
  max with the skipped keys at P = bf16(exp(sneg - m2)) (their V summed)
  and the padded keys counted. It equals `flash_attention_plain` bit for
  bit on every row with a visible key, and to 1e-6 on a row with none (its
  V sum is taken in another order), under the causal prefill mask, a
  sliding window, a mixed serving ubatch's cell mask and ALiBi.
- Gradients end to end: `torch.autograd` through the port's
  `flash_attention` against `jax.grad` through the JAX one (interpret mode)
  at Tk 200 with a masked row, within 1e-2 of each gradient's largest
  magnitude (tests/test_torch_flash_backward.py's tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.ops import flash_attention as jflash
from ggml_imax_tpu_torch.models.common import cells_attention_mask
from ggml_imax_tpu_torch.ops import flash_attention as tflash
from ggml_imax_tpu_torch.ops import flash_backward as tfb
from ggml_imax_tpu_torch.ops.decode_attention import NEG
from ggml_imax_tpu_torch.runtime.batched import MAX_SEQ

T = torch.from_numpy
ROW = 3                                   # the query row that sees no key


def nmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2) / (np.mean(a * a) + 1e-30))


@pytest.mark.parametrize("tk,want", [(1, 128), (127, 128), (128, 128),
                                     (200, 256), (512, 512), (600, 1024),
                                     (2048, 2048)])
def test_padded_keys_is_the_reference_tk(tk, want):
    bk = min(512, jflash._round_up(tk, 128))           # _flash's own steps
    assert tflash.padded_keys(tk) == jflash._round_up(tk, bk) == want


def masked_row_inputs(tk, d, hq, hkv, alibi, seed=7):
    """bf16-grid q/k/v (1, 8, hq, d) / (1, tk, hkv, d), a causal mask over
    the last 8 keys (key distances under ALiBi) with row ROW hidden."""
    rng = np.random.default_rng(seed)
    q, k, v = (np.array(jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
                        .astype(jnp.float32))
               for s in ((1, 8, hq, d), (1, tk, hkv, d), (1, tk, hkv, d)))
    dist = (np.arange(tk)[None, :] - np.arange(8)[:, None]
            - (tk - 8)).astype(np.float32)
    mask = np.where(dist > 0, -np.inf, dist if alibi else 0.0)
    mask[ROW] = -np.inf
    return q, k, v, mask[None, None].astype(np.float32)


@pytest.mark.parametrize("tk", [200, 300, 600])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("hq,hkv,alibi", [(2, 2, False), (2, 2, True),
                                          (4, 2, False)],
                         ids=["plain", "alibi", "gqa"])
def test_masked_row_matches_reference(tk, d, hq, hkv, alibi):
    q, k, v, mask = masked_row_inputs(tk, d, hq, hkv, alibi)
    kw = {"max_bias": 8.0} if alibi else {}
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jflash.flash_attention(
        jq, jk, jv, jnp.asarray(mask), out_dtype=jnp.float32,
        interpret=True, **kw))
    _, ref_lse = jflash._flash(
        jq, jk, jv, jnp.asarray(mask), scale=1 / np.sqrt(d),
        max_bias=kw.get("max_bias", 0.0), logit_softcap=0.0,
        out_dtype=jnp.float32, block_q=256, block_k=512, interpret=True,
        want_lse=True)
    ref_lse = np.asarray(ref_lse)[:, :8, 0].reshape(1, hq, 8)
    out, lse = tflash.flash_attention(T(q), T(k), T(v), T(mask),
                                      out_dtype=torch.float32, want_lse=True,
                                      **kw)
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert nmse(ref, out.numpy()) < 5e-5
    assert nmse(ref[:, ROW], out[:, ROW].numpy()) < 5e-5
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-5, atol=1e-5)


def mixed_ubatch_mask(n_ctx, nb):
    """The cell mask (1, 1, nb, n_ctx) of chip_smoke.py's mixed serving
    ubatch (the same registry and seed): 7 sequences decoding, a new
    request's 100-token prompt chunk, pad rows up to nb that see no cell."""
    rng = np.random.default_rng(3)
    cell_pos = np.full(n_ctx, -1, np.int64)
    cell_seq = np.zeros(n_ctx, np.int64)
    tok_pos, tok_seq, head = [], [], 0
    for s, n in enumerate(rng.integers(64, 128, 7) + rng.integers(0, 32, 7)):
        cell_pos[head:head + n + 1] = np.arange(n + 1)
        cell_seq[head:head + n + 1] = 1 << s
        tok_pos.append(n)
        tok_seq.append(s)
        head += n + 1
    cell_pos[head:head + 100] = np.arange(100)
    cell_seq[head:head + 100] = 1 << 7
    tok_pos += range(100)
    tok_seq += [7] * 100
    pad = nb - len(tok_pos)
    tok_pos += [0] * pad
    tok_seq += [MAX_SEQ - 1] * pad
    return cells_attention_mask(*(torch.as_tensor(np.asarray(a))[None]
                                  for a in (tok_pos, tok_seq, cell_pos,
                                            cell_seq)))


def skip_applied(qb, kb, vb, m3, slopes, scale):
    """The kernel's walk on the plain side: (out, lse) with the skipped
    tiles' scores removed and the rows brought back as the kernel does."""
    B, Tq, Hq, _ = qb.shape
    Tk = kb.shape[1]
    rep = Hq // kb.shape[2]
    skip = tflash.skipped_tiles_plain(tfb.backward_tile_map_plain(m3),
                                      slopes, Hq)
    skip = skip.repeat_interleave(tfb.TILE, 2).repeat_interleave(
        tfb.TILE, 3)[:, :, :Tq, :Tk]
    qf = qb.float().transpose(1, 2)
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(rep, dim=1)
              for t in (kb, vb))
    mb = m3[:, None]
    if slopes is not None:
        mb = mb * slopes.reshape(1, Hq, 1, 1)
    s = torch.clamp(qf @ kf.transpose(-1, -2) * scale + mb, min=NEG)
    s = s.masked_fill(skip, float("-inf"))
    m = torch.clamp(s.amax(-1, keepdim=True), min=NEG)
    p = torch.exp(s - m)
    acc, l = p.to(torch.bfloat16).float() @ vf, p.sum(-1, keepdim=True)
    sneg = tflash.masked_score(slopes, Hq)
    left = skip.sum(-1, keepdim=True) + tflash.padded_keys(Tk) - Tk
    m2 = torch.where(left > 0, torch.clamp(m, min=sneg), m)
    alpha = torch.exp(m - m2)
    beta = torch.where(left > 0, torch.exp(sneg - m2), 0.0)
    acc = acc * alpha + beta.to(torch.bfloat16).float() * (skip.float() @ vf)
    l = torch.clamp(l * alpha + left * beta, min=1e-30)
    return (acc / l).transpose(1, 2), (m2 + torch.log(l))[..., 0]


def skip_case(kind, seed=11):
    """(q, k, v, additive mask, max_bias) for one mask kind."""
    rng = np.random.default_rng(seed)
    if kind == "serving":
        mask, B, Hq, Hkv, D = mixed_ubatch_mask(2048, 128), 1, 2, 2, 32
        Tq, Tk = mask.shape[2:]
    else:
        B, Tq, Tk, Hq, Hkv, D = {"causal": (2, 256, 256, 2, 2, 32),
                                 "window": (1, 300, 300, 4, 2, 32),
                                 "alibi": (1, 200, 200, 4, 4, 32)}[kind]
        i = np.arange(Tq)[:, None] + (Tk - Tq)
        j = np.arange(Tk)[None, :]
        vis = (j <= i) & (j > i - 70) if kind == "window" else j <= i
        fill = (j - i).astype(np.float32) if kind == "alibi" else 0.0
        m = np.where(vis, fill, -np.inf).astype(np.float32)
        if kind != "causal":
            m[5] = -np.inf                  # a row that sees no key
        mask = T(np.broadcast_to(m, (B, 1, Tq, Tk)).copy())
    q, k, v = (T(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Tq, Hq, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D)))
    return q, k, v, mask, 8.0 if kind == "alibi" else 0.0


@pytest.mark.parametrize("kind", ["causal", "window", "serving", "alibi"])
def test_skipping_tiles_leaves_the_plain_forward(kind):
    q, k, v, mask, max_bias = skip_case(kind)
    qb, kb, vb, m3, slopes = tflash._prep(q, k, v, mask, max_bias)
    scale = 1 / np.sqrt(q.shape[-1])
    tiles = tfb.backward_tile_map_plain(m3)
    assert bool((tiles == tfb.TILE_NEG).any())
    got, got_lse = skip_applied(qb, kb, vb, m3, slopes, scale)
    want, want_lse = tflash.flash_attention_plain(qb, kb, vb, m3, slopes,
                                                  scale, 0.0, True)
    seen = (m3 > NEG).any(-1)                             # (B, Tq)
    assert bool(seen.any())
    assert torch.equal(got[seen], want[seen])
    assert torch.equal(got_lse.transpose(1, 2)[seen],
                       want_lse.transpose(1, 2)[seen])
    if kind != "causal":
        assert not bool(seen.all())                      # rows with no key
        big = float(want.abs().max())
        torch.testing.assert_close(got[~seen], want[~seen], rtol=0,
                                   atol=1e-6 * big)
        torch.testing.assert_close(got_lse, want_lse, rtol=1e-6, atol=0)


def test_grads_with_a_masked_row_match_reference():
    q, k, v, mask = masked_row_inputs(200, 32, 4, 2, False, seed=5)
    g = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v):
        o = jflash.flash_attention(q, k, v, jnp.asarray(mask),
                                   out_dtype=jnp.float32, interpret=True)
        return jnp.sum(o * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    args = [T(a).requires_grad_(True) for a in (q, k, v)]
    out = tflash.flash_attention(*args, T(mask), out_dtype=torch.float32)
    (out * T(g)).sum().backward()
    for name, a, w in zip("qkv", args, want):
        w = np.asarray(w)
        assert a.grad.shape == w.shape and bool(torch.isfinite(a.grad).all())
        err = np.abs(a.grad.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-2, f"d{name}: {err:.3e}"
