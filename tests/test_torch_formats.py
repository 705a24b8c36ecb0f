"""Port parity: the float and non-codebook block formats the port took over
last (Q4_1, Q5_0, Q5_1, Q8_1, Q5_K, Q6_K, Q8_K, F16 and BF16).

- Codecs: quantize and dequantize are bit-exact against the JAX package's
  numpy twins (`_QUANTIZERS` / `_DEQUANTIZERS`; its native C++ path is not
  the reference here) on seeds 0-7 of rows with zero blocks, tiny and
  1e5-scaled blocks and half-step ties, on rows of exact half steps, and
  against the compiled reference's golden vectors. F16 and BF16 are bit-
  exact against the JAX package's public quantize / dequantize.
- Layouts: `to_device_format` is byte-identical to the JAX package's (q,
  scale, bias, zero, dtypes) at K 256, 768, 4096 and 11008; Q8_K raises in
  both. `quantize_for_device`, `dequantize_qtensor` and the K pad (Q6_K's
  per-16 int8 down projection 11008 -> 11264) are exact too.
- Repack: `params_repack` is byte-identical to `params_repack_device`,
  with f32 and with bf16 scales: Q4_1 natpair with a bias, Q5_0, Q8_1 (no
  bias), Q5_1, Q5_K (bias) and Q6_K (g 16) nat8, F16 and BF16 dense.
- Ops: `get_rows` and `dequantize` bit-exact on the natural and the
  repacked layouts.
- Small models: a 2-layer GPT-2 (n_embd 256, 4 heads of 64, vocab 1000)
  in each format, built by the JAX package and carried over by
  params_from_jax, through the port's forward (plain versions on the CPU)
  against the JAX package's (its kernels in interpret mode), teacher-
  forced: a 16-token prefill, then 3 decode steps. Logits within atol 2e-2
  (as tests/test_torch_gpt2.py: logits are ~1 in magnitude; the prefill
  attention is bf16 flash in the port and f32 XLA attention in the
  reference), argmax equal wherever the reference's top-2 margin exceeds
  0.1. Every layer product takes a kernel route (N 768, 256, 1024, 256);
  the tied head (N 1000) dequantizes. The port's synthetic_params are
  byte-identical to the reference's with its numpy twins.
"""
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.models import gpt2 as jgpt2
from ggml_imax_tpu.ops import embedding as jemb
from ggml_imax_tpu.ops import pallas_qmm as jpq
from ggml_imax_tpu.quant import codecs as jcodecs
from ggml_imax_tpu.quant import device as jdev
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.models import gpt2 as tgpt2
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.ops import embedding as temb
from ggml_imax_tpu_torch.ops import qmatmul as tqmatmul
from ggml_imax_tpu_torch.ops.qmm import params_repack
from ggml_imax_tpu_torch.quant import codecs as tcodecs
from ggml_imax_tpu_torch.quant import device as tdev
from ggml_imax_tpu_torch.quant.formats import FORMATS, GGMLType

from test_torch_gpt2 import assert_same_tree
from test_torch_kquant import assert_same_qtensor, interesting_data

jqmatmul = importlib.import_module("ggml_imax_tpu.ops.qmatmul")

GOLDEN = Path(__file__).parent / "fixtures" / "golden_quant.npz"
BLOCKS = ["Q4_1", "Q5_0", "Q5_1", "Q8_1", "Q5_K", "Q6_K", "Q8_K"]
# every new format with a device layout
LAID = ["F16", "BF16", "Q4_1", "Q5_0", "Q5_1", "Q8_1", "Q5_K", "Q6_K"]
# (kind, group, bias, zero) of each natural layout
LAYOUT = {"F16": ("dense", None, False, 0), "BF16": ("dense", None, False, 0),
          "Q4_1": ("nib4", 32, True, 0), "Q5_0": ("int8", 32, False, 0),
          "Q5_1": ("int8", 32, True, 0), "Q8_1": ("int8", 32, False, 0),
          "Q5_K": ("int8", 32, True, 0), "Q6_K": ("int8", 16, False, 0)}
CFG = dict(n_vocab=1000, n_ctx=64, n_embd=256, n_head=4, n_layer=2)
SEED, PROMPT, STEPS = 11, 16, 3
ATOL, MARGIN = 2e-2, 0.1


def _block(fmt):
    return FORMATS[GGMLType[fmt]].block_size


def _twin(fmt, x):
    return np.asarray(jcodecs._QUANTIZERS[JType[fmt]](x)).reshape(-1)


# ---- codecs

@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("fmt", BLOCKS)
def test_codec_bit_exact(fmt, seed):
    x = interesting_data(np.random.default_rng(seed), 256 * 16)
    got = tcodecs.quantize(x, GGMLType[fmt])
    ref = _twin(fmt, x)
    assert got.dtype == np.uint8
    assert got.size == x.size // _block(fmt) * FORMATS[GGMLType[fmt]].type_size
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tcodecs.dequantize(got, GGMLType[fmt], shape=(16, 256)),
        jcodecs._DEQUANTIZERS[JType[fmt]](ref).reshape(16, 256))


@pytest.mark.parametrize("fmt", BLOCKS)
def test_codec_bit_exact_on_half_steps(fmt):
    """Rows of exact half steps of a few scales: every rounding rule of the
    format (floor of + 0.5, roundf, round half to even) meets ties."""
    rng = np.random.default_rng(5)
    steps = rng.integers(-40, 41, 256 * 8).astype(np.float32) / 2
    x = steps * np.repeat(np.float32([1, 0.25, 3, 1e-3, 7, 0.5, 2, 1e4]), 256)
    got = tcodecs.quantize(x, GGMLType[fmt])
    np.testing.assert_array_equal(got, _twin(fmt, x))
    np.testing.assert_array_equal(
        tcodecs.dequantize(got, GGMLType[fmt]),
        jcodecs._DEQUANTIZERS[JType[fmt]](got))


@pytest.mark.parametrize("row", ["x", "x2", "x3"])
@pytest.mark.parametrize("fmt", BLOCKS)
def test_codec_matches_golden_vectors(fmt, row):
    gold = np.load(GOLDEN)
    name = fmt[:2].lower() + fmt[2:]                 # "q5_K"
    raw = tcodecs.quantize(gold[row], GGMLType[fmt])
    np.testing.assert_array_equal(raw, gold[f"{row}_{name}_bytes"])
    np.testing.assert_array_equal(tcodecs.dequantize(raw, GGMLType[fmt]),
                                  gold[f"{row}_{name}_dequant"])


@pytest.mark.parametrize("fmt", ["F16", "BF16"])
def test_float_formats_bit_exact(fmt):
    x = interesting_data(np.random.default_rng(3), 1024)
    x[:4] = [np.inf, -np.inf, 65520.0, 1e-40]        # overflow and denormal
    got = tcodecs.quantize(x, GGMLType[fmt])
    ref = np.asarray(jcodecs.quantize(x, JType[fmt]))
    assert got.size == 2 * x.size
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tcodecs.dequantize(got, GGMLType[fmt], shape=(8, 128)),
        np.asarray(jcodecs.dequantize(ref, JType[fmt], shape=(8, 128))))


def test_block_dtypes_match_reference():
    for fmt in BLOCKS:
        assert tcodecs.BLOCK_DTYPES[GGMLType[fmt]] == \
            jcodecs.BLOCK_DTYPES[JType[fmt]], fmt
        assert FORMATS[GGMLType[fmt]].type_size == \
            jcodecs.FORMATS[JType[fmt]].type_size, fmt


# ---- device layouts

def _weight(k, n, seed=0):
    w = (np.random.default_rng(k + n + seed).standard_normal((k, n)) * 0.05) \
        .astype(np.float32)
    w[:, 3] = 0.0                                   # an all-zero column
    w[:, 5] = np.abs(w[:, 5])                       # a min of 0
    return w


def _raw(fmt, w):
    """ggml bytes of w (K, N), rows along K, through the numpy twin."""
    wt = np.ascontiguousarray(w.T)
    if fmt in ("F16", "BF16"):
        return np.asarray(jcodecs.quantize(wt, JType[fmt]))
    return _twin(fmt, wt)


@pytest.mark.parametrize("k", [256, 768, 4096, 11008])
@pytest.mark.parametrize("fmt", LAID)
def test_device_layout_byte_identical(fmt, k):
    n = 8
    w = _weight(k, n)
    raw = _raw(fmt, w)
    got = tdev.to_device_format(raw, GGMLType[fmt], (k, n), device="cpu")
    ref = jdev.to_device_format(raw, JType[fmt], (k, n))
    assert_same_qtensor(got, ref)
    kind, g, bias, zero = LAYOUT[fmt]
    assert (got.kind, got.zero, got.bias is not None) == (kind, zero, bias)
    if g is not None:
        assert got.scale.shape == (k // g, n)
    np.testing.assert_array_equal(tdev.dequantize_qtensor(got).numpy(),
                                  jdev.dequantize_qtensor(ref))
    # and it is the codec's own dequantization, row for row
    np.testing.assert_array_equal(
        tdev.dequantize_qtensor(got).numpy(),
        tcodecs.dequantize(raw, GGMLType[fmt], shape=(n, k)).T)


def test_q8_k_has_no_device_layout_in_either_package():
    raw = tcodecs.quantize(np.ones(512, np.float32), GGMLType.Q8_K)
    with pytest.raises(NotImplementedError):
        tdev.to_device_format(raw, GGMLType.Q8_K, (256, 2), device="cpu")
    with pytest.raises(NotImplementedError):
        jdev.to_device_format(raw, JType.Q8_K, (256, 2))


@pytest.mark.parametrize("fmt", LAID)
def test_quantize_for_device_and_pads(fmt):
    """quantize_for_device through the port's codec equals the reference's
    layout of the twin's bytes; the K pad to 11264 (LLaMA's down
    projection, Q6_K's at g 16) and the N pad are byte-identical, and the
    padded rows and columns decode to 0."""
    k, n = 11008, 8
    w = _weight(k, n, 1)
    got = tdev.quantize_for_device(w, GGMLType[fmt], device="cpu")
    # both through their package's public codec (the native loops)
    ref = jdev.to_device_format(
        np.asarray(jcodecs.quantize(np.ascontiguousarray(w.T), JType[fmt])),
        JType[fmt], (k, n))
    assert_same_qtensor(got, ref)
    if got.kind == "dense":
        return
    gr, kr = tdev.pad_qtensor_rows(got, 1024)
    jr, jkr = jdev.pad_qtensor_rows(ref, 1024)
    assert kr == jkr == 256 and gr.k == 11264
    assert_same_qtensor(gr, jr)
    deq = tdev.dequantize_qtensor(gr)
    assert bool((deq[k:] == 0).all())
    np.testing.assert_array_equal(deq[:k].numpy(),
                                  tdev.dequantize_qtensor(got).numpy())
    gc, nc = tdev.pad_qtensor_cols(got, 128)
    jc, jnc = jdev.pad_qtensor_cols(ref, 128)
    assert nc == jnc == 120
    assert_same_qtensor(gc, jc)
    assert bool((tdev.dequantize_qtensor(gc)[:, n:] == 0).all())


# ---- repack and ops

def _layouts(fmt, scale_dtype):
    """(port, reference) QTensors of one weight: natural and repacked."""
    k, n = 1024, 256
    w = _weight(k, n, 2)
    raw = _raw(fmt, w)
    jn = jdev.to_device_format(raw, JType[fmt], (k, n))
    tn = params_from_jax(jn, device="cpu")
    jsd = None if scale_dtype is None else jnp.bfloat16
    tr = params_repack({"w": tn}, scale_dtype=scale_dtype)["w"]
    jr = jpq.params_repack_device({"w": jn}, scale_dtype=jsd)["w"]
    return (tn, jn), (tr, jr)


def _same_bits(a, b, what):
    a, b = a, np.asarray(b)
    if a.dtype == torch.bfloat16:
        assert b.dtype.name == "bfloat16", what
        np.testing.assert_array_equal(a.view(torch.uint16).numpy(),
                                      b.view(np.uint16), err_msg=what)
    else:
        assert a.numpy().dtype == b.dtype, what
        np.testing.assert_array_equal(a.numpy(), b, err_msg=what)


@pytest.mark.parametrize("scale_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("fmt", LAID)
def test_params_repack_byte_identical(fmt, scale_dtype):
    _, (tr, jr) = _layouts(fmt, scale_dtype)
    for f in ("kind", "k", "n", "zero", "interleaved_bk", "q4_layout"):
        assert getattr(tr, f) == getattr(jr, f), f
    want = {"dense": 0, "nib4": 3, "int8": 4}[LAYOUT[fmt][0]]
    assert tr.q4_layout == want
    for attr in ("q", "scale", "bias"):
        a, b = getattr(tr, attr), getattr(jr, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            _same_bits(a, b, attr)


@pytest.mark.parametrize("repacked", [False, True])
@pytest.mark.parametrize("fmt", LAID)
def test_get_rows_and_dequantize_bit_exact(fmt, repacked):
    pair = _layouts(fmt, torch.bfloat16 if repacked else None)
    t, j = pair[1] if repacked else pair[0]
    ids = np.array([[0, 3, 5, 255], [17, 17, 128, 1]], np.int32)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        _same_bits(temb.get_rows(t, torch.from_numpy(ids).long(), dtype=tdt),
                   jemb.get_rows(j, jnp.asarray(ids), dtype=jdt), "get_rows")
        _same_bits(tqmatmul.dequantize(t, tdt),
                   jqmatmul.dequantize_xla(j, jdt), "dequantize")


# ---- small models

@pytest.mark.parametrize("fmt", LAID)
def test_synthetic_params_bit_exact(fmt):
    """The host draw through the port's codecs equals the reference's
    through its own (both packages' public codecs run their native
    loops)."""
    cfg = dict(CFG, n_layer=1)
    ref = jgpt2.synthetic_params(jgpt2.GPT2Config(**cfg), JType[fmt], seed=3)
    got = tgpt2.synthetic_params(tgpt2.GPT2Config(**cfg), GGMLType[fmt],
                                 seed=3, device="cpu")
    assert_same_tree(got, ref)


_JAX = {}


def _jax_params(fmt):
    if fmt not in _JAX:
        _JAX[fmt] = jgpt2.synthetic_params(jgpt2.GPT2Config(**CFG),
                                           JType[fmt], seed=SEED)
    return _JAX[fmt]


def _jax_logits(fmt, prompt, feed):
    cfg = jgpt2.GPT2Config(**CFG)
    p = jpq.params_repack_device(jgpt2.prepare_fused(_jax_params(fmt)))
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


def _port_logits(fmt, prompt, feed):
    cfg = tgpt2.GPT2Config(**CFG)
    p = params_repack(tgpt2.prepare_fused(params_from_jax(
        _jax_params(fmt), device="cpu"), cfg))
    cache = tgpt2.init_cache(cfg, device="cpu")
    lg, cache = tgpt2.forward(cfg, p, torch.as_tensor(prompt[None]).long(),
                              torch.arange(PROMPT)[None], cache, 0)
    out = [lg[0].numpy()]
    for i, tok in enumerate(feed):
        n = PROMPT + i
        lg, cache = tgpt2.forward(cfg, p, torch.tensor([[int(tok)]]),
                                  torch.tensor([[n]]), cache, n)
        out.append(lg[0].numpy())
    return out, p


@pytest.mark.parametrize("fmt", LAID)
def test_small_gpt2_matches_reference_forward(fmt):
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, CFG["n_vocab"], PROMPT).astype(np.int32)
    feed = rng.integers(0, CFG["n_vocab"], STEPS).astype(np.int32)
    ref = _jax_logits(fmt, prompt, feed)
    got, p = _port_logits(fmt, prompt, feed)
    lp = p["layers"][0]
    want = {"dense": 0, "nib4": 3, "int8": 4}[LAYOUT[fmt][0]]
    assert all(lp[k].q4_layout == want for k in ("attn_w", "proj_w", "fc_w",
                                                  "out_w"))
    assert max(float(np.abs(r).max()) for r in ref) > 0.3   # not degenerate
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL)
        for rr, gg in zip(r, g):
            top2 = np.sort(rr)[-2:]
            if top2[1] - top2[0] > MARGIN:
                assert int(np.argmax(gg)) == int(np.argmax(rr))
