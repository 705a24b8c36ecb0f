"""Port parity: the IQ codebook formats (IQ4_NL, IQ4_XS, IQ2_XXS, IQ2_XS,
IQ2_S, IQ3_XXS, IQ3_S, IQ1_S, IQ1_M) and the bf16 residency.

- Grids: the port's quant/iq_grids.npz is a byte copy of the JAX package's,
  no port module opens a file of the JAX package (an audit hook in a
  subprocess that decodes every kind) or computes with a string naming its
  directory.
- Codecs: all nine decoders are bit-exact against the JAX package's on
  random blocks (codecs.random_blocks: uniform bytes, the fp16 super-scale
  set)
  and reproduce tests/fixtures/golden_iq.npz's reference-encoded bytes ->
  dequant vectors bit for bit; IQ4_NL and IQ4_XS quantize bit-exactly
  against the JAX package's numpy quantizers on interesting_data; the
  decode-only kinds refuse to quantize.
- Layouts: to_device_format equals the JAX package's QTensor field by
  field (q, scale, bias, lut, signs, zero, dtypes), and dequantize_qtensor
  the decoder's output; quantize_for_device for IQ4_NL and IQ4_XS.
- Ops: dequantize and get_rows bit-exact against the JAX package's
  dequantize_xla (its columns for get_rows: the JAX get_rows reads a nib4
  table with a lut as affine levels and cannot reshape a nib2 table), and
  qmatmul within 1e-5 of the largest |y| (the same bf16 products summed in
  another order); params_repack (IQ4 nat8 g 32, the codebook layouts passed
  through); concat, permute and the pads carry lut and signs as the JAX
  package's do; natural_q refuses a codebook, naming dequantize.
- Residency: to_dense_bf16 and params_to_dense_bf16 bit-exact against the
  JAX package's; Engine(residency="bf16") holds the same dense weights as
  the JAX Engine's and its teacher-forced logits agree within the LLaMA
  tests' atol 0.1; the q4 residencies and other values refuse.
- Small models, teacher-forced (a 16-token prefill, then 3 decode steps):
  a 2-layer LLaMA in llama.cpp's IQ4_XS mix (`output` Q6_K, every other
  2-D weight IQ4_XS) through the port (plain versions) against the JAX
  package's stacked forward (its nat8 kernels in interpret mode), logits
  within atol 0.1 and, with an f32 prefill attention, every op teacher-
  forced within 1e-4 (test_torch_llama.TeacherForced); a 2-layer GPT-2 in
  IQ3_S and in IQ2_XS (random blocks through both packages'
  to_device_format) against the JAX forward, its embedding gather taken
  from dequantize_xla's columns, logits within atol 2e-2 (as
  tests/test_torch_formats.py).
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

from ggml_imax_tpu.models import gpt2 as jgpt2
from ggml_imax_tpu.models import llama as jllama
from ggml_imax_tpu.ops import pallas_qmm as jpq
from ggml_imax_tpu.quant import codecs as jcodecs
from ggml_imax_tpu.quant import device as jdev
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu.runtime.engine import Engine as JEngine
from ggml_imax_tpu_torch.models import gpt2 as tgpt2
from ggml_imax_tpu_torch.models import llama as tllama
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.ops import embedding as temb
from ggml_imax_tpu_torch.ops import qmm
from ggml_imax_tpu_torch.ops import qmatmul as tqmatmul
from ggml_imax_tpu_torch.quant import codecs as tcodecs
from ggml_imax_tpu_torch.quant import device as tdev
from ggml_imax_tpu_torch.quant.formats import FORMATS, GGMLType
from ggml_imax_tpu_torch.runtime.engine import Engine

from test_torch_cuda import iq4_xs_types
from test_torch_formats import _same_bits
from test_torch_kquant import interesting_data
from test_torch_llama import (_f32_attention, assert_close_logits,
                              teacher_forced)

jqmatmul = importlib.import_module("ggml_imax_tpu.ops.qmatmul")
jemb = importlib.import_module("ggml_imax_tpu.ops.embedding")

REPO = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).parent / "fixtures" / "golden_iq.npz"
IQ4 = ["IQ4_NL", "IQ4_XS"]
DECODE_ONLY = ["IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ3_XXS", "IQ3_S", "IQ1_S",
               "IQ1_M"]
KINDS = IQ4 + DECODE_ONLY
# (kind, scale group, lut entries) of each layout
LAYOUT = {"IQ4_NL": ("int8", 32, 0), "IQ4_XS": ("int8", 32, 0),
          "IQ2_XXS": ("nib2", 32, 4), "IQ2_XS": ("nib2", 16, 4),
          "IQ2_S": ("nib2", 16, 4), "IQ3_XXS": ("nib4", 32, 16),
          "IQ3_S": ("nib4", 32, 16), "IQ1_S": ("dense", None, 0),
          "IQ1_M": ("dense", None, 0)}
# a super-scale that gives weights of std ~0.05 (IQ1: ~0.01)
D = 0.001
# the super-scale that gives each decode-only kind's random blocks weights
# of std ~0.02 (GPT-2's synthetic scale)
D_STD02 = {"IQ2_XXS": 3.4e-4, "IQ2_XS": 3.5e-4, "IQ2_S": 3.6e-4,
           "IQ3_XXS": 1.6e-4, "IQ3_S": 1.35e-4, "IQ1_S": 2.7e-3,
           "IQ1_M": 2.7e-3}


def _raw(fmt, k, n, seed=0):
    """A (K, N) weight's ggml bytes: the codec on a normal draw of std 0.05
    for IQ4, random blocks for the decode-only kinds."""
    t = GGMLType[fmt]
    rng = np.random.default_rng(seed)
    if fmt in IQ4:
        w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
        w[3] = 0.0                                  # an all-zero row
        return tcodecs.quantize(w, t)
    return tcodecs.random_blocks(t, n * k // FORMATS[t].block_size, rng, D)


def _pair(fmt, k=512, n=256, seed=0):
    """(port, reference) natural QTensors of one weight."""
    raw = _raw(fmt, k, n, seed)
    return (tdev.to_device_format(raw, GGMLType[fmt], (k, n), device="cpu"),
            jdev.to_device_format(raw, JType[fmt], (k, n)))


def assert_same_fields(t, j):
    for f in ("kind", "k", "n", "zero", "interleaved_bk", "q4_layout"):
        assert getattr(t, f) == getattr(j, f), f
    assert int(t.ggml_type) == int(j.ggml_type)
    for attr in ("q", "scale", "bias", "lut", "signs"):
        a, b = getattr(t, attr), getattr(j, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            _same_bits(a, b, attr)


# ---- grids and isolation

def test_iq_grids_are_a_byte_copy():
    ours = REPO / "ggml_imax_tpu_torch" / "quant" / "iq_grids.npz"
    assert ours.read_bytes() == \
        (REPO / "ggml_imax_tpu" / "quant" / "iq_grids.npz").read_bytes()


def test_no_port_code_names_the_jax_package_directory():
    """No string a port module computes with (docstrings aside, which cite
    the JAX package's files as counterparts) names the JAX package's
    directory, as a path to read would."""
    import ast
    found = []
    for f in (REPO / "ggml_imax_tpu_torch").rglob("*.py"):
        tree = ast.parse(f.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef,
                                  ast.AsyncFunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        found += [(f.name, n.value) for n in ast.walk(tree)
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)
                  and id(n) not in docs
                  and ("ggml_imax_tpu/" in n.value
                       or n.value == "ggml_imax_tpu")]
    assert not found, found


def test_port_opens_no_file_of_the_jax_package():
    code = (
        "import sys, numpy as np\n"
        "opened = []\n"
        "sys.addaudithook(lambda e, a: opened.append(str(a[0])) "
        "if e == 'open' else None)\n"
        "from ggml_imax_tpu_torch.quant import codecs, device\n"
        "from ggml_imax_tpu_torch.quant.formats import GGMLType\n"
        f"for name in {DECODE_ONLY!r}:\n"
        "    t = GGMLType[name]\n"
        "    raw = codecs.random_blocks(t, 2, np.random.default_rng(0), 1e-3)\n"
        "    codecs.dequantize(raw, t)\n"
        "    device.to_device_format(raw, t, (256, 2), device='cpu')\n"
        "grids = [f for f in opened if f.endswith('iq_grids.npz')]\n"
        "assert grids and all('ggml_imax_tpu_torch' in f for f in grids), "
        "grids\n"
        "bad = [f for f in opened if '/ggml_imax_tpu/' in f]\n"
        "assert not bad, bad\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'ggml_imax_tpu')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# ---- codecs

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fmt", KINDS)
def test_decoder_bit_exact_on_random_blocks(fmt, seed):
    t = GGMLType[fmt]
    n = 24 * 256 // FORMATS[t].block_size
    raw = tcodecs.random_blocks(t, n, np.random.default_rng(seed), D)
    got = tcodecs.dequantize(raw, t, shape=(24, 256))
    assert np.isfinite(got).all() and got.std() > 0
    np.testing.assert_array_equal(
        got, jcodecs._DEQUANTIZERS[JType[fmt]](raw).reshape(24, 256))


@pytest.mark.parametrize("fmt", DECODE_ONLY)
def test_decoder_matches_golden_vectors(fmt):
    gold = np.load(GOLDEN)
    raw = gold[f"{fmt.lower()}_bytes"]
    np.testing.assert_array_equal(tcodecs.dequantize(raw, GGMLType[fmt]),
                                  gold[f"{fmt.lower()}_dequant"])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fmt", IQ4)
def test_iq4_codecs_bit_exact(fmt, seed):
    x = interesting_data(np.random.default_rng(seed), 256 * 16)
    got = tcodecs.quantize(x, GGMLType[fmt])
    ref = np.asarray(jcodecs._QUANTIZERS[JType[fmt]](x)).reshape(-1)
    assert got.dtype == np.uint8
    assert got.size == 256 * 16 // FORMATS[GGMLType[fmt]].block_size \
        * FORMATS[GGMLType[fmt]].type_size
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tcodecs.dequantize(got, GGMLType[fmt]),
        jcodecs._DEQUANTIZERS[JType[fmt]](ref))


@pytest.mark.parametrize("fmt", DECODE_ONLY)
def test_decode_only_kinds_refuse_to_quantize(fmt):
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        tcodecs.quantize(np.ones(256, np.float32), GGMLType[fmt])


def test_block_dtypes_match_reference():
    for fmt in KINDS:
        assert tcodecs.BLOCK_DTYPES[GGMLType[fmt]] == \
            jcodecs.BLOCK_DTYPES[JType[fmt]], fmt
        assert FORMATS[GGMLType[fmt]].type_size == \
            jcodecs.BLOCK_DTYPES[JType[fmt]].itemsize
    np.testing.assert_array_equal(tcodecs.KVALUES_IQ4NL,
                                  jcodecs.KVALUES_IQ4NL)
    np.testing.assert_array_equal(tcodecs.KSIGNS8, jcodecs._KSIGNS8)
    assert tcodecs.IQ1_DELTA == jcodecs.IQ1_DELTA


# ---- layouts

@pytest.mark.parametrize("k,n", [(256, 40), (768, 96), (4096, 8)])
@pytest.mark.parametrize("fmt", KINDS)
def test_device_layout_field_by_field(fmt, k, n):
    if fmt == "IQ4_NL" and k == 4096:
        k = 11008                         # a row length IQ4_XS cannot take
    raw = _raw(fmt, k, n, seed=k + n)
    got = tdev.to_device_format(raw, GGMLType[fmt], (k, n), device="cpu")
    ref = jdev.to_device_format(raw, JType[fmt], (k, n))
    assert_same_fields(got, ref)
    kind, group, lut = LAYOUT[fmt]
    assert got.kind == kind and got.bias is None
    if group:
        assert got.scale.shape == (k // group, n)
        assert got.scale.dtype == torch.float32
    assert (0 if got.lut is None else got.lut.numel()) == lut
    assert (got.signs is not None) == (kind == "nib2")
    if kind == "nib2":
        assert got.q.shape == (k // 4, n) and got.signs.shape == (k // 8, n)
    # the layout decodes to the codec's values, bit for bit
    np.testing.assert_array_equal(
        tdev.dequantize_qtensor(got).numpy(),
        tcodecs.dequantize(raw, GGMLType[fmt], shape=(n, k)).T)
    np.testing.assert_array_equal(tdev.dequantize_qtensor(got).numpy(),
                                  jdev.dequantize_qtensor(ref))


@pytest.mark.parametrize("fmt", IQ4)
def test_quantize_for_device_iq4(fmt):
    w = (np.random.default_rng(4).standard_normal((512, 64)) * 0.05) \
        .astype(np.float32)
    got = tdev.quantize_for_device(w, GGMLType[fmt], device="cpu")
    assert_same_fields(got, jdev.quantize_for_device(w, JType[fmt]))
    assert set(np.unique(got.q.numpy())) <= set(tcodecs.KVALUES_IQ4NL)


def test_layout_refuses_a_magnitude_off_the_grid(monkeypatch):
    grid = tcodecs.iq_grid("iq3s_grid").copy()
    grid[:] = 2                           # no IQ3_S magnitude
    monkeypatch.setattr(tcodecs, "iq_grid", lambda name: grid)
    raw = tcodecs.random_blocks(GGMLType.IQ3_S, 1, np.random.default_rng(0),
                                D)
    with pytest.raises(ValueError, match="magnitude"):
        tdev.to_device_format(raw, GGMLType.IQ3_S, (256, 1), device="cpu")


# ---- ops

@pytest.mark.parametrize("fmt", KINDS)
def test_dequantize_and_get_rows_bit_exact(fmt):
    t, j = _pair(fmt)
    ids = np.array([[0, 3, 5, 255], [17, 17, 128, 1]], np.int32)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        w = jqmatmul.dequantize_xla(j, jdt)
        _same_bits(tqmatmul.dequantize(t, tdt), w, "dequantize")
        _same_bits(temb.get_rows(t, torch.from_numpy(ids).long(), dtype=tdt),
                   jnp.asarray(w).T[jnp.asarray(ids)], "get_rows")


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("fmt", KINDS)
def test_qmatmul_matches_reference(fmt, m):
    """The plain route (codebook layouts, IQ1's dense, IQ4's natural int8)
    against the JAX package's XLA route: the same bf16 operands, f32 sums
    in another order."""
    t, j = _pair(fmt)
    x = np.random.default_rng(m).standard_normal((m, t.k)).astype(np.float32)
    got = tqmatmul.qmatmul(torch.from_numpy(x), t, out_dtype=torch.float32)
    ref = np.asarray(jqmatmul.qmatmul(jnp.asarray(x), j,
                                      out_dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_natural_q_refuses_a_codebook_and_names_dequantize():
    for fmt in ("IQ2_XS", "IQ3_S"):
        t, _ = _pair(fmt)
        with pytest.raises(NotImplementedError, match="dequantize"):
            qmm.natural_q(t)
    t, _ = _pair("IQ4_XS")                 # IQ4's int8 has levels
    assert torch.equal(qmm.natural_q(t), t.q)


@pytest.mark.parametrize("scale_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("fmt", KINDS)
def test_params_repack(fmt, scale_dtype):
    t, j = _pair(fmt)
    jsd = None if scale_dtype is None else jnp.bfloat16
    tr = qmm.params_repack({"w": t}, scale_dtype=scale_dtype)["w"]
    jr = jpq.params_repack_device({"w": j}, scale_dtype=jsd)["w"]
    assert_same_fields(tr, jr)
    assert tr is not t                     # a shallow copy at the least
    if fmt in IQ4:
        assert (tr.kind, tr.q4_layout, qmm.nat8_group(tr)) == ("int8", 4, 32)
        assert tr.q is t.q                 # nat8 keeps the bytes
    else:
        assert tr.q4_layout == 0 and tr.interleaved_bk == 0
        assert all(getattr(tr, a) is getattr(t, a)
                   for a in ("q", "scale", "lut", "signs"))


@pytest.mark.parametrize("fmt", ["IQ2_XXS", "IQ2_S", "IQ3_XXS", "IQ4_XS"])
def test_concat_permute_and_pads_carry_lut_and_signs(fmt):
    (t1, j1), (t2, j2) = _pair(fmt, 512, 200, 1), _pair(fmt, 512, 56, 2)
    tc = tdev.concat_qtensors([t1, t2])
    jc = jdev.concat_qtensors([j1, j2])
    assert_same_fields(tc, jc)
    perm = np.random.default_rng(0).permutation(256)
    tp = tdev.permute_qtensor_cols(tc, perm)
    assert_same_fields(tp, jdev.permute_qtensor_cols(jc, perm))
    np.testing.assert_array_equal(tdev.dequantize_qtensor(tp).numpy(),
                                  tdev.dequantize_qtensor(tc).numpy()[:, perm])
    (tpc, npad), (jpc, jnpad) = (tdev.pad_qtensor_cols(t2, 128),
                                 jdev.pad_qtensor_cols(j2, 128))
    assert npad == jnpad == 72
    assert_same_fields(tpc, jpc)
    wc = tdev.dequantize_qtensor(tpc)
    assert torch.equal(wc[:, :56], tdev.dequantize_qtensor(t2))
    assert not wc[:, 56:].any()
    tk, _ = _pair(fmt, 768, 64, 3)
    (tpr, kpad), (jpr, jkpad) = (tdev.pad_qtensor_rows(tk, 1024),
                                 jdev.pad_qtensor_rows(_pair(fmt, 768, 64,
                                                             3)[1], 1024))
    assert kpad == jkpad == 256
    assert_same_fields(tpr, jpr)
    wr = tdev.dequantize_qtensor(tpr)
    assert torch.equal(wr[:768], tdev.dequantize_qtensor(tk))
    assert not wr[768:].any()
    tk2 = tdev.concat_qtensors_k([tk, tk])
    assert torch.equal(tdev.dequantize_qtensor(tk2),
                       torch.cat([tdev.dequantize_qtensor(tk)] * 2))
    assert (tk2.signs is None) == (tk.signs is None)


# ---- residency

@pytest.mark.parametrize("fmt", KINDS + ["Q4_K"])
def test_to_dense_bf16_bit_exact(fmt):
    """Bit-exact against the JAX package's to_dense_bf16 for the IQ kinds
    (one product a weight). A format with a bias (Q4_K) rounds q * s to
    bf16 before adding the bias, as the JAX package's dequantize_xla does
    op by op; its to_dense_bf16 runs that under jax.jit, where XLA:CPU
    keeps q * s in f32 (excess precision), so there the two are held
    within a bf16 ulp and the port bit-exact to the eager dequantize_xla."""
    if fmt == "Q4_K":
        w = (np.random.default_rng(0).standard_normal((512, 256)) * 0.05) \
            .astype(np.float32)
        j = jdev.quantize_for_device(w, JType.Q4_K)
        t = params_from_jax(j, device="cpu")
    else:
        t, j = _pair(fmt)
    got, ref = tdev.to_dense_bf16(t), jdev.to_dense_bf16(j)
    if fmt == "Q4_K":
        _same_bits(got.q, jqmatmul.dequantize_xla(j, jnp.bfloat16), "q")
        np.testing.assert_allclose(
            got.q.float().numpy(), np.asarray(ref.q, np.float32),
            rtol=2 ** -8, atol=0)
    else:
        assert_same_fields(got, ref)
    if t.kind != "dense":
        assert got.kind == "dense" and got.q.dtype == torch.bfloat16
        assert (got.scale, got.bias, got.lut, got.signs) == (None,) * 4
    tree = tdev.params_to_dense_bf16({"a": [t, torch.ones(2)], "b": None})
    assert torch.equal(tree["a"][0].q, got.q) and tree["b"] is None
    assert torch.equal(tree["a"][1], torch.ones(2))


LLAMA = dict(n_vocab=512, n_ctx=128, n_embd=256, n_head=2, n_head_kv=1,
             n_layer=2, n_ff=768)
PROMPT, STEPS, PAD = 16, 3, 1024


_RAW = {}


def jax_llama():
    """The IQ4_XS-mix LLaMA, built by the JAX package (quantize_for_device
    per tensor type; IQ4_XS has no native encoder, so its numpy twin)."""
    if not _RAW:
        cfg = jllama.LlamaConfig(**LLAMA)
        rng = np.random.default_rng(21)
        E, V, F = cfg.n_embd, cfg.n_vocab, cfg.n_ff
        kv = cfg.n_head_kv * cfg.head_dim

        def q(name, layer, k, n):
            w = (rng.standard_normal((k, n)) * 0.08).astype(np.float32)
            t = iq4_xs_types(name, layer)
            return jdev.quantize_for_device(w, JType(int(t)))

        def norm(n):
            return jnp.asarray((1 + 0.1 * rng.standard_normal(n))
                               .astype(np.float32))

        p = {"tok_embd": q("tok_embd", None, E, V), "out_norm": norm(E),
             "output": q("output", None, E, V), "layers": []}
        for li in range(cfg.n_layer):
            p["layers"].append({
                "attn_norm": norm(E), "q_w": q("q_w", li, E, E),
                "k_w": q("k_w", li, E, kv), "v_w": q("v_w", li, E, kv),
                "o_w": q("o_w", li, E, E), "ffn_norm": norm(E),
                "gate_w": q("gate_w", li, E, F), "up_w": q("up_w", li, E, F),
                "down_w": q("down_w", li, F, E)})
        _RAW["v"] = (cfg, p)
    return _RAW["v"]


def _tokens(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, PROMPT).astype(np.int32),
            rng.integers(0, vocab, STEPS).astype(np.int32))


def _jax_run(module, cfg, p, cache, prompt, feed):
    out = []
    jqmatmul.set_force_fused(True)
    try:
        fwd = jax.jit(lambda p, t, pos, c, n: module.forward(cfg, p, t, pos,
                                                             c, n))
        lg, cache = fwd(p, jnp.asarray(prompt[None]),
                        jnp.arange(PROMPT, dtype=jnp.int32)[None], cache, 0)
        out.append(np.asarray(lg[0]))
        for i, tok in enumerate(feed):
            n = PROMPT + i
            lg, cache = fwd(p, jnp.asarray([[tok]], jnp.int32),
                            jnp.asarray([[n]], jnp.int32), cache, n)
            out.append(np.asarray(lg[0]))
    finally:
        jqmatmul.set_force_fused(False)
    return out


def _port_run(module, cfg, p, cache, prompt, feed):
    lg, cache = module.forward(cfg, p, torch.as_tensor(prompt[None]).long(),
                               torch.arange(PROMPT)[None], cache, 0)
    out = [lg[0].numpy()]
    for i, tok in enumerate(feed):
        n = PROMPT + i
        lg, cache = module.forward(cfg, p, torch.tensor([[int(tok)]]),
                                   torch.tensor([[n]]), cache, n)
        out.append(lg[0].numpy())
    return out


def llama_jax_logits(prompt, feed):
    cfg, raw = jax_llama()
    p = jllama.fuse_gate_up(jllama.fuse_qkv(raw), pad_multiple=PAD)
    p = jllama.stack_model(jpq.params_repack_device(p))
    cache = jllama.init_cache(cfg, dtype=jnp.bfloat16, flat=True)
    return _jax_run(jllama, cfg, p, cache, prompt, feed)


def llama_port(prompt, feed):
    cfg = tllama.LlamaConfig(**LLAMA)
    p = params_from_jax(jax_llama()[1], device="cpu")
    p = qmm.params_repack(tllama.fuse_gate_up(tllama.fuse_qkv(p),
                                              pad_multiple=PAD))
    cache = tllama.init_cache(cfg, device="cpu")
    return _port_run(tllama, cfg, p, cache, prompt, feed), p


def test_small_llama_iq4_xs_matches_reference_forward():
    prompt, feed = _tokens(LLAMA["n_vocab"])
    ref = llama_jax_logits(prompt, feed)
    got, p = llama_port(prompt, feed)
    lp = p["layers"][0]
    assert {k: (lp[k].kind, lp[k].q4_layout, qmm.nat8_group(lp[k]))
            for k in ("qkv_w", "o_w", "gu_w", "down_w")} == \
        {k: ("int8", 4, 32) for k in ("qkv_w", "o_w", "gu_w", "down_w")}
    assert (lp["gu_w"].n, lp["down_w"].k) == (2 * PAD, PAD)
    assert (p["output"].ggml_type, qmm.nat8_group(p["output"])) == \
        (GGMLType.Q6_K, 16)
    assert p["tok_embd"].ggml_type == GGMLType.IQ4_XS
    assert max(float(np.abs(r).max()) for r in ref) > 0.5   # not degenerate
    assert_close_logits(ref, got, atol=0.1)


def test_small_llama_iq4_xs_teacher_forced(monkeypatch):
    """With an f32 prefill attention, every op teacher-forced on the
    reference's input within 1e-4 of the reference's."""
    prompt, feed = _tokens(LLAMA["n_vocab"])
    monkeypatch.setattr(tllama, "attention", _f32_attention)
    ref, got, tf = teacher_forced(monkeypatch,
                                  lambda: llama_jax_logits(prompt, feed),
                                  lambda: llama_port(prompt, feed)[0])
    tf.check(1e-4)
    assert_close_logits(ref, got, atol=1e-4)


def test_synthetic_params_device_iq4_xs_draw():
    cfg = tllama.LlamaConfig(**dict(LLAMA, n_embd=512, n_head=4,
                                    n_head_kv=4))
    p = tllama.synthetic_params_device(cfg, types=iq4_xs_types, seed=3,
                                       device="cpu")
    w = p["layers"][1]["gate_w"]
    assert (w.kind, w.ggml_type, w.bias, w.scale.shape) == \
        ("int8", GGMLType.IQ4_XS, None, (cfg.n_embd // 32, cfg.n_ff))
    vals = np.unique(w.q.numpy())
    np.testing.assert_array_equal(vals, tcodecs.KVALUES_IQ4NL)
    assert abs(float(w.q.float().std()) / tllama.IQ4NL_STD - 1) < 0.01
    assert abs(float(np.std(tcodecs.KVALUES_IQ4NL.astype(np.float64)))
               - tllama.IQ4NL_STD) < 0.005
    # the dequantized weights' standard deviation is near `scale` (0.02)
    std = float(tdev.dequantize_qtensor(w).std())
    assert 0.015 < std < 0.025
    assert p["output"].ggml_type == GGMLType.Q6_K
    pp = qmm.params_repack(tllama.prepare_fused(p))
    assert pp["layers"][0]["gu_w"].q4_layout == 4


def test_engine_bf16_residency_matches_reference():
    cfg, raw = jax_llama()
    jeng = JEngine(jllama, cfg, raw, residency="bf16")
    teng = Engine(tllama, tllama.LlamaConfig(**LLAMA),
                  params_from_jax(raw, device="cpu"), residency="bf16",
                  device="cpu")
    assert teng.residency == "bf16"
    jl, tl = jeng.params["layers"][1], teng.params["layers"][1]
    for key in ("q_w", "gate_w", "down_w"):
        assert_same_fields(tl[key], jl[key])
    assert_same_fields(teng.params["output"], jeng.params["output"])
    assert teng.params["tok_embd"].q.dtype == torch.bfloat16
    prompt, feed = _tokens(LLAMA["n_vocab"], seed=1)
    ref, got = [], []
    for eng, out in ((jeng, ref), (teng, got)):
        cache = eng.new_cache()
        lg, cache = eng.prefill(cache, prompt[None])
        out.append(np.asarray(lg))
        for i, tok in enumerate(feed):
            lg, cache = eng.decode_step(cache, np.array([tok], np.int32),
                                        PROMPT + i)
            out.append(np.asarray(lg))
    assert_close_logits(ref, got, atol=0.1)


def test_engine_residency_refusals():
    cfg = tllama.LlamaConfig(**LLAMA)
    for r in ("q4-fused", "q4-stacked"):
        with pytest.raises(NotImplementedError, match="Queue 3"):
            Engine(tllama, cfg, {}, residency=r, device="cpu")
    with pytest.raises(ValueError):
        Engine(tllama, cfg, {}, residency="bf32", device="cpu")
    assert Engine(tllama, cfg, {}, device="cpu").residency == "as-is"


GPT2 = dict(n_vocab=1000, n_ctx=64, n_embd=256, n_head=4, n_layer=2)


def gpt2_raw(fmt, seed=5):
    """A GPT-2's params in a decode-only kind, built by the JAX package from
    random blocks (each 2-D weight through its to_device_format)."""
    rng = np.random.default_rng(seed)
    t = GGMLType[fmt]

    def q(shape_kn):
        k, n = shape_kn
        raw = tcodecs.random_blocks(t, n * k // 256, rng, D_STD02[fmt])
        return jdev.to_device_format(raw, JType[fmt], (k, n))

    def vec(n):
        return jnp.asarray((rng.standard_normal(n) * 0.02)
                           .astype(np.float32))

    return tgpt2._param_tree(jgpt2.GPT2Config(**GPT2), q, vec)


def _dequantized_get_rows(qt, ids, dtype=jnp.bfloat16):
    """The rows of the JAX package's dequantize_xla: what its get_rows
    should give (it reads a nib4 table with a lut as affine levels and
    cannot reshape a nib2 table)."""
    if qt.kind == "dense":
        return jnp.asarray(qt.q).T[ids].astype(dtype)
    return jqmatmul.dequantize_xla(qt, dtype).T[ids]


@pytest.mark.parametrize("fmt", ["IQ3_S", "IQ2_XS"])
def test_small_gpt2_codebook_matches_reference_forward(fmt, monkeypatch):
    raw = gpt2_raw(fmt)
    prompt, feed = _tokens(GPT2["n_vocab"], seed=2)
    monkeypatch.setattr(jgpt2, "get_rows", _dequantized_get_rows)
    jcfg = jgpt2.GPT2Config(**GPT2)
    ref = _jax_run(jgpt2, jcfg, jpq.params_repack_device(raw),
                   jgpt2.init_cache(jcfg, dtype=jnp.bfloat16), prompt, feed)
    cfg = tgpt2.GPT2Config(**GPT2)
    p = qmm.params_repack(params_from_jax(raw, device="cpu"))
    assert p["wte"].kind == LAYOUT[fmt][0] and p["wte"].lut is not None
    assert p["layers"][0]["fc_w"].kind == LAYOUT[fmt][0]
    got = _port_run(tgpt2, cfg, p, tgpt2.init_cache(cfg, device="cpu"),
                    prompt, feed)
    assert max(float(np.abs(r).max()) for r in ref) > 0.3   # not degenerate
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-2)
