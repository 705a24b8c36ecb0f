"""Port parity: the quantization tools (tools/quantize.py,
tools/perplexity.py).

- requantize_gguf and requantize_legacy_bin: from one source file (written
  by the JAX package's writers: F16, F32 and Q8_0 weights, 1-D tensors, a
  row length that no K-quant block divides, metadata of many wire types),
  the port's output file byte-identical to the JAX package's, to Q4_0,
  Q4_K, Q5_0 and IQ2_XS, each with an importance row per weight (IQ2_XS
  needs one), and Q4_0 without. Also: an include pattern quantizes its
  tensors only and copies the others byte for byte, every metadata key
  keeps its wire type, general.file_type and the legacy ftype take the
  target type, the stats agree.
- perplexity on a tiny GPT-2 and a tiny LLaMA against the JAX function, in
  f32 with both prefill attentions f32 (the port's pointed at
  attention_xla, as the reference computes it on the host): NLL within
  1e-5 relative; n_tokens equal, also with another min_context; the same
  ValueError for too few tokens.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.io.gguf import GGUFWriter as JWriter
from ggml_imax_tpu.io.legacy_bin import write_legacy_bin as jwrite_legacy
from ggml_imax_tpu.models import gpt2 as jgpt2
from ggml_imax_tpu.models import llama as jllama
from ggml_imax_tpu.quant import codecs as jcodecs
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu.tools.perplexity import perplexity as jperplexity
from ggml_imax_tpu.tools import quantize as jq
from ggml_imax_tpu_torch.io.gguf import GGUFReader
from ggml_imax_tpu_torch.models import gpt2 as tgpt2
from ggml_imax_tpu_torch.models import llama as tllama
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.ops.attention import attention_xla
from ggml_imax_tpu_torch.quant.formats import GGMLType
from ggml_imax_tpu_torch.tools.perplexity import perplexity as tperplexity
from ggml_imax_tpu_torch.tools import quantize as tq

from test_torch_imatrix import tiny_gpt2, tiny_llama

RTOL = 1e-5
# name -> (type, ne); ne[0] is the row length
TENSORS = {"token_embd.weight": (JType.F16, (256, 12)),
           "blk.0.attn_q.weight": (JType.F16, (512, 8)),
           "blk.0.attn_k.weight": (JType.F32, (96, 8)),
           "blk.0.ffn_down.weight": (JType.Q8_0, (256, 6)),
           "blk.0.attn_norm.weight": (JType.F32, (256,)),
           "blk.0.ffn_down.bias": (JType.F16, (6,))}
HPARAMS = ["n_vocab", "n_ctx", "ftype"]


def _payloads(rng):
    out = {}
    for name, (t, ne) in TENSORS.items():
        x = rng.standard_normal(int(np.prod(ne))).astype(np.float32)
        x[:32] = 0.0                                  # a dead block
        out[name] = np.asarray(jcodecs.quantize(x, t)).reshape(-1)
    return out


def _imatrix(rng):
    return {name: rng.exponential(1.0, ne[0]).astype(np.float32)
            for name, (_, ne) in TENSORS.items() if len(ne) == 2}


def write_gguf(path, rng):
    w = JWriter(path)
    w.add_kv("general.architecture", "llama")
    w.add_kv("general.file_type", np.uint32(1))
    w.add_kv("llama.block_count", np.uint32(1))
    w.add_kv("llama.rope.freq_base", np.float32(10000.0))
    w.add_kv("test.u8", np.uint8(7))
    w.add_kv("test.i16", np.int16(-3))
    w.add_kv("test.flag", True)
    w.add_kv("test.u64", 1 << 40)
    w.add_kv("tokenizer.ggml.tokens", ["a", "b", "ab"])
    w.add_kv("tokenizer.ggml.scores", np.float32([0.5, -1.0, 2.0]))
    for name, raw in _payloads(rng).items():
        t, ne = TENSORS[name]
        w.add_tensor(name, raw, t, shape=ne)
    w.write()


def write_bin(path, rng):
    tensors = {name: (t, ne, raw) for (name, raw), (t, ne) in
               zip(_payloads(rng).items(), TENSORS.values())}
    jwrite_legacy(path, {"n_vocab": 3, "n_ctx": 16, "ftype": 1}, HPARAMS,
                  [b"a", b"b", b"ab"], tensors)


CASES = [("Q4_0", False), ("Q4_0", True), ("Q4_K", True), ("Q5_0", True),
         ("IQ2_XS", True)]
IDS = [f"{f}{'-imatrix' if i else ''}" for f, i in CASES]


@pytest.mark.parametrize("fmt,with_imatrix", CASES, ids=IDS)
def test_requantize_gguf_equals_the_jax_file(fmt, with_imatrix, tmp_path):
    rng = np.random.default_rng(3)
    src = tmp_path / "src.gguf"
    write_gguf(src, rng)
    imx = _imatrix(rng) if with_imatrix else None
    t_stats = tq.requantize_gguf(src, tmp_path / "t.gguf", GGMLType[fmt],
                                 imatrix=imx)
    j_stats = jq.requantize_gguf(src, tmp_path / "j.gguf", JType[fmt],
                                 imatrix=imx)
    assert (tmp_path / "t.gguf").read_bytes() == \
        (tmp_path / "j.gguf").read_bytes()
    assert {k: tuple(int(v) for v in s) for k, s in t_stats.items()} == \
        {k: tuple(int(v) for v in s) for k, s in j_stats.items()}
    with GGUFReader(src) as a, GGUFReader(tmp_path / "t.gguf") as b:
        assert b.metadata["general.file_type"] == int(GGMLType[fmt])
        assert b.metadata_types == a.metadata_types
        assert list(b.metadata) == list(a.metadata)
        for k, v in a.metadata.items():
            if k != "general.file_type":
                assert np.array_equal(np.asarray(b.metadata[k]),
                                      np.asarray(v)), k
        block = {"Q4_0": 32, "Q5_0": 32}.get(fmt, 256)
        for name, (t, ne) in TENSORS.items():
            info = b.tensors[name]
            moved = len(ne) == 2 and ne[0] % block == 0
            assert info.ggml_type == (GGMLType[fmt] if moved
                                      else GGMLType(int(t))), name
            if not moved:
                assert np.array_equal(b.tensor_data(name),
                                      a.tensor_data(name)), name


@pytest.mark.parametrize("fmt,with_imatrix", CASES, ids=IDS)
def test_requantize_legacy_bin_equals_the_jax_file(fmt, with_imatrix,
                                                   tmp_path):
    rng = np.random.default_rng(4)
    src = tmp_path / "src.bin"
    write_bin(src, rng)
    imx = _imatrix(rng) if with_imatrix else None
    tq.requantize_legacy_bin(src, tmp_path / "t.bin", GGMLType[fmt], HPARAMS,
                             imatrix=imx)
    jq.requantize_legacy_bin(src, tmp_path / "j.bin", JType[fmt], HPARAMS,
                             imatrix=imx)
    got = (tmp_path / "t.bin").read_bytes()
    assert got == (tmp_path / "j.bin").read_bytes()
    # ftype: GGML_QNT_VERSION 2 * 1000 + the target type
    assert int.from_bytes(got[12:16], "little") == 2000 + int(GGMLType[fmt])


def test_include_patterns(tmp_path):
    rng = np.random.default_rng(5)
    src = tmp_path / "src.gguf"
    write_gguf(src, rng)
    inc = ("blk.0.attn_*",)
    stats = tq.requantize_gguf(src, tmp_path / "t.gguf", GGMLType.Q5_0,
                               include=inc)
    jq.requantize_gguf(src, tmp_path / "j.gguf", JType.Q5_0, include=inc)
    assert (tmp_path / "t.gguf").read_bytes() == \
        (tmp_path / "j.gguf").read_bytes()
    moved = {k for k, s in stats.items() if s[0] != s[1]}
    assert moved == {"blk.0.attn_q.weight", "blk.0.attn_k.weight"}
    with GGUFReader(src) as a, GGUFReader(tmp_path / "t.gguf") as b:
        for name in set(TENSORS) - moved:
            assert np.array_equal(b.tensor_data(name), a.tensor_data(name))


def test_requantize_without_file_type_adds_it(tmp_path):
    w = JWriter(tmp_path / "s.gguf")
    x = np.random.default_rng(6).standard_normal((2, 256)).astype(np.float32)
    w.add_tensor("w.weight", x, JType.F32, shape=(256, 2))
    w.write()
    tq.requantize_gguf(tmp_path / "s.gguf", tmp_path / "t.gguf",
                       GGMLType.Q4_K)
    jq.requantize_gguf(tmp_path / "s.gguf", tmp_path / "j.gguf", JType.Q4_K)
    assert (tmp_path / "t.gguf").read_bytes() == \
        (tmp_path / "j.gguf").read_bytes()
    with GGUFReader(tmp_path / "t.gguf") as r:
        assert r.metadata["general.file_type"] == int(GGMLType.Q4_K)


# ---- perplexity

def _models(model, monkeypatch):
    jmod, tmod, make = {"gpt2": (jgpt2, tgpt2, tiny_gpt2),
                        "llama": (jllama, tllama, tiny_llama)}[model]
    jcfg, tcfg, jp = make()
    monkeypatch.setattr(tmod, "attention", attention_xla)
    return jmod, jcfg, jp, tmod, tcfg, params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("min_context", [None, 3])
@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_perplexity_equals_the_jax_one(model, min_context, monkeypatch):
    jmod, jcfg, jp, tmod, tcfg, tp = _models(model, monkeypatch)
    toks = np.random.default_rng(7).integers(0, jcfg.n_vocab, 40)
    want = jperplexity(jmod, jcfg, jp, toks, n_ctx=16,
                           compute_dtype=jnp.float32, min_context=min_context)
    seen = []
    got = tperplexity(tmod, tcfg, tp, toks, n_ctx=16,
                          compute_dtype=torch.float32,
                          min_context=min_context,
                          progress=lambda *a: seen.append(a))
    assert got["n_tokens"] == want["n_tokens"] == \
        2 * (15 - (7 if min_context is None else 2))
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=RTOL)
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=RTOL)
    assert [s[:2] for s in seen] == [(1, 2), (2, 2)]


def test_perplexity_refuses_too_few_tokens(monkeypatch):
    jmod, jcfg, jp, tmod, tcfg, tp = _models("gpt2", monkeypatch)
    toks = np.arange(10) % jcfg.n_vocab
    with pytest.raises(ValueError) as jerr:
        jperplexity(jmod, jcfg, jp, toks, n_ctx=16)
    with pytest.raises(ValueError) as terr:
        tperplexity(tmod, tcfg, tp, toks, n_ctx=16)
    assert str(terr.value) == str(jerr.value)
