"""Port parity: the model loaders and the HuggingFace converters.

- `gptj.load_legacy`, `gpt2.load_legacy` (with and without an untied
  model/lm_head), `llama.load_gguf` (with and without max_layers) and
  `whisper.load_legacy` on tiny files that the JAX package's writers write
  (each 2-D weight in a block format or F16/F32, mixed across the model;
  1-D tensors F32 or F16), as tests/test_gptj_llama.py and
  tests/test_whisper.py write theirs: the port's params bit-equal to
  models.common.params_from_jax of the JAX loader's params, the config
  equal, the tokenizer (or Whisper's mel filters and vocab) equal.
- One forward of each loaded model against the JAX forward on its loaded
  params, at the tolerance of that model's existing port parity test
  (tests/test_torch_gptj.py, test_torch_gpt2.py, test_torch_llama.py,
  test_torch_whisper.py): the port's prefill attention is bf16 flash, the
  reference's f32 on the host.
The HuggingFace converters are in tests/test_torch_loaders_hf.py.
"""
import dataclasses
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_imax_tpu.io.gguf import GGUFWriter as JGGUFWriter
from ggml_imax_tpu.io.legacy_bin import write_legacy_bin as jwrite_legacy
from ggml_imax_tpu.models import gpt2 as jgpt2
from ggml_imax_tpu.models import gptj as jgptj
from ggml_imax_tpu.models import llama as jllama
from ggml_imax_tpu.models import whisper as JW
from ggml_imax_tpu.quant import codecs as jcodecs
from ggml_imax_tpu.quant.formats import GGMLType as JType
from ggml_imax_tpu_torch.models import gpt2 as tgpt2
from ggml_imax_tpu_torch.models import gptj as tgptj
from ggml_imax_tpu_torch.models import llama as tllama
from ggml_imax_tpu_torch.models import whisper as TW
from ggml_imax_tpu_torch.models.common import params_from_jax
from ggml_imax_tpu_torch.quant.device import QTensor
from ggml_imax_tpu_torch.tokenizer.bpe import bytes_to_unicode

Q = JType
QT_FIELDS = ("kind", "k", "n", "ggml_type", "zero", "interleaved_bk",
             "q4_layout")


def assert_same(t, j, where="params"):
    """t (the port's) equal to j (params_from_jax of the JAX package's):
    the same tree, every tensor the same dtype, shape and bits."""
    if isinstance(j, dict):
        assert set(t) == set(j), where
        for k in j:
            assert_same(t[k], j[k], f"{where}.{k}")
    elif isinstance(j, list):
        assert isinstance(t, list) and len(t) == len(j), where
        for i, (a, b) in enumerate(zip(t, j)):
            assert_same(a, b, f"{where}[{i}]")
    elif j is None:
        assert t is None, where
    elif isinstance(j, QTensor):
        assert isinstance(t, QTensor), where
        for f in QT_FIELDS:
            assert getattr(t, f) == getattr(j, f), f"{where}.{f}"
        for f in ("q", "scale", "bias", "lut", "signs"):
            assert_same(getattr(t, f), getattr(j, f), f"{where}.{f}")
    else:
        assert isinstance(t, torch.Tensor), where
        assert t.dtype == j.dtype and t.shape == j.shape, \
            (where, t.dtype, j.dtype, t.shape, j.shape)
        assert torch.equal(t, j), where


def same_config(t, j):
    return dataclasses.asdict(t) == dataclasses.asdict(j)


def encoder(rng, scale=0.1):
    """(type, ne) -> (JAX type, ne, payload): rows of ne[0] values drawn
    from rng, encoded by the JAX package's codec (F32 written as floats)."""
    def enc(t, ne):
        rows = int(np.prod(ne[1:])) if len(ne) > 1 else 1
        x = (rng.standard_normal((rows, ne[0])) * scale).astype(np.float32)
        if len(ne) == 1:
            x = x + 1.0
        if t == Q.F32:
            return t, tuple(ne), x
        return t, tuple(ne), jcodecs.quantize(x, t)
    return enc


def ascii_vocab(words):
    return [bytes([c]) for c in range(0x20, 0x7F)] + \
        [w.encode() for w in words]


TEXTS = ["the quick brown fox", "Hello, World! 42 times", " spaced  out ",
         "don't stop"]


def assert_same_tokenizer(t, j):
    assert t.id_to_token == j.id_to_token
    for text in TEXTS:
        ids = t.encode(text)
        assert ids == j.encode(text) and t.decode(ids) == j.decode(ids)


# ---- GPT-J

GPTJ = dict(n_vocab=128, n_ctx=32, n_embd=64, n_head=4, n_layer=2, n_rot=16)
GPTJ_WORDS = ["the", " the", " quick", " brown", " fox", "Hello", " World",
              " times", "don", "'t", " stop", " out", " spaced", "er", "ing",
              " a", " is", " of", " to", " and", " in", " it", " that",
              " was", " he", " for", " on", " are", " as", " with", " his",
              " they", " at"]


def write_gptj(path, seed=0):
    enc = encoder(np.random.default_rng(seed))
    E, V = GPTJ["n_embd"], GPTJ["n_vocab"]
    kinds = {"q_proj": Q.Q4_0, "k_proj": Q.Q4_1, "v_proj": Q.Q5_0,
             "out_proj": Q.Q8_0}
    tensors = {"transformer.wte.weight": enc(Q.Q4_0, (E, V)),
               "transformer.ln_f.weight": enc(Q.F32, (E,)),
               "transformer.ln_f.bias": enc(Q.F32, (E,)),
               "lm_head.weight": enc(Q.Q8_0, (E, V)),
               "lm_head.bias": enc(Q.F32, (V,))}
    for i in range(GPTJ["n_layer"]):
        p = f"transformer.h.{i}"
        tensors[f"{p}.ln_1.weight"] = enc(Q.F32, (E,))
        tensors[f"{p}.ln_1.bias"] = enc(Q.F16, (E,))
        for name, t in kinds.items():
            tensors[f"{p}.attn.{name}.weight"] = enc(t, (E, E))
        tensors[f"{p}.mlp.fc_in.weight"] = enc(Q.F16 if i else Q.Q4_0,
                                               (E, 4 * E))
        tensors[f"{p}.mlp.fc_in.bias"] = enc(Q.F32, (4 * E,))
        tensors[f"{p}.mlp.fc_out.weight"] = enc(Q.F32 if i else Q.Q5_1,
                                                (4 * E, E))
        tensors[f"{p}.mlp.fc_out.bias"] = enc(Q.F32, (E,))
    jwrite_legacy(path, dict(GPTJ, ftype=2), jgptj.HPARAM_NAMES,
                  ascii_vocab(GPTJ_WORDS), tensors)


def test_gptj_load_legacy_matches_jax(tmp_path):
    path = tmp_path / "gptj.bin"
    write_gptj(path)
    jcfg, jparams, jtok = jgptj.load_legacy(path)
    cfg, params, tok = tgptj.load_legacy(path, device="cpu")
    assert tgptj.HPARAM_NAMES == jgptj.HPARAM_NAMES
    assert same_config(cfg, jcfg) and cfg == tgptj.GPTJConfig(**GPTJ)
    assert_same(params, params_from_jax(jparams, device="cpu"))
    assert_same_tokenizer(tok, jtok)
    assert tok.decode(tok.encode("the quick brown fox")) == \
        "the quick brown fox"


def test_gptj_loaded_forward_matches_jax(tmp_path):
    """atol 5e-2 as tests/test_torch_gptj.py (seen: 9.7e-3 of logits up
    to 4.2)."""
    path = tmp_path / "gptj.bin"
    write_gptj(path, seed=1)
    jcfg, jparams, _ = jgptj.load_legacy(path)
    cfg, params, tok = tgptj.load_legacy(path, device="cpu")
    ids = tok.encode("the quick brown fox was Hello")
    toks = np.asarray([ids], np.int32)
    pos = np.arange(len(ids), dtype=np.int32)[None]
    ref, _ = jgptj.forward(jcfg, jparams, jnp.asarray(toks), jnp.asarray(pos),
                           jgptj.init_cache(jcfg), 0)
    got, _ = tgptj.forward(cfg, params, torch.from_numpy(toks).long(),
                           torch.from_numpy(pos).long(),
                           tgptj.init_cache(cfg, device="cpu"), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=5e-2)


# ---- GPT-2

GPT2 = dict(n_vocab=128, n_ctx=32, n_embd=64, n_head=4, n_layer=2)


def write_gpt2(path, seed=0, lm_head=False):
    enc = encoder(np.random.default_rng(seed))
    E, V, C = GPT2["n_embd"], GPT2["n_vocab"], GPT2["n_ctx"]
    tensors = {"model/wte": enc(Q.Q8_0, (E, V)),
               "model/wpe": enc(Q.F32, (E, C)),
               "model/ln_f/g": enc(Q.F32, (E,)),
               "model/ln_f/b": enc(Q.F32, (E,))}
    if lm_head:
        tensors["model/lm_head"] = enc(Q.Q4_0, (E, V))
    for i in range(GPT2["n_layer"]):
        p = f"model/h{i}"
        for n in ("ln_1", "ln_2"):
            tensors[f"{p}/{n}/g"] = enc(Q.F32, (E,))
            tensors[f"{p}/{n}/b"] = enc(Q.F16, (E,))
        for n, ne, t in (("attn/c_attn", (E, 3 * E), Q.Q4_0),
                         ("attn/c_proj", (E, E), Q.Q8_0),
                         ("mlp/c_fc", (E, 4 * E), Q.Q5_0 if i else Q.Q4_0),
                         ("mlp/c_proj", (4 * E, E), Q.F16 if i else Q.Q8_0)):
            tensors[f"{p}/{n}/w"] = enc(t, ne)
            tensors[f"{p}/{n}/b"] = enc(Q.F32, (ne[1],))
    jwrite_legacy(path, dict(GPT2, ftype=7), jgpt2.HPARAM_NAMES,
                  ascii_vocab(GPTJ_WORDS), tensors)


@pytest.mark.parametrize("lm_head", [False, True])
def test_gpt2_load_legacy_matches_jax(tmp_path, lm_head):
    path = tmp_path / "gpt2.bin"
    write_gpt2(path, lm_head=lm_head)
    jcfg, jparams, jtok = jgpt2.load_legacy(path)
    cfg, params, tok = tgpt2.load_legacy(path, device="cpu")
    assert tgpt2.HPARAM_NAMES == jgpt2.HPARAM_NAMES
    assert same_config(cfg, jcfg) and cfg == tgpt2.GPT2Config(**GPT2)
    assert (params["lm_head"] is None) == (not lm_head)
    assert_same(params, params_from_jax(jparams, device="cpu"))
    assert_same_tokenizer(tok, jtok)


@pytest.mark.parametrize("lm_head", [False, True])
def test_gpt2_loaded_forward_matches_jax(tmp_path, lm_head):
    """atol 2e-2 as tests/test_torch_gpt2.py (seen: 1.0e-2 of logits up
    to 3.4)."""
    path = tmp_path / "gpt2.bin"
    write_gpt2(path, seed=2, lm_head=lm_head)
    jcfg, jparams, _ = jgpt2.load_legacy(path)
    cfg, params, tok = tgpt2.load_legacy(path, device="cpu")
    ids = tok.encode("Hello, World! the fox")
    toks = np.asarray([ids], np.int32)
    pos = np.arange(len(ids), dtype=np.int32)[None]
    ref, _ = jgpt2.forward(jcfg, jparams, jnp.asarray(toks), jnp.asarray(pos),
                           jgpt2.init_cache(jcfg), 0)
    got, _ = tgpt2.forward(cfg, params, torch.from_numpy(toks).long(),
                           torch.from_numpy(pos).long(),
                           tgpt2.init_cache(cfg, device="cpu"), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-2)


# ---- LLaMA (GGUF)

LLAMA = dict(n_embd=256, n_head=4, n_head_kv=2, n_ff=512, n_layer=3,
             n_ctx=64)
CORPUS = ("the quick brown fox jumps over the lazy dog; the dog sleeps "
          "while the fox runs. 12 foxes, 3 dogs!")


def train_merges(corpus, n_merges):
    """A deterministic byte-level BPE: every byte a token, then the
    n_merges most frequent adjacent pairs of the corpus's words (ties to
    the first pair seen). Returns (tokens, merges)."""
    b2u = bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    words = [[b2u[b] for b in (" " + w if i else w).encode()]
             for i, w in enumerate(corpus.split(" "))]
    merges = []
    for _ in range(n_merges):
        counts = {}
        for w in words:
            for pair in zip(w, w[1:]):
                counts[pair] = counts.get(pair, 0) + 1
        if not counts:
            break
        best = max(counts, key=counts.get)
        merges.append(" ".join(best))
        tokens.append(best[0] + best[1])
        for w in words:
            i = 0
            while i < len(w) - 1:
                if (w[i], w[i + 1]) == best:
                    w[i:i + 2] = [best[0] + best[1]]
                i += 1
    return tokens, merges


def write_llama(path, seed=0):
    enc = encoder(np.random.default_rng(seed), scale=0.05)
    E, F, L = LLAMA["n_embd"], LLAMA["n_ff"], LLAMA["n_layer"]
    kv = LLAMA["n_head_kv"] * E // LLAMA["n_head"]
    tokens, merges = train_merges(CORPUS, 32)
    V = len(tokens)
    w = JGGUFWriter(path)
    w.add_kv("general.architecture", "llama")
    for k, v in (("block_count", L), ("context_length", LLAMA["n_ctx"]),
                 ("embedding_length", E), ("feed_forward_length", F),
                 ("attention.head_count", LLAMA["n_head"]),
                 ("attention.head_count_kv", LLAMA["n_head_kv"])):
        w.add_kv(f"llama.{k}", np.uint32(v))
    w.add_kv("llama.attention.layer_norm_rms_epsilon", np.float32(1e-5))
    w.add_kv("llama.rope.freq_base", np.float32(10000.0))
    w.add_kv("tokenizer.ggml.tokens", tokens)
    w.add_kv("tokenizer.ggml.merges", merges)

    def add(name, t, ne):
        t, ne, data = enc(t, ne)
        w.add_tensor(name, data, t, shape=ne)

    add("token_embd.weight", Q.Q4_K, (E, V))
    add("output_norm.weight", Q.F32, (E,))
    add("output.weight", Q.Q6_K, (E, V))
    for i in range(L):
        more = Q.Q6_K if i == 1 else Q.Q4_K          # the Q4_K_M mix
        for name, t, ne in (("attn_norm", Q.F32, (E,)),
                            ("attn_q", Q.Q4_K, (E, E)),
                            ("attn_k", Q.Q4_K, (E, kv)),
                            ("attn_v", more, (E, kv)),
                            ("attn_output", Q.Q4_K, (E, E)),
                            ("ffn_norm", Q.F32, (E,)),
                            ("ffn_gate", Q.Q4_K, (E, F)),
                            ("ffn_up", Q.Q4_K, (E, F)),
                            ("ffn_down", more, (F, E))):
            add(f"blk.{i}.{name}.weight", t, ne)
    w.write()
    return V


@pytest.mark.parametrize("max_layers", [None, 2])
def test_llama_load_gguf_matches_jax(tmp_path, max_layers):
    path = tmp_path / "llama.gguf"
    V = write_llama(path)
    jcfg, jparams, jtok = jllama.load_gguf(path, max_layers=max_layers)
    cfg, params, tok = tllama.load_gguf(path, max_layers=max_layers,
                                        device="cpu")
    assert same_config(cfg, jcfg)
    assert cfg.n_layer == (max_layers or LLAMA["n_layer"]) and cfg.n_vocab == V
    assert_same(params, params_from_jax(jparams, device="cpu"))
    assert tok.id_to_token == jtok.id_to_token and tok.ranks == jtok.ranks
    for text in TEXTS + [CORPUS]:
        ids = tok.encode(text)
        assert ids == jtok.encode(text) and all(0 <= i < V for i in ids)
        assert tok.decode(ids) == jtok.decode(ids) == text


def test_llama_load_gguf_without_tokenizer(tmp_path):
    path = tmp_path / "bare.gguf"
    w = JGGUFWriter(path)
    w.add_kv("general.architecture", "llama")
    for k, v in (("block_count", 1), ("embedding_length", 256),
                 ("feed_forward_length", 256), ("attention.head_count", 2)):
        w.add_kv(f"llama.{k}", np.uint32(v))
    w.add_kv("llama.vocab_size", np.uint32(8))
    enc = encoder(np.random.default_rng(3))
    for name, t, ne in (("token_embd", Q.Q8_0, (256, 8)),
                        ("output_norm", Q.F32, (256,)),
                        ("blk.0.attn_norm", Q.F32, (256,)),
                        ("blk.0.attn_q", Q.F16, (256, 256)),
                        ("blk.0.attn_k", Q.F16, (256, 256)),
                        ("blk.0.attn_v", Q.F16, (256, 256)),
                        ("blk.0.attn_output", Q.Q8_0, (256, 256)),
                        ("blk.0.ffn_norm", Q.F32, (256,)),
                        ("blk.0.ffn_gate", Q.Q4_0, (256, 256)),
                        ("blk.0.ffn_up", Q.Q4_0, (256, 256)),
                        ("blk.0.ffn_down", Q.Q4_0, (256, 256))):
        t, ne, data = enc(t, ne)
        w.add_tensor(f"{name}.weight", data, t, shape=ne)
    w.write()
    jcfg, jparams, jtok = jllama.load_gguf(path)
    cfg, params, tok = tllama.load_gguf(path, device="cpu")
    assert tok is None and jtok is None and params["output"] is None
    assert same_config(cfg, jcfg) and cfg.n_vocab == 8 and cfg.n_head_kv == 2
    assert_same(params, params_from_jax(jparams, device="cpu"))


def test_llama_loaded_forward_matches_jax(tmp_path):
    """atol 0.1 as tests/test_torch_llama.py (seen: 2.2e-2 of logits up
    to 3.3)."""
    path = tmp_path / "llama.gguf"
    write_llama(path, seed=4)
    jcfg, jparams, _ = jllama.load_gguf(path)
    cfg, params, tok = tllama.load_gguf(path, device="cpu")
    ids = tok.encode("the lazy dog runs")
    toks = np.asarray([ids], np.int32)
    pos = np.arange(len(ids), dtype=np.int32)[None]
    ref, _ = jllama.forward(jcfg, jparams, jnp.asarray(toks),
                            jnp.asarray(pos), jllama.init_cache(jcfg), 0)
    got, _ = tllama.forward(cfg, params, torch.from_numpy(toks).long(),
                            torch.from_numpy(pos).long(),
                            tllama.init_cache(cfg, device="cpu"), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=0.1)


# ---- Whisper

WHISPER = dict(n_vocab=128, n_audio_ctx=32, n_audio_state=64, n_audio_head=2,
               n_audio_layer=2, n_text_ctx=24, n_text_state=64,
               n_text_head=2, n_text_layer=2, n_mels=16)
WHISPER_VOCAB = 100        # the file's; the loader pads to n_vocab


def write_whisper(path, seed=0):
    """whisper.cpp's layout, as tests/test_whisper.py writes it: magic, 11
    hparams, the mel filters, the vocab, the tensors."""
    enc = encoder(np.random.default_rng(seed))
    c = WHISPER
    E, T = c["n_audio_state"], c["n_text_state"]
    buf = bytearray(struct.pack("<I", 0x67676D6C))
    buf += struct.pack("<11i", *c.values(), 8)
    filters = np.linspace(0, 1, c["n_mels"] * 201, dtype=np.float32)
    buf += struct.pack("<2i", c["n_mels"], 201) + filters.tobytes()
    buf += struct.pack("<i", WHISPER_VOCAB)
    for i in range(WHISPER_VOCAB):
        tok = f"t{i}".encode()
        buf += struct.pack("<I", len(tok)) + tok

    def add(name, t, ne):
        t, ne, data = enc(t, ne)
        data = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        nb = name.encode()
        return (struct.pack("<3i", len(ne), len(nb), int(t))
                + struct.pack(f"<{len(ne)}i", *ne) + nb + data.tobytes())

    out = [add("encoder.positional_embedding", Q.F32, (E, c["n_audio_ctx"])),
           add("encoder.conv1.weight", Q.F16, (3, c["n_mels"], E)),
           add("encoder.conv1.bias", Q.F32, (E,)),
           add("encoder.conv2.weight", Q.F16, (3, E, E)),
           add("encoder.conv2.bias", Q.F32, (E,)),
           add("encoder.ln_post.weight", Q.F32, (E,)),
           add("encoder.ln_post.bias", Q.F32, (E,)),
           add("decoder.token_embedding.weight", Q.Q5_0, (T, c["n_vocab"])),
           add("decoder.positional_embedding", Q.F32, (T, c["n_text_ctx"])),
           add("decoder.ln.weight", Q.F32, (T,)),
           add("decoder.ln.bias", Q.F16, (T,))]

    def block(pre, W, cross):
        parts = [("attn_ln.weight", Q.F32, (W,)), ("attn_ln.bias", Q.F32, (W,)),
                 ("attn.query.weight", Q.Q5_0, (W, W)),
                 ("attn.query.bias", Q.F32, (W,)),
                 ("attn.key.weight", Q.Q5_0, (W, W)),
                 ("attn.value.weight", Q.Q5_0, (W, W)),
                 ("attn.value.bias", Q.F32, (W,)),
                 ("attn.out.weight", Q.Q8_0, (W, W)),
                 ("attn.out.bias", Q.F32, (W,)),
                 ("mlp_ln.weight", Q.F32, (W,)), ("mlp_ln.bias", Q.F32, (W,)),
                 ("mlp.0.weight", Q.Q5_0, (W, 4 * W)),
                 ("mlp.0.bias", Q.F32, (4 * W,)),
                 ("mlp.2.weight", Q.Q5_0, (4 * W, W)),
                 ("mlp.2.bias", Q.F32, (W,))]
        if cross:
            parts += [(f"cross_{n}", t, ne) for n, t, ne in parts[:9]]
        return [add(f"{pre}.{n}", t, ne) for n, t, ne in parts]

    for i in range(c["n_audio_layer"]):
        out += block(f"encoder.blocks.{i}", E, False)
    for i in range(c["n_text_layer"]):
        out += block(f"decoder.blocks.{i}", T, True)
    path.write_bytes(bytes(buf) + b"".join(out))
    return filters


def test_whisper_load_legacy_matches_jax(tmp_path):
    path = tmp_path / "whisper.bin"
    filters = write_whisper(path)
    jcfg, jparams, jfilt, jvocab = JW.load_legacy(path)
    cfg, params, filt, vocab = TW.load_legacy(path, device="cpu")
    assert same_config(cfg, jcfg) and cfg == TW.WhisperConfig(**WHISPER)
    assert_same(params, params_from_jax(jparams, device="cpu"))
    assert filt.dtype == np.float32 and filt.shape == (16, 201)
    np.testing.assert_array_equal(filt, jfilt)
    np.testing.assert_array_equal(filt.reshape(-1), filters)
    assert vocab == jvocab and len(vocab) == WHISPER["n_vocab"]
    assert vocab[:2] == [b"t0", b"t1"]
    assert vocab[WHISPER_VOCAB] == f"[_extra_token_{WHISPER_VOCAB}]".encode()


def test_whisper_loaded_forward_matches_jax(tmp_path):
    """Encoder states within 1e-2 of their largest |value| and logits
    within 3e-2 of the largest |logit|, as tests/test_torch_whisper.py
    (seen: 1.7e-3 and 2.8e-3)."""
    path = tmp_path / "whisper.bin"
    write_whisper(path, seed=5)
    jcfg, jparams, _, _ = JW.load_legacy(path)
    cfg, params, _, _ = TW.load_legacy(path, device="cpu")
    mel = np.random.default_rng(6).standard_normal(
        (1, WHISPER["n_mels"], 2 * WHISPER["n_audio_ctx"])).astype(np.float32)
    jenc = JW.encode(jcfg, jparams, jnp.asarray(mel))
    tenc = TW.encode(cfg, params, torch.from_numpy(mel))
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    assert rel(tenc.float().numpy(), np.asarray(jenc, np.float32)) <= 1e-2
    toks = np.asarray([[3, 9, 27, 4, 120]], np.int32)
    pos = np.arange(5, dtype=np.int32)[None]
    jx = JW.precompute_cross_kv(jcfg, jparams, jenc)
    ref, _ = JW.decode(jcfg, jparams, jnp.asarray(toks), jnp.asarray(pos),
                       JW.init_cache(jcfg), jx, 0)
    tx = TW.precompute_cross_kv(cfg, params, tenc)
    got, _ = TW.decode(cfg, params, torch.from_numpy(toks).long(),
                       torch.from_numpy(pos).long(),
                       TW.init_cache(cfg, device="cpu"), tx, 0)
    assert rel(got.numpy(), np.asarray(ref)) <= 3e-2
