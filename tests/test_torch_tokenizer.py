"""Port parity: the two BPE tokenizers, whose word split runs without the
third-party `regex` module.

- The word split (`split_words`) against the JAX package's `_SPLIT_RE`
  (regex's GPT2_SPLIT_PATTERN) on every BMP code point, alone and in a few
  contexts (between a letter and a digit, after a space, between spaces),
  and on random strings over every character class the pattern tells
  apart. The split follows this Python's `unicodedata` (15.0.0 here);
  `regex` carries newer Unicode tables. The code points where the two part
  for that reason alone are listed in UNICODE_VERSION_EXCEPTIONS, each
  checked to be unassigned (Cn) here and a letter to `regex`; nothing else
  is left out.
- GreedyBPETokenizer and ByteLevelBPETokenizer: encode and decode equal to
  the JAX ones on the prompt battery of tests/test_tokenizer_parity.py, on
  the 800-merge vocab trained there with HF `tokenizers`, and with
  special tokens.
- Importing the port's tokenizer loads no `regex`.
"""
import json
import os
import random
import subprocess
import sys
import unicodedata
from pathlib import Path

import pytest

from ggml_imax_tpu.tokenizer import bpe as jbpe
from ggml_imax_tpu_torch.tokenizer import bpe as tbpe

REPO = Path(__file__).resolve().parent.parent

# letters in regex's Unicode tables (16.0 / 17.0) that Python 3.12's
# unicodedata 15.0.0 leaves unassigned (Cn): the port splits them as
# "other" characters
UNICODE_VERSION_EXCEPTIONS = (
    0x088F, 0x0C5C, 0x0CDC, 0x1C89, 0x1C8A, 0xA7CB, 0xA7CC, 0xA7CD, 0xA7CE,
    0xA7CF, 0xA7D2, 0xA7D4, 0xA7DA, 0xA7DB, 0xA7DC, 0xA7F1)

WORDS = [
    "the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
    "meaning", "of", "life", "is", "believe", "building", "website",
    "simple", "as", "three", "steps", "tokens", "model", "quantize",
    "tensor", "kernel", "attention", "head", "layer", "norm", "scale",
    "block", "format", "weight", "matrix", "vector", "product", "numbers",
    "1", "2", "3", "42", "100", "3.14159", "hello", "world",
]

# the battery of tests/test_tokenizer_parity.py
PROMPTS = [
    "I believe the meaning of life is",
    "Building a website can be done in 10 simple steps:",
    "Hello, World!  \t multiple   spaces\nand\nnewlines",
    "don't can't won't it's we're I'll you've they'd",
    "MixedCASE wordsWith numbers123 and 456mixed",
    "  leading spaces and trailing   ",
    "punctuation!?.,;:()[]{}<>@#$%^&*-_=+|\\/~`\"'",
    "unicode: café naïve 中文 рус \U0001f600 ☃",
    "",
    "a",
    "\n\n\n",
    "tab\tseparated\tvalues",
]


def ref_split(text):
    return [m.group(0) for m in jbpe._SPLIT_RE.finditer(text)]


def test_unicode_version_exceptions_are_only_that():
    regex = pytest.importorskip("regex")
    letter = regex.compile(r"\p{L}")
    assert unicodedata.unidata_version == "15.0.0"
    for c in UNICODE_VERSION_EXCEPTIONS:
        ch = chr(c)
        assert unicodedata.category(ch) == "Cn", hex(c)
        assert letter.match(ch), hex(c)
        assert tbpe.split_words("a" + ch + "1") == ["a", ch, "1"]
        assert ref_split("a" + ch + "1") == ["a" + ch, "1"]


@pytest.mark.parametrize("block", range(16))
def test_split_matches_regex_on_every_bmp_code_point(block):
    skip = set(UNICODE_VERSION_EXCEPTIONS)
    for c in range(block * 0x1000, (block + 1) * 0x1000):
        if c in skip:
            continue
        ch = chr(c)
        for text in (ch, "a" + ch + "1", "1" + ch + "a", " " + ch,
                     ch + " x", "  " + ch + ch + "  ", "'" + ch):
            assert tbpe.split_words(text) == ref_split(text), (hex(c), text)


@pytest.mark.parametrize("seed", range(4))
def test_split_matches_regex_on_random_strings(seed):
    pool = (list(" \t\n\r\x0b\x0c\x1c\x1d\x85\xa0 　 'srtvemldSL"
                 "!?.,-_aZé中ß1٣２Ⅷ¼́\U0001f600\ud800")
            + ["'s", "'ll", "'re", "'ve", "'d", "'m", "'t", "'S"])
    rnd = random.Random(seed)
    for _ in range(5000):
        text = "".join(rnd.choice(pool) for _ in range(rnd.randint(0, 14)))
        assert tbpe.split_words(text) == ref_split(text), repr(text)


def test_bytes_to_unicode_matches():
    assert tbpe.bytes_to_unicode() == jbpe.bytes_to_unicode()


def _greedy_vocab():
    chars = sorted({c for p in PROMPTS + WORDS for c in p})
    toks = chars + WORDS + [" " + w for w in WORDS] + ["'t", " can", "ing"]
    return [t.encode() if i % 3 == 0 else t for i, t in enumerate(toks)]


@pytest.mark.parametrize("prompt", PROMPTS, ids=range(len(PROMPTS)))
def test_greedy_tokenizer_matches_jax(prompt):
    vocab = _greedy_vocab()
    t, j = tbpe.GreedyBPETokenizer(vocab), jbpe.GreedyBPETokenizer(vocab)
    ids = t.encode(prompt)
    assert ids == j.encode(prompt)
    assert t.decode(ids) == j.decode(ids)


@pytest.fixture(scope="module")
def trained():
    """The 800-merge byte-level vocab of tests/test_tokenizer_parity.py."""
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import decoders, models, pre_tokenizers, trainers
    corpus = []
    for i in range(600):
        ws = [WORDS[(i * 7 + j * 3) % len(WORDS)] for j in range(12)]
        corpus.append(" ".join(ws) + ("." if i % 3 else "!"))
    corpus += PROMPTS * 3
    hf = tokenizers.Tokenizer(models.BPE())
    hf.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    hf.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=800, special_tokens=[], show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    hf.train_from_iterator(corpus, trainer)
    state = json.loads(hf.to_str())
    merges = [m if isinstance(m, str) else " ".join(m)
              for m in state["model"]["merges"]]
    vocab = [None] * len(state["model"]["vocab"])
    for tok, i in state["model"]["vocab"].items():
        vocab[i] = tok
    return hf, vocab, merges


@pytest.mark.parametrize("prompt", PROMPTS, ids=range(len(PROMPTS)))
def test_byte_level_tokenizer_matches_jax_and_hf(trained, prompt):
    hf, vocab, merges = trained
    t = tbpe.ByteLevelBPETokenizer(vocab, merges)
    j = jbpe.ByteLevelBPETokenizer(vocab, merges)
    ids = t.encode(prompt)
    assert ids == j.encode(prompt) == hf.encode(prompt).ids
    assert t.decode(ids) == j.decode(ids) == hf.decode(ids)


def test_byte_level_tokenizer_corpus_sweep(trained):
    hf, vocab, merges = trained
    t = tbpe.ByteLevelBPETokenizer(vocab, merges)
    j = jbpe.ByteLevelBPETokenizer(vocab, merges)
    for i in range(200):
        line = " ".join(WORDS[(i * 11 + k * 5) % len(WORDS)]
                        for k in range(1 + i % 17))
        if i % 4 == 0:
            line = line.upper()
        if i % 5 == 0:
            line = "  " + line + "\t"
        assert t.encode(line) == j.encode(line) == hf.encode(line).ids, line


SPECIALS = ["<|endoftext|>", "[SEP]", "a.b*", "<s>"]
SPECIAL_TEXTS = ["hello<|endoftext|>world", "[SEP]x[SEP]", "<s>the a.b* fox",
                 "a.bb and a.b*<|endoftext|>", "no specials here", "<s><s>",
                 "<|endoftext|>"]


@pytest.mark.parametrize("text", SPECIAL_TEXTS)
def test_special_tokens_match_jax(trained, text):
    _, vocab, merges = trained
    vocab = vocab + SPECIALS
    bt = tbpe.ByteLevelBPETokenizer(vocab, merges, SPECIALS + ["<absent>"])
    bj = jbpe.ByteLevelBPETokenizer(vocab, merges, SPECIALS + ["<absent>"])
    assert bt.special_tokens == bj.special_tokens
    assert bt.encode(text) == bj.encode(text)
    gvocab = _greedy_vocab() + SPECIALS
    gt = tbpe.GreedyBPETokenizer(gvocab, SPECIALS)
    gj = jbpe.GreedyBPETokenizer(gvocab, SPECIALS)
    ids = gt.encode(text)
    assert ids == gj.encode(text)
    assert gt.decode(ids) == gj.decode(ids)


def test_port_tokenizer_loads_no_regex():
    code = ("import sys\n"
            "import ggml_imax_tpu_torch.tokenizer.bpe as b\n"
            "b.ByteLevelBPETokenizer(['a', 'b', 'ab'], ['a b']).encode('ab')\n"
            "b.GreedyBPETokenizer([b'a']).encode('a a')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('regex', 'transformers', 'tokenizers', 'jax', "
            "'ggml_imax_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
