"""GPT-style tokenizers (the port's own copy of
ggml_imax_tpu/tokenizer/bpe.py), on the standard library alone.

Two flavors, as in the reference:
- `GreedyBPETokenizer`: the examples' tokenizer (gpt_tokenize,
  examples/common.cpp:297-360): the GPT-2 word split + greedy
  longest-substring matching against the vocab. The gpt-2/gpt-j CLIs use
  it with legacy .bin vocabs (no merge ranks).
- `ByteLevelBPETokenizer`: byte-level merge-rank BPE for GGUF models that
  carry tokenizer.ggml.merges (HF-compatible encoding).

Both share the GPT-2 word split and the byte-level decode table. The JAX
package splits with the third-party `regex` module's GPT2_SPLIT_PATTERN;
here `split_words` scans for the same matches with `unicodedata` (\\p{L}:
categories L*, \\p{N}: N*) and the Unicode White_Space set (what `regex`'s
\\s matches; str.isspace() adds U+001C-U+001F). The two part only where
the Unicode tables differ: a code point that `regex`'s newer tables call a
letter and this Python's unicodedata leaves unassigned.
"""
from __future__ import annotations

import re
import unicodedata

GPT2_SPLIT_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)

# the Unicode White_Space property
_WHITESPACE = frozenset(map(chr, (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85,
                                  0xA0, 0x1680, *range(0x2000, 0x200B),
                                  0x2028, 0x2029, 0x202F, 0x205F, 0x3000)))
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _kind(ch: str) -> str:
    """'S' whitespace, 'L' letter, 'N' number, 'O' anything else."""
    if ch in _WHITESPACE:
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def split_words(text: str) -> list[str]:
    """The matches of GPT2_SPLIT_PATTERN over text, in order. At each
    position the pattern's alternatives are tried as the regex engine tries
    them: a contraction; an optional space and a run of letters, of
    numbers or of other characters (greedy); a run of whitespace that
    leaves its last character to the word after it (\\s+(?!\\S)), or all of
    it at the end of the text; a lone whitespace character."""
    kinds = [_kind(c) for c in text]
    n, i, out = len(text), 0, []
    while i < n:
        if text[i] == "'":
            word = next((w for w in _CONTRACTIONS if text.startswith(w, i)),
                        None)
            if word is not None:
                out.append(word)
                i += len(word)
                continue
        if kinds[i] != "S" or (text[i] == " " and i + 1 < n
                               and kinds[i + 1] != "S"):
            j = i + (kinds[i] == "S")
            kind = kinds[j]
            while j < n and kinds[j] == kind:
                j += 1
        else:
            j = i
            while j < n and kinds[j] == "S":
                j += 1
            if j < n and j - i > 1:
                j -= 1          # the last one goes with the next word
        out.append(text[i:j])
        i = j
    return out


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2 byte <-> printable-unicode table (as in HF's gpt2 tokenizer)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD))
          + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_B2U = bytes_to_unicode()
_U2B = {v: k for k, v in _B2U.items()}


def _special_pattern(tokens) -> re.Pattern:
    return re.compile("|".join(re.escape(t) for t in tokens))


class GreedyBPETokenizer:
    """Vocab-only tokenizer used by the reference examples."""

    def __init__(self, vocab: list[bytes] | list[str], special_tokens=()):
        self.id_to_token = [t.decode("utf-8", errors="replace") if isinstance(t, bytes) else t
                            for t in vocab]
        self.token_to_id = {t: i for i, t in enumerate(self.id_to_token)}
        self.special_tokens = list(special_tokens)

    def encode(self, text: str) -> list[int]:
        words: list[str] = []
        if self.special_tokens:
            pos = 0
            for m in _special_pattern(self.special_tokens).finditer(text):
                words.extend(split_words(text[pos:m.start()]))
                words.append(m.group(0))
                pos = m.end()
            text = text[pos:]
        words.extend(split_words(text))

        tokens: list[int] = []
        for word in words:
            i = 0
            while i < len(word):
                for j in range(len(word) - 1, i - 1, -1):
                    cand = word[i:j + 1]
                    tid = self.token_to_id.get(cand)
                    if tid is not None:
                        tokens.append(tid)
                        i = j + 1
                        break
                    if j == i:  # no single-char match: skip (reference warns)
                        i += 1
        return tokens

    def decode(self, ids) -> str:
        return "".join(self.id_to_token[int(i)] for i in ids)


class ByteLevelBPETokenizer:
    """Merge-rank byte-level BPE (GPT-2/HF-compatible), for GGUF vocabs."""

    def __init__(self, vocab: list[str], merges: list[str], special_tokens=()):
        self.id_to_token = list(vocab)
        self.token_to_id = {t: i for i, t in enumerate(vocab)}
        self.ranks = {}
        for r, m in enumerate(merges):
            a, b = m.split(" ", 1)
            self.ranks[(a, b)] = r
        self.special_tokens = {t: self.token_to_id[t] for t in special_tokens
                               if t in self.token_to_id}

    def _bpe_word(self, word: str) -> list[str]:
        parts = list(word)
        while len(parts) > 1:
            best, best_rank = None, None
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            parts[best:best + 2] = [parts[best] + parts[best + 1]]
        return parts

    def encode(self, text: str) -> list[int]:
        out: list[int] = []
        segments = [(text, False)]
        if self.special_tokens:
            segments = []
            pos = 0
            for m in _special_pattern(self.special_tokens).finditer(text):
                if m.start() > pos:
                    segments.append((text[pos:m.start()], False))
                segments.append((m.group(0), True))
                pos = m.end()
            if pos < len(text):
                segments.append((text[pos:], False))
        for seg, is_special in segments:
            if is_special:
                out.append(self.special_tokens[seg])
                continue
            for w in split_words(seg):
                word = "".join(_B2U[b] for b in w.encode("utf-8"))
                for piece in self._bpe_word(word):
                    tid = self.token_to_id.get(piece)
                    if tid is not None:
                        out.append(tid)
        return out

    def decode(self, ids) -> str:
        text = "".join(self.id_to_token[int(i)] for i in ids)
        data = bytes(_U2B.get(c, ord(" ")) for c in text)
        return data.decode("utf-8", errors="replace")
