"""CLIP tokenizers of the port: the BPE ``CLIPTokenizer`` and ``HashTokenizer``.

A copy of ``sid_lsg_tpu/models/tokenizer.py``.  ``CLIPTokenizer`` reads an
SD checkpoint's ``tokenizer/`` (``vocab.json``, ``merges.txt`` or
``merges.txt.gz``, ``tokenizer_config.json``): lowercased, twice
HTML-unescaped, whitespace-normalised text is split into words, each word's
UTF-8 bytes are byte-pair encoded, and the ids are bracketed by the start and
end tokens and padded to ``model_max_length`` (77).  SD1.5 pads with
``<|endoftext|>``, SD2.x with ``!`` (from ``tokenizer_config.json``).

The JAX package splits words with the ``regex`` package's
``[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` (after the special tokens and the
contractions ``'s 't 're 've 'm 'll 'd``, case-insensitive).  The card's
machine has no ``regex``, and the stdlib ``re`` has no ``\\p{..}`` (its
``\\w`` also takes the ``No``/``Nl`` numbers, ``\\d`` only ``Nd``), so
``_split_words`` scans by ``unicodedata.category`` instead: letters are the
``L*`` categories and numbers the ``N*`` ones.  It gives ``regex``'s split on
every code point that the interpreter's Unicode database assigns; a code
point assigned only by a later Unicode version is ``Cn`` here and splits as
punctuation.

``HashTokenizer`` is the offline stand-in with the same framing: each
whitespace word maps to a stable id in [4, vocab).  ``load_tokenizer`` gives
a ``CLIPTokenizer`` when a checkpoint has a ``tokenizer/`` and the stand-in
otherwise, as the JAX package's does.
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import html
import json
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _frame(tokenizer, prompts: Sequence[str]) -> np.ndarray:
    """(B, model_max_length) int32: [bos] ids[:max - 2] [eos], then padding."""
    n = tokenizer.model_max_length
    out = np.full((len(prompts), n), tokenizer.pad_token_id, dtype=np.int32)
    for i, p in enumerate(prompts):
        seq = [tokenizer.bos_token_id] + tokenizer.encode(p)[: n - 2] + [tokenizer.eos_token_id]
        out[i, : len(seq)] = seq
    return out


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable unicode map (the GPT-2 / CLIP table)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Sequence[str]) -> set:
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _char_class(c: str) -> str:
    """'L' (letter), 'N' (number), 'S' (skipped) or 'P' (anything else).

    Skipped are white space and, as the regex module's case-insensitive
    negated class leaves them out, the non-letters that case fold to a letter
    (U+0345, which folds to iota): no alternative of the pattern takes them."""
    if c.isspace():
        return "S"
    cat = unicodedata.category(c)[0]
    if cat in "LN":
        return cat
    folded = c.casefold()
    return "S" if folded != c and unicodedata.category(folded[0])[0] == "L" else "P"


def _matches_at(text: str, i: int, literal: str) -> bool:
    """``literal`` at ``text[i:]`` under the regex module's case-insensitive
    match of lowercase text: 's' also matches the long s U+017F, which case
    folds to it (no other letter of the literals has such a partner)."""
    chunk = text[i:i + len(literal)]
    return len(chunk) == len(literal) and all(c == t or (t == "s" and c == "ſ")
                                              for c, t in zip(chunk, literal))


def _split_words(text: str) -> List[str]:
    """The JAX tokenizer's ``regex.findall`` split, by character category."""
    words, i, n = [], 0, len(text)
    while i < n:
        literals = _SPECIALS if text[i] == "<" else _CONTRACTIONS if text[i] == "'" else ()
        literal = next((lit for lit in literals if _matches_at(text, i, lit)), None)
        if literal is not None:
            words.append(text[i:i + len(literal)])
            i += len(literal)
            continue
        cls = _char_class(text[i])
        if cls == "S":
            i += 1
            continue
        j = i + 1
        if cls != "N":  # numbers go one at a time; letters and the rest in runs
            while j < n and _char_class(text[j]) == cls:
                j += 1
        words.append(text[i:j])
        i = j
    return words


class CLIPTokenizer:
    """BPE tokenizer over a local SD ``tokenizer/`` directory."""

    def __init__(self, tokenizer_dir: str, model_max_length: int = 77,
                 pad_token: Optional[str] = None):
        with open(os.path.join(tokenizer_dir, "vocab.json"), encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        merges_path = os.path.join(tokenizer_dir, "merges.txt")
        if not os.path.exists(merges_path) and os.path.exists(merges_path + ".gz"):
            merges_path += ".gz"
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [m for m in merges if m and not m.startswith("#version")]
        self.bpe_ranks: Dict[Tuple[str, ...], int] = {tuple(m.split()): i
                                                      for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache: Dict[str, str] = {}
        self.model_max_length = model_max_length
        self.bos_token_id = self.encoder["<|startoftext|>"]
        self.eos_token_id = self.encoder["<|endoftext|>"]
        cfg_path = os.path.join(tokenizer_dir, "tokenizer_config.json")
        if pad_token is None and os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                pad_token = json.load(f).get("pad_token")
            if isinstance(pad_token, dict):
                pad_token = pad_token.get("content")
        self.pad_token_id = self.encoder.get(pad_token, self.eos_token_id)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        """Text -> BPE ids (no framing); a token missing from the vocab raises
        ``KeyError``."""
        ids: List[int] = []
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        for word in _split_words(text):
            word = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(word).split(" "))
        return ids

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        """(B, model_max_length) int32 ids, truncated and padded (HF
        ``padding='max_length', truncation=True``)."""
        return _frame(self, prompts)


class HashTokenizer:
    """Deterministic offline stand-in with CLIP-compatible framing."""

    def __init__(self, vocab_size: int = 1000, model_max_length: int = 77):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.pad_token_id = 2

    def encode(self, text: str) -> List[int]:
        ids = []
        for w in _whitespace_clean(text).lower().split(" "):
            if not w:
                continue
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            ids.append(4 + h % (self.vocab_size - 4))
        return ids

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        return _frame(self, prompts)


def load_tokenizer(model_dir: str, model_max_length: int = 77):
    """A checkpoint directory's tokenizer: ``CLIPTokenizer`` over its
    ``tokenizer/`` (or over ``model_dir`` itself when that holds
    ``vocab.json``), else ``HashTokenizer`` with its default vocab of 1000."""
    tok_dir = os.path.join(model_dir, "tokenizer")
    if not os.path.isdir(tok_dir):
        tok_dir = model_dir
    if os.path.exists(os.path.join(tok_dir, "vocab.json")):
        return CLIPTokenizer(tok_dir, model_max_length=model_max_length)
    return HashTokenizer(model_max_length=model_max_length)
