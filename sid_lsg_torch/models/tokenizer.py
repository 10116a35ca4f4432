"""Offline stand-in tokenizer with CLIP framing.

A copy of ``HashTokenizer`` from ``sid_lsg_tpu/models/tokenizer.py``: each
whitespace word maps to a stable id in [4, vocab), bracketed by start/end
tokens and padded to 77.  For tests and random-weight runs where no vocab
files exist; the BPE ``CLIPTokenizer`` is not ported yet.
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Sequence

import numpy as np


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


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
        out = np.full((len(prompts), self.model_max_length), self.pad_token_id, dtype=np.int32)
        for i, p in enumerate(prompts):
            ids = self.encode(p)[: self.model_max_length - 2]
            seq = [self.bos_token_id] + ids + [self.eos_token_id]
            out[i, : len(seq)] = seq
        return out
