"""Prompt corpus: the only training input (data-free distillation).

Port of ``sid_lsg_tpu/data/prompts.py`` for one process: one prompt per
non-empty line (a directory resolves the aesthetics file names), and an
endless, seeded, window-shuffled stream of prompt batches.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

_AESTHETICS_VARIANTS = (
    "aesthetics_6_plus.txt",
    "aesthetics_625.txt",
    "aesthetics_65.txt",
)


def read_prompt_file(path: str) -> List[str]:
    """Load one prompt per non-empty line; dirs resolve the aesthetics names."""
    if os.path.isdir(path):
        for name in _AESTHETICS_VARIANTS:
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(f"no prompt file under {path}")
    with open(path, encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


class PromptDataset:
    """Indexable prompt corpus from a file, a directory or a list."""

    def __init__(self, path_or_prompts, name: Optional[str] = None):
        if isinstance(path_or_prompts, (list, tuple)):
            self.prompts = list(path_or_prompts)
            self.name = name or "prompts"
        else:
            self.prompts = read_prompt_file(path_or_prompts)
            self.name = name or os.path.splitext(os.path.basename(path_or_prompts))[0]

    def __len__(self) -> int:
        return len(self.prompts)

    def __getitem__(self, idx: int) -> str:
        return self.prompts[idx]


class InfinitePromptIterator:
    """Endless shuffled prompt batches: deterministic given ``seed``; each
    pass reshuffles lazily within a window of ``window_ratio / 2`` of the
    corpus (the JAX package's order, single process)."""

    def __init__(self, dataset: Sequence[str], batch_size: int, seed: int = 0,
                 shuffle: bool = True, window_ratio: float = 0.5):
        if len(dataset) == 0 or batch_size <= 0:
            raise ValueError("need a non-empty corpus and a positive batch size")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.window = int(np.rint(len(dataset) * window_ratio / 2)) if shuffle else 0
        self._stream = self._indices()

    def _indices(self) -> Iterator[int]:
        order = np.arange(len(self.dataset))
        rnd = np.random.RandomState(self.seed)
        if self.shuffle:
            rnd.shuffle(order)
        idx = 0
        while True:
            i = idx % len(order)
            yield int(order[i])
            if self.window >= 2:
                j = (i - rnd.randint(self.window)) % len(order)
                order[i], order[j] = order[j], order[i]
            idx += 1

    def __iter__(self) -> "InfinitePromptIterator":
        return self

    def __next__(self) -> List[str]:
        return [self.dataset[next(self._stream)] for _ in range(self.batch_size)]
