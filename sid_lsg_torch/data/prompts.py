"""Prompt corpus: the only training input (data-free distillation).

Port of ``sid_lsg_tpu/data/prompts.py`` for one process: one prompt per
non-empty line (a directory resolves the aesthetics file names), and an
endless, seeded, window-shuffled stream of prompt batches whose position
is an explicit state (``state_dict`` / ``load_state_dict``), so that a
training-state dump can carry it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def random_state_dict(rnd: np.random.RandomState) -> Dict[str, object]:
    """A ``RandomState``'s state as tensors and numbers (what
    ``torch.load(weights_only=True)`` reads back)."""
    kind, keys, pos, has_gauss, cached = rnd.get_state()
    return {"kind": kind, "keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}


def set_random_state(rnd: np.random.RandomState, state: Dict[str, object]) -> None:
    rnd.set_state((state["kind"], np.asarray(state["keys"], dtype=np.uint32), state["pos"],
                   state["has_gauss"], state["cached_gaussian"]))

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
    corpus (the JAX package's order, single process).  The state is the
    order, the position and the ``RandomState`` that swaps within the
    window."""

    def __init__(self, dataset: Sequence[str], batch_size: int, seed: int = 0,
                 shuffle: bool = True, window_ratio: float = 0.5):
        if len(dataset) == 0 or batch_size <= 0:
            raise ValueError("need a non-empty corpus and a positive batch size")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.window = int(np.rint(len(dataset) * window_ratio / 2)) if shuffle else 0
        self._order = np.arange(len(dataset))
        self._rnd = np.random.RandomState(seed)
        if shuffle:
            self._rnd.shuffle(self._order)
        self._idx = 0

    def _next_index(self) -> int:
        i = self._idx % len(self._order)
        out = int(self._order[i])
        if self.window >= 2:
            j = (i - self._rnd.randint(self.window)) % len(self._order)
            self._order[i], self._order[j] = self._order[j], self._order[i]
        self._idx += 1
        return out

    def state_dict(self) -> Dict[str, object]:
        return {"order": torch.from_numpy(self._order.astype(np.int64)), "idx": self._idx,
                "rnd": random_state_dict(self._rnd)}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        order = np.asarray(state["order"], dtype=np.int64)
        if order.shape != self._order.shape:
            raise ValueError(f"a prompt order of {len(order)} for a corpus of {len(self._order)}")
        self._order = order.astype(self._order.dtype)
        self._idx = int(state["idx"])
        set_random_state(self._rnd, state["rnd"])

    def __iter__(self) -> "InfinitePromptIterator":
        return self

    def __next__(self) -> List[str]:
        return [self.dataset[self._next_index()] for _ in range(self.batch_size)]
