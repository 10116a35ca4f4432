"""Real-image latent stream for SiDA adversarial training (one process).

Port of ``sid_lsg_tpu/data/latents.py``.  An ``encode_latents`` corpus is two
files from one ``--dest foo.npz``:

- ``foo.latents.npy``: (N, h, w, c) float16, VAE posterior means already
  multiplied by the VAE scaling factor (the space the UNet consumes),
  memory-mapped so that start-up is O(1) and host memory stays flat;
- ``foo.npz``: ``captions`` (N,) of the paired prompts (plus ``latents`` in
  hand-built fixtures without the sidecar; npz members cannot be mapped).

Latents come out NHWC float32, as the files hold them.  ``write_corpus``
writes the two files (``cli/encode_latents``).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np


def _sidecar_path(npz_path: str) -> str:
    root, _ = os.path.splitext(npz_path)
    return root + ".latents.npy"


def write_corpus(dest: str, latents: np.ndarray, captions: List[str]) -> str:
    """Write ``latents`` (N, h, w, c) as the f16 sidecar of ``dest`` and the
    captions into ``dest``; returns the sidecar's path."""
    if len(latents) != len(captions):
        raise ValueError(f"{len(latents)} latents but {len(captions)} captions")
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    sidecar = _sidecar_path(os.path.abspath(dest))
    mm = np.lib.format.open_memmap(sidecar, mode="w+", dtype=np.float16, shape=latents.shape)
    mm[:] = latents
    mm.flush()
    del mm
    np.savez(dest, captions=np.array(captions))
    return sidecar


class LatentDataset:
    """(latent, caption) pairs of an ``encode_latents`` corpus."""

    def __init__(self, path: str):
        self.path = path
        sidecar = _sidecar_path(path)
        with np.load(path) as data:
            if "captions" not in data or ("latents" not in data and not os.path.exists(sidecar)):
                raise ValueError(f"{path}: expected 'captions' plus 'latents' (or a {sidecar} "
                                 "sidecar), as cli/encode_latents writes them")
            self.captions = [str(c) for c in data["captions"]]
            if os.path.exists(sidecar):
                self.latents = np.load(sidecar, mmap_mode="r")
            else:
                print(f"note: {sidecar} not found; loading latents from the npz into RAM (fine "
                      "for fixtures, O(corpus) for real data)", file=sys.stderr)
                self.latents = data["latents"]
        if len(self.latents) != len(self.captions):
            raise ValueError(f"{path}: latents/captions length mismatch")

    def __len__(self) -> int:
        return len(self.captions)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, str]:
        return np.asarray(self.latents[idx], np.float32), self.captions[idx]


class InfiniteLatentIterator:
    """Endless microbatches, reshuffled each epoch with
    ``RandomState(seed + epoch)`` (the JAX iterator's order for one process).
    The state is the epoch and the position in it (``state_dict``)."""

    def __init__(self, dataset: LatentDataset, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self._epoch = 0
        self._pos = 0
        self._order: Optional[np.ndarray] = None

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self._epoch, "pos": self._pos}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self._epoch, self._pos = int(state["epoch"]), int(state["pos"])
        self._order = (None if self._epoch == 0 else np.random.RandomState(
            self.seed + self._epoch - 1).permutation(len(self.dataset)))

    def __iter__(self) -> "InfiniteLatentIterator":
        return self

    def __next__(self) -> Tuple[np.ndarray, List[str]]:
        lats, caps = [], []
        while len(caps) < self.batch_size:
            if self._order is None or self._pos >= len(self._order):
                self._order = np.random.RandomState(self.seed + self._epoch).permutation(
                    len(self.dataset))
                self._pos = 0
                self._epoch += 1
            lat, cap = self.dataset[int(self._order[self._pos])]
            self._pos += 1
            lats.append(lat)
            caps.append(cap)
        return np.stack(lats), caps
