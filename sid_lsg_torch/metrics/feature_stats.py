"""Streaming feature statistics and progress reporting for metric loops.

Port of ``sid_lsg_tpu/metrics/feature_stats.py``: an order-invariant moment
accumulator (count, sum x, sum x^T x in float64) and/or a doubling flat
feature buffer, a stats cache on disk, and an ms/item progress line.
``merge_across_processes`` is the identity in one process; runs over
several processes are not ported yet (ROADMAP Queue 1 item 5b).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

_SAVE_VERSION = 2


@dataclass
class _Moments:
    """Order-invariant running sums: count, Σx and Σxᵀx in float64."""

    dim: int
    count: int = 0
    sum1: np.ndarray = field(init=False)
    sum2: np.ndarray = field(init=False)

    def __post_init__(self) -> None:
        self.sum1 = np.zeros(self.dim, np.float64)
        self.sum2 = np.zeros((self.dim, self.dim), np.float64)

    def add(self, x: np.ndarray) -> None:
        x64 = x.astype(np.float64, copy=False)
        self.count += x64.shape[0]
        self.sum1 += x64.sum(axis=0)
        self.sum2 += x64.T @ x64

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        mean = self.sum1 / self.count
        cov = self.sum2 / self.count - np.outer(mean, mean)
        return mean, cov


class _GrowBuffer:
    """Flat (N, dim) float32 store that doubles capacity on demand."""

    def __init__(self, dim: int):
        self._data = np.empty((256, dim), np.float32)
        self._n = 0

    def extend(self, x: np.ndarray) -> None:
        need = self._n + x.shape[0]
        if need > self._data.shape[0]:
            cap = max(need, 2 * self._data.shape[0])
            grown = np.empty((cap, self._data.shape[1]), np.float32)
            grown[: self._n] = self._data[: self._n]
            self._data = grown
        self._data[self._n : need] = x
        self._n = need

    def view(self) -> np.ndarray:
        return self._data[: self._n]


class FeatureStats:
    """Streams detector feature batches into moments and/or a raw buffer."""

    def __init__(self, capture_all: bool = False, capture_mean_cov: bool = False,
                 max_items: Optional[int] = None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self._moments: Optional[_Moments] = None
        self._buffer: Optional[_GrowBuffer] = None

    # ---------------------------------------------------------------- append
    @property
    def num_items(self) -> int:
        if self._moments is not None:
            return self._moments.count
        return self._buffer._n if self._buffer else 0

    @property
    def num_features(self) -> Optional[int]:
        if self._moments is not None:
            return self._moments.dim
        if self._buffer is not None:
            return self._buffer.view().shape[1]
        return None

    def is_full(self) -> bool:
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x: np.ndarray) -> None:
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 2:
            raise ValueError(f"expected (batch, features), got {x.shape}")
        if self.max_items is not None:
            room = self.max_items - self.num_items
            if room <= 0:
                return
            x = x[:room]
        if self.capture_mean_cov:
            if self._moments is None:
                self._moments = _Moments(x.shape[1])
            self._moments.add(x)
        if self.capture_all:
            if self._buffer is None:
                self._buffer = _GrowBuffer(x.shape[1])
            self._buffer.extend(x)

    # --------------------------------------------------------------- results
    def get_all(self) -> np.ndarray:
        if not self.capture_all:
            raise ValueError("these stats were not asked to capture the features")
        if self._buffer is None:
            return np.zeros((0, 0), np.float32)
        return self._buffer.view().copy()

    def get_mean_cov(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self.capture_mean_cov or self._moments is None:
            raise ValueError("these stats hold no mean and covariance")
        return self._moments.finalize()

    # ------------------------------------------------------------ multihost
    def merge_across_processes(self) -> None:
        """The identity for one process; more raise (ROADMAP Queue 1 item 5b)."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise NotImplementedError("merging metric features across processes is not ported "
                                      "yet (ROADMAP Queue 1 item 5b)")

    # ---------------------------------------------------------------- cache
    def save(self, path: str) -> None:
        """Write the stats as an ``.npz`` (no pickle), atomically."""
        arrays = {"version": np.int64(_SAVE_VERSION),
                  "flags": np.array([self.capture_all, self.capture_mean_cov]),
                  "max_items": np.int64(-1 if self.max_items is None else self.max_items)}
        if self._moments is not None:
            arrays.update(count=np.int64(self._moments.count), sum1=self._moments.sum1,
                          sum2=self._moments.sum2)
        if self._buffer is not None:
            arrays["features"] = self._buffer.view()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "FeatureStats":
        with np.load(path, allow_pickle=False) as d:
            max_items = int(d["max_items"])
            obj = cls(capture_all=bool(d["flags"][0]), capture_mean_cov=bool(d["flags"][1]),
                      max_items=None if max_items < 0 else max_items)
            if "sum1" in d:
                obj._moments = _Moments(d["sum1"].shape[0])
                obj._moments.count = int(d["count"])
                obj._moments.sum1 = d["sum1"]
                obj._moments.sum2 = d["sum2"]
            if "features" in d:
                obj._buffer = _GrowBuffer(d["features"].shape[1])
                obj._buffer.extend(d["features"])
        return obj


class ProgressMonitor:
    """An ms/item progress line, at most every ``flush_interval`` seconds."""

    def __init__(self, tag: Optional[str] = None, num_items: Optional[int] = None,
                 verbose: bool = True, flush_interval: float = 2.0):
        self.tag = tag
        self.num_items = num_items
        self.verbose = verbose
        self.flush_interval = flush_interval
        self.start_time = time.time()
        self.batch_time = self.start_time
        self.batch_items = 0
        self._last_flush = 0.0

    def update(self, cur_items: int) -> None:
        now = time.time()
        if not self.verbose or now - self._last_flush < self.flush_interval:
            self.batch_time, self.batch_items = now, cur_items
            return
        total_time = now - self.start_time
        time_per_item = (
            (now - self.batch_time) / max(cur_items - self.batch_items, 1)
        )
        frac = f"{cur_items}/{self.num_items}" if self.num_items else str(cur_items)
        print(f"{self.tag or 'progress'} items {frac:<14s} time {total_time:<8.1f}s "
              f"ms/item {time_per_item * 1000:.2f}")
        self._last_flush = now
        self.batch_time, self.batch_items = now, cur_items
