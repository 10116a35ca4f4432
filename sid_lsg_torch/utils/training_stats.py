"""Named scalar counters for the training loop, one process (port of the
single-process part of ``sid_lsg_tpu/utils/training_stats.py``): ``report``
accumulates [count, sum, sum of squares] per name, a ``Collector`` reads
the moments reported since its last ``update``."""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np

_counters: Dict[str, np.ndarray] = {}


def report(name: str, value: Any) -> Any:
    """Accumulate the finite scalar(s) of ``value`` under ``name``."""
    if value is None:
        return value
    arr = np.asarray(value, dtype=np.float64).reshape(-1)
    arr = arr[np.isfinite(arr)]
    if arr.size:
        _counters.setdefault(name, np.zeros(3))
        _counters[name] += np.array([arr.size, arr.sum(), np.square(arr).sum()])
    return value


class Collector:
    """Moments per name (matching ``regex``) between two ``update`` calls."""

    def __init__(self, regex: str = ".*"):
        self._regex = re.compile(regex)
        self._moments: Dict[str, np.ndarray] = {}
        self.update()
        self._moments.clear()

    def names(self) -> List[str]:
        return [n for n in _counters if self._regex.fullmatch(n)]

    def update(self) -> None:
        self._moments.clear()
        for name in self.names():
            delta = _counters[name].copy()
            _counters[name][:] = 0
            if delta[0]:
                self._moments[name] = delta

    def num(self, name: str) -> int:
        return int(self._moments.get(name, np.zeros(3))[0])

    def mean(self, name: str) -> float:
        m = self._moments.get(name, np.zeros(3))
        return float(m[1] / m[0]) if m[0] else float("nan")
