"""Launch counters for the port's CUDA kernels.

Each kernel wrapper calls ``record`` once where it launches its kernel, and
nowhere else, so a run can show that its main path went through the kernels.
There is no implementation choice here: a wrapper runs the plain PyTorch
version for a CPU tensor and the kernel for a CUDA tensor.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Hashable

KERNELS = ("flash_attn_fwd", "gn_stats", "gn_apply", "flash_attn_bwd", "flash_attn_bwd_dq",
           "flash_attn_bwd_dkv", "bias_act", "gn_fused")

_launches: Dict[str, Counter] = {name: Counter() for name in KERNELS}


def record(name: str, key: Hashable) -> None:
    """Count one launch of kernel ``name`` on inputs described by ``key``."""
    _launches[name][key] += 1


def reset() -> None:
    for c in _launches.values():
        c.clear()


def counts() -> Dict[str, int]:
    """Launches per kernel since the last ``reset``."""
    return {name: sum(c.values()) for name, c in _launches.items()}


def launches_by_key(name: str) -> Counter:
    """Launches of kernel ``name`` per input description since the last ``reset``."""
    return Counter(_launches[name])
