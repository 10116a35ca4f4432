"""Runtime misc: shape asserts, profiler annotations and traces, module
summaries, host and device memory.

Port of ``sid_lsg_tpu/utils/misc.py``: ``profiled_function`` is a
``torch.profiler.record_function`` span, the trace is one
``torch.profiler.profile`` over the CPU and (when there is one) the card,
written as a Chrome trace into the directory, and the memory numbers come
from ``torch.cuda``.
"""

from __future__ import annotations

import functools
import os
import resource
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn


def assert_shape(tensor: Any, ref_shape: Sequence[Optional[int]]) -> None:
    """Shape check with None wildcards."""
    shape = tuple(np.shape(tensor))
    if len(shape) != len(ref_shape):
        raise AssertionError(
            f"wrong number of dimensions: got {len(shape)}, expected {len(ref_shape)}")
    for i, (got, ref) in enumerate(zip(shape, ref_shape)):
        if ref is not None and got != ref:
            raise AssertionError(f"wrong size for dimension {i}: got {got}, expected {ref}")


def profiled_function(fn):
    """Name each call of ``fn`` as a span in the profiler's trace."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(fn.__name__):
            return fn(*args, **kwargs)

    return wrapper


class ProfilerTrace:
    """One ``torch.profiler.profile`` over the CPU and the card (when one
    is there) whose Chrome trace ``stop`` writes into ``logdir``."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()

    def stop(self) -> str:
        """End the trace (after the card's queue drains); returns the file."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        self._prof.export_chrome_trace(path)
        return path


def start_profiler_trace(logdir: str) -> ProfilerTrace:
    return ProfilerTrace(logdir)


def stop_profiler_trace(trace: ProfilerTrace) -> str:
    return trace.stop()


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per card {bytes_in_use, peak_bytes_in_use}; {} without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {"bytes_in_use": torch.cuda.memory_allocated(i),
                          "peak_bytes_in_use": torch.cuda.max_memory_allocated(i)}
            for i in range(torch.cuda.device_count())}


def peak_device_memory_gb() -> float:
    stats = device_memory_stats()
    if not stats:
        return 0.0
    return max(s["peak_bytes_in_use"] for s in stats.values()) / 2**30


def cpu_memory_gb() -> float:
    """The process's peak resident set (Linux reports it in KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def count_params(tree: Any) -> int:
    """Elements of a module's parameters, or of a dict / list of tensors."""
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return int(np.prod(np.shape(tree)))


def print_module_summary(module: nn.Module, depth: int = 2) -> str:
    """Parameter counts of ``module``'s submodules down to ``depth``."""
    rows = []
    for name, sub in module.named_modules():
        level = 0 if not name else name.count(".") + 1
        if level <= depth:
            rows.append((name or type(module).__name__, type(sub).__name__, count_params(sub)))
    width = max(len(r[0]) for r in rows)
    table = "\n".join(f"{n:<{width}}  {kind:<24} {p:>14,d}" for n, kind, p in rows)
    print(table)
    return table
