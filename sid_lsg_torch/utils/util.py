"""Host utilities of the training loop: EasyDict, a stdout/stderr tee into
the run dir's ``log.txt``, run-dir numbering and time formatting (port of
the parts of ``sid_lsg_tpu/utils/util.py`` the loop uses)."""

from __future__ import annotations

import io
import os
import sys
from typing import Any, Optional


class EasyDict(dict):
    """dict with attribute access."""

    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__  # type: ignore[assignment]

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(name)


class _Fanout(io.TextIOBase):
    """Text stream that mirrors every write to a list of sinks."""

    def __init__(self, sinks: list, autoflush: bool):
        super().__init__()
        self._sinks = sinks
        self._autoflush = autoflush

    def writable(self) -> bool:
        return True

    def write(self, text: str) -> int:
        for sink in self._sinks:
            sink.write(text)
            if self._autoflush:
                sink.flush()
        return len(text)

    def flush(self) -> None:
        for sink in self._sinks:
            sink.flush()


class Logger:
    """Mirror stdout and stderr into ``file_name`` until ``close``;
    ``file_name=None`` leaves the console alone."""

    def __init__(self, file_name: Optional[str] = None, file_mode: str = "a",
                 should_flush: bool = True):
        self._log_file = open(file_name, file_mode) if file_name else None
        self._prev = {"stdout": sys.stdout, "stderr": sys.stderr}
        self._tees = {}
        for name, prev in self._prev.items():
            sinks = [prev] + ([self._log_file] if self._log_file else [])
            self._tees[name] = _Fanout(sinks, autoflush=should_flush)
            setattr(sys, name, self._tees[name])

    def __enter__(self) -> "Logger":
        return self

    def __exit__(self, *_: Any) -> None:
        self.close()

    def close(self) -> None:
        for name, prev in self._prev.items():
            if getattr(sys, name) is self._tees.get(name):
                setattr(sys, name, prev)
        if self._log_file is not None:
            self._log_file.flush()
            self._log_file.close()
            self._log_file = None


def format_time(seconds: float) -> str:
    """Human-readable duration: 42s, 3m 05s, 2h 03m 05s, 1d 02h 03m."""
    s = int(round(seconds))
    if s < 60:
        return f"{s}s"
    if s < 60 * 60:
        return f"{s // 60}m {s % 60:02d}s"
    if s < 24 * 60 * 60:
        return f"{s // (60 * 60)}h {(s // 60) % 60:02d}m {s % 60:02d}s"
    return f"{s // (24 * 60 * 60)}d {(s // (60 * 60)) % 24:02d}h {(s // 60) % 60:02d}m"


def make_run_dir(outdir: str, desc: str) -> str:
    """Create the next numbered run dir ``{id:05d}-{desc}`` under ``outdir``."""
    prev = [x for x in os.listdir(outdir) if os.path.isdir(os.path.join(outdir, x))] \
        if os.path.isdir(outdir) else []
    ids = [int(x.split("-")[0]) for x in prev if x.split("-")[0].isdigit()]
    run_dir = os.path.join(outdir, f"{max(ids, default=-1) + 1:05d}-{desc}")
    os.makedirs(run_dir)
    return run_dir
