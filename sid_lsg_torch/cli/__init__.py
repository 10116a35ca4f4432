"""Command-line entry points of the port:

  python -m sid_lsg_torch.cli.generate_onestep ...   (one-step generation)
  python -m sid_lsg_torch.cli.sid_train ...          (distillation training)
  python -m sid_lsg_torch.cli.encode_latents ...     (SiDA real-latent corpus)
"""

import argparse
from typing import List, Optional


def parse_bool(s: str) -> bool:
    """argparse type for the reference CLIs' boolean flags (1/0, true/false, ...)."""
    low = s.lower()
    if low in ("1", "true", "yes", "y", "t", "on"):
        return True
    if low in ("0", "false", "no", "n", "f", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {s!r}")


def int_range(lo: int, hi: Optional[int] = None):
    """argparse type: an int in [lo, hi]."""
    def parse(s: str) -> int:
        v = int(s)
        if v < lo or (hi is not None and v > hi):
            raise argparse.ArgumentTypeError(f"{v} is outside [{lo}, {hi if hi is not None else 'inf'}]")
        return v
    return parse


def parse_int_list(s) -> List[int]:
    """'1,2,5-10' -> [1,2,5,...,10] (reference sid_train.py:33)."""
    if isinstance(s, (list, tuple)):
        return list(s)
    out: List[int] = []
    for part in str(s).split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part[1:]:
            lo, hi = part.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out
