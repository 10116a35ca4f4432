"""Command-line entry points of the port:

  python -m sid_lsg_torch.cli.generate_onestep ...   (one-step generation)
"""

from typing import List


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
