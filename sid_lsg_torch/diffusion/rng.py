"""Per-seed deterministic latents: one ``torch.Generator`` per seed.

The reference's ``StackedRandomGenerator`` (``generate_onestep.py:30-44``
of mingyuanzhou/SiD-LSG): every image is reproducible from its integer seed
alone, independent of batch composition.  The JAX package draws the same
shapes from ``jax.random`` keys instead, so a seed gives other latents there.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch


class StackedRandomGenerator:
    def __init__(self, seeds: Sequence[int], device: Union[str, torch.device]):
        self.device = torch.device(device)
        self.generators = [torch.Generator(self.device).manual_seed(int(s) % (1 << 32))
                           for s in seeds]

    def randn(self, size: Tuple[int, ...]) -> torch.Tensor:
        """f32 normal draws; size[0] must equal the number of seeds, one draw per seed."""
        if size[0] != len(self.generators):
            raise ValueError(f"batch {size[0]} != {len(self.generators)} seeds")
        return torch.stack([torch.randn(size[1:], generator=g, device=self.device)
                            for g in self.generators])
