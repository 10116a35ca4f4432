"""conv2d_resample, grid_sample and fma.

Port of ``sid_lsg_tpu/ops/resample_conv.py``; stock ops on every device, as
the JAX package leaves these to XLA:

- ``conv2d_resample``: for ``up > 1`` one up-front ``upfirdn2d`` (pad,
  zero-stuff, FIR) and an unpadded conv; then ``F.conv2d`` (``groups``,
  ``flip_weight=False`` a true convolution) and, for ``down > 1``, a
  ``downsample2d`` after it.
- ``grid_sample``: bilinear, ``align_corners=False``, zeros outside, as the
  JAX ``map_coordinates(order=1, mode="constant")``; ``F.grid_sample``
  computes the same (held to the JAX package at the border by the tests).
- ``fma``: ``a * b + c``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .upfirdn2d import _pad_or_crop, _parse_padding, downsample2d, setup_filter, upfirdn2d


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f: Optional[torch.Tensor] = None,
                    up: int = 1, down: int = 1, padding=0, groups: int = 1,
                    flip_weight: bool = True) -> torch.Tensor:
    """2-D conv of NCHW ``x`` with OIHW ``w``, with optional FIR up- and
    downsampling by ``f``."""
    px0, px1, py0, py1 = _parse_padding(padding)
    if up > 1:
        if f is None:
            f = setup_filter(None)
        px0 += (f.shape[-1] + up - 1) // 2
        px1 += (f.shape[-1] - up) // 2
        py0 += (f.shape[0] + up - 1) // 2
        py1 += (f.shape[0] - up) // 2
        x = upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up * up)
        px0 = px1 = py0 = py1 = 0
    if not flip_weight:  # true convolution
        w = w.flip([2, 3])
    if px0 == px1 >= 0 and py0 == py1 >= 0:  # a padding F.conv2d takes itself
        x = F.conv2d(x, w.to(x.dtype), padding=(py0, px0), groups=groups)
    else:
        x = F.conv2d(_pad_or_crop(x, px0, px1, py0, py1), w.to(x.dtype), groups=groups)
    if down > 1:
        if f is None:
            f = setup_filter(None)
        x = downsample2d(x, f, down=down)
    return x


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of x (B, C, H, W) at grid (B, H_out, W_out, 2), xy in
    [-1, 1], ``align_corners=False``, zeros outside."""
    return F.grid_sample(x, grid.to(x.dtype), mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c."""
    return a * b + c
