"""Pillow's resamplers without Pillow: separable BICUBIC and LANCZOS with
antialiasing, on uint8 images on the host, and the same filters in float on
tensors.

The metric stack of the JAX package resizes with Pillow (``Image.resize``
with ``BICUBIC`` or ``LANCZOS``), which the card's machine lacks.  This
module computes what Pillow's ``Resample.c`` computes for 8-bit images:

- per output pixel, the filter's support scaled by the downscale factor
  (``filterscale = max(in / out, 1)``), taps from
  ``int(center - support + 0.5)`` to ``int(center + support + 0.5)``, weights
  ``filter((x + xmin - center + 0.5) / filterscale)`` normalised to sum 1, in
  double precision;
- the weights as 22-bit fixed-point integers (rounded half away from 0), the
  sum started at one half and shifted down, clipped to [0, 255];
- the horizontal pass first (to uint8), then the vertical one.

BICUBIC is Keys' cubic with ``a = -0.5`` (support 2), LANCZOS ``sinc(x)
sinc(x / 3)`` (support 3).  The weights are computed with ``math``, as the C
code computes them with libm, so that a last-bit difference of a vectorised
``sin`` cannot move a fixed-point weight.

``resize_float`` applies the same normalised weights to a float tensor
without the fixed point: ``jax.image.resize(..., antialias=True)`` on a
downscale and on an upscale.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


FILTERS = {"bicubic": (_bicubic, 2.0), "lanczos": (_lanczos, 3.0)}


@functools.lru_cache(maxsize=64)
def coefficients(in_size: int, out_size: int, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """(tap indices (out, ksize), normalised double weights (out, ksize)) of
    Pillow's ``precompute_coeffs`` for the whole input; indices past a
    pixel's taps repeat its first tap with weight 0."""
    fn, base = FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ks = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in ks:
            ww += w
        if ww != 0.0:
            ks = [w / ww for w in ks]
        idx[xx] = xmin
        idx[xx, :xmax] = np.arange(xmin, xmin + xmax)
        weights[xx, :xmax] = ks
    return idx, weights


@functools.lru_cache(maxsize=64)
def _fixed_point(in_size: int, out_size: int, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    idx, weights = coefficients(in_size, out_size, kind)
    scaled = weights * (1 << PRECISION_BITS)
    # C's (int) truncates toward 0 after the half is added away from 0.
    fixed = np.where(weights < 0, np.trunc(scaled - 0.5), np.trunc(scaled + 0.5)).astype(np.int64)
    return idx, fixed


def _pass_uint8(x: np.ndarray, out_size: int, axis: int, kind: str) -> np.ndarray:
    """One 8-bit pass of Pillow along ``axis`` of a (N, H, W, C) uint8 array."""
    idx, fixed = _fixed_point(x.shape[axis], out_size, kind)
    shape = [1] * x.ndim
    shape[axis] = out_size
    acc = np.full(x.shape[:axis] + (out_size,) + x.shape[axis + 1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    for t in range(idx.shape[1]):
        tap = np.take(x, idx[:, t], axis=axis).astype(np.int64)
        acc += tap * fixed[:, t].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_uint8(images: np.ndarray, size: Tuple[int, int], kind: str = "bicubic") -> np.ndarray:
    """(N, H, W, C) or (H, W, C) uint8 -> ``size`` = (out_h, out_w), as
    Pillow's ``Image.resize((out_w, out_h), BICUBIC / LANCZOS)`` gives it
    for each image."""
    x = np.asarray(images, dtype=np.uint8)
    single = x.ndim == 3
    if single:
        x = x[None]
    out_h, out_w = size
    if x.shape[2] != out_w:
        x = _pass_uint8(x, out_w, 2, kind)
    if x.shape[1] != out_h:
        x = _pass_uint8(x, out_h, 1, kind)
    return x[0] if single else x


def _weight_matrix(in_size: int, out_size: int, kind: str, device, dtype) -> torch.Tensor:
    idx, weights = coefficients(in_size, out_size, kind)
    m = np.zeros((out_size, in_size), np.float64)
    np.add.at(m, (np.repeat(np.arange(out_size), idx.shape[1]), idx.reshape(-1)),
              weights.reshape(-1))
    return torch.as_tensor(m, dtype=dtype, device=device)


def resize_float(x: torch.Tensor, size: Tuple[int, int], kind: str = "bicubic") -> torch.Tensor:
    """A float (..., H, W) tensor resized with the normalised weights above
    (antialiased on a downscale), as two matrix products."""
    out_h, out_w = size
    h, w = x.shape[-2:]
    if w != out_w:
        x = x @ _weight_matrix(w, out_w, kind, x.device, x.dtype).t()
    if h != out_h:
        x = _weight_matrix(h, out_h, kind, x.device, x.dtype) @ x
    return x
