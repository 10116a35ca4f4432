"""Pad, upsample, FIR-filter and downsample NCHW images (upfirdn2d).

Port of ``sid_lsg_tpu/ops/upfirdn2d.py``.  The JAX package runs this op as
one depthwise ``lax.conv_general_dilated`` and never as a Pallas kernel
(``pallas_ok=False``), so the port's version is stock ops on every device:
zero-stuffing for the upsample, ``F.pad`` and slicing for the padding
(negative padding crops), and one depthwise ``F.conv2d`` (``groups=C``)
whose stride is the downsample.  Filters of 1-D taps of length 8 or more
run separably, a vertical pass and then a horizontal one, as in JAX.

The semantics are the reference's: the filter is scaled by
``gain ** (f.ndim / 2)``, ``flip_filter=False`` is a true convolution, and
an upsample by ``up`` gives ``n * up`` samples (``up - 1`` trailing zeros).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

IntOrPair = Union[int, Sequence[int]]


def _parse_scaling(scaling: IntOrPair) -> Tuple[int, int]:
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    assert sx >= 1 and sy >= 1
    return int(sx), int(sy)


def _parse_padding(padding: IntOrPair) -> Tuple[int, int, int, int]:
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    padx0, padx1, pady0, pady1 = padding
    return int(padx0), int(padx1), int(pady0), int(pady1)


def setup_filter(f, normalize: bool = True, flip_filter: bool = False, gain: float = 1.0,
                 separable: Optional[bool] = None) -> torch.Tensor:
    """A FIR filter as an f32 tensor: 1-D taps become their outer product
    unless separable (1-D and at least 8 taps), normalised to sum 1, flipped
    and scaled by ``gain ** (ndim / 2)`` as asked.  Computed in numpy, as
    the JAX package computes it."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (0, 1, 2) and f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    assert f.ndim == (1 if separable else 2)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = np.flip(f, axis=tuple(range(f.ndim)))
    f = f * (gain ** (f.ndim / 2))
    return torch.tensor(np.ascontiguousarray(f), dtype=torch.float32)


def _pad_or_crop(x: torch.Tensor, padx0: int, padx1: int, pady0: int, pady1: int) -> torch.Tensor:
    x = F.pad(x, [max(padx0, 0), max(padx1, 0), max(pady0, 0), max(pady1, 0)])
    return x[:, :, max(-pady0, 0):x.shape[2] - max(-pady1, 0),
             max(-padx0, 0):x.shape[3] - max(-padx1, 0)]


def _depthwise(x: torch.Tensor, f2d: torch.Tensor, up: Tuple[int, int], down: Tuple[int, int],
               pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """Zero-stuff by ``up``, pad or crop, correlate each channel with
    ``f2d`` and keep every ``down``-th sample."""
    b, c, h, w = x.shape
    upx, upy = up
    if upx > 1 or upy > 1:
        x = x.reshape(b, c, h, 1, w, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(b, c, h * upy, w * upx)
    x = _pad_or_crop(x, *pad)
    weight = f2d.to(x.device, x.dtype)[None, None].expand(c, 1, *f2d.shape)
    return F.conv2d(x, weight, stride=(down[1], down[0]), groups=c)


def upfirdn2d(x: torch.Tensor, f: Optional[torch.Tensor], up: IntOrPair = 1,
              down: IntOrPair = 1, padding: IntOrPair = 0, flip_filter: bool = False,
              gain: float = 1.0) -> torch.Tensor:
    """Pad, upsample, FIR-filter and downsample a batch of NCHW images."""
    assert x.dim() == 4
    if f is None:
        f = torch.ones((1, 1), dtype=torch.float32)
    assert f.dim() in (1, 2)
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    f = f * (gain ** (f.dim() / 2))
    if not flip_filter:
        f = f.flip(list(range(f.dim())))
    if f.dim() == 2:
        return _depthwise(x, f, (upx, upy), (downx, downy), (padx0, padx1, pady0, pady1))
    x = _depthwise(x, f[:, None], (1, upy), (1, downy), (0, 0, pady0, pady1))
    return _depthwise(x, f[None, :], (upx, 1), (downx, 1), (padx0, padx1, 0, 0))


def _filter_size(f: Optional[torch.Tensor]) -> Tuple[int, int]:
    return (f.shape[-1], f.shape[0]) if f is not None else (1, 1)


def filter2d(x, f, padding=0, flip_filter=False, gain=1.0):
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _filter_size(f)
    p = [padx0 + fw // 2, padx1 + (fw - 1) // 2, pady0 + fh // 2, pady1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1.0):
    upx, upy = _parse_scaling(up)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _filter_size(f)
    p = [padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
         pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1.0):
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _filter_size(f)
    p = [padx0 + (fw - downx + 1) // 2, padx1 + (fw - downx) // 2,
         pady0 + (fh - downy + 1) // 2, pady1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)
