"""StyleGAN shared layers in PyTorch.

Port of ``sid_lsg_tpu/models/stylegan_shared.py``: ``normalize_2nd_moment``,
``FullyConnectedLayer`` with the runtime weight scaling (weight gain
``lr_multiplier / sqrt(fan_in)``, bias gain ``lr_multiplier``) and the fused
bias + activation through ``ops.bias_act`` (kernel K7 on the card), ``MLP``
and ``ResidualBlock``.  Parameter names are the JAX package's (``weight``
(out, in), ``bias``; ``fc{i}`` in ``MLP``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import ops


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """x / sqrt(mean(x^2))."""
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


class FullyConnectedLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int, activation: str = "linear",
                 bias: bool = True, lr_multiplier: float = 1.0, weight_init: float = 1.0,
                 bias_init: Union[float, Sequence[float]] = 0.0):
        super().__init__()
        self.activation = activation
        self.lr_multiplier, self.weight_init, self.bias_init = lr_multiplier, weight_init, bias_init
        self.weight_gain = lr_multiplier / math.sqrt(in_features)
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """weight ~ N(0, 1) * weight_init / lr_multiplier, bias = bias_init /
        lr_multiplier (the JAX initialisers)."""
        self.weight.normal_(generator=generator).mul_(self.weight_init / self.lr_multiplier)
        if self.bias is not None:
            binit = np.broadcast_to(np.asarray(self.bias_init, np.float32), self.bias.shape)
            self.bias.copy_(torch.from_numpy(binit / self.lr_multiplier))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, (self.weight * self.weight_gain).to(x.dtype))
        b = None if self.bias is None else (self.bias * self.lr_multiplier).to(x.dtype)
        return ops.bias_act(y, b, dim=y.dim() - 1, act=self.activation)


class MLP(nn.Module):
    """Stack of FullyConnectedLayers; ``features_list`` = [in, h1, ..., out]."""

    def __init__(self, features_list: Sequence[int], activation: str = "lrelu",
                 lr_multiplier: float = 1.0, linear_out: bool = False):
        super().__init__()
        n = len(features_list) - 1
        for idx in range(n):
            act = "linear" if (linear_out and idx == n - 1) else activation
            self.add_module(f"fc{idx}", FullyConnectedLayer(
                features_list[idx], features_list[idx + 1], activation=act,
                lr_multiplier=lr_multiplier))
        self.num_layers = n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        squeeze = x.dim() == 3
        if squeeze:
            b, n, c = x.shape
            x = x.reshape(b * n, c)
        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)
        return x.reshape(b, n, -1) if squeeze else x


class ResidualBlock(nn.Module):
    """(fn(x) + x) / sqrt(2)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        return (self.fn(x, *args, **kwargs) + x) * math.sqrt(0.5)
