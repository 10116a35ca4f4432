"""InceptionV3 (FID variant): the 2048-d feature extractor for FID.

Port of ``sid_lsg_tpu/models/inception.py`` as an ``nn.Module`` in NCHW.
The graph is the canonical FID detector (TF-Slim InceptionV3 as pytorch-fid
replicates it): torchvision's topology with

- branch-pool average pooling that does not count the padding,
- max pooling in the pool branch of the last block (Mixed_7c),
- features = the global average of Mixed_7c (2048-d), no classifier.

Input is uint8 RGB (B, H, W, 3), scaled to [-1, 1] and resized to 299x299
bilinearly with antialiasing on a downscale (what ``jax.image.resize(...,
"bilinear")`` does).  BatchNorm is folded into the convolutions
(``convert_inception``: a torchvision / pytorch-fid state dict, BN eps
1e-3); without a weights file the extractor runs on random weights drawn
from a seed (fine for plumbing, not for comparable FID).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .layers import init_weights_

FEATURE_DIM = 2048


class ConvBN(nn.Module):
    """conv (BN folded into its weight and bias) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv(x))


def _avg_pool_nopad(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 64, 1)
        self.branch5x5_1 = ConvBN(cin, 48, 1)
        self.branch5x5_2 = ConvBN(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, padding=1)
        self.branch_pool = ConvBN(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool_nopad(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = ConvBN(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 192, 1)
        self.branch7x7_1 = ConvBN(cin, c7, 1)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(cin, c7, 1)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool_nopad(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(cin, 192, 1)
        self.branch3x3_2 = ConvBN(192, 320, 3, stride=2)
        self.branch7x7x3_1 = ConvBN(cin, 192, 1)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for conv in (self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3,
                     self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_mode: str):
        super().__init__()
        self.pool_mode = pool_mode  # 'avg' (Mixed_7b) | 'max' (Mixed_7c, the FID detail)
        self.branch1x1 = ConvBN(cin, 320, 1)
        self.branch3x3_1 = ConvBN(cin, 384, 1)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(cin, 448, 1)
        self.branch3x3dbl_2 = ConvBN(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = (F.max_pool2d(x, 3, 1, padding=1) if self.pool_mode == "max"
              else _avg_pool_nopad(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Features(nn.Module):
    """uint8 (B, H, W, 3) or float images -> (B, 2048) f32 FID features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = ConvBN(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, 3)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, 1)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.Conv2d_1a_3x3.conv.weight.device, torch.float32)
        if images.dtype == torch.uint8:
            x = x / 127.5 - 1.0
        x = x.permute(0, 3, 1, 2)
        if x.shape[-2:] != (299, 299):
            x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                              antialias=True)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def convert_inception(state_dict) -> Dict[str, torch.Tensor]:
    """A torchvision / pytorch-fid state dict (``<block>.conv.weight`` and
    ``<block>.bn.{weight,bias,running_mean,running_var}``) -> the folded
    ``InceptionV3Features`` state dict (OIHW weight, bias), in f64 then f32."""
    out: Dict[str, torch.Tensor] = {}
    f64 = lambda k: np.asarray(state_dict[k], np.float64)
    for p in sorted(k[:-len(".conv.weight")] for k in state_dict if k.endswith(".conv.weight")):
        scale = f64(f"{p}.bn.weight") / np.sqrt(f64(f"{p}.bn.running_var") + 1e-3)
        w = f64(f"{p}.conv.weight") * scale[:, None, None, None]
        b = f64(f"{p}.bn.bias") - f64(f"{p}.bn.running_mean") * scale
        out[f"{p}.conv.weight"] = torch.from_numpy(w.astype(np.float32))
        out[f"{p}.conv.bias"] = torch.from_numpy(b.astype(np.float32))
    return out


def load_inception(weights_path: Optional[str] = None, device="cuda",
                   seed: int = 0) -> InceptionV3Features:
    """The detector on ``device``, eval mode, frozen: converted from a torch
    weights file (``torch.load(weights_only=True)``), else random weights
    drawn from ``seed`` (flax's default initialisers).  ``device`` is the
    card unless the caller asks for the CPU."""
    device = resolve_device(device)
    model = InceptionV3Features()
    if weights_path:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        model.load_state_dict(convert_inception(sd.get("state_dict", sd)), strict=True)
    else:
        init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval().requires_grad_(False)
