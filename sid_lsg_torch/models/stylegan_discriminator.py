"""Projected DINO-ViT discriminator in PyTorch: the SiDA pixel judge.

Port of ``sid_lsg_tpu/models/stylegan_discriminator.py``:

- ``DINOViT``: the ViT backbone (patch embedding, CLS token, position
  embedding, pre-LN blocks with exact GELU and LayerNorm eps 1e-6, f32)
  returning token activations (B, C, N) after the patch embedding and after
  the blocks in ``hooks``.  Module names are timm's (``patch_embed.proj``,
  ``blocks.{i}.attn.qkv``, ``blocks.{i}.mlp.fc1``, ...), so the backbone
  part of a timm/DINO state dict (``convert_dino``) loads with a strict
  ``load_state_dict``.  Attention goes through ``ops.attention`` (kernels K1
  and K4 in f32 on the card).
- the resize to the ViT's input is ``jax.image.resize(method="linear")``,
  which filters with a widened triangle when it shrinks (antialias); it is
  built here as two (in, out) weight matrices by the same formula
  (``resize_weights``) and applied as two matmuls.
- ``SpectralConv1d`` (circular conv over tokens, kernel divided by its
  spectral norm from ``power_iters`` power-iteration sweeps that start at
  the stored ``u`` buffer; the gradient flows through the sweeps, as in
  JAX), ``BatchNormLocal`` (virtual batch 8, biased variance), ``DiscHead``
  (conditioned through ``FullyConnectedLayer``, i.e. ``ops.bias_act``),
  ``ProjectedDiscriminator`` (NCHW [-1, 1] in, (B, K) logits out, heads in
  tap order), ``refresh_spectral_u`` and ``diff_augment``.
- ``diff_augment`` takes its random draws as tensors (``DiffAugmentDraws``)
  so that the same draws can be fed to JAX in tests and so that the train
  step makes them on its CPU generator (``draw_diff_augment``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from .layers import init_weights_
from .stylegan_shared import FullyConnectedLayer

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 384
    layers: int = 12
    heads: int = 6
    mlp_ratio: float = 4.0
    hooks: Tuple[int, ...] = (2, 5, 8, 11)
    hook_patch: bool = True

    @property
    def n_hooks(self) -> int:
        return len(self.hooks) + int(self.hook_patch)


DINO_VIT_S16 = ViTConfig()
TINY_VIT = ViTConfig(image_size=32, patch_size=8, width=32, layers=4, heads=2, hooks=(1, 3),
                     hook_patch=True)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) f32 weights of ``jax.image.resize`` with the
    triangle kernel and antialiasing along one axis (JAX
    ``compute_weight_mat`` at translation 0): output j samples the input at
    (j + 0.5) * in / out - 0.5 with a triangle widened by in / out when
    shrinking, each column normalised to sum 1."""
    inv_scale = in_size / out_size
    sample_f = (np.arange(out_size, dtype=np.float32) + 0.5) * np.float32(inv_scale) - 0.5
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
         / np.float32(max(inv_scale, 1.0)))
    w = np.maximum(0.0, 1.0 - np.abs(x)).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


_RESIZE_WEIGHTS: Dict[tuple, torch.Tensor] = {}


def _resize_weights_on(in_size: int, out_size: int, device: torch.device,
                       dtype: torch.dtype) -> torch.Tensor:
    """``resize_weights`` as a tensor on ``device``, built once per key."""
    key = (in_size, out_size, str(device), dtype)
    if key not in _RESIZE_WEIGHTS:
        with torch.inference_mode(False):  # a normal tensor, usable under autograd later
            _RESIZE_WEIGHTS[key] = torch.from_numpy(
                resize_weights(in_size, out_size)).to(device, dtype)
    return _RESIZE_WEIGHTS[key]


def resize_linear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size, size) as ``jax.image.resize(..., "linear")``."""
    wh = _resize_weights_on(x.shape[2], size, x.device, x.dtype)
    ww = _resize_weights_on(x.shape[3], size, x.device, x.dtype)
    return wh.t() @ (x @ ww)


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        return self.proj(ops.attention(q, k, v).transpose(1, 2).reshape(b, n, c))


class _Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class _Block(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = _Attention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = _Mlp(width, int(width * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, width: int):
        super().__init__()
        self.proj = nn.Conv2d(3, width, patch, stride=patch)


class DINOViT(nn.Module):
    """ViT backbone returning the hooked token activations (B, C, N) by tap
    index (``"0"`` the patch embedding when ``hook_patch``)."""

    def __init__(self, config: ViTConfig = DINO_VIT_S16):
        super().__init__()
        cfg = self.config = config
        n = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embed = _PatchEmbed(cfg.patch_size, cfg.width)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, cfg.width))
        self.blocks = nn.ModuleList(
            [_Block(cfg.width, cfg.heads, cfg.mlp_ratio) for _ in range(cfg.layers)])
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN)[:, None, None], persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD)[:, None, None], persistent=False)

    def forward(self, pixels01: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.config
        x = (pixels01 - self.mean) / self.std
        if x.shape[2] != cfg.image_size:
            x = resize_linear(x, cfg.image_size)
        tokens = self.patch_embed.proj(x).flatten(2).transpose(1, 2)  # (B, N, C)
        feats: Dict[str, torch.Tensor] = {}
        if cfg.hook_patch:
            feats[str(len(feats))] = tokens.transpose(1, 2)
        b = tokens.shape[0]
        x = torch.cat([self.cls_token.expand(b, -1, -1), tokens], dim=1) + self.pos_embed
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in cfg.hooks:
                feats[str(len(feats))] = x[:, 1:].transpose(1, 2)  # drop CLS
        return feats


class SpectralConv1d(nn.Module):
    """Circular conv1d over tokens, kernel (features, c_in * k) divided by
    its spectral norm; ``u`` is a buffer, never trained."""

    def __init__(self, c_in: int, features: int, kernel_size: int = 1, power_iters: int = 1):
        super().__init__()
        self.features, self.kernel_size, self.power_iters = features, kernel_size, power_iters
        self.weight = nn.Parameter(torch.zeros(features, c_in * kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("u", torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, N)
        w = self.weight
        u = self.u
        for _ in range(self.power_iters):
            v = w.t() @ u
            v = v / (v.norm() + 1e-12)
            u = w @ v
            u = u / (u.norm() + 1e-12)
        sigma = u @ w @ v
        w_sn = (w / sigma).reshape(self.features, -1, self.kernel_size)
        if self.kernel_size > 1:
            p = self.kernel_size // 2
            x = torch.cat([x[..., -p:], x, x[..., :p]], dim=-1)
        return F.conv1d(x, w_sn) + self.bias[None, :, None]


class BatchNormLocal(nn.Module):
    """Normalisation over (virtual batch of 8, tokens) per channel."""

    def __init__(self, channels: int, virtual_bs: int = 8, eps: float = 1e-5):
        super().__init__()
        self.virtual_bs, self.eps = virtual_bs, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, n = x.shape
        xg = x.reshape(max(b // self.virtual_bs, 1), -1, c, n)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
        x = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, c, n)
        return x * self.weight[None, :, None] + self.bias[None, :, None]


class _HeadBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int, power_iters: int):
        super().__init__()
        self.conv = SpectralConv1d(channels, channels, kernel_size, power_iters)
        self.bn = BatchNormLocal(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return torch.where(x >= 0, x, 0.2 * x)


class DiscHead(nn.Module):
    def __init__(self, channels: int, c_dim: int, cmap_dim: int = 64, power_iters: int = 1):
        super().__init__()
        self.c_dim, self.cmap_dim = c_dim, cmap_dim
        self.main0 = _HeadBlock(channels, 1, power_iters)
        self.main1 = _HeadBlock(channels, 9, power_iters)
        self.cls = SpectralConv1d(channels, cmap_dim if c_dim > 0 else 1, 1, power_iters)
        if c_dim > 0:
            self.cmapper = FullyConnectedLayer(c_dim, cmap_dim)

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor]) -> torch.Tensor:
        h = self.main0(x)
        h = (h + self.main1(h)) * math.sqrt(0.5)
        out = self.cls(h)
        if self.c_dim > 0:
            cmap = self.cmapper(c)[..., None]
            return (out * cmap).sum(dim=1, keepdim=True) / math.sqrt(self.cmap_dim)
        return out


class DiffAugmentDraws(NamedTuple):
    """The random draws of one ``diff_augment`` call, per image: color
    (brightness, saturation, contrast; (B, 1, 1, 1) uniform [0, 1)),
    translation (shift_y, shift_x; (B,) ints in [-s/8, s/8]) and cutout
    centre (cy, cx; (B,) ints in [0, s))."""

    brightness: torch.Tensor
    saturation: torch.Tensor
    contrast: torch.Tensor
    shift_y: torch.Tensor
    shift_x: torch.Tensor
    cy: torch.Tensor
    cx: torch.Tensor

    def to(self, device) -> "DiffAugmentDraws":
        return DiffAugmentDraws(*(t.to(device) for t in self))


def draw_diff_augment(generator: torch.Generator, b: int, h: int, w: int) -> DiffAugmentDraws:
    """The draws of one ``diff_augment`` call from ``generator``, in field order."""
    u = lambda: torch.rand(b, 1, 1, 1, generator=generator)
    brightness, saturation, contrast = u(), u(), u()
    shift_y = torch.randint(-(h // 8), h // 8 + 1, (b,), generator=generator)
    shift_x = torch.randint(-(w // 8), w // 8 + 1, (b,), generator=generator)
    cy = torch.randint(0, h, (b,), generator=generator)
    cx = torch.randint(0, w, (b,), generator=generator)
    return DiffAugmentDraws(brightness, saturation, contrast, shift_y, shift_x, cy, cx)


def diff_augment(x: torch.Tensor, draws: DiffAugmentDraws) -> torch.Tensor:
    """DiffAugment (color, translation, cutout) on NCHW images in [-1, 1]:
    translation reads clamped indices (edge pixels repeat), cutout zeroes a
    (h/2 x w/2) box around (cy, cx)."""
    b, c, h, w = x.shape
    d = draws.to(x.device)
    x = x + (d.brightness - 0.5)
    mean = x.mean(dim=1, keepdim=True)
    x = (x - mean) * (d.saturation * 2) + mean
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    x = (x - mean) * (d.contrast + 0.5) + mean
    yy = (torch.arange(h, device=x.device)[None, :] + d.shift_y[:, None]).clamp(0, h - 1)
    xx = (torch.arange(w, device=x.device)[None, :] + d.shift_x[:, None]).clamp(0, w - 1)
    x = x.gather(2, yy[:, None, :, None].expand(b, c, h, w))
    x = x.gather(3, xx[:, None, None, :].expand(b, c, h, w))
    gy = torch.arange(h, device=x.device)[None, :, None]
    gx = torch.arange(w, device=x.device)[None, None, :]
    keep = (((gy - d.cy[:, None, None]).abs() >= (h // 2) // 2)
            | ((gx - d.cx[:, None, None]).abs() >= (w // 2) // 2))
    return x * keep[:, None].to(x.dtype)


class ProjectedDiscriminator(nn.Module):
    """DINO features -> one spectral conv head per tap -> (B, K) logits."""

    def __init__(self, c_dim: int, vit: ViTConfig = DINO_VIT_S16, power_iters: int = 1):
        super().__init__()
        self.dino = DINOViT(vit)
        self.heads = nn.ModuleDict({str(i): DiscHead(vit.width, c_dim, power_iters=power_iters)
                                    for i in range(vit.n_hooks)})

    def forward(self, x_nchw: torch.Tensor, c: Optional[torch.Tensor] = None,
                aug: Optional[DiffAugmentDraws] = None) -> torch.Tensor:
        if aug is not None:
            x_nchw = diff_augment(x_nchw, aug)
        feats = self.dino(x_nchw * 0.5 + 0.5)
        b = x_nchw.shape[0]
        return torch.cat([self.heads[k](feats[k], c).reshape(b, -1)
                          for k in sorted(feats, key=int)], dim=1)


def head_params(disc: ProjectedDiscriminator) -> Params:
    """The trainable parameters of the heads, by their names in ``disc``."""
    return {k: v for k, v in disc.named_parameters() if k.startswith("heads.")}


def spectral_buffers(disc: ProjectedDiscriminator) -> Params:
    """Every ``u`` buffer of the heads, by its name in ``disc``."""
    return {k: v for k, v in disc.named_buffers() if k.endswith(".u")}


@torch.no_grad()
def refresh_spectral_u(disc_params: Params, spectral: Params, iters: int = 3) -> Params:
    """Advance each ``u`` (key ``<conv>.u``) by ``iters`` power-iteration
    sweeps against the current kernel ``disc_params['<conv>.weight']``: the
    persistent-u semantics of torch ``spectral_norm``, run after every step
    so that the next step's sweeps start converged."""
    out = {}
    for key, u in spectral.items():
        w = disc_params[key[:-len("u")] + "weight"]
        for _ in range(iters):
            v = w.t() @ u
            v = v / (v.norm() + 1e-12)
            u = w @ v
            u = u / (u.norm() + 1e-12)
        out[key] = u
    return out


def convert_dino(state_dict: Params, cfg: ViTConfig = DINO_VIT_S16) -> Params:
    """A timm/DINO ViT state dict -> the ``DINOViT`` state dict (the keys it
    holds, f32; the final norm and any head of the timm model are dropped).
    A missing key raises ``KeyError``."""
    keys = ["patch_embed.proj.weight", "patch_embed.proj.bias", "cls_token", "pos_embed"]
    for i in range(cfg.layers):
        keys += [f"blocks.{i}.{m}.{p}" for m in ("norm1", "attn.qkv", "attn.proj", "norm2",
                                                  "mlp.fc1", "mlp.fc2") for p in ("weight", "bias")]
    return {k: torch.as_tensor(state_dict[k]).float() for k in keys}


@torch.no_grad()
def init_disc_weights_(disc: ProjectedDiscriminator, generator: torch.Generator) -> nn.Module:
    """Fill ``disc`` as the JAX package's flax initialisers do: lecun-normal
    dense and conv kernels, unit LayerNorms, N(0, 0.02) CLS token and
    position embedding; he-uniform spectral kernels (fan-in = the kernel's
    second-to-last axis, as flax counts it), N(0, 1) ``u``; unit BatchNormLocal
    scales; N(0, 1) FullyConnectedLayer weights; zero biases."""
    init_weights_(disc.dino, generator)
    disc.dino.cls_token.normal_(0.0, 0.02, generator=generator)
    disc.dino.pos_embed.normal_(0.0, 0.02, generator=generator)
    for m in disc.heads.modules():
        if isinstance(m, SpectralConv1d):
            limit = math.sqrt(6.0 / m.weight.shape[0])
            m.weight.uniform_(-limit, limit, generator=generator)
            m.bias.zero_()
            m.u.normal_(generator=generator)
        elif isinstance(m, BatchNormLocal):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, FullyConnectedLayer):
            m.reset_parameters(generator)
    return disc
