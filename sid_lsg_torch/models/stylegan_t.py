"""The StyleGAN-T generator: text-conditional, NCHW.

Port of ``sid_lsg_tpu/models/stylegan_t.py``.  Module and parameter names
are the JAX package's (``synthesis.b8.convs1_1.gn_scale``, ``affine.proj.
weight`` (out, in), ``mapping.mlp.fc0``), so ``models.convert.
stylegan_t_params_from_jax`` is a rename of its paths; the W average is the
buffer ``mapping.x_avg`` (the JAX ``stats`` collection).

- ``modulated_conv2d`` is the unfused form: styles scale x, one
  ``ops.conv2d_resample`` (for ``up > 1`` one up-front ``upfirdn2d`` and an
  unpadded conv with the kernel flipped), outputs scaled by
  ``rsqrt(sum w^2 + 1e-8)``.
- ``SynthesisLayer``'s bias, leaky ReLU (gain ``sqrt(2) * gain``) and clamp
  (``256 * gain``) go through ``ops.bias_act`` (kernel K7 on the card), the
  residual layers' GroupNorm through ``ops.group_norm`` (K8 or K2 + K3), and
  the residual adds the normalised x.
- Noise: with a ``torch.Generator`` as ``rng`` each layer draws its
  (B, 1, res, res) noise from it; with ``rng=None`` each layer adds its
  ``noise_const``.  The two packages draw differently, so only the
  ``noise_const`` path compares with JAX.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import ops
from .stylegan_shared import MLP, FullyConnectedLayer, normalize_2nd_moment


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor, styles: torch.Tensor,
                     noise: Optional[torch.Tensor] = None, up: int = 1, padding: int = 0,
                     resample_filter: Optional[torch.Tensor] = None,
                     demodulate: bool = True) -> torch.Tensor:
    """Style modulation, conv, demodulation (+ noise) of x (B, C_in, H, W)
    with weight (C_out, C_in, kh, kw) and styles (B, C_in)."""
    b, c_in = x.shape[:2]
    c_out = weight.shape[0]
    dcoefs = None
    if demodulate:
        w = weight[None] * styles.reshape(b, 1, c_in, 1, 1)
        dcoefs = torch.rsqrt(w.square().sum(dim=(2, 3, 4)) + 1e-8)  # (B, O)
    x = x * styles.reshape(b, c_in, 1, 1).to(x.dtype)
    # The reference's transposed conv for up > 1 has convolution semantics,
    # so the kernel is flipped there.
    x = ops.conv2d_resample(x, weight, resample_filter, up=up, padding=padding,
                            flip_weight=(up == 1))
    if demodulate:
        x = x * dcoefs.reshape(b, c_out, 1, 1).to(x.dtype)
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x


class StyleSplit(nn.Module):
    """w -> m1 * m2 + m3 of a 3-way projection."""

    def __init__(self, in_features: int, out_channels: int, bias_init: float = 0.0):
        super().__init__()
        self.proj = FullyConnectedLayer(in_features, 3 * out_channels, bias_init=bias_init)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        m1, m2, m3 = self.proj(w).chunk(3, dim=-1)
        return m1 * m2 + m3


class SynthesisInput(nn.Module):
    """Fourier features on a grid, rotated and translated by an affine of w."""

    def __init__(self, w_dim: int, channels: int, size: int, sampling_rate: int,
                 bandwidth: float):
        super().__init__()
        self.channels, self.size = channels, size
        self.sampling_rate, self.bandwidth = sampling_rate, bandwidth
        self.freqs = nn.Parameter(torch.empty(channels, 2))
        self.phases = nn.Parameter(torch.empty(channels))
        self.weight = nn.Parameter(torch.empty(channels, channels))
        self.affine = FullyConnectedLayer(w_dim, 4, weight_init=0.0, bias_init=[1, 0, 0, 0])
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        f = torch.randn(self.channels, 2, generator=generator)
        radii = f.square().sum(dim=1, keepdim=True).sqrt()
        self.freqs.copy_(f / (radii * radii.square().exp() ** 0.25) * self.bandwidth)
        self.phases.copy_(torch.rand(self.channels, generator=generator) - 0.5)
        self.weight.normal_(generator=generator)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        t = self.affine(w)  # (B, 4): rotation cos / sin, translation
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        rc, rs, tx, ty = t.unbind(1)
        rot = torch.stack([torch.stack([rc, -rs], -1), torch.stack([rs, rc], -1)], dim=1)
        f = torch.einsum("cd,bde->bce", self.freqs, rot)  # (B, C, 2)
        ph = self.phases[None] + f[:, :, 0] * (-tx[:, None]) + f[:, :, 1] * (-ty[:, None])
        amplitudes = (1 - (f.norm(dim=2) - self.bandwidth)
                      / (self.sampling_rate / 2 - self.bandwidth)).clamp(0.0, 1.0)
        coords = ((torch.arange(self.size, dtype=torch.float32, device=w.device) + 0.5)
                  / self.size * 2.0 - 1.0)
        scale = 0.5 * self.size / self.sampling_rate
        gy, gx = torch.meshgrid(coords * scale, coords * scale, indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)  # (H, W, 2), x first
        x = torch.einsum("hwd,bcd->bhwc", grid, f) + ph[:, None, None, :]
        x = torch.sin(x * (2.0 * math.pi)) * amplitudes[:, None, None, :]
        x = x @ (self.weight.t() / np.sqrt(self.channels))
        return x.permute(0, 3, 1, 2)


class SynthesisLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 kernel_size: int = 3, up: int = 1, use_noise: bool = True,
                 activation: str = "lrelu", resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = 256.0, layer_scale_init: float = 1e-5,
                 residual: bool = False, gn_groups: int = 32):
        super().__init__()
        self.resolution, self.up, self.use_noise = resolution, up, use_noise
        self.activation, self.conv_clamp, self.residual = activation, conv_clamp, residual
        self.layer_scale_init = layer_scale_init
        self.gn_groups = min(gn_groups, in_channels)
        self.register_buffer("resample_filter", ops.setup_filter(list(resample_filter)),
                             persistent=False)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.affine = StyleSplit(w_dim, in_channels, bias_init=1.0)
        if use_noise:
            self.noise_strength = nn.Parameter(torch.zeros(()))
            self.noise_const = nn.Parameter(torch.empty(resolution, resolution))
        if residual:
            self.gamma = nn.Parameter(torch.empty(1, out_channels, 1, 1))
            self.gn_scale = nn.Parameter(torch.ones(in_channels))
            self.gn_bias = nn.Parameter(torch.zeros(in_channels))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.normal_(generator=generator)
        self.bias.zero_()
        if self.use_noise:
            self.noise_strength.zero_()
            self.noise_const.normal_(generator=generator)
        if self.residual:
            self.gamma.fill_(self.layer_scale_init)
            self.gn_scale.fill_(1.0)
            self.gn_bias.zero_()

    def forward(self, x: torch.Tensor, w: torch.Tensor, rng: Optional[torch.Generator] = None,
                gain: float = 1.0) -> torch.Tensor:
        styles = self.affine(w)
        noise = None
        if self.use_noise:
            if rng is not None:
                shape = (x.shape[0], 1, self.resolution, self.resolution)
                noise = (torch.randn(shape, generator=rng, device=rng.device).to(x.device)
                         * self.noise_strength)
            else:
                noise = self.noise_const[None, None] * self.noise_strength
        if self.residual:
            x = ops.group_norm(x, self.gn_scale, self.gn_bias, num_groups=self.gn_groups)
        y = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up,
                             padding=self.weight.shape[-1] // 2,
                             resample_filter=self.resample_filter)
        act_gain = ops.activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        y = ops.bias_act(y, self.bias.to(y.dtype), dim=1, act=self.activation, gain=act_gain,
                         clamp=act_clamp)
        if self.residual:
            # The residual adds the normalised x.
            y = (self.gamma * y + x) * math.sqrt(2)
        return y


class ToRGBLayer(nn.Module):
    def __init__(self, in_channels: int, img_channels: int, w_dim: int,
                 conv_clamp: Optional[float] = 256.0):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.weight = nn.Parameter(torch.empty(img_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(img_channels))
        self.affine = StyleSplit(w_dim, in_channels, bias_init=1.0)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.normal_(generator=generator).mul_(0.1)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w) / np.sqrt(x.shape[1])
        y = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return ops.bias_act(y, self.bias.to(y.dtype), dim=1, clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 img_channels: int, is_last: bool, num_res_blocks: int = 1,
                 architecture: str = "skip", resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: float = 256.0):
        super().__init__()
        self.in_channels, self.num_res_blocks = in_channels, num_res_blocks
        self.register_buffer("resample_filter", ops.setup_filter(list(resample_filter)),
                             persistent=False)
        layer = dict(w_dim=w_dim, resolution=resolution, resample_filter=resample_filter,
                     conv_clamp=conv_clamp)
        if in_channels == 0:
            self.input = SynthesisInput(w_dim, out_channels, resolution,
                                        sampling_rate=resolution, bandwidth=2)
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, up=2, **layer)
        for i in range(num_res_blocks):
            self.add_module(f"convs1_{2 * i}", SynthesisLayer(out_channels, out_channels, **layer))
            self.add_module(f"convs1_{2 * i + 1}",
                            SynthesisLayer(out_channels, out_channels, residual=True, **layer))
        self.torgb = (ToRGBLayer(out_channels, img_channels, w_dim, conv_clamp)
                      if is_last or architecture == "skip" else None)

    @property
    def num_conv(self) -> int:
        return 1 + 2 * self.num_res_blocks

    def forward(self, x, img, ws, rng: Optional[torch.Generator] = None):
        gain = math.sqrt(0.5)
        x = self.input(ws[:, 0]) if self.in_channels == 0 else self.conv0(x, ws[:, 0], rng=rng)
        for i in range(2 * self.num_res_blocks):
            x = getattr(self, f"convs1_{i}")(x, ws[:, 1 + i], rng=rng, gain=gain)
        if img is not None:
            img = ops.upsample2d(img, self.resample_filter)
        if self.torgb is not None:
            y = self.torgb(x, ws[:, self.num_conv]).float()
            img = img + y if img is not None else y
        return x, img


class SynthesisNetwork(nn.Module):
    def __init__(self, w_dim: int, img_resolution: int, img_channels: int = 3,
                 channel_base: int = 32768, channel_max: int = 512, base_mult: int = 3,
                 num_res_blocks: int = 3):
        super().__init__()
        log2 = int(np.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(base_mult, log2 + 1)]
        channels = {res: min(channel_base // res, channel_max) for res in self.block_resolutions}
        for res in self.block_resolutions:
            in_ch = channels[res // 2] if res > self.block_resolutions[0] else 0
            self.add_module(f"b{res}", SynthesisBlock(
                in_ch, channels[res], w_dim=w_dim, resolution=res, img_channels=img_channels,
                is_last=res == img_resolution, num_res_blocks=num_res_blocks))
        self.num_ws = len(self.block_resolutions) * (1 + 2 * num_res_blocks) + 1

    def forward(self, ws: torch.Tensor, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            x, img = block(x, img, ws[:, w_idx:w_idx + block.num_conv + 1], rng=rng)
            w_idx += block.num_conv
        return img


class MappingNetwork(nn.Module):
    """z (+ a conditioning embedding c) -> W broadcast over ``num_ws``; the W
    average is the buffer ``x_avg``."""

    def __init__(self, z_dim: int, c_dim: int = 0, num_ws: int = 1, num_layers: int = 2,
                 lr_multiplier: float = 0.01, x_avg_beta: float = 0.995):
        super().__init__()
        self.z_dim, self.c_dim, self.num_ws, self.x_avg_beta = z_dim, c_dim, num_ws, x_avg_beta
        self.mlp = MLP([z_dim] * (num_layers + 1), lr_multiplier=lr_multiplier, linear_out=True)
        self.register_buffer("x_avg", torch.zeros(z_dim))

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor] = None,
                truncation_psi: float = 1.0, update_avg: bool = False) -> torch.Tensor:
        x = self.mlp(normalize_2nd_moment(z))
        if update_avg:
            with torch.no_grad():
                self.x_avg.copy_(x.detach().mean(dim=0) * (1 - self.x_avg_beta)
                                 + self.x_avg * self.x_avg_beta)
        if truncation_psi != 1.0:
            x = self.x_avg[None] + truncation_psi * (x - self.x_avg[None])
        if self.c_dim > 0:
            assert c is not None and c.shape[-1] == self.c_dim
            x = torch.cat([x, c.to(x.dtype)], dim=1)
        return x[:, None].repeat(1, self.num_ws, 1)


class Generator(nn.Module):
    """The text-conditional StyleGAN-T generator: ``forward(z, c)`` -> images
    (B, img_channels, res, res)."""

    def __init__(self, z_dim: int = 64, c_dim: int = 0, img_resolution: int = 64,
                 img_channels: int = 3, channel_base: int = 32768, channel_max: int = 512,
                 num_res_blocks: int = 3):
        super().__init__()
        self.synthesis = SynthesisNetwork(w_dim=z_dim + c_dim, img_resolution=img_resolution,
                                          img_channels=img_channels, channel_base=channel_base,
                                          channel_max=channel_max, num_res_blocks=num_res_blocks)
        self.mapping = MappingNetwork(z_dim, c_dim, num_ws=self.synthesis.num_ws)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor] = None,
                truncation_psi: float = 1.0, rng: Optional[torch.Generator] = None,
                update_avg: bool = False) -> torch.Tensor:
        ws = self.mapping(z, c, truncation_psi=truncation_psi, update_avg=update_avg)
        return self.synthesis(ws, rng=rng)
