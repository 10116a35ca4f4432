"""AutoencoderKL in PyTorch (NCHW): the SD latent codec.

Port of ``sid_lsg_tpu/models/vae.py``: ``Decoder`` (latents to pixels, the
generation path), ``Encoder`` (pixels to the posterior's moments, for
``cli/encode_latents``) and ``AutoencoderKL``.  The mid-block attentions and
every GroupNorm's statistics run in f32 whatever the dtype, as in the JAX
package; convs follow the weights' dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .configs import VAEConfig
from .layers import Downsample2D, GroupNorm, ResnetBlock2D, Upsample2D, VAEAttention


def _mid_block(ch: int, groups: int) -> nn.ModuleDict:
    return nn.ModuleDict({
        "resnets": nn.ModuleList([ResnetBlock2D(ch, ch, None, groups, 1e-6),
                                  ResnetBlock2D(ch, ch, None, groups, 1e-6)]),
        "attentions": nn.ModuleList([VAEAttention(ch, groups)]),
    })


def _run_mid_block(mid: nn.ModuleDict, h: torch.Tensor) -> torch.Tensor:
    dtype = h.dtype
    h = mid["resnets"][0](h)
    h = mid["attentions"][0](h.float()).to(dtype)
    return mid["resnets"][1](h)


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        g = config.norm_num_groups
        boc = config.block_out_channels
        self.conv_in = nn.Conv2d(config.in_channels, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cin = boc[0]
        for i, ch in enumerate(boc):
            block = nn.ModuleDict({"resnets": nn.ModuleList()})
            for _ in range(config.layers_per_block):
                block["resnets"].append(ResnetBlock2D(cin, ch, None, g, 1e-6))
                cin = ch
            if i < len(boc) - 1:
                block["downsamplers"] = nn.ModuleList([Downsample2D(ch, asymmetric_pad=True)])
            self.down_blocks.append(block)
        self.mid_block = _mid_block(boc[-1], g)
        self.conv_norm_out = GroupNorm(g, boc[-1], 1e-6, silu=True)
        self.conv_out = nn.Conv2d(boc[-1], 2 * config.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.to(self.conv_in.weight.dtype))
        for block in self.down_blocks:
            for res in block["resnets"]:
                h = res(h)
            if "downsamplers" in block:
                h = block["downsamplers"][0](h)
        h = _run_mid_block(self.mid_block, h)
        return self.conv_out(self.conv_norm_out(h))


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        g = config.norm_num_groups
        boc = list(reversed(config.block_out_channels))  # e.g. [512, 512, 256, 128]
        self.conv_in = nn.Conv2d(config.latent_channels, boc[0], 3, padding=1)
        self.mid_block = _mid_block(boc[0], g)
        self.up_blocks = nn.ModuleList()
        cin = boc[0]
        for i, ch in enumerate(boc):
            block = nn.ModuleDict({"resnets": nn.ModuleList()})
            for _ in range(config.layers_per_block + 1):
                block["resnets"].append(ResnetBlock2D(cin, ch, None, g, 1e-6))
                cin = ch
            if i < len(boc) - 1:
                block["upsamplers"] = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(block)
        self.conv_norm_out = GroupNorm(g, boc[-1], 1e-6, silu=True)
        self.conv_out = nn.Conv2d(boc[-1], config.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z.to(self.conv_in.weight.dtype))
        h = _run_mid_block(self.mid_block, h)
        for block in self.up_blocks:
            for res in block["resnets"]:
                h = res(h)
            if "upsamplers" in block:
                h = block["upsamplers"][0](h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    """``decode``: ``post_quant_conv`` then ``decoder``; ``encode_moments``:
    ``encoder`` then ``quant_conv``.  The decode half is declared first, so
    its random draws (``pipeline.random_state_dicts``) come first."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)
        self.encoder = Encoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents (already divided by scaling_factor) -> pixels in [-1, 1], NCHW."""
        z = self.post_quant_conv(latents.to(self.post_quant_conv.weight.dtype))
        return self.decoder(z)

    def encode_moments(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pixels in [-1, 1] (NCHW) -> the posterior's (mean, logvar), each
        (B, latent_channels, H/8, W/8), logvar clipped to [-30, 20]."""
        moments = self.quant_conv(self.encoder(images))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, images: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The posterior's mean, or with ``generator`` a sample from it."""
        mean, logvar = self.encode_moments(images)
        if generator is None:
            return mean
        noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(0.5 * logvar) * noise
