"""AutoencoderKL decoder in PyTorch (NCHW): latents to pixels.

Port of ``sid_lsg_tpu/models/vae.py`` (``Decoder`` and
``AutoencoderKL.decode``; the encoder is not ported yet).  The mid-block
attention and every GroupNorm's statistics run in f32 whatever the dtype, as
in the JAX package; convs follow the weights' dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from .configs import VAEConfig
from .layers import GroupNorm, ResnetBlock2D, Upsample2D, VAEAttention


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        g = config.norm_num_groups
        boc = list(reversed(config.block_out_channels))  # e.g. [512, 512, 256, 128]
        self.conv_in = nn.Conv2d(config.latent_channels, boc[0], 3, padding=1)
        self.mid_block = nn.ModuleDict({
            "resnets": nn.ModuleList([ResnetBlock2D(boc[0], boc[0], None, g, 1e-6),
                                      ResnetBlock2D(boc[0], boc[0], None, g, 1e-6)]),
            "attentions": nn.ModuleList([VAEAttention(boc[0], g)]),
        })
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
        dtype = self.conv_in.weight.dtype
        h = self.conv_in(z.to(dtype))
        h = self.mid_block["resnets"][0](h)
        h = self.mid_block["attentions"][0](h.float()).to(dtype)
        h = self.mid_block["resnets"][1](h)
        for block in self.up_blocks:
            for res in block["resnets"]:
                h = res(h)
            if "upsamplers" in block:
                h = block["upsamplers"][0](h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    """The VAE's decode half: ``post_quant_conv`` then ``decoder``."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents (already divided by scaling_factor) -> pixels in [-1, 1], NCHW."""
        z = self.post_quant_conv(latents.to(self.post_quant_conv.weight.dtype))
        return self.decoder(z)
