"""UNet2DCondition in PyTorch (NCHW): the SD denoiser backbone.

Port of ``sid_lsg_tpu/models/unet.py`` (forward only, without remat and
without ``encoder_only``).  Same topology: conv_in, down levels with
cross-attention where the config says so, mid resnet/transformer/resnet, the
mirrored up path with skip concatenation, GN+SiLU head.  Submodules carry the
diffusers names (``down_blocks.{i}``, ``mid_block``, ``up_blocks.{k}`` with
k = 0 the deepest level).
"""

from __future__ import annotations

import torch
from torch import nn

from .configs import UNetConfig
from .layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    timestep_embedding,
)


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        boc = cfg.block_out_channels
        n = len(boc)
        temb = cfg.time_embed_dim

        def resnet(cin, cout):
            return ResnetBlock2D(cin, cout, temb, cfg.norm_num_groups, cfg.norm_eps)

        def transformer(level, ch):
            heads = cfg.num_attention_heads[level]
            return Transformer2D(ch, heads, ch // heads, cfg.cross_attention_dim,
                                 cfg.transformer_layers_per_block, cfg.use_linear_projection,
                                 cfg.norm_num_groups)

        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], temb)

        skip_channels = [boc[0]]
        self.down_blocks = nn.ModuleList()
        cin = boc[0]
        for i, ch in enumerate(boc):
            block = nn.ModuleDict({"resnets": nn.ModuleList(), "attentions": nn.ModuleList()})
            for _ in range(cfg.layers_per_block):
                block["resnets"].append(resnet(cin, ch))
                if cfg.cross_attention_levels[i]:
                    block["attentions"].append(transformer(i, ch))
                skip_channels.append(ch)
                cin = ch
            if i < n - 1:
                block["downsamplers"] = nn.ModuleList([Downsample2D(ch)])
                skip_channels.append(ch)
            self.down_blocks.append(block)

        self.mid_block = nn.ModuleDict({
            "resnets": nn.ModuleList([resnet(boc[-1], boc[-1]), resnet(boc[-1], boc[-1])]),
            "attentions": nn.ModuleList([transformer(n - 1, boc[-1])]),
        })

        self.up_blocks = nn.ModuleList()
        cin = boc[-1]
        for i in reversed(range(n)):
            ch = boc[i]
            block = nn.ModuleDict({"resnets": nn.ModuleList(), "attentions": nn.ModuleList()})
            for _ in range(cfg.layers_per_block + 1):
                block["resnets"].append(resnet(cin + skip_channels.pop(), ch))
                if cfg.cross_attention_levels[i]:
                    block["attentions"].append(transformer(i, ch))
                cin = ch
            if i > 0:
                block["upsamplers"] = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(block)

        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, boc[0], cfg.norm_eps, silu=True)
        self.conv_out = nn.Conv2d(boc[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """(B, C_in, H, W) latents, (B,) int timesteps, (B, L, cross_dim) context
        -> (B, C_out, H, W) model output in the weights' dtype."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
                                   cfg.freq_shift)
        temb = self.time_embedding(t_emb)
        context = encoder_hidden_states.to(dtype)

        h = self.conv_in(sample.to(dtype))
        skips = [h]
        for block in self.down_blocks:
            for j, res in enumerate(block["resnets"]):
                h = res(h, temb)
                if len(block["attentions"]):
                    h = block["attentions"][j](h, context)
                skips.append(h)
            if "downsamplers" in block:
                h = block["downsamplers"][0](h)
                skips.append(h)

        h = self.mid_block["resnets"][0](h, temb)
        h = self.mid_block["attentions"][0](h, context)
        h = self.mid_block["resnets"][1](h, temb)

        for block in self.up_blocks:
            for j, res in enumerate(block["resnets"]):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(block["attentions"]):
                    h = block["attentions"][j](h, context)
            if "upsamplers" in block:
                h = block["upsamplers"][0](h)
        assert not skips
        return self.conv_out(self.conv_norm_out(h))
