"""UNet2DCondition in PyTorch (NCHW): the SD denoiser backbone.

Port of ``sid_lsg_tpu/models/unet.py``.  Same topology: conv_in, down
levels with cross-attention where the config says so, mid
resnet/transformer/resnet, the mirrored up path with skip concatenation,
GN+SiLU head.  With ``encoder_only`` the forward stops after the mid block
and returns the bottleneck map (the SiDA discriminator tower).  Submodules carry the diffusers names
(``down_blocks.{i}``, ``mid_block``, ``up_blocks.{k}`` with k = 0 the
deepest level).

Rematerialisation (JAX ``remat``/``remat_policy``): with ``remat_policy``
set, each ``ResnetBlock2D`` and ``Transformer2D`` runs under
``torch.utils.checkpoint`` (non-reentrant) whenever grad is enabled.
``full`` keeps only the blocks' inputs; ``flash`` also keeps the outputs
(out, lse) of the flash-attention op, so the backward sweep recomputes the
projections but runs no forward attention kernel again.

``unet_apply_fn`` gives the functional form the train step uses:
``apply(params, x, t, c)`` on a dict of (f32 master) tensors, cast to the
compute dtype at apply time, as the JAX package applies f32 params through
a bf16 module.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..ops.attention import FLASH_OP
from .configs import UNetConfig
from .layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    keeps_f32,
    timestep_embedding,
)

REMAT_POLICIES = ("full", "flash")
# The JAX package's other policies; the port raises for them (ROADMAP Queue 1 item 2).
UNPORTED_REMAT_POLICIES = ("dots", "dots_no_batch", "attn", "attn_offload")


def _flash_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op is FLASH_OP else CheckpointPolicy.PREFER_RECOMPUTE


def _flash_context():
    return create_selective_checkpoint_contexts(_flash_policy)


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig, remat_policy: Optional[str] = None):
        super().__init__()
        if remat_policy in UNPORTED_REMAT_POLICIES:
            raise ValueError(f"remat policy {remat_policy!r} is not ported yet (ROADMAP Queue 1 "
                             f"item 2); the port has {REMAT_POLICIES}")
        if remat_policy not in (None,) + REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {remat_policy!r}")
        self.remat_policy = remat_policy
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

    def _block(self, block: nn.Module, *args: torch.Tensor) -> torch.Tensor:
        """Run ``block``, under checkpoint when remat is on and grad is enabled.

        The block's parameters enter the checkpoint as explicit inputs and the
        recompute rebinds them with ``functional_call``: under
        ``unet_apply_fn`` they are the apply-time tensors, which are no longer
        bound to the module when the backward sweep recomputes."""
        if self.remat_policy is None or not torch.is_grad_enabled():
            return block(*args)
        names, params = zip(*block.named_parameters())
        n = len(args)

        def run(*xs):
            return functional_call(block, dict(zip(names, xs[n:])), xs[:n])

        context_fn = _flash_context if self.remat_policy == "flash" else None
        kwargs = {"context_fn": context_fn} if context_fn else {}
        return checkpoint(run, *args, *params, use_reentrant=False, **kwargs)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, encoder_only: bool = False) -> torch.Tensor:
        """(B, C_in, H, W) latents, (B,) int timesteps, (B, L, cross_dim) context
        -> (B, C_out, H, W) model output in the weights' dtype; with
        ``encoder_only``, the mid block's output (B, C_max, H/2^(n-1),
        W/2^(n-1)) instead."""
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
                h = self._block(res, h, temb)
                if len(block["attentions"]):
                    h = self._block(block["attentions"][j], h, context)
                skips.append(h)
            if "downsamplers" in block:
                h = block["downsamplers"][0](h)
                skips.append(h)

        h = self._block(self.mid_block["resnets"][0], h, temb)
        h = self._block(self.mid_block["attentions"][0], h, context)
        h = self._block(self.mid_block["resnets"][1], h, temb)
        if encoder_only:
            return h

        for block in self.up_blocks:
            for j, res in enumerate(block["resnets"]):
                h = self._block(res, torch.cat([h, skips.pop()], dim=1), temb)
                if len(block["attentions"]):
                    h = self._block(block["attentions"][j], h, context)
            if "upsamplers" in block:
                h = block["upsamplers"][0](h)
        assert not skips
        return self.conv_out(self.conv_norm_out(h))


Params = Dict[str, torch.Tensor]
UNetApplyP = Callable[[Params, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


_DECODER_PREFIXES = ("up_blocks.", "conv_norm_out.", "conv_out.")


def unet_apply_fn(config: UNetConfig, dtype: torch.dtype, remat_policy: Optional[str] = None,
                  encoder_only: bool = False) -> UNetApplyP:
    """``apply(params, x, t, c)``: the UNet on a dict of parameter tensors
    (diffusers keys), each cast to ``dtype`` at apply time; those of the
    modules that keep f32 (``layers.keeps_f32``) are brought to f32 instead,
    so a teacher held in bf16 (``--teacher-bf16``) normalises in f32 on its
    bf16-rounded parameters, as the JAX norms promote them.  The module
    itself holds no weights (meta).  With ``encoder_only`` it returns the
    bottleneck map and casts only the parameters that path reads."""
    with torch.device("meta"):
        skeleton = UNet2DCondition(config, remat_policy=remat_policy)
    keep = frozenset(f"{name}.{p}" for name, m in skeleton.named_modules() if keeps_f32(m)
                     for p, _ in m.named_parameters())

    def apply(params: Params, x: torch.Tensor, t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        cast = {k: v.float() if k in keep else v.to(dtype) for k, v in params.items()
                if not (encoder_only and k.startswith(_DECODER_PREFIXES))}
        return functional_call(skeleton, cast, (x, t, c), {"encoder_only": encoder_only})

    return apply
