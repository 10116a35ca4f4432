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
``torch.utils.checkpoint`` (non-reentrant) whenever grad is enabled, and
keeps what the JAX policy of the same name keeps; the backward sweep
recomputes the rest.  ``full`` keeps only the blocks' inputs; ``dots`` the
outputs of every matrix product and convolution (JAX ``checkpoint_dots``);
``dots_no_batch`` those of the products without batch dimensions, the
dense layers (``dots_with_no_batch_dims_saveable``); ``attn`` the merged
attention outputs (``layers.merge_heads``, JAX's ``attn_out``);
``attn_offload`` the same tensors in pinned host memory (only these two
policies' blocks merge the heads through ``merge_heads``); ``flash`` the
outputs (out, lse) of the flash-attention op.  Only ``flash`` spares the
sweep the forward attention kernel: the op is no product, as a
``pallas_call`` is no ``dot_general``.

``unet_apply_fn`` gives the functional form the train step uses:
``apply(params, x, t, c)`` on a dict of (f32 master) tensors, cast to the
compute dtype at apply time, as the JAX package applies f32 params through
a bf16 module.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import torch
from torch import nn
from torch.func import functional_call
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..ops.attention import FLASH_OP
from .configs import UNetConfig
from .layers import (
    MERGE_HEADS_OP,
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    keeps_f32,
    tag_attention_outputs,
    timestep_embedding,
)

REMAT_POLICIES = ("full", "dots", "dots_no_batch", "attn", "attn_offload", "flash")
# The policies that keep the attention outputs: their blocks merge the heads
# through ``merge_heads`` (``layers.tag_attention_outputs``).
ATTN_POLICIES = ("attn", "attn_offload")

_aten = torch.ops.aten
# The ops whose outputs each selective policy keeps, as the dispatcher names
# them under autograd (nn.Linear reaches ``mm`` or ``addmm``, nn.Conv2d
# ``convolution``, on the CPU and on CUDA alike).
NO_BATCH_PRODUCTS = frozenset({_aten.mm.default, _aten.addmm.default})
PRODUCTS = NO_BATCH_PRODUCTS | {_aten.bmm.default, _aten.baddbmm.default,
                                _aten.convolution.default}
SAVED_OPS = {"dots": PRODUCTS, "dots_no_batch": NO_BATCH_PRODUCTS,
             "attn": frozenset({MERGE_HEADS_OP}), "flash": frozenset({FLASH_OP})}

# Bytes and tensors that ``attn_offload`` has copied to pinned host memory
# (cumulative; a caller may zero them).
offload_stats = {"bytes": 0, "tensors": 0}
_side_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


def _keep(saved, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE


def _to_host(t: torch.Tensor):
    """Start ``t``'s copy into pinned host memory on a side stream -> (host
    tensor, the copy's event).  A CPU tensor stays as it is."""
    if t.device.type == "cpu":
        return t, None
    stream = _side_streams.get(t.device)
    if stream is None:
        stream = _side_streams[t.device] = torch.cuda.Stream(t.device)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    stream.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(stream):
        host.copy_(t, non_blocking=True)
        done = stream.record_event()
    t.record_stream(stream)  # t's memory is reused only once the copy has read it
    offload_stats["bytes"] += host.nbytes
    offload_stats["tensors"] += 1
    return host, done


def _to_device(saved, device: torch.device) -> torch.Tensor:
    t, done = saved
    if done is None:
        return t
    torch.cuda.current_stream(device).wait_event(done)
    return t.to(device, non_blocking=True)


class _OffloadForward(TorchDispatchMode):
    """The block's forward under ``attn_offload``: each ``merge_heads``
    output goes to pinned host memory."""

    def __init__(self, store: List):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is MERGE_HEADS_OP:
            self.store.append(_to_host(out))
        return out


class _OffloadRecompute(TorchDispatchMode):
    """The block's recompute under ``attn_offload``: each ``merge_heads``
    gives back its offloaded output, in the forward's order; every other op
    runs again."""

    def __init__(self, store: List):
        super().__init__()
        self.store = store

    def __enter__(self):
        self.next = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is not MERGE_HEADS_OP:
            return func(*args, **(kwargs or {}))
        saved = self.store[self.next]
        self.next += 1
        return _to_device(saved, args[0].device)


def _offload_contexts():
    store: List = []
    return _OffloadForward(store), _OffloadRecompute(store)


def remat_context_fn(policy: str) -> Optional[Callable]:
    """``torch.utils.checkpoint``'s ``context_fn`` for ``policy`` (None: keep
    only the inputs)."""
    if policy == "full":
        return None
    if policy == "attn_offload":
        return _offload_contexts
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_keep, SAVED_OPS[policy]))


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig, remat_policy: Optional[str] = None):
        super().__init__()
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
            with tag_attention_outputs(self.remat_policy in ATTN_POLICIES):
                return functional_call(block, dict(zip(names, xs[n:])), xs[:n])

        context_fn = remat_context_fn(self.remat_policy)
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
