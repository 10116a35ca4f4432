"""Building blocks of the SD models in PyTorch (NCHW).

Port of ``sid_lsg_tpu/models/layers.py``.  Module and parameter names follow
the diffusers state-dict keys (``to_out.0``, ``ff.net.0.proj``, ...), so a
port state dict has the layout of an HF checkpoint.  Activations are NCHW;
convs and dense layers are stock ``F.conv2d`` / ``F.linear`` (the JAX package
leaves them to XLA too); attention and GroupNorm(+SiLU) go through ``ops``,
which launches the CUDA kernels on the card.

Each module computes in the dtype of its weights.  GroupNorm and LayerNorm
keep f32 parameters and compute their statistics in f32 whatever the
activation dtype (see ``to_compute_dtype``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers get_timestep_embedding parity), f32."""
    half_dim = dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half_dim - freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class GroupNorm(nn.Module):
    """GroupNorm with optional fused SiLU over (N, C, H, W); f32 statistics and
    affine, output in the input's dtype."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5, silu: bool = False):
        super().__init__()
        self.num_groups, self.eps, self.silu = num_groups, eps, silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.group_norm(x, self.weight, self.bias, self.num_groups, self.eps, self.silu)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in f32, output cast back to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class TimestepEmbedding(nn.Module):
    """Two-layer MLP over the sinusoidal embedding (time_embedding in SD)."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        x = self.linear_1(t_emb.to(self.linear_1.weight.dtype))
        return self.linear_2(F.silu(x))


# The heads' merge as an op of its own, so that selective checkpointing sees
# the attention output: the UNet's remat policies ``attn`` and
# ``attn_offload`` keep what it returns (JAX tags the same tensor
# ``attn_out``).  It is the copy that ``transpose(1, 2).reshape`` makes.
# ``multihead_attention`` calls it only inside ``tag_attention_outputs``;
# everywhere else the merge is that reshape.
@torch.library.custom_op("sidlsg::merge_heads", mutates_args=(), schema="(Tensor x) -> Tensor")
def merge_heads(x):
    """(B, H, S, hd) -> (B, S, H*hd), a new tensor."""
    b, h, s, hd = x.shape
    out = x.new_empty((b, s, h * hd))
    out.view(b, s, h, hd).copy_(x.transpose(1, 2))
    return out


@merge_heads.register_fake
def _merge_heads_fake(x):
    b, h, s, hd = x.shape
    return x.new_empty((b, s, h * hd))


def _merge_heads_setup(ctx, inputs, output):
    ctx.heads = inputs[0].shape[1]


def _merge_heads_backward(ctx, grad):
    b, s, inner = grad.shape
    return grad.reshape(b, s, ctx.heads, inner // ctx.heads).transpose(1, 2)


merge_heads.register_autograd(_merge_heads_backward, setup_context=_merge_heads_setup)

MERGE_HEADS_OP = torch.ops.sidlsg.merge_heads.default

# A module global, not a thread-local: the remat recompute runs in the
# autograd engine's thread on CUDA tensors.
_tag_merge = False


@contextlib.contextmanager
def tag_attention_outputs(on: bool = True):
    """While ``on``, every multi-head merge runs as ``merge_heads``, whatever
    the head count (one head copies its (B, S, hd) output)."""
    global _tag_merge
    before, _tag_merge = _tag_merge, on
    try:
        yield
    finally:
        _tag_merge = before


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                        causal: bool = False) -> torch.Tensor:
    """(B, S, H*hd) projections -> (B, S_q, H*hd), heads split as (b, s, heads, hd)."""
    b, sq, inner = q.shape
    sk = k.shape[1]
    hd = inner // num_heads
    split = lambda t, s: t.reshape(b, s, num_heads, hd).transpose(1, 2)
    out = ops.attention(split(q, sq), split(k, sk), split(v, sk), causal=causal)
    if _tag_merge:
        return merge_heads(out)
    return out.transpose(1, 2).reshape(b, sq, inner)


class Attention(nn.Module):
    """Multi-head self (context=None) or cross attention; q/k/v without bias
    unless ``qkv_bias``, output projection with bias (diffusers parity)."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 context_dim: Optional[int] = None, qkv_bias: bool = False):
        super().__init__()
        inner = num_heads * head_dim
        context_dim = context_dim or query_dim
        self.num_heads = num_heads
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(context_dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(context_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        out = multihead_attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.num_heads)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate.float(), approximate="none").to(h.dtype)


class FeedForward(nn.Module):
    """GEGLU feed-forward, mult=4 (diffusers FeedForward; net.1 is its dropout)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> GEGLU FF, each pre-LN residual."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm32(dim)
        self.attn1 = Attention(dim, num_heads, head_dim)
        self.norm2 = LayerNorm32(dim)
        self.attn2 = Attention(dim, num_heads, head_dim, context_dim=context_dim)
        self.norm3 = LayerNorm32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> proj_in -> blocks -> proj_out -> residual.
    ``use_linear_projection`` picks Linear (SD2.x) or 1x1 conv (SD1.5) for the
    in/out projections."""

    def __init__(self, channels: int, num_heads: int, head_dim: int, context_dim: int,
                 depth: int = 1, use_linear_projection: bool = False, norm_num_groups: int = 32):
        super().__init__()
        inner = num_heads * head_dim
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm(norm_num_groups, channels, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(channels, inner)
            self.proj_out = nn.Linear(inner, channels)
        else:
            self.proj_in = nn.Conv2d(channels, inner, 1)
            self.proj_out = nn.Conv2d(inner, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, num_heads, head_dim, context_dim) for _ in range(depth)])

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if self.use_linear_projection:
            x = self.proj_in(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            x = self.proj_in(x)
            x = x.permute(0, 2, 3, 1).reshape(b, h * w, x.shape[1])
        for block in self.transformer_blocks:
            x = block(x, context)
        if self.use_linear_projection:
            x = self.proj_out(x).reshape(b, h, w, c).permute(0, 3, 1, 2)
        else:
            x = self.proj_out(x.reshape(b, h, w, -1).permute(0, 3, 1, 2))
        return x + residual


class ResnetBlock2D(nn.Module):
    """GN+SiLU -> conv -> (+temb) -> GN+SiLU -> conv, with 1x1 shortcut."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int] = None,
                 norm_num_groups: int = 32, norm_eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(norm_num_groups, in_channels, norm_eps, silu=True)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels) if temb_channels else None
        self.norm2 = GroupNorm(norm_num_groups, out_channels, norm_eps, silu=True)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return h + residual


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv: padding 1 on every side (the UNet's downsampler),
    or with ``asymmetric_pad`` (the VAE encoder's) padding 0 before and 1
    after on H and W."""

    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0 if asymmetric_pad else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest-neighbour 2x then 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class VAEAttention(Attention):
    """Single-head spatial self-attention of the VAE mid block (to_q/k/v with
    bias).  Kept in f32 by ``to_compute_dtype``."""

    def __init__(self, channels: int, norm_num_groups: int = 32):
        super().__init__(channels, 1, channels, qkv_bias=True)
        self.group_norm = GroupNorm(norm_num_groups, channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        y = super().forward(y)
        return y.transpose(1, 2).reshape(b, c, h, w) + x


def keeps_f32(module: nn.Module) -> bool:
    """Whether ``module``'s parameters stay f32 at every compute dtype:
    GroupNorm, LayerNorm and the VAE mid attention (the JAX package computes
    those in f32 whatever the activation dtype)."""
    return isinstance(module, (GroupNorm, nn.LayerNorm, VAEAttention))


def to_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast ``module`` to ``dtype`` in place, except where ``keeps_f32``."""
    module.to(dtype)
    for m in module.modules():
        if keeps_f32(m):
            m.float()
    return module


def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter as flax's defaults do: lecun-normal kernels
    (normal truncated at 2 std, scaled to variance 1/fan_in), zero biases,
    normal(1/sqrt(dim)) embeddings, unit norm scales; all drawn from
    ``generator`` (on the parameters' device)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                std = fan_in ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0, m.embedding_dim ** -0.5, generator=generator)
            elif isinstance(m, (GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return module
