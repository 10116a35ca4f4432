"""The EDM nets: SongUNet (DDPM++ / NCSN++), DhariwalUNet (ADM) and the four
sigma preconditioners, NCHW.

Port of ``sid_lsg_tpu/models/edm_networks.py``.  Module and parameter names
are those of the reference's ``training/networks.py`` (``enc.16x16_block0.
conv0.weight`` OIHW, ``affine.weight`` (out, in), GroupNorm ``weight`` /
``bias``, ``map_noise.freqs``; a preconditioner holds its net as ``model``),
so a state dict in EDM's published layout loads with ``load_state_dict``
after ``models.convert.normalise_edm_state_dict``.  The constant
``resample_filter`` buffers are not part of the state dict: each block builds
its filter with ``ops.setup_filter``.

Every conv's bias goes through ``ops.bias_act(..., dim=1, act="linear")``
(kernel K7 on the card), every GroupNorm through ``ops.group_norm`` with
``min(32, C // 4) or 1`` groups (K8, or K2 + K3, as ``ops.gn_plan`` routes
it) and the attention through ``ops.attention`` (K1), as the JAX nets call
their ops.  The FIR resampling is ``ops.upsample2d`` / ``ops.downsample2d``
(stock ops).  Dropout is ``nn.Dropout``: ``eval()`` is the JAX package's
``deterministic=True``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import ops


# ---------------------------------------------------------------------------
# Small pieces


class PositionalEmbedding(nn.Module):
    def __init__(self, num_channels: int, max_positions: int = 10000, endpoint: bool = False):
        super().__init__()
        self.num_channels, self.max_positions, self.endpoint = num_channels, max_positions, endpoint

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = self.num_channels // 2
        freqs = torch.arange(half, dtype=torch.float32, device=x.device)
        freqs = freqs / (half - (1 if self.endpoint else 0))
        freqs = (1.0 / self.max_positions) ** freqs
        angles = x[:, None].float() * freqs[None]
        return torch.cat([angles.cos(), angles.sin()], dim=1)


class FourierEmbedding(nn.Module):
    def __init__(self, num_channels: int, scale: float = 16.0):
        super().__init__()
        self.scale = scale
        self.register_buffer("freqs", torch.empty(num_channels // 2))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.freqs.normal_(generator=generator).mul_(self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        angles = 2.0 * math.pi * x[:, None].float() * self.freqs[None]
        return torch.cat([angles.cos(), angles.sin()], dim=1)


def _he_uniform_(w: torch.Tensor, fan_in: int, scale: float,
                 generator: Optional[torch.Generator]) -> None:
    """The JAX package's init: uniform with std ``scale / sqrt(fan_in)``."""
    bound = math.sqrt(3) * scale / math.sqrt(fan_in)
    w.uniform_(-bound, bound, generator=generator)


class Linear(nn.Module):
    """``EDMLinear``: y = x W^T + b, W (out, in)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init_scale: float = 1.0):
        super().__init__()
        self.init_scale = init_scale
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _he_uniform_(self.weight, self.weight.shape[1], self.init_scale, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class Conv2d(nn.Module):
    """``EDMConv``: a k x k conv with padding k // 2, its bias added by
    ``ops.bias_act`` (K7 on the card)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, bias: bool = True,
                 init_scale: float = 1.0):
        super().__init__()
        self.init_scale = init_scale
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _he_uniform_(self.weight, self.weight[0].numel(), self.init_scale, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.weight.to(x.dtype), padding=self.weight.shape[-1] // 2)
        if self.bias is not None:
            y = ops.bias_act(y, self.bias.to(y.dtype), dim=1, act="linear")
        return y


class GroupNorm(nn.Module):
    """``EDMGroupNorm``: ``min(32, C // 4) or 1`` groups through
    ``ops.group_norm`` (K8 or K2 + K3 on the card), optionally with SiLU."""

    def __init__(self, num_channels: int, eps: float = 1e-5, silu: bool = False):
        super().__init__()
        self.eps, self.silu = eps, silu
        self.num_groups = min(32, num_channels // 4) or 1
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.group_norm(x, self.weight, self.bias, num_groups=self.num_groups,
                              eps=self.eps, silu=self.silu)


def _resample(x: torch.Tensor, f: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "up":
        return ops.upsample2d(x, f)
    if mode == "down":
        return ops.downsample2d(x, f)
    return x


# ---------------------------------------------------------------------------
# The shared EDM UNet block


class UNetBlock(nn.Module):
    """``EDMUNetBlock``: GroupNorm-SiLU, optional FIR resample, conv, the
    embedding's shift (or adaptive scale and shift), conv, skip, and
    optional self-attention with the reference's (heads, head_dim, 3) qkv
    channel layout."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int, up: bool = False,
                 down: bool = False, attention: bool = False, num_heads: Optional[int] = None,
                 channels_per_head: int = 64, dropout: float = 0.0, skip_scale: float = 1.0,
                 eps: float = 1e-5, resample_filter: Sequence[int] = (1, 1),
                 resample_proj: bool = False, adaptive_scale: bool = True,
                 init_zero_scale: float = 0.0):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.mode = "up" if up else ("down" if down else "keep")
        self.skip_scale, self.adaptive_scale = skip_scale, adaptive_scale
        # No max(..., 1): a block narrower than channels_per_head has no
        # attention, as in the reference.
        heads = num_heads if num_heads is not None else out_channels // channels_per_head
        self.num_heads = heads if attention else 0
        self.register_buffer("resample_filter", ops.setup_filter(list(resample_filter)),
                             persistent=False)
        self.norm0 = GroupNorm(in_channels, eps, silu=True)
        self.conv0 = Conv2d(in_channels, out_channels, 3)
        self.affine = Linear(emb_channels, out_channels * (2 if adaptive_scale else 1))
        self.norm1 = GroupNorm(out_channels, eps, silu=not adaptive_scale)
        self.dropout = nn.Dropout(dropout)
        self.conv1 = Conv2d(out_channels, out_channels, 3, init_scale=init_zero_scale)
        self.skip = None
        if out_channels != in_channels or up or down:
            if resample_proj or out_channels != in_channels:
                self.skip = Conv2d(in_channels, out_channels, 1)
        if self.num_heads:
            self.norm2 = GroupNorm(out_channels, eps)
            self.qkv = Conv2d(out_channels, out_channels * 3, 1)
            self.proj = Conv2d(out_channels, out_channels, 1, init_scale=init_zero_scale)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        orig = _resample(x, self.resample_filter, self.mode)
        h = self.conv0(_resample(self.norm0(x), self.resample_filter, self.mode))
        params = self.affine(emb.float())[:, :, None, None]
        if self.adaptive_scale:
            scale, shift = params.chunk(2, dim=1)
            h = F.silu(self.norm1(h) * (scale + 1.0) + shift)
        else:
            h = self.norm1(h + params)
        h = self.conv1(self.dropout(h))
        if self.skip is not None:
            orig = self.skip(orig)
        x = (h + orig) * self.skip_scale
        if self.num_heads:
            b, c, hh, ww = x.shape
            heads = self.num_heads
            qkv = self.qkv(self.norm2(x)).reshape(b, heads, c // heads, 3, hh * ww)
            q, k, v = (qkv[:, :, :, i].transpose(2, 3) for i in range(3))  # (B, heads, S, D)
            out = ops.attention(q.contiguous(), k.contiguous(), v.contiguous())
            out = out.transpose(2, 3).reshape(b, c, hh, ww)
            x = (x + self.proj(out)) * self.skip_scale
        return x


def _init_all(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


# ---------------------------------------------------------------------------
# SongUNet (DDPM++ / NCSN++)


class SongUNet(nn.Module):
    def __init__(self, img_resolution: int, in_channels: int, out_channels: int,
                 label_dim: int = 0, augment_dim: int = 0, model_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 2, 2, 2), channel_mult_emb: int = 4,
                 num_blocks: int = 4, attn_resolutions: Sequence[int] = (16,),
                 dropout: float = 0.10, label_dropout: float = 0.0,
                 embedding_type: str = "positional", channel_mult_noise: int = 1,
                 encoder_type: str = "standard", decoder_type: str = "standard",
                 resample_filter: Sequence[int] = (1, 1)):
        super().__init__()
        assert embedding_type in ("fourier", "positional")
        assert encoder_type in ("standard", "skip", "residual")
        assert decoder_type in ("standard", "skip")
        self.img_resolution, self.label_dim, self.augment_dim = img_resolution, label_dim, augment_dim
        self.channel_mult, self.num_blocks = tuple(channel_mult), num_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.encoder_type, self.decoder_type = encoder_type, decoder_type
        self.resample_taps = len(resample_filter)
        emb_channels = model_channels * channel_mult_emb
        noise_channels = model_channels * channel_mult_noise
        block = dict(emb_channels=emb_channels, num_heads=1, dropout=dropout,
                     skip_scale=math.sqrt(0.5), eps=1e-6, resample_filter=resample_filter,
                     resample_proj=True, adaptive_scale=False)
        self.register_buffer("resample_filter", ops.setup_filter(list(resample_filter)),
                             persistent=False)

        self.map_noise = (FourierEmbedding(noise_channels) if embedding_type == "fourier"
                          else PositionalEmbedding(noise_channels, endpoint=True))
        self.map_label = Linear(label_dim, noise_channels) if label_dim else None
        self.map_augment = Linear(augment_dim, noise_channels, bias=False) if augment_dim else None
        self.map_layer0 = Linear(noise_channels, emb_channels)
        self.map_layer1 = Linear(emb_channels, emb_channels)

        self.enc = nn.ModuleDict()
        cout, caux = in_channels, in_channels
        skips = []
        for level, mult in enumerate(self.channel_mult):
            res = img_resolution >> level
            if level == 0:
                self.enc[f"{res}x{res}_conv"] = Conv2d(cout, model_channels, 3)
                cout = model_channels
            else:
                self.enc[f"{res}x{res}_down"] = UNetBlock(cout, cout, down=True, **block)
                if encoder_type == "skip":
                    self.enc[f"{res}x{res}_aux_skip"] = Conv2d(caux, cout, 1)
                elif encoder_type == "residual":
                    self.enc[f"{res}x{res}_aux_residual"] = Conv2d(caux, cout, 3)
                    caux = cout
            skips.append(cout)
            for idx in range(num_blocks):
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_block{idx}"] = UNetBlock(
                    cin, cout, attention=res in self.attn_resolutions, **block)
                skips.append(cout)

        self.dec = nn.ModuleDict()
        last = len(self.channel_mult) - 1
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            res = img_resolution >> level
            if level == last:
                self.dec[f"{res}x{res}_in0"] = UNetBlock(cout, cout, attention=True, **block)
                self.dec[f"{res}x{res}_in1"] = UNetBlock(cout, cout, **block)
            else:
                self.dec[f"{res}x{res}_up"] = UNetBlock(cout, cout, up=True, **block)
            for idx in range(num_blocks + 1):
                cin, cout = cout + skips.pop(), model_channels * mult
                self.dec[f"{res}x{res}_block{idx}"] = UNetBlock(
                    cin, cout, attention=idx == num_blocks and res in self.attn_resolutions,
                    **block)
            if decoder_type == "skip" or level == 0:
                self.dec[f"{res}x{res}_aux_norm"] = GroupNorm(cout, eps=1e-6, silu=True)
                zero = level == 0 and decoder_type != "skip"
                self.dec[f"{res}x{res}_aux_conv"] = Conv2d(cout, out_channels, 3,
                                                           init_scale=0.0 if zero else 1.0)
        assert not skips

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _init_all(self, generator)

    def forward(self, x: torch.Tensor, noise_labels: torch.Tensor,
                class_labels: Optional[torch.Tensor] = None,
                augment_labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = self.map_noise(noise_labels)
        cos_half, sin_half = emb.chunk(2, dim=1)
        emb = torch.cat([sin_half, cos_half], dim=1)  # the reference's [cos, sin] -> [sin, cos]
        if self.map_label is not None:
            assert class_labels is not None
            emb = emb + self.map_label(class_labels.float() * math.sqrt(self.label_dim))
        if self.map_augment is not None and augment_labels is not None:
            emb = emb + self.map_augment(augment_labels.float())
        emb = F.silu(self.map_layer0(emb))
        emb = F.silu(self.map_layer1(emb))

        f = self.resample_filter
        skips = []
        aux = h = x
        for level, _ in enumerate(self.channel_mult):
            res = self.img_resolution >> level
            if level == 0:
                h = self.enc[f"{res}x{res}_conv"](h)
            else:
                h = self.enc[f"{res}x{res}_down"](h, emb)
                if self.encoder_type == "skip":
                    aux = _resample(aux, f, "down")
                    h = h + self.enc[f"{res}x{res}_aux_skip"](aux)
                elif self.encoder_type == "residual":
                    # Conv first, at full resolution with the filter's padding
                    # added to the conv's, then a stride-2 FIR with none.
                    fp = (self.resample_taps - 1) // 2
                    a = self.enc[f"{res}x{res}_aux_residual"](F.pad(aux, [fp, fp, fp, fp]))
                    aux = ops.upfirdn2d(a, f, down=2, padding=0)
                    h = aux = (h + aux) * math.sqrt(0.5)
            skips.append(h)
            for idx in range(self.num_blocks):
                h = self.enc[f"{res}x{res}_block{idx}"](h, emb)
                skips.append(h)

        aux_out = None
        last = len(self.channel_mult) - 1
        for level, _ in reversed(list(enumerate(self.channel_mult))):
            res = self.img_resolution >> level
            if level == last:
                h = self.dec[f"{res}x{res}_in0"](h, emb)
                h = self.dec[f"{res}x{res}_in1"](h, emb)
            else:
                h = self.dec[f"{res}x{res}_up"](h, emb)
            for idx in range(self.num_blocks + 1):
                h = self.dec[f"{res}x{res}_block{idx}"](torch.cat([h, skips.pop()], dim=1), emb)
            if self.decoder_type == "skip" or level == 0:
                if self.decoder_type == "skip" and level < last:
                    aux_out = _resample(aux_out, f, "up")
                tmp = self.dec[f"{res}x{res}_aux_conv"](self.dec[f"{res}x{res}_aux_norm"](h))
                aux_out = tmp if aux_out is None else aux_out + tmp
        assert not skips
        return aux_out


# ---------------------------------------------------------------------------
# DhariwalUNet (ADM)


class DhariwalUNet(nn.Module):
    def __init__(self, img_resolution: int, in_channels: int, out_channels: int,
                 label_dim: int = 0, augment_dim: int = 0, model_channels: int = 192,
                 channel_mult: Sequence[int] = (1, 2, 3, 4), channel_mult_emb: int = 4,
                 num_blocks: int = 3, attn_resolutions: Sequence[int] = (32, 16, 8),
                 dropout: float = 0.10, label_dropout: float = 0.0):
        super().__init__()
        self.img_resolution, self.label_dim = img_resolution, label_dim
        self.channel_mult, self.num_blocks = tuple(channel_mult), num_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        emb_channels = model_channels * channel_mult_emb
        block = dict(emb_channels=emb_channels, channels_per_head=64, dropout=dropout,
                     adaptive_scale=True)
        self.map_noise = PositionalEmbedding(model_channels)
        self.map_augment = (Linear(augment_dim, model_channels, bias=False) if augment_dim
                            else None)
        self.map_layer0 = Linear(model_channels, emb_channels)
        self.map_layer1 = Linear(emb_channels, emb_channels)
        # The sqrt(label_dim) gain is in the init, not the forward.
        self.map_label = (Linear(label_dim, emb_channels, bias=False,
                                 init_scale=math.sqrt(label_dim)) if label_dim else None)

        self.enc = nn.ModuleDict()
        cout = in_channels
        skips = []
        for level, mult in enumerate(self.channel_mult):
            res = img_resolution >> level
            if level == 0:
                self.enc[f"{res}x{res}_conv"] = Conv2d(cout, model_channels * mult, 3)
                cout = model_channels * mult
            else:
                self.enc[f"{res}x{res}_down"] = UNetBlock(cout, cout, down=True, **block)
            skips.append(cout)
            for idx in range(num_blocks):
                cin, cout = cout, model_channels * mult
                self.enc[f"{res}x{res}_block{idx}"] = UNetBlock(
                    cin, cout, attention=res in self.attn_resolutions, **block)
                skips.append(cout)

        self.dec = nn.ModuleDict()
        last = len(self.channel_mult) - 1
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            res = img_resolution >> level
            if level == last:
                self.dec[f"{res}x{res}_in0"] = UNetBlock(cout, cout, attention=True, **block)
                self.dec[f"{res}x{res}_in1"] = UNetBlock(cout, cout, **block)
            else:
                self.dec[f"{res}x{res}_up"] = UNetBlock(cout, cout, up=True, **block)
            for idx in range(num_blocks + 1):
                cin, cout = cout + skips.pop(), model_channels * mult
                self.dec[f"{res}x{res}_block{idx}"] = UNetBlock(
                    cin, cout, attention=res in self.attn_resolutions, **block)
        assert not skips
        self.out_norm = GroupNorm(cout, silu=True)
        self.out_conv = Conv2d(cout, out_channels, 3, init_scale=0.0)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _init_all(self, generator)

    def forward(self, x: torch.Tensor, noise_labels: torch.Tensor,
                class_labels: Optional[torch.Tensor] = None,
                augment_labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = self.map_noise(noise_labels)
        if self.map_augment is not None and augment_labels is not None:
            emb = emb + self.map_augment(augment_labels.float())
        emb = F.silu(self.map_layer0(emb))
        emb = self.map_layer1(emb)
        if self.map_label is not None:
            assert class_labels is not None
            emb = emb + self.map_label(class_labels.float())
        emb = F.silu(emb)

        skips = []
        h = x
        for level, _ in enumerate(self.channel_mult):
            res = self.img_resolution >> level
            h = (self.enc[f"{res}x{res}_conv"](h) if level == 0
                 else self.enc[f"{res}x{res}_down"](h, emb))
            skips.append(h)
            for idx in range(self.num_blocks):
                h = self.enc[f"{res}x{res}_block{idx}"](h, emb)
                skips.append(h)
        last = len(self.channel_mult) - 1
        for level, _ in reversed(list(enumerate(self.channel_mult))):
            res = self.img_resolution >> level
            if level == last:
                h = self.dec[f"{res}x{res}_in0"](h, emb)
                h = self.dec[f"{res}x{res}_in1"](h, emb)
            else:
                h = self.dec[f"{res}x{res}_up"](h, emb)
            for idx in range(self.num_blocks + 1):
                h = self.dec[f"{res}x{res}_block{idx}"](torch.cat([h, skips.pop()], dim=1), emb)
        assert not skips
        return self.out_conv(self.out_norm(h))


# ---------------------------------------------------------------------------
# Preconditioners: D(x; sigma) = c_skip x + c_out F(c_in x, c_noise)


def _sigma(sigma, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(sigma, dtype=torch.float32, device=x.device).reshape(-1, 1, 1, 1)


class _Precond(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def _net(self, x, c_in, c_noise, class_labels=None, **kw) -> torch.Tensor:
        return self.model(c_in * x.float(), c_noise, class_labels, **kw).float()

    def round_sigma(self, sigma):
        return torch.as_tensor(sigma, dtype=torch.float32)


class EDMPrecond(_Precond):
    def __init__(self, model: nn.Module, sigma_data: float = 0.5, sigma_min: float = 0.0,
                 sigma_max: float = float("inf")):
        super().__init__(model)
        self.sigma_data, self.sigma_min, self.sigma_max = sigma_data, sigma_min, sigma_max

    def forward(self, x, sigma, class_labels=None):
        sigma = _sigma(sigma, x)
        sd2 = self.sigma_data ** 2
        c_skip = sd2 / (sigma ** 2 + sd2)
        c_out = sigma * self.sigma_data / torch.sqrt(sigma ** 2 + sd2)
        c_in = 1.0 / torch.sqrt(sd2 + sigma ** 2)
        c_noise = torch.log(sigma.reshape(-1)) / 4.0
        return c_skip * x.float() + c_out * self._net(x, c_in, c_noise, class_labels)


class VPPrecond(_Precond):
    def __init__(self, model: nn.Module, beta_d: float = 19.9, beta_min: float = 0.1,
                 M: int = 1000, epsilon_t: float = 1e-5):
        super().__init__(model)
        self.beta_d, self.beta_min, self.M, self.epsilon_t = beta_d, beta_min, M, epsilon_t
        self.sigma_min = float(self.sigma(epsilon_t))
        self.sigma_max = float(self.sigma(1.0))

    def sigma(self, t):
        t = torch.as_tensor(t, dtype=torch.float32)
        return torch.sqrt(torch.exp(0.5 * self.beta_d * t ** 2 + self.beta_min * t) - 1.0)

    def sigma_inv(self, sigma):
        sigma = torch.as_tensor(sigma, dtype=torch.float32)
        return (torch.sqrt(self.beta_min ** 2 + 2 * self.beta_d * torch.log(1 + sigma ** 2))
                - self.beta_min) / self.beta_d

    def forward(self, x, sigma, class_labels=None):
        sigma = _sigma(sigma, x)
        c_skip = torch.ones_like(sigma)
        c_out = -sigma
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        c_noise = ((self.M - 1) * self.sigma_inv(sigma.reshape(-1))).float()
        return c_skip * x.float() + c_out * self._net(x, c_in, c_noise, class_labels)


class VEPrecond(_Precond):
    def __init__(self, model: nn.Module, sigma_min: float = 0.02, sigma_max: float = 100.0):
        super().__init__(model)
        self.sigma_min, self.sigma_max = sigma_min, sigma_max

    def forward(self, x, sigma, class_labels=None):
        sigma = _sigma(sigma, x)
        c_skip = torch.ones_like(sigma)
        c_in = torch.ones_like(sigma)
        c_noise = torch.log(0.5 * sigma.reshape(-1))
        return c_skip * x.float() + sigma * self._net(x, c_in, c_noise, class_labels)


def iddpm_u(C_1: float = 0.001, C_2: float = 0.008, M: int = 1000) -> np.ndarray:
    """The iDDPM sigma grid: the JAX package's f32 recursion, op for op (the
    table is the grid ``round_sigma`` snaps to, so its bits decide the
    indices)."""
    one = np.float32(1.0)

    def alpha_bar(j):
        a = np.float32(0.5 * np.pi) * np.float32(j) / np.float32(M)
        a = a / np.float32(C_2 + 1)
        return np.float32(np.sin(a)) ** 2

    u = np.zeros(M + 1, dtype=np.float32)
    for j in range(M, 0, -1):
        ratio = np.maximum(alpha_bar(j - 1) / alpha_bar(j), np.float32(C_1))
        u[j - 1] = np.sqrt((u[j] * u[j] + one) / ratio - one)
    return u


class iDDPMPrecond(_Precond):
    def __init__(self, model: nn.Module, C_1: float = 0.001, C_2: float = 0.008, M: int = 1000):
        super().__init__(model)
        self.C_1, self.C_2, self.M = C_1, C_2, M
        u = iddpm_u(C_1, C_2, M)
        self.register_buffer("u", torch.from_numpy(u), persistent=False)
        self.sigma_min, self.sigma_max = float(u[M - 1]), float(u[0])

    def round_sigma(self, sigma, return_index: bool = False):
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=self.u.device).reshape(-1)
        index = (sigma[:, None] - self.u[None, :]).abs().argmin(dim=1)
        return index if return_index else self.u[index]

    def forward(self, x, sigma, class_labels=None):
        sigma = _sigma(sigma, x)
        c_skip = torch.ones_like(sigma)
        c_out = -sigma
        c_in = 1.0 / torch.sqrt(sigma ** 2 + 1.0)
        index = self.round_sigma(sigma.reshape(-1), return_index=True)
        c_noise = (self.M - 1 - index).float()
        fx = self._net(x, c_in, c_noise, class_labels)
        # iDDPM nets give mean and variance channels; D(x) keeps the mean.
        return c_skip * x.float() + c_out * fx[:, :x.shape[1]]


PRECONDS = {"vp": VPPrecond, "ve": VEPrecond, "iddpm": iDDPMPrecond, "edm": EDMPrecond}
