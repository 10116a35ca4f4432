"""Model configuration presets (SD1.5, SD2.1-base and a tiny test model).

A copy of the plain dataclasses of ``sid_lsg_tpu/models/configs.py``: the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    sample_size: int = 64
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # Per-level attention: True for CrossAttn(Down|Up)Block2D, False for plain.
    cross_attention_levels: Tuple[bool, ...] = (True, True, True, False)
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    transformer_layers_per_block: int = 1
    freq_shift: float = 0.0
    flip_sin_to_cos: bool = True

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    force_upcast: bool = True

    @property
    def vae_scale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # 'quick_gelu' (SD1.5) | 'gelu' (SD2.x)
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class SDConfig:
    """One Stable-Diffusion model family = UNet + VAE + text encoder + sched."""

    name: str
    unet: UNetConfig
    vae: VAEConfig
    text: CLIPTextConfig
    prediction_type: str = "epsilon"
    resolution: int = 512


SD15 = SDConfig(
    name="sd15",
    unet=UNetConfig(),
    vae=VAEConfig(),
    text=CLIPTextConfig(),
)

# stabilityai/stable-diffusion-2-1-base: OpenCLIP ViT-H text tower (1024 wide,
# 23 of 24 layers, gelu), 64-dim attention heads, linear transformer proj.
SD21_BASE = SDConfig(
    name="sd21base",
    unet=UNetConfig(
        cross_attention_dim=1024,
        num_attention_heads=(5, 10, 20, 20),
        use_linear_projection=True,
    ),
    vae=VAEConfig(),
    text=CLIPTextConfig(
        hidden_size=1024,
        intermediate_size=4096,
        num_hidden_layers=23,
        num_attention_heads=16,
        hidden_act="gelu",
    ),
)

# Tiny configs for tests / CPU smoke: same topology, ~1000x fewer params.
TINY = SDConfig(
    name="tiny",
    unet=UNetConfig(
        sample_size=8,
        block_out_channels=(32, 64),
        layers_per_block=1,
        cross_attention_levels=(True, False),
        num_attention_heads=(2, 2),
        cross_attention_dim=32,
        norm_num_groups=8,
    ),
    vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8),
    text=CLIPTextConfig(
        vocab_size=1000,
        hidden_size=32,
        intermediate_size=64,
        num_hidden_layers=2,
        num_attention_heads=2,
    ),
    resolution=16,
)


PRESETS = {"sd15": SD15, "sd21base": SD21_BASE, "tiny": TINY}

# HF hub repo ids the reference CLIs accept (sid_train.py run_sid.sh recipes).
HF_REPOS = {
    "runwayml/stable-diffusion-v1-5": SD15,
    "stabilityai/stable-diffusion-2-1-base": SD21_BASE,
}


def resolve(name_or_repo: str) -> SDConfig:
    if name_or_repo in PRESETS:
        return PRESETS[name_or_repo]
    if name_or_repo in HF_REPOS:
        return HF_REPOS[name_or_repo]
    raise KeyError(f"unknown model preset {name_or_repo!r}")
