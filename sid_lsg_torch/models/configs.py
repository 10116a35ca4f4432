"""Model configuration presets (SD1.5, SD2.1-base and a tiny test model).

A copy of the plain dataclasses of ``sid_lsg_tpu/models/configs.py``: the
port imports nothing of the JAX package.  ``config_from_hf_json`` builds a
config from an HF-layout checkpoint's own config files and
``write_hf_config_jsons`` writes them.
"""

from __future__ import annotations

import dataclasses
import json
import os
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


def config_from_hf_json(model_dir: str) -> SDConfig:
    """An ``SDConfig`` from an HF-layout checkpoint's config files.

    ``unet/config.json`` is required (``FileNotFoundError`` without it);
    ``vae/config.json``, ``text_encoder/config.json`` and
    ``scheduler/scheduler_config.json`` refine their parts when present (the
    dataclass defaults are SD1.5's).  Without a text-tower config an SD2.x
    UNet (cross-attention width 1024) gets the OpenCLIP ViT-H tower."""

    def _load(*parts):
        path = os.path.join(model_dir, *parts)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    uc = _load("unet", "config.json")
    if uc is None:
        raise FileNotFoundError(os.path.join(model_dir, "unet", "config.json"))

    def _fields(cls, src):
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: tuple(v) if isinstance(v, list) else v for k, v in src.items() if k in names}

    n_levels = len(uc.get("block_out_channels", (320, 640, 1280, 1280)))
    ukw = _fields(UNetConfig, uc)
    # diffusers stores the head COUNT in ``attention_head_dim`` (8 for SD1.5,
    # [5, 10, 20, 20] for SD2.1) when ``num_attention_heads`` is unset.
    heads = uc.get("num_attention_heads") or uc.get("attention_head_dim", 8)
    if not isinstance(heads, (list, tuple)):
        heads = [heads] * n_levels
    ukw["num_attention_heads"] = tuple(heads)
    if "down_block_types" in uc:
        ukw["cross_attention_levels"] = tuple("CrossAttn" in t for t in uc["down_block_types"])
    tlpb = uc.get("transformer_layers_per_block", 1)
    ukw["transformer_layers_per_block"] = tlpb[0] if isinstance(tlpb, (list, tuple)) else tlpb
    unet = UNetConfig(**ukw)

    vc = _load("vae", "config.json")
    vae = VAEConfig(**_fields(VAEConfig, vc)) if vc else VAEConfig()

    tc = _load("text_encoder", "config.json")
    if tc:
        text = CLIPTextConfig(**_fields(CLIPTextConfig, tc))
    elif unet.cross_attention_dim == 1024:
        text = SD21_BASE.text
    else:
        text = CLIPTextConfig()

    sc = _load("scheduler", "scheduler_config.json") or {}
    return SDConfig(name=os.path.basename(os.path.normpath(model_dir)), unet=unet, vae=vae,
                    text=text, prediction_type=sc.get("prediction_type", "epsilon"),
                    resolution=unet.sample_size * vae.vae_scale_factor)


def write_hf_config_jsons(model_dir: str, cfg: SDConfig) -> None:
    """Write the HF-layout config files that ``config_from_hf_json`` reads,
    under the diffusers / transformers field names."""
    u, v, t = cfg.unet, cfg.vae, cfg.text
    unet_json = {
        "_class_name": "UNet2DConditionModel",
        "sample_size": u.sample_size,
        "in_channels": u.in_channels,
        "out_channels": u.out_channels,
        "block_out_channels": list(u.block_out_channels),
        "layers_per_block": u.layers_per_block,
        "cross_attention_dim": u.cross_attention_dim,
        "attention_head_dim": list(u.num_attention_heads),
        "use_linear_projection": u.use_linear_projection,
        "norm_num_groups": u.norm_num_groups,
        "norm_eps": u.norm_eps,
        "transformer_layers_per_block": u.transformer_layers_per_block,
        "flip_sin_to_cos": u.flip_sin_to_cos,
        "freq_shift": u.freq_shift,
        "down_block_types": ["CrossAttnDownBlock2D" if x else "DownBlock2D"
                             for x in u.cross_attention_levels],
        "up_block_types": ["CrossAttnUpBlock2D" if x else "UpBlock2D"
                           for x in reversed(u.cross_attention_levels)],
    }
    vae_json = {
        "_class_name": "AutoencoderKL",
        "in_channels": v.in_channels,
        "out_channels": v.out_channels,
        "latent_channels": v.latent_channels,
        "block_out_channels": list(v.block_out_channels),
        "layers_per_block": v.layers_per_block,
        "norm_num_groups": v.norm_num_groups,
        "scaling_factor": v.scaling_factor,
        "force_upcast": v.force_upcast,
    }
    text_json = {
        "architectures": ["CLIPTextModel"],
        "vocab_size": t.vocab_size,
        "hidden_size": t.hidden_size,
        "intermediate_size": t.intermediate_size,
        "num_hidden_layers": t.num_hidden_layers,
        "num_attention_heads": t.num_attention_heads,
        "max_position_embeddings": t.max_position_embeddings,
        "hidden_act": t.hidden_act,
        "layer_norm_eps": t.layer_norm_eps,
    }
    sched_json = {
        "_class_name": "DDPMScheduler",
        "prediction_type": cfg.prediction_type,
        "beta_start": 0.00085,
        "beta_end": 0.012,
        "beta_schedule": "scaled_linear",
        "num_train_timesteps": 1000,
    }
    for sub, name, payload in (("unet", "config.json", unet_json),
                               ("vae", "config.json", vae_json),
                               ("text_encoder", "config.json", text_json),
                               ("scheduler", "scheduler_config.json", sched_json)):
        os.makedirs(os.path.join(model_dir, sub), exist_ok=True)
        with open(os.path.join(model_dir, sub, name), "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")


def scaled_unet_config(base: UNetConfig, width: float) -> UNetConfig:
    """``base`` with its channels scaled by ``width``, snapped to multiples of
    64 so that 32 GroupNorm groups and 8 head splits stay whole."""
    snap = lambda c: max(64, int(round(c * width / 64)) * 64)
    return dataclasses.replace(base,
                               block_out_channels=tuple(snap(c) for c in base.block_out_channels))
