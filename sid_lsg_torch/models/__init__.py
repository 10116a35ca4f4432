"""SD model zoo of the port: UNet, VAE, CLIP text tower (NCHW, PyTorch)."""

from .clip_text import CLIPTextModel
from .configs import PRESETS, SD15, SD21_BASE, TINY, SDConfig, config_from_hf_json, resolve
from .convert import load_sd_checkpoint, params_from_jax
from .tokenizer import CLIPTokenizer, HashTokenizer, load_tokenizer
from .unet import UNet2DCondition
from .vae import AutoencoderKL

__all__ = [
    "AutoencoderKL",
    "CLIPTextModel",
    "CLIPTokenizer",
    "HashTokenizer",
    "PRESETS",
    "SD15",
    "SD21_BASE",
    "SDConfig",
    "TINY",
    "UNet2DCondition",
    "config_from_hf_json",
    "load_sd_checkpoint",
    "load_tokenizer",
    "params_from_jax",
    "resolve",
]
