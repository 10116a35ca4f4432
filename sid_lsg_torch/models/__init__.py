"""SD model zoo of the port: UNet, VAE decoder, CLIP text tower (NCHW, PyTorch)."""

from .clip_text import CLIPTextModel
from .configs import PRESETS, SD15, SD21_BASE, TINY, SDConfig, resolve
from .convert import params_from_jax
from .tokenizer import HashTokenizer
from .unet import UNet2DCondition
from .vae import AutoencoderKL

__all__ = [
    "AutoencoderKL",
    "CLIPTextModel",
    "HashTokenizer",
    "PRESETS",
    "SD15",
    "SD21_BASE",
    "SDConfig",
    "TINY",
    "UNet2DCondition",
    "params_from_jax",
    "resolve",
]
