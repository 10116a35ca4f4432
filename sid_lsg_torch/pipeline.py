"""SDPipeline: tokenizer + CLIP text tower + UNet + VAE + scheduler.

Port of ``sid_lsg_tpu/pipeline.py`` for one-step (or few-step) generation.
The public functions keep the JAX package's layout: latents in and x0 out are
NHWC f32, images in and out are NHWC uint8.  Inside, the models run NCHW in
the pipeline's dtype on its device, which is the card unless the caller
passes ``device='cpu'``.  Their inputs are made NCHW in memory (``_nchw``)
whatever the caller's strides: cuDNN rounds an NCHW and a channels-last
convolution differently in bf16, and the result must not depend on how the
caller's array lies in memory.

Loading:

- ``from_pretrained(model)``: an HF-layout checkpoint directory (``unet/``,
  ``vae/``, ``text_encoder/``, ``tokenizer/``; safetensors or torch ``.bin``
  files), its architecture from its own config files (SD1.5 without them);
  or a preset name / ``random:<preset>``, which is ``random_init``.  Any
  other argument raises: a mistyped path never gives random weights.
- ``random_init(preset)``: weights drawn from ``seed`` as flax's default
  initialisers would (``random_state_dicts``).
- ``load_generator(path)``: a distilled generator (the port's or the JAX
  package's export, or a reference pickle) for sampling; the teacher UNet
  stays as it is.

Weights otherwise come from a state dict per part (``{'unet', 'vae',
'text'}``, e.g. the output of ``models.params_from_jax``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .device import resolve_device
from .diffusion.ddpm import DDPMScheduler, SchedulerConfig
from .diffusion.sampling import sid_sampler
from .models import AutoencoderKL, CLIPTextModel, HashTokenizer, SDConfig, UNet2DCondition, resolve
from .models.configs import PRESETS, config_from_hf_json
from .models.convert import load_sd_checkpoint
from .models.layers import init_weights_, to_compute_dtype
from .models.tokenizer import load_tokenizer
from .runtime.checkpoint import load_generator_params

StateDict = Dict[str, torch.Tensor]


def _skeletons(config: SDConfig) -> Dict[str, nn.Module]:
    with torch.device("meta"):
        return {"unet": UNet2DCondition(config.unet), "vae": AutoencoderKL(config.vae),
                "text": CLIPTextModel(config.text)}


def random_state_dicts(config: SDConfig, device: Union[str, torch.device] = "cuda",
                       seed: int = 0) -> Dict[str, StateDict]:
    """f32 weights of every part drawn from ``seed`` on ``device`` (UNet, then
    VAE, then text tower, from one generator)."""
    device = resolve_device(device)
    generator = torch.Generator(device).manual_seed(seed)
    out = {}
    for part, module in _skeletons(config).items():
        module.to_empty(device=device)
        out[part] = init_weights_(module, generator).requires_grad_(False).state_dict()
    return out


def _sniff_config(model_dir: str) -> SDConfig:
    """The checkpoint's architecture from its config files; SD1.5 (the
    published default) without ``unet/config.json``."""
    try:
        return config_from_hf_json(model_dir)
    except FileNotFoundError:
        return resolve("sd15")


def load_pretrained(model: str, device: Union[str, torch.device] = "cuda",
                    seed: int = 0) -> Tuple[SDConfig, Dict[str, StateDict], object]:
    """``(config, f32 state dicts, tokenizer)`` of ``model``, as
    ``SDPipeline.from_pretrained`` takes it: random weights from ``seed`` on
    ``device`` for a preset or ``random:<preset>``, else the checkpoint
    directory's files (on the CPU)."""
    if model in PRESETS or model.startswith("random:"):
        config = resolve(model[len("random:"):] if model.startswith("random:") else model)
        return (config, random_state_dicts(config, device, seed),
                HashTokenizer(vocab_size=config.text.vocab_size))
    if not os.path.isdir(model):
        raise FileNotFoundError(
            f"model {model!r} is not a local checkpoint directory. Pass an HF-layout SD "
            f"directory (unet/ vae/ text_encoder/ tokenizer/), a preset name {sorted(PRESETS)}, "
            f"or 'random:<preset-or-repo>' for explicit random initialisation (no weights are "
            f"downloaded).")
    return _sniff_config(model), load_sd_checkpoint(model), load_tokenizer(model)


def _nchw(x: torch.Tensor, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """An NHWC tensor -> NCHW, contiguous, on ``device`` in ``dtype``."""
    return x.to(device, dtype).permute(0, 3, 1, 2).contiguous()


def _materialise(module: nn.Module, device: torch.device, dtype: torch.dtype,
                 state_dict: StateDict) -> nn.Module:
    """``module`` on ``device`` in its compute dtype, then loaded: the
    parameters that stay f32 (``keeps_f32``) hold the state dict's values
    exactly, as the JAX package's f32 params do, instead of their rounding
    to ``dtype``."""
    to_compute_dtype(module.to_empty(device=device), dtype)
    module.load_state_dict(state_dict, strict=True)
    return module.eval().requires_grad_(False)


class SDPipeline:
    def __init__(self, config: SDConfig, state_dicts: Optional[Dict[str, StateDict]] = None,
                 tokenizer=None, dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cuda", prediction_type: Optional[str] = None,
                 seed: int = 0):
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or HashTokenizer(vocab_size=config.text.vocab_size)
        self.scheduler = DDPMScheduler(SchedulerConfig.sd(prediction_type or config.prediction_type),
                                       device=self.device)
        if state_dicts is None:
            state_dicts = random_state_dicts(config, self.device, seed)
        if set(state_dicts) != {"unet", "vae", "text"}:
            raise KeyError(f"state_dicts needs 'unet', 'vae' and 'text', got {sorted(state_dicts)}")
        parts = {part: _materialise(module, self.device, dtype, state_dicts[part])
                 for part, module in _skeletons(config).items()}
        self.unet, self.vae, self.text_model = parts["unet"], parts["vae"], parts["text"]
        self.generator: Optional[nn.Module] = None
        self._uncond: Optional[torch.Tensor] = None

    @classmethod
    def from_pretrained(cls, model: str, dtype: torch.dtype = torch.float32,
                        device: Union[str, torch.device] = "cuda",
                        prediction_type: Optional[str] = None, seed: int = 0) -> "SDPipeline":
        """An HF-layout checkpoint directory, or a preset / ``random:<preset>``
        with weights drawn from ``seed`` (``load_pretrained``)."""
        device = resolve_device(device)
        config, state_dicts, tokenizer = load_pretrained(model, device, seed)
        return cls(config, state_dicts, tokenizer=tokenizer, dtype=dtype, device=device,
                   prediction_type=prediction_type)

    @classmethod
    def random_init(cls, preset: str = "tiny", dtype: torch.dtype = torch.float32,
                    device: Union[str, torch.device] = "cuda", seed: int = 0) -> "SDPipeline":
        """A preset (``tiny`` / ``sd15`` / ``sd21base``) with weights drawn from ``seed``."""
        return cls(resolve(preset), None, dtype=dtype, device=device, seed=seed)

    def load_generator(self, path: str) -> None:
        """Sample from the distilled generator in ``path`` (any file
        ``runtime.checkpoint.load_generator_params`` reads) from now on."""
        with torch.device("meta"):
            module = UNet2DCondition(self.config.unet)
        self.generator = _materialise(module, self.device, self.dtype,
                                      load_generator_params(path, self.config.unet))

    @property
    def generator_unet(self) -> nn.Module:
        """The UNet that samples: the loaded generator, else the teacher."""
        return self.unet if self.generator is None else self.generator

    @torch.no_grad()
    def encode_prompts(self, prompts: Sequence[str]) -> torch.Tensor:
        """(B, 77, D) final-hidden-state embeddings of the frozen text tower.

        Not under inference mode: the train step's cross-attention saves the
        embeddings for its weight gradients, which an inference tensor
        refuses."""
        ids = torch.as_tensor(self.tokenizer(list(prompts)), dtype=torch.long, device=self.device)
        return self.text_model(ids)

    def uncond_embedding(self) -> torch.Tensor:
        """(77, D) embedding of the empty prompt, computed once."""
        if self._uncond is None:
            self._uncond = self.encode_prompts([""])[0]
        return self._uncond

    @torch.inference_mode()
    def generate_latents(self, latents: torch.Tensor, text_embeddings: torch.Tensor,
                         num_steps: int = 1, init_timestep: int = 625,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Noise latents (B, H, W, 4) -> x0 latents (B, H, W, 4), f32 NHWC."""
        z = _nchw(latents, self.device, torch.float32)
        init_t = torch.full((z.shape[0],), init_timestep, dtype=torch.int32, device=self.device)
        x0 = sid_sampler(self.generator_unet, z, text_embeddings.to(self.device), init_t,
                         self.scheduler, num_steps=num_steps, generator=generator, dtype=self.dtype)
        return x0.permute(0, 2, 3, 1)

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """x0 latents (B, H, W, 4) -> uint8 images (B, 8H, 8W, 3)."""
        z = _nchw(latents, self.device, torch.float32)
        img = self.vae.decode(z / self.config.vae.scaling_factor)
        # The reference's uint8 mapping: x * 127.5 + 128, clipped, truncated.
        img = (img.float() * 127.5 + 128.0).clamp(0, 255).to(torch.uint8)
        return img.permute(0, 2, 3, 1)

    @torch.inference_mode()
    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 images (B, H, W, 3) -> posterior-mean latents times the
        scaling factor (B, H/8, W/8, 4), f32 NHWC: the space the UNet reads."""
        x = _nchw(images, self.device, torch.float32) / 127.5 - 1.0
        mean = self.vae.encode(x)
        return (mean.float() * self.config.vae.scaling_factor).permute(0, 2, 3, 1)

    def generate(self, prompts: Sequence[str], latents: torch.Tensor, num_steps: int = 1,
                 init_timestep: int = 625,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Prompts + seeded latents -> uint8 images (B, H, W, 3) on the pipeline's device."""
        emb = self.encode_prompts(prompts)
        x0 = self.generate_latents(latents, emb, num_steps=num_steps,
                                   init_timestep=init_timestep, generator=generator)
        return self.decode(x0)
