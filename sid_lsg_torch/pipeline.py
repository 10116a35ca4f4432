"""SDPipeline: tokenizer + CLIP text tower + UNet + VAE decoder + scheduler.

Port of ``sid_lsg_tpu/pipeline.py`` for one-step (or few-step) generation.
The public functions keep the JAX package's layout: latents in and x0 out are
NHWC f32, images out are NHWC uint8.  Inside, the models run NCHW in the
pipeline's dtype on its device, which is the card unless the caller passes
``device='cpu'``.

Weights come from a state dict per part (``{'unet', 'vae', 'text'}``, e.g.
the output of ``models.params_from_jax``) or, with ``state_dicts=None``, are
drawn from ``seed`` as flax's default initialisers would
(``random_state_dicts``, ``random_init``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from .device import resolve_device
from .diffusion.ddpm import DDPMScheduler, SchedulerConfig
from .diffusion.sampling import sid_sampler
from .models import AutoencoderKL, CLIPTextModel, HashTokenizer, SDConfig, UNet2DCondition, resolve
from .models.layers import init_weights_, to_compute_dtype

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


def _materialise(module: nn.Module, device: torch.device, dtype: torch.dtype,
                 state_dict: StateDict) -> nn.Module:
    module.to_empty(device=device)
    module.load_state_dict(state_dict, strict=True)
    return to_compute_dtype(module, dtype).eval().requires_grad_(False)


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
        self._uncond: Optional[torch.Tensor] = None

    @classmethod
    def random_init(cls, preset: str = "tiny", dtype: torch.dtype = torch.float32,
                    device: Union[str, torch.device] = "cuda", seed: int = 0) -> "SDPipeline":
        """A preset (``tiny`` / ``sd15`` / ``sd21base``) with weights drawn from ``seed``."""
        return cls(resolve(preset), None, dtype=dtype, device=device, seed=seed)

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
        z = latents.to(self.device, torch.float32).permute(0, 3, 1, 2)
        init_t = torch.full((z.shape[0],), init_timestep, dtype=torch.int32, device=self.device)
        x0 = sid_sampler(self.unet, z, text_embeddings.to(self.device), init_t, self.scheduler,
                         num_steps=num_steps, generator=generator, dtype=self.dtype)
        return x0.permute(0, 2, 3, 1)

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """x0 latents (B, H, W, 4) -> uint8 images (B, 8H, 8W, 3)."""
        z = latents.to(self.device, torch.float32).permute(0, 3, 1, 2)
        img = self.vae.decode(z / self.config.vae.scaling_factor)
        # The reference's uint8 mapping: x * 127.5 + 128, clipped, truncated.
        img = (img.float() * 127.5 + 128.0).clamp(0, 255).to(torch.uint8)
        return img.permute(0, 2, 3, 1)

    def generate(self, prompts: Sequence[str], latents: torch.Tensor, num_steps: int = 1,
                 init_timestep: int = 625,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Prompts + seeded latents -> uint8 images (B, H, W, 3) on the pipeline's device."""
        emb = self.encode_prompts(prompts)
        x0 = self.generate_latents(latents, emb, num_steps=num_steps,
                                   init_timestep=init_timestep, generator=generator)
        return self.decode(x0)
