"""SiD generator sampler on tensors.

Port of ``sid_lsg_tpu/diffusion/sampling.py:sid_sampler``: iterative
x0-prediction, re-noising the running x0 estimate at
``floor(init_t * (1 - i / num_steps))``.  Step 0 uses the given latents as
its noise; later steps draw fresh noise from ``generator``.  Layout-agnostic:
``unet_apply`` sees the latents in whatever layout the caller passes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .ddpm import DDPMScheduler

UNetApply = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def sid_sampler(unet_apply: UNetApply, latents: torch.Tensor, text_embeddings: torch.Tensor,
                init_timesteps: torch.Tensor, scheduler: DDPMScheduler, *, num_steps: int = 1,
                generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Generator forward; returns the final x0 estimate in f32."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    if num_steps > 1 and generator is None:
        raise ValueError("a generator is required for num_steps > 1 (fresh noise per step)")
    d_x = torch.zeros_like(latents, dtype=torch.float32)
    for i in range(num_steps):
        if i == 0:
            noise = latents.float()
        else:
            noise = torch.randn(latents.shape, generator=generator, device=latents.device,
                                dtype=torch.float32)
        t_i = (init_timesteps.float() * (1.0 - i / num_steps)).to(torch.int32)
        noisy = scheduler.add_noise(d_x, noise, t_i)
        model_in = scheduler.scale_model_input(noisy, t_i)
        model_out = unet_apply(model_in.to(dtype), t_i, text_embeddings).float()
        d_x = scheduler.pred_original_sample(model_out, t_i, noisy)
    return d_x
