"""SiD generator sampler and LSG denoiser on tensors.

Port of ``sid_lsg_tpu/diffusion/sampling.py``.  ``sid_sampler``: iterative
x0-prediction, re-noising the running x0 estimate at
``floor(init_t * (1 - i / num_steps))``.  Step 0 uses the given latents as
its noise; later steps draw fresh noise from ``generator``.  ``sid_denoise``:
noise the images, run the UNet (one call on ``cat([uncond, cond])`` when the
guidance scale is not 1) and mix ``eps_u + kappa (eps_c - eps_u)``.
Layout-agnostic: ``unet_apply`` sees the latents in whatever layout the
caller passes.
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
            # Drawn where the generator lives (a CPU generator gives the
            # same noise for a run on the card and on the CPU), then moved.
            noise = torch.randn(latents.shape, generator=generator, device=generator.device,
                                dtype=torch.float32).to(latents.device)
        t_i = (init_timesteps.float() * (1.0 - i / num_steps)).to(torch.int32)
        noisy = scheduler.add_noise(d_x, noise, t_i)
        model_in = scheduler.scale_model_input(noisy, t_i)
        model_out = unet_apply(model_in.to(dtype), t_i, text_embeddings).float()
        d_x = scheduler.pred_original_sample(model_out, t_i, noisy)
    return d_x


def sid_denoise(unet_apply: UNetApply, images: torch.Tensor, noise: torch.Tensor,
                text_embeddings: torch.Tensor, uncond_embeddings: Optional[torch.Tensor],
                timesteps: torch.Tensor, scheduler: DDPMScheduler, *,
                guidance_scale: float = 1.0, predict_x0: bool = True,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Score-network denoise with classifier-free guidance (the LSG core);
    returns the x0 estimate (``predict_x0``) or the mixed model output, f32."""
    latents = scheduler.add_noise(images, noise, timesteps)
    if guidance_scale == 1.0:
        model_in = scheduler.scale_model_input(latents, timesteps)
        model_out = unet_apply(model_in.to(dtype), timesteps, text_embeddings).float()
    else:
        if uncond_embeddings is None:
            raise ValueError("uncond_embeddings required when guidance_scale != 1")
        emb = torch.cat([uncond_embeddings, text_embeddings], dim=0)
        t2 = torch.cat([timesteps, timesteps], dim=0)
        lat2 = torch.cat([latents, latents], dim=0)
        model_in = scheduler.scale_model_input(lat2, t2)
        out_uncond, out_text = unet_apply(model_in.to(dtype), t2, emb).float().chunk(2, dim=0)
        model_out = out_uncond + guidance_scale * (out_text - out_uncond)
    if predict_x0:
        return scheduler.pred_original_sample(model_out, timesteps, latents.float())
    return model_out
