"""SiDA adversarial terms of the distillation step.

Port of ``sid_lsg_tpu/training/adversarial.py``.  Two judges:

- the ``encoder`` tower: psi's own encoder (conv_in, down path, mid block;
  ``unet_apply_fn(..., encoder_only=True)``) on noised latents, mean-pooled
  into one logit per image (``pooled_logit``), with no parameters beyond
  psi;
- the ``dino`` tower: ``make_pixel_disc`` VAE-decodes the latents and judges
  the pixels with the projected discriminator (frozen DINO backbone,
  trainable spectral heads), conditioned on the mean-pooled caption.

The losses are per sample, so the caller can mask each side by its own row
validity: non-saturating logistic (``ns``) or hinge.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ..models.stylegan_discriminator import (
    DiffAugmentDraws,
    ProjectedDiscriminator,
    draw_diff_augment,
)

Params = Dict[str, torch.Tensor]


def pooled_logit(features: torch.Tensor) -> torch.Tensor:
    """(B, ...) bottleneck features -> (B,) logits: the f32 mean over all
    but the batch axis."""
    return features.float().mean(dim=tuple(range(1, features.dim())))


def d_loss_real(logit_real: torch.Tensor, kind: str = "ns") -> torch.Tensor:
    """Real-side per-sample discriminator term: push ``logit_real`` up."""
    if kind == "ns":
        return F.softplus(-logit_real)
    if kind == "hinge":
        return torch.clamp(1.0 - logit_real, min=0.0)
    raise ValueError(f"unknown gan loss kind: {kind!r}")


def d_loss_fake(logit_fake: torch.Tensor, kind: str = "ns") -> torch.Tensor:
    """Fake-side per-sample discriminator term: push ``logit_fake`` down."""
    if kind == "ns":
        return F.softplus(logit_fake)
    if kind == "hinge":
        return torch.clamp(1.0 + logit_fake, min=0.0)
    raise ValueError(f"unknown gan loss kind: {kind!r}")


def d_loss(logit_real: torch.Tensor, logit_fake: torch.Tensor, kind: str = "ns") -> torch.Tensor:
    """Per-sample discriminator loss (both sides)."""
    return d_loss_real(logit_real, kind) + d_loss_fake(logit_fake, kind)


def g_loss(logit_fake: torch.Tensor, kind: str = "ns") -> torch.Tensor:
    """Per-sample generator adversarial loss: make fakes score high."""
    if kind == "ns":
        return F.softplus(-logit_fake)
    if kind == "hinge":
        return -logit_fake
    raise ValueError(f"unknown gan loss kind: {kind!r}")


class PixelDisc:
    """The pixel judge of ``adv_tower='dino'``:
    ``pixel_disc(head_params, latents, emb, aug) -> (B, K) logits``.

    ``latents`` (B, 4, h, w) are divided by ``scaling_factor`` and decoded by
    ``vae`` (frozen); the f32 image is judged by ``disc`` with its heads'
    parameters replaced by ``head_params`` (names as in ``disc``, e.g.
    ``heads.0.main0.conv.weight``), conditioned on the caption embedding
    ``emb`` (B, L, D) averaged over tokens; ``aug`` are the DiffAugment
    draws of the call, made by ``draw``."""

    def __init__(self, vae, disc: ProjectedDiscriminator, scaling_factor: float):
        self.vae, self.disc, self.scaling_factor = vae, disc, scaling_factor

    def __call__(self, head_params: Params, latents: torch.Tensor, emb: torch.Tensor,
                 aug: Optional[DiffAugmentDraws]) -> torch.Tensor:
        img = self.vae.decode(latents / self.scaling_factor).float()
        c = emb.float().mean(dim=1)
        return functional_call(self.disc, head_params, (img, c, aug))

    def draw(self, generator: torch.Generator, b: int, latent_size: int) -> DiffAugmentDraws:
        """The DiffAugment draws of one call on ``b`` latents of side ``latent_size``."""
        size = latent_size * self.vae.config.vae_scale_factor
        return draw_diff_augment(generator, b, size, size)


make_pixel_disc = PixelDisc  # the JAX package's name for the pixel judge
