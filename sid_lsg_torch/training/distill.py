"""The SiD-LSG distillation step.

Port of ``sid_lsg_tpu/training/distill.py``.  Per iteration: the fake-score
psi update (a denoising loss on generator samples), then the generator
theta update (the score-identity loss) on the freshly updated psi, each
with gradient accumulation over A rounds, NaN row masking, ``nan_to_num`` +
Adam, then the EMA lerp.  With ``adv_weight_D`` / ``adv_weight_G`` > 0 the
SiDA adversarial terms join the two losses (``training/adversarial.py``):
the discriminator loss on real against generated samples trains psi (the
``encoder`` tower) or the spectral heads of the pixel judge (the ``dino``
tower, whose head parameters ride in ``params_fake`` under the prefix
``disc.`` and share psi's optimizer), and the generator term steers theta.

Latents are NCHW.  All random draws of a step come from one CPU
``torch.Generator`` and are then moved to the device, so one seed gives the
same step on the card and on the CPU; they are a few hundred KB per
microbatch.  Per accumulation round, in this order:

- psi phase: the context-dropout keep mask (with context dropout), z, noise,
  t (``draw_round``); with ``adv_weight_D`` > 0 the adversarial draws
  (``draw_adv_psi``): noise for the real latents (``encoder``) or the
  DiffAugment draws of the fake judge then of the real judge (``dino``);
  then the multistep sampler's draws;
- theta phase: z, noise, t; with ``adv_weight_G`` > 0 and the ``dino`` tower
  the DiffAugment draws of the judge (``draw_adv_g``); then the multistep
  sampler's draws.

The UNet is applied functionally, ``unet_apply(params, x, t, c)`` on dicts of
tensors (``models.unet.unet_apply_fn``).
"""

from __future__ import annotations

import dataclasses
import types
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..diffusion.ddpm import DDPMScheduler
from ..diffusion.sampling import sid_denoise, sid_sampler
from . import adversarial
from .adversarial import PixelDisc
from .state import Optimizer, SiDState

Params = Dict[str, torch.Tensor]
UNetApplyP = Callable[[Params, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Knobs of the distillation step; defaults = the reference paper config."""

    latent_size: int = 64  # resolution // 8
    latent_channels: int = 4
    init_timestep: int = 625
    tmin: int = 20
    tmax: int = 980
    cfg_train_fake: float = 1.0  # kappa1
    cfg_eval_fake: float = 1.0  # kappa2 = kappa3
    cfg_eval_real: float = 1.0  # kappa4
    alpha: float = 1.0
    loss_scaling: float = 1.0
    loss_scaling_G: float = 1.0
    num_steps: int = 1  # multistep generator
    batch_size: int = 512  # global batch per iteration (EMA / nimg bookkeeping)
    ema_halflife_kimg: float = 500.0
    ema_rampup_ratio: Optional[float] = 0.05
    context_dropout: float = 0.1
    dtype: torch.dtype = torch.float32  # compute dtype of the UNet applications
    adv_weight_D: float = 0.0
    adv_weight_G: float = 0.0
    gan_loss: str = "ns"  # 'ns' | 'hinge'
    adv_tower: str = "encoder"  # 'encoder' | 'dino'

    @property
    def use_context_dropout_fake(self) -> bool:
        return self.cfg_train_fake != 1.0 or self.cfg_eval_fake != 1.0

    @property
    def adversarial(self) -> bool:
        return self.adv_weight_D > 0.0 or self.adv_weight_G > 0.0


def ema_beta(cfg: DistillConfig, nimg: float) -> float:
    """EMA decay with ramp-up."""
    halflife_nimg = cfg.ema_halflife_kimg * 1000.0
    if cfg.ema_rampup_ratio is not None:
        halflife_nimg = min(halflife_nimg, nimg * cfg.ema_rampup_ratio)
    return 0.5 ** (cfg.batch_size / max(halflife_nimg, 1e-8))


def _per_sample_finite(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (B,) bool: every element finite."""
    return torch.isfinite(x.reshape(x.shape[0], -1)).all(dim=1)


def _mask_rows(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Zero invalid rows so they contribute neither loss nor gradient."""
    return torch.where(valid.reshape((-1,) + (1,) * (x.dim() - 1)), x, torch.zeros((), dtype=x.dtype,
                                                                                   device=x.device))


def _masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B,) mean over valid rows only (0 when none)."""
    return torch.where(valid, x, torch.zeros_like(x)).sum() / valid.sum().clamp_min(1)


DISC_PREFIX = "disc."


def _per_sample(d: torch.Tensor) -> torch.Tensor:
    """(B,) or (B, K) per-logit losses -> (B,): the pixel judge emits one
    logit per head and token; their mean keeps the gan weights comparable
    between towers."""
    return d if d.dim() == 1 else d.mean(dim=tuple(range(1, d.dim())))


def make_loss_fns(unet_apply: UNetApplyP, scheduler: DDPMScheduler, cfg: DistillConfig,
                  fake_transform: Optional[Callable[[Params, Params], Params]] = None,
                  unet_encode: Optional[UNetApplyP] = None,
                  pixel_disc: Optional[PixelDisc] = None):
    """The per-round loss functions of both phases (JAX ``make_loss_fns``):

    - ``psi_loss(params_fake, teacher, images, noise, emb, uncond_b, t, denom,
      adv=None) -> (loss, aux)``
    - ``g_loss(params_g, params_fake, teacher, z, noise, emb, uncond_b, t,
      init_t, denom, generator=None, adv=None) -> (loss, aux)``
    - ``draw``, ``draw_adv_psi``, ``draw_adv_g``, ``generate``, ``denoise``
      building blocks.

    ``adv`` carries the adversarial inputs of a round: for ``psi_loss`` with
    ``adv_weight_D`` > 0 the real latents ``lat_real`` and their caption
    embeddings ``emb_real`` plus ``draw_adv_psi``'s draws; for ``g_loss``
    with ``adv_weight_G`` > 0 ``draw_adv_g``'s draws.  ``unet_encode`` (the
    encoder-only UNet apply) backs the ``encoder`` tower, ``pixel_disc`` the
    ``dino`` tower, whose heads are the ``disc.``-prefixed entries of
    ``params_fake``.
    """
    if cfg.adv_tower not in ("encoder", "dino"):
        raise ValueError(f"unknown adv_tower: {cfg.adv_tower!r}")
    pixel_mode = cfg.adversarial and cfg.adv_tower == "dino"
    if cfg.adversarial and not pixel_mode and unet_encode is None:
        raise ValueError("adv_weight_D/adv_weight_G > 0 with adv_tower='encoder' requires "
                         "unet_encode (encoder-only UNet apply for the SiDA discriminator)")
    if pixel_mode and pixel_disc is None:
        raise ValueError("adv_tower='dino' requires pixel_disc")
    fake_transform = fake_transform or (lambda pf, teacher: pf)
    v_pred = scheduler.config.prediction_type == "v_prediction"

    def psi_of(params_fake: Params) -> Params:
        if not pixel_mode:
            return params_fake
        return {k: v for k, v in params_fake.items() if not k.startswith(DISC_PREFIX)}

    def disc_of(params_fake: Params) -> Params:
        return {k[len(DISC_PREFIX):]: v for k, v in params_fake.items()
                if k.startswith(DISC_PREFIX)}

    def draw(generator: torch.Generator, mb: int, device) -> Tuple[torch.Tensor, ...]:
        shape = (mb, cfg.latent_channels, cfg.latent_size, cfg.latent_size)
        z = torch.randn(shape, generator=generator)
        noise = torch.randn(shape, generator=generator)
        t = torch.randint(cfg.tmin, cfg.tmax, (mb,), generator=generator)
        init_t = torch.full((mb,), cfg.init_timestep, dtype=torch.long)
        return tuple(x.to(device) for x in (z, noise, t, init_t))

    def generate(params_g, z, emb, init_t, generator=None):
        apply = lambda x, t, c: unet_apply(params_g, x, t, c)
        return sid_sampler(apply, z, emb, init_t, scheduler, num_steps=cfg.num_steps,
                           generator=generator, dtype=cfg.dtype)

    def denoise(params, images, noise, emb, uncond_b, t, scale, predict_x0):
        apply = lambda x, tt, c: unet_apply(params, x, tt, c)
        return sid_denoise(apply, images, noise, emb, uncond_b if scale != 1.0 else None, t,
                           scheduler, guidance_scale=scale, predict_x0=predict_x0,
                           dtype=cfg.dtype)

    def draw_adv_psi(generator: torch.Generator, mb: int, device) -> Dict[str, object]:
        if pixel_mode:
            return {side: pixel_disc.draw(generator, mb, cfg.latent_size)
                    for side in ("aug_fake", "aug_real")}
        shape = (mb, cfg.latent_channels, cfg.latent_size, cfg.latent_size)
        return {"noise_real": torch.randn(shape, generator=generator).to(device)}

    def draw_adv_g(generator: torch.Generator, mb: int) -> Dict[str, object]:
        return {"aug": pixel_disc.draw(generator, mb, cfg.latent_size)} if pixel_mode else {}

    def d_logits(params_fake, eff, latents, noise, emb, t, aug):
        """Discriminator logits of one side (real or generated), per tower:
        the pixel judge, or psi's pooled encoder features of the noised
        latents (the denoising loss's timestep draw, so D sees every noise
        level)."""
        if pixel_mode:
            return pixel_disc(disc_of(params_fake), latents, emb, aug)
        x_in = scheduler.scale_model_input(scheduler.add_noise(latents, noise, t), t)
        return adversarial.pooled_logit(unet_encode(eff, x_in.to(cfg.dtype), t, emb))

    def psi_loss(params_fake, teacher, images, noise, emb, uncond_b, t, denom, adv=None):
        # Invalid input rows are zeroed before they enter the net, so every
        # activation stays finite and valid rows keep their gradients.
        valid_in = _per_sample_finite(images) & _per_sample_finite(noise)
        images = _mask_rows(images, valid_in)
        noise = _mask_rows(noise, valid_in)
        eff = fake_transform(psi_of(params_fake), teacher)
        noise_fake = denoise(eff, images, noise, emb, uncond_b, t, cfg.cfg_train_fake,
                             predict_x0=False)
        valid = valid_in & _per_sample_finite(noise_fake)
        if v_pred:
            target = scheduler.get_velocity(images, noise, t)
            valid = valid & _per_sample_finite(target)
        else:
            target = noise
        diff = _mask_rows(noise_fake, valid) - _mask_rows(target, valid)
        per = diff.square().sum(dim=(1, 2, 3))
        if v_pred:
            snr = scheduler.snr(t)
            per = per * snr / (snr + 1.0)
        loss = per.sum() * (cfg.loss_scaling / denom)
        aux = {"n_valid": valid.sum(), "loss": loss.detach()}
        if cfg.adv_weight_D <= 0.0:
            return loss, aux
        # The real rows carry their own corruption risk: sanitised like the
        # generated side, and each side's d-loss masked by its own validity.
        valid_real = _per_sample_finite(adv["lat_real"]) & _per_sample_finite(adv["emb_real"])
        lat_real = _mask_rows(adv["lat_real"], valid_real)
        emb_real = _mask_rows(adv["emb_real"], valid_real)
        logit_fake = d_logits(params_fake, eff, images, noise, emb, t, adv.get("aug_fake"))
        logit_real = d_logits(params_fake, eff, lat_real, adv.get("noise_real"), emb_real, t,
                              adv.get("aug_real"))
        d_fake = _per_sample(adversarial.d_loss_fake(logit_fake, cfg.gan_loss))
        d_real = _per_sample(adversarial.d_loss_real(logit_real, cfg.gan_loss))
        zero = torch.zeros((), dtype=d_fake.dtype, device=d_fake.device)
        d_fake = torch.where(valid_in & torch.isfinite(d_fake), d_fake, zero)
        d_real = torch.where(valid_real & torch.isfinite(d_real), d_real, zero)
        adv_loss = (d_fake.sum() + d_real.sum()) * (cfg.adv_weight_D * cfg.loss_scaling / denom)
        aux.update(adv_d_loss=adv_loss.detach(),
                   d_logit_real=_masked_mean(_per_sample(logit_real.detach()), valid_real),
                   d_logit_fake=_masked_mean(_per_sample(logit_fake.detach()), valid_in))
        return loss + adv_loss, aux

    def g_loss(params_g, params_fake, teacher, z, noise, emb, uncond_b, t, init_t, denom,
               generator=None, adv=None):
        valid_in = _per_sample_finite(z) & _per_sample_finite(noise)
        z = _mask_rows(z, valid_in)
        noise = _mask_rows(noise, valid_in)
        images = generate(params_g, z, emb, init_t, generator)
        eff_fake = fake_transform(psi_of(params_fake), teacher)
        y_fake = denoise(eff_fake, images, noise, emb, uncond_b, t, cfg.cfg_eval_fake,
                         predict_x0=True)
        y_real = denoise(teacher, images, noise, emb, uncond_b, t, cfg.cfg_eval_real,
                         predict_x0=True)
        valid = (valid_in & _per_sample_finite(images) & _per_sample_finite(y_real)
                 & _per_sample_finite(y_fake))
        x = _mask_rows(images, valid)
        y_real = _mask_rows(y_real, valid)
        y_fake = _mask_rows(y_fake, valid)
        w = (x - y_real).abs().mean(dim=(1, 2, 3), keepdim=True).clamp_min(1e-5).detach()
        if cfg.alpha == 1.0:
            per = (y_real - y_fake) * (y_fake - x) / w
        else:
            per = (y_real - y_fake) * ((y_real - x) - cfg.alpha * (y_real - y_fake)) / w
        per = _mask_rows(per, valid).sum(dim=(1, 2, 3))
        loss = per.sum() * (cfg.loss_scaling_G / denom)
        aux = {"n_valid": valid.sum(), "loss": loss.detach()}
        if cfg.adv_weight_G <= 0.0:
            return loss, aux
        # The gradient reaches theta through `images`; the judge is fixed here.
        logit_gen = d_logits(params_fake, eff_fake, images, noise, emb, t,
                             (adv or {}).get("aug"))
        g_per = _per_sample(adversarial.g_loss(logit_gen, cfg.gan_loss))
        g_per = torch.where(valid & torch.isfinite(g_per), g_per,
                            torch.zeros((), dtype=g_per.dtype, device=g_per.device))
        adv_loss = g_per.sum() * (cfg.adv_weight_G * cfg.loss_scaling_G / denom)
        aux["adv_g_loss"] = adv_loss.detach()
        return loss + adv_loss, aux

    return types.SimpleNamespace(psi_loss=psi_loss, g_loss=g_loss, draw=draw,
                                 draw_adv_psi=draw_adv_psi, draw_adv_g=draw_adv_g,
                                 generate=generate, denoise=denoise)


def draw_round(L, cfg: DistillConfig, generator: torch.Generator, mb: int, device,
               dropout: bool):
    """One accumulation round's draws, in this order: the context-dropout
    keep mask (only when ``dropout``), z, noise, t.  Returns (keep or None,
    z, noise, t, init_t) on ``device``."""
    keep = None
    if dropout:
        keep = (torch.rand(mb, generator=generator) >= cfg.context_dropout).to(device)
    return (keep,) + L.draw(generator, mb, device)


def _detached(params: Params) -> Params:
    return {k: v.detach() for k, v in params.items()}


def make_train_step(unet_apply: UNetApplyP, scheduler: DDPMScheduler, cfg: DistillConfig,
                    opt_g: Optimizer, opt_fake: Optimizer,
                    fake_transform: Optional[Callable[[Params, Params], Params]] = None,
                    unet_encode: Optional[UNetApplyP] = None,
                    pixel_disc: Optional[PixelDisc] = None):
    """Build ``train_step(state, teacher, batch, generator) -> (state, metrics)``.

    ``batch``: ``emb_fake`` and ``emb_g`` (A, mb, L, D) prompt embeddings of
    the two phases, ``uncond_emb`` (L, D); with ``adv_weight_D`` > 0 also
    ``lat_real`` (A, mb, 4, h, w) real latents and ``emb_real`` (A, mb, L, D)
    their caption embeddings.  ``generator``: a CPU generator (the module
    docstring gives the order of its draws).  The state's tensors are
    updated in place (parameters, moments, EMA) and its counters advanced;
    ``metrics`` holds device scalars.
    """
    L = make_loss_fns(unet_apply, scheduler, cfg, fake_transform, unet_encode, pixel_disc)

    def accumulate(grad_fn, params: Params, rounds: int):
        tensors = list(params.values())
        total, aux_sum = None, None
        for a in range(rounds):
            loss, aux = grad_fn(a)
            # Zeros for a parameter the loss does not reach (the judge's heads
            # when only the generator term is on), as jax.grad gives.
            grads = torch.autograd.grad(loss, tensors, allow_unused=True, materialize_grads=True)
            if total is None:
                total, aux_sum = list(grads), dict(aux)
            else:
                torch._foreach_add_(total, list(grads))
                aux_sum = {k: aux_sum[k] + aux[k] for k in aux_sum}
        return total, aux_sum

    def train_step(state: SiDState, teacher: Params, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator):
        emb_fake, emb_g, uncond = batch["emb_fake"], batch["emb_g"], batch["uncond_emb"]
        rounds, mb = emb_fake.shape[:2]
        device = emb_fake.device
        denom = float(rounds * mb)
        uncond_b = uncond.expand(mb, *uncond.shape[-2:])

        # psi update (the generator enters frozen).
        params_g_frozen = _detached(state.params_G)

        def psi_round(a):
            keep, z, noise, t, init_t = draw_round(L, cfg, generator, mb, device,
                                                   cfg.use_context_dropout_fake)
            drop = (lambda e: e) if keep is None else (
                lambda e: torch.where(keep[:, None, None], e, uncond_b))
            emb = drop(emb_fake[a])
            adv = None
            if cfg.adv_weight_D > 0.0:
                # The same keep mask on the real captions: otherwise carrying
                # the empty prompt would mark a sample as generated.
                adv = {"lat_real": batch["lat_real"][a], "emb_real": drop(batch["emb_real"][a]),
                       **L.draw_adv_psi(generator, mb, device)}
            with torch.no_grad():
                images = L.generate(params_g_frozen, z, emb, init_t, generator)
            return L.psi_loss(state.params_fake, teacher, images, noise, emb, uncond_b, t, denom,
                              adv)

        grads_f, aux_f = accumulate(psi_round, state.params_fake, rounds)
        opt_fake.step(state.params_fake, grads_f, state.opt_fake)
        del grads_f

        # theta update on the freshly updated psi.
        params_fake_frozen = _detached(state.params_fake)

        def g_round(a):
            _, z, noise, t, init_t = draw_round(L, cfg, generator, mb, device, False)
            adv = L.draw_adv_g(generator, mb) if cfg.adv_weight_G > 0.0 else None
            return L.g_loss(state.params_G, params_fake_frozen, teacher, z, noise, emb_g[a],
                            uncond_b, t, init_t, denom, generator, adv)

        grads_g, aux_g = accumulate(g_round, state.params_G, rounds)
        opt_g.step(state.params_G, grads_g, state.opt_G)
        del grads_g

        # EMA lerp with half-life ramp: ema = beta ema + (1 - beta) G.
        beta = ema_beta(cfg, state.nimg)
        with torch.no_grad():
            torch._foreach_lerp_(list(state.ema.values()), list(state.params_G.values()),
                                 1.0 - beta)
        state.step += 1
        state.nimg += cfg.batch_size
        metrics = {
            "fake_score_loss": aux_f["loss"] / rounds,
            "g_loss": aux_g["loss"] / rounds,
            "fake_valid": aux_f["n_valid"],
            "g_valid": aux_g["n_valid"],
            "ema_beta": beta,
        }
        for k in ("adv_d_loss", "d_logit_real", "d_logit_fake"):
            if k in aux_f:
                metrics[k] = aux_f[k] / rounds
        if "adv_g_loss" in aux_g:
            metrics["adv_g_loss"] = aux_g["adv_g_loss"] / rounds
        return state, metrics

    train_step.loss_fns = L
    return train_step
