"""The SiD-LSG distillation step.

Port of ``sid_lsg_tpu/training/distill.py`` without the SiDA adversarial
branches (``adv_weight_D/G > 0`` raises; ROADMAP Queue 1 item 8).  Per
iteration: the fake-score psi update (a denoising loss on generator
samples), then the generator theta update (the score-identity loss) on the
freshly updated psi, each with gradient accumulation over A rounds, NaN row
masking, ``nan_to_num`` + Adam, then the EMA lerp.

Latents are NCHW.  All random draws of a step (the context-dropout mask, z,
noise, t) come from one CPU ``torch.Generator`` and are then moved to the
device, so one seed gives the same step on the card and on the CPU
(``draw_round``); they are a few hundred KB per microbatch.  The UNet is
applied functionally, ``unet_apply(params, x, t, c)`` on dicts of tensors
(``models.unet.unet_apply_fn``).
"""

from __future__ import annotations

import dataclasses
import types
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..diffusion.ddpm import DDPMScheduler
from ..diffusion.sampling import sid_denoise, sid_sampler
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


def _check_not_adversarial(cfg: DistillConfig) -> None:
    if cfg.adversarial:
        raise ValueError("adv_weight_D / adv_weight_G > 0: the SiDA adversarial terms are not "
                         "ported yet (ROADMAP Queue 1 item 8)")


def make_loss_fns(unet_apply: UNetApplyP, scheduler: DDPMScheduler, cfg: DistillConfig,
                  fake_transform: Optional[Callable[[Params, Params], Params]] = None):
    """The per-round loss functions of both phases (JAX ``make_loss_fns``):

    - ``psi_loss(params_fake, teacher, images, noise, emb, uncond_b, t, denom)
      -> (loss, aux)``
    - ``g_loss(params_g, params_fake, teacher, z, noise, emb, uncond_b, t,
      init_t, denom, generator=None) -> (loss, aux)``
    - ``draw``, ``generate``, ``denoise`` building blocks.
    """
    _check_not_adversarial(cfg)
    fake_transform = fake_transform or (lambda pf, teacher: pf)
    v_pred = scheduler.config.prediction_type == "v_prediction"

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

    def psi_loss(params_fake, teacher, images, noise, emb, uncond_b, t, denom):
        # Invalid input rows are zeroed before they enter the net, so every
        # activation stays finite and valid rows keep their gradients.
        valid_in = _per_sample_finite(images) & _per_sample_finite(noise)
        images = _mask_rows(images, valid_in)
        noise = _mask_rows(noise, valid_in)
        eff = fake_transform(params_fake, teacher)
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
        return loss, {"n_valid": valid.sum(), "loss": loss.detach()}

    def g_loss(params_g, params_fake, teacher, z, noise, emb, uncond_b, t, init_t, denom,
               generator=None):
        valid_in = _per_sample_finite(z) & _per_sample_finite(noise)
        z = _mask_rows(z, valid_in)
        noise = _mask_rows(noise, valid_in)
        images = generate(params_g, z, emb, init_t, generator)
        eff_fake = fake_transform(params_fake, teacher)
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
        return loss, {"n_valid": valid.sum(), "loss": loss.detach()}

    return types.SimpleNamespace(psi_loss=psi_loss, g_loss=g_loss, draw=draw,
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
                    fake_transform: Optional[Callable[[Params, Params], Params]] = None):
    """Build ``train_step(state, teacher, batch, generator) -> (state, metrics)``.

    ``batch``: ``emb_fake`` and ``emb_g`` (A, mb, L, D) prompt embeddings of
    the two phases, ``uncond_emb`` (L, D).  ``generator``: a CPU generator
    (see ``draw_round``).  The state's tensors are updated in place
    (parameters, moments, EMA) and its counters advanced; ``metrics`` holds
    device scalars.
    """
    L = make_loss_fns(unet_apply, scheduler, cfg, fake_transform)

    def accumulate(grad_fn, params: Params, rounds: int):
        tensors = list(params.values())
        total, aux_sum = None, None
        for a in range(rounds):
            loss, aux = grad_fn(a)
            grads = torch.autograd.grad(loss, tensors)
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
            emb = emb_fake[a]
            if keep is not None:
                emb = torch.where(keep[:, None, None], emb, uncond_b)
            with torch.no_grad():
                images = L.generate(params_g_frozen, z, emb, init_t, generator)
            return L.psi_loss(state.params_fake, teacher, images, noise, emb, uncond_b, t, denom)

        grads_f, aux_f = accumulate(psi_round, state.params_fake, rounds)
        opt_fake.step(state.params_fake, grads_f, state.opt_fake)
        del grads_f

        # theta update on the freshly updated psi.
        params_fake_frozen = _detached(state.params_fake)

        def g_round(a):
            _, z, noise, t, init_t = draw_round(L, cfg, generator, mb, device, False)
            return L.g_loss(state.params_G, params_fake_frozen, teacher, z, noise, emb_g[a],
                            uncond_b, t, init_t, denom, generator)

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
        return state, metrics

    train_step.loss_fns = L
    return train_step
