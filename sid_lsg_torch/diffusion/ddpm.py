"""DDPM noise-schedule math on tensors.

Port of ``sid_lsg_tpu/diffusion/ddpm.py`` (``SchedulerConfig``,
``make_betas``, ``DDPMScheduler`` with ``add_noise``, ``scale_model_input``,
``get_velocity``, ``pred_original_sample`` and ``snr``, and
``compute_snr``).  The tables are computed in float64 with numpy and
stored as f32 tensors on the scheduler's device; per-sample coefficients are
gathers, so every method is vectorised over the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # 'linear' | 'scaled_linear' | 'squaredcos_cap_v2'
    prediction_type: str = "epsilon"  # 'epsilon' | 'v_prediction' | 'sample'
    steps_offset: int = 1
    clip_sample: bool = False
    clip_sample_range: float = 1.0

    @classmethod
    def sd(cls, prediction_type: str = "epsilon") -> "SchedulerConfig":
        """The Stable-Diffusion schedule (SD1.5 & SD2.1-base scheduler config)."""
        return cls(prediction_type=prediction_type)


def make_betas(config: SchedulerConfig) -> np.ndarray:
    n = config.num_train_timesteps
    if config.beta_schedule == "linear":
        betas = np.linspace(config.beta_start, config.beta_end, n, dtype=np.float64)
    elif config.beta_schedule == "scaled_linear":
        betas = np.linspace(config.beta_start**0.5, config.beta_end**0.5, n, dtype=np.float64) ** 2
    elif config.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t: float) -> float:
            return float(np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2)
        betas = np.array(
            [min(1 - alpha_bar((i + 1) / n) / alpha_bar(i / n), 0.999) for i in range(n)],
            dtype=np.float64,
        )
    else:
        raise ValueError(f"unknown beta_schedule {config.beta_schedule!r}")
    return betas


class DDPMScheduler:
    """Constant schedule tables + pure functions of them."""

    def __init__(self, config: Optional[SchedulerConfig] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config or SchedulerConfig()
        self.device = resolve_device(device)
        betas = make_betas(self.config)
        alphas_cumprod = np.cumprod(1.0 - betas)
        table = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        self.betas = table(betas)
        self.alphas_cumprod = table(alphas_cumprod)
        self.sqrt_alphas_cumprod = table(np.sqrt(alphas_cumprod))
        self.sqrt_one_minus_alphas_cumprod = table(np.sqrt(1.0 - alphas_cumprod))

    def _gather(self, table: torch.Tensor, timesteps: torch.Tensor, ndim: int) -> torch.Tensor:
        """Per-sample coefficients broadcast to an ndim tensor."""
        vals = table[timesteps.long()]
        return vals.reshape(vals.shape + (1,) * (ndim - vals.dim()))

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        nd = original_samples.dim()
        return (self._gather(self.sqrt_alphas_cumprod, timesteps, nd) * original_samples
                + self._gather(self.sqrt_one_minus_alphas_cumprod, timesteps, nd) * noise)

    def scale_model_input(self, sample: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        """DDPM does not rescale model input (diffusers DDPMScheduler parity)."""
        del timesteps
        return sample

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        """v-prediction target sqrt(abar) noise - sqrt(1 - abar) sample."""
        nd = sample.dim()
        return (self._gather(self.sqrt_alphas_cumprod, timesteps, nd) * noise
                - self._gather(self.sqrt_one_minus_alphas_cumprod, timesteps, nd) * sample)

    def pred_original_sample(self, model_output: torch.Tensor, timesteps: torch.Tensor,
                             sample: torch.Tensor) -> torch.Tensor:
        """x0 estimate: the vectorised ``step(...).pred_original_sample``."""
        sqrt_ac = self._gather(self.sqrt_alphas_cumprod, timesteps, sample.dim())
        sqrt_omac = self._gather(self.sqrt_one_minus_alphas_cumprod, timesteps, sample.dim())
        pt = self.config.prediction_type
        if pt == "epsilon":
            x0 = (sample - sqrt_omac * model_output) / sqrt_ac
        elif pt == "v_prediction":
            x0 = sqrt_ac * sample - sqrt_omac * model_output
        elif pt == "sample":
            x0 = model_output
        else:
            raise ValueError(f"unknown prediction_type {pt!r}")
        if self.config.clip_sample:
            x0 = x0.clamp(-self.config.clip_sample_range, self.config.clip_sample_range)
        return x0

    def snr(self, timesteps: torch.Tensor) -> torch.Tensor:
        """Signal-to-noise ratio abar / (1 - abar) per timestep."""
        ac = self.alphas_cumprod[timesteps.long()]
        return ac / (1.0 - ac)


def compute_snr(scheduler: DDPMScheduler, timesteps: torch.Tensor) -> torch.Tensor:
    """Free-function form of ``DDPMScheduler.snr`` (diffusers' name)."""
    return scheduler.snr(timesteps)
