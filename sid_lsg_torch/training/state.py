"""Training state + optimizer for SiD distillation.

Port of ``sid_lsg_tpu/training/state.py``.  Parameters are plain dicts of
tensors keyed by the diffusers names (the JAX package's pytrees).  The
optimizer computes what the JAX package's optax chain computes:

    nan_to_num(g, nan=0, +-1e5)  ->  [clip(+-c)]  ->  Adam(b1, b2, eps)
    ->  [+ weight_decay * p]  ->  * -lr  ->  p + update

with Adam as ``optax.adam`` (both moments f32) or, with ``low_mem_state``,
as ``scale_by_adam_low_mem`` (no first moment at b1 = 0, second moment
stored in bf16, arithmetic in f32).  Unlike optax it updates the
parameters and the moments in place, which saves a copy of each.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

Params = Dict[str, torch.Tensor]
_CHUNK = 64  # tensors per foreach call: bounds the temporaries of one update


def nan_to_num_grads(grads: Sequence[torch.Tensor], limit: float = 1e5) -> None:
    """In place: NaN -> 0 and +-inf -> +-limit in every gradient."""
    for g in grads:
        torch.nan_to_num_(g, nan=0.0, posinf=limit, neginf=-limit)


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Optional[Params]  # None for the low-memory state at b1 = 0
    nu: Params


class Optimizer:
    """The optax chain of ``make_optimizer`` as one in-place step over a dict
    of parameters."""

    def __init__(self, lr: float = 1e-6, b1: float = 0.0, b2: float = 0.999, eps: float = 1e-8,
                 grad_clip_value: Optional[float] = None, low_mem_state: bool = False,
                 weight_decay: float = 0.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.grad_clip_value = grad_clip_value
        self.low_mem_state = low_mem_state
        self.weight_decay = weight_decay
        self.state_dtype = torch.bfloat16 if low_mem_state else None

    def init(self, params: Params) -> AdamState:
        zeros = lambda p: torch.zeros_like(p, dtype=self.state_dtype or p.dtype)
        drop_mu = self.low_mem_state and self.b1 == 0.0
        mu = None if drop_mu else {k: zeros(p) for k, p in params.items()}
        return AdamState(count=0, mu=mu, nu={k: zeros(p) for k, p in params.items()})

    @torch.no_grad()
    def step(self, params: Params, grads: Sequence[torch.Tensor], state: AdamState) -> None:
        """One update of ``params`` (in dict order) from ``grads``, which it
        overwrites; ``state`` advances in place."""
        keys = list(params)
        if len(grads) != len(keys):
            raise ValueError(f"{len(grads)} gradients for {len(keys)} parameters")
        grads = list(grads)
        nan_to_num_grads(grads)
        if self.grad_clip_value is not None:
            torch._foreach_clamp_min_(grads, -self.grad_clip_value)
            torch._foreach_clamp_max_(grads, self.grad_clip_value)
        state.count += 1
        bc1 = 1.0 - self.b1 ** state.count
        bc2 = 1.0 - self.b2 ** state.count
        for i in range(0, len(keys), _CHUNK):
            ks = keys[i:i + _CHUNK]
            self._update([params[k] for k in ks], grads[i:i + _CHUNK],
                         None if state.mu is None else [state.mu[k] for k in ks],
                         [state.nu[k] for k in ks], bc1, bc2)

    def _update(self, p: List[torch.Tensor], g: List[torch.Tensor],
                mu: Optional[List[torch.Tensor]], nu: List[torch.Tensor], bc1: float,
                bc2: float) -> None:
        # Moments in f32: nu = b2 nu + (1 - b2) g^2, mu = b1 mu + (1 - b1) g.
        nu32 = [v.float() for v in nu] if self.low_mem_state else nu
        torch._foreach_mul_(nu32, self.b2)
        torch._foreach_addcmul_(nu32, g, g, value=1.0 - self.b2)
        if mu is None:
            mu_hat = g  # b1 = 0: the first moment is the gradient
        else:
            mu32 = [m.float() for m in mu] if self.low_mem_state else mu
            torch._foreach_mul_(mu32, self.b1)
            torch._foreach_add_(mu32, g, alpha=1.0 - self.b1)
            if self.low_mem_state:
                for m, m32 in zip(mu, mu32):
                    m.copy_(m32)
            mu_hat = torch._foreach_div(mu32, bc1)
        # update = mu_hat / (sqrt(nu / bc2) + eps) (+ weight_decay * p).
        denom = torch._foreach_div(nu32, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        del denom
        if self.low_mem_state:
            for v, v32 in zip(nu, nu32):
                v.copy_(v32)
        if self.weight_decay:
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-self.lr)


def make_optimizer(lr: float = 1e-6, b1: float = 0.0, b2: float = 0.999, eps: float = 1e-8,
                   grad_clip_value: Optional[float] = None, low_mem_state: bool = False,
                   weight_decay: float = 0.0) -> Optimizer:
    """Adam(b1, b2) with NaN hygiene; ``weight_decay`` > 0 gives AdamW
    (decoupled decay, as ``optax.adamw``)."""
    return Optimizer(lr, b1, b2, eps, grad_clip_value, low_mem_state, weight_decay)


@dataclasses.dataclass
class SiDState:
    """Everything that changes during distillation.  ``nimg`` is the number
    of images trained on (drives the EMA ramp-up)."""

    step: int
    nimg: float
    params_G: Params
    params_fake: Params
    ema: Params
    opt_G: AdamState
    opt_fake: AdamState


def init_state(params_unet: Params, opt_g: Optimizer, opt_fake: Optimizer, resume_nimg: int = 0,
               params_fake: Optional[Params] = None) -> SiDState:
    """G, psi and the EMA start from the (teacher) UNet params, each its own
    copy; ``params_fake`` (e.g. LoRA factors) replaces psi's copy.  G and psi
    are leaves that require grad; the EMA does not."""
    copy = lambda tree, grad: {k: v.detach().clone().requires_grad_(grad) for k, v in tree.items()}
    params_g = copy(params_unet, True)
    params_f = copy(params_fake if params_fake is not None else params_unet, True)
    return SiDState(step=0, nimg=float(resume_nimg), params_G=params_g, params_fake=params_f,
                    ema=copy(params_unet, False), opt_G=opt_g.init(params_g),
                    opt_fake=opt_fake.init(params_f))
