"""LoRA adapters for the fake-score network.

Port of ``sid_lsg_tpu/training/lora.py`` on the port's parameter dicts.
psi is ``teacher + scale * A B`` over the attention projections (to_q, to_k,
to_v, to_out): a linear weight W of shape (out, in) becomes
W + scale * (A B)^T with A (in, r) and B (r, out), the JAX package's factors
of its (in, out) kernels.  The factor dict is flat, keyed by the diffusers
module name: ``{site + '.a': A, site + '.b': B}``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

Params = Dict[str, torch.Tensor]
DEFAULT_TARGETS: Tuple[str, ...] = ("to_q", "to_k", "to_v", "to_out")


def lora_sites(base_params: Params, targets: Sequence[str] = DEFAULT_TARGETS):
    """Module names of the 2-D weights whose module (``to_out.0``: its
    parent) names a target, in the dict's order."""
    for key, w in base_params.items():
        if not key.endswith(".weight") or w.dim() != 2:
            continue
        site = key[:-len(".weight")]
        parts = site.split(".")
        name = parts[-2] if parts[-1].isdigit() and len(parts) > 1 else parts[-1]
        if any(t in name for t in targets):
            yield site


def init_lora(generator: torch.Generator, base_params: Params, rank: int = 4,
              targets: Sequence[str] = DEFAULT_TARGETS) -> Params:
    """A ~ normal / sqrt(in), B = 0, so LoRA(0) is the base exactly; f32,
    drawn from ``generator`` on the base weights' device."""
    factors: Params = {}
    for site in lora_sites(base_params, targets):
        w = base_params[site + ".weight"]
        fan_out, fan_in = w.shape
        a = torch.randn(fan_in, rank, generator=generator, device=w.device) / fan_in ** 0.5
        factors[site + ".a"] = a
        factors[site + ".b"] = torch.zeros(rank, fan_out, device=w.device)
    if not factors:
        raise ValueError("no LoRA target weights found in base params")
    return factors


def apply_lora(base_params: Params, lora_params: Params, scale: float = 1.0) -> Params:
    """Effective params: each target weight becomes W + scale * (A B)^T."""
    out = dict(base_params)
    for key, a in lora_params.items():
        if not key.endswith(".a"):
            continue
        site = key[:-2]
        w = base_params[site + ".weight"]
        delta = (a @ lora_params[site + ".b"]) * scale
        out[site + ".weight"] = w + delta.t().to(w.dtype)
    return out


def lora_param_count(lora_params: Params) -> int:
    return sum(int(t.numel()) for t in lora_params.values())
