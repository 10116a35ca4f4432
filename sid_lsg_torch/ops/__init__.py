"""Hot ops of the port: each a CUDA kernel for Hopper beside its plain PyTorch
version.  The tensor's device picks the path: CUDA launches the kernel, CPU
runs the plain version."""

from . import registry
from .attention import (
    attention,
    attention_ref,
    flash_attn_bwd,
    flash_attn_bwd_dkv,
    flash_attn_bwd_dq,
    flash_attn_bwd_ref,
    flash_attn_bwd_twopass,
    flash_attn_fwd,
)
from .bias_act import activation_funcs, bias_act, bias_act_fwd, bias_act_ref
from .groupnorm import (
    gn_apply,
    gn_fused,
    gn_plan,
    gn_apply_ref,
    gn_stats,
    gn_stats_ref,
    group_norm,
    group_norm_ref,
    group_norm_silu,
)

__all__ = [
    "registry",
    "attention",
    "attention_ref",
    "activation_funcs",
    "bias_act",
    "bias_act_fwd",
    "bias_act_ref",
    "flash_attn_bwd",
    "flash_attn_bwd_dkv",
    "flash_attn_bwd_dq",
    "flash_attn_bwd_ref",
    "flash_attn_bwd_twopass",
    "flash_attn_fwd",
    "gn_apply",
    "gn_apply_ref",
    "gn_fused",
    "gn_plan",
    "gn_stats",
    "gn_stats_ref",
    "group_norm",
    "group_norm_ref",
    "group_norm_silu",
]
