"""Hot ops of the port: each a CUDA kernel for Hopper beside its plain PyTorch
version.  The tensor's device picks the path: CUDA launches the kernel, CPU
runs the plain version.  The resampling ops (``upfirdn2d``,
``conv2d_resample``, ``grid_sample``, ``fma``) have no kernel in either
package: they are stock ops on every device."""

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
from .resample_conv import conv2d_resample, fma, grid_sample
from .upfirdn2d import downsample2d, filter2d, setup_filter, upfirdn2d, upsample2d

__all__ = [
    "registry",
    "attention",
    "attention_ref",
    "activation_funcs",
    "bias_act",
    "bias_act_fwd",
    "bias_act_ref",
    "conv2d_resample",
    "downsample2d",
    "filter2d",
    "flash_attn_bwd",
    "flash_attn_bwd_dkv",
    "flash_attn_bwd_dq",
    "flash_attn_bwd_ref",
    "flash_attn_bwd_twopass",
    "flash_attn_fwd",
    "fma",
    "gn_apply",
    "gn_apply_ref",
    "gn_fused",
    "gn_plan",
    "gn_stats",
    "gn_stats_ref",
    "grid_sample",
    "group_norm",
    "group_norm_ref",
    "group_norm_silu",
    "setup_filter",
    "upfirdn2d",
    "upsample2d",
]
