"""GroupNorm (+ fused SiLU) over NCHW: plain PyTorch version + CUDA kernels.

Port of ``sid_lsg_tpu/ops/groupnorm.py``.  The work splits in two kernels:
K2 (``csrc/gn_stats.cu``) computes per (sample, group) f32 mean and rstd,
K3 (``csrc/gn_apply.cu``) normalises, applies the affine and optionally SiLU
in one pass.  Each wrapper launches its kernel on a CUDA tensor and runs its
plain version (``gn_stats_ref`` / ``gn_apply_ref``) on a CPU tensor.  The
plain versions follow ``_group_norm_ref`` step for step: per-channel sums
first, one-pass moments in f32, the variance clamped at 0, and the group
statistics folded into a per-channel scale and bias.

``group_norm`` is differentiable: its forward is K2 + K3 and its backward
recomputes ``group_norm_ref`` and takes that formula's VJP, as the JAX
package's custom VJP does (``sid_lsg_tpu/ops/groupnorm.py:215-229``); the
backward is plain PyTorch on every device, as the JAX package leaves it to
XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import registry
from ._build import check, dtype_code, library, use_kernel

_ELEMS_PER_BLOCK = 8192  # K2 splits a span over blocks of about this many elements
_MAX_SPLITS = 1024


def gn_stats_ref(x: torch.Tensor, num_groups: int, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, C, ...) -> f32 (mean, rstd), each (N, num_groups)."""
    b, c = x.shape[:2]
    cg = c // num_groups
    xf = x.float().reshape(b, c, -1)
    ch_sum = xf.sum(dim=2)
    ch_sq = xf.square().sum(dim=2)
    g_sum = ch_sum.reshape(b, num_groups, cg).sum(dim=2)
    g_sq = ch_sq.reshape(b, num_groups, cg).sum(dim=2)
    n = float(xf.shape[2] * cg)
    mean = g_sum / n
    var = torch.clamp(g_sq / n - mean.square(), min=0.0)
    return mean, torch.rsqrt(var + eps)


def gn_apply_ref(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, silu: bool) -> torch.Tensor:
    """x * scale_c + bias_c (+ SiLU) in f32, returned in x's dtype."""
    b, c = x.shape[:2]
    cg = c // mean.shape[1]
    gamma32 = gamma.float()[None]
    scale_c = rstd.repeat_interleave(cg, dim=1) * gamma32
    bias_c = beta.float()[None] - (mean * rstd).repeat_interleave(cg, dim=1) * gamma32
    y = x.float().reshape(b, c, -1) * scale_c[:, :, None] + bias_c[:, :, None]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(x.shape)


def group_norm_ref(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5, silu: bool = False):
    return gn_apply_ref(x, *gn_stats_ref(x, num_groups, eps), gamma, beta, silu)


def gn_stats(x: torch.Tensor, num_groups: int, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K2 on a CUDA tensor, ``gn_stats_ref`` on a CPU tensor."""
    if not use_kernel(x):
        return gn_stats_ref(x, num_groups, eps)
    b, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"gn_stats: {c} channels do not split into {num_groups} groups")
    code = dtype_code(x)
    x = x.contiguous()
    groups_total = b * num_groups
    span = x.numel() // groups_total
    splits = min(_MAX_SPLITS, -(-span // _ELEMS_PER_BLOCK))
    chunk = -(-span // splits)
    chunk = -(-chunk // 8) * 8  # keep every block's start on a 16-byte boundary
    part = torch.empty(groups_total * splits * 2, dtype=torch.float32, device=x.device)
    mean = torch.empty((b, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library().sidlsg_gn_stats(x.data_ptr(), part.data_ptr(), mean.data_ptr(),
                                    rstd.data_ptr(), groups_total, span, splits, chunk,
                                    float(eps), code, stream)
    check(err, "gn_stats")
    registry.record("gn_stats", (tuple(x.shape), str(x.dtype), num_groups))
    return mean, rstd


def gn_apply(x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor, gamma: torch.Tensor,
             beta: torch.Tensor, silu: bool) -> torch.Tensor:
    """Kernel K3 on a CUDA tensor, ``gn_apply_ref`` on a CPU tensor."""
    if not use_kernel(x, mean, rstd, gamma, beta):
        return gn_apply_ref(x, mean, rstd, gamma, beta, silu)
    b, c = x.shape[:2]
    num_groups = mean.shape[1]
    if mean.shape != (b, num_groups) or rstd.shape != mean.shape or c % num_groups:
        raise ValueError(f"gn_apply: x{tuple(x.shape)} with stats {tuple(mean.shape)}")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gn_apply: affine shapes {tuple(gamma.shape)}, {tuple(beta.shape)} for C={c}")
    code = dtype_code(x)
    x = x.contiguous()
    stats = [t.float().contiguous() for t in (mean, rstd, gamma, beta)]
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library().sidlsg_gn_apply(x.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in stats),
                                    b, c, num_groups, x.numel() // (b * c), int(silu), code, stream)
    check(err, "gn_apply")
    registry.record("gn_apply", (tuple(x.shape), str(x.dtype), num_groups, bool(silu)))
    return y


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, silu):
        ctx.save_for_backward(x, gamma, beta)
        ctx.args = (num_groups, eps, silu)
        mean, rstd = gn_stats(x, num_groups, eps)
        return gn_apply(x, mean, rstd, gamma, beta, silu)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip((x, gamma, beta), ctx.needs_input_grad[:3])]
            y = group_norm_ref(*inputs, *ctx.args)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, dy) if wanted else ())
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,) * 3


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, num_groups: int = 32,
               eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """GroupNorm over (N, C, ...) with optional fused SiLU; K2 + K3 on the
    card, differentiable (backward: the VJP of ``group_norm_ref``)."""
    return _GroupNorm.apply(x, gamma, beta, num_groups, eps, silu)


def group_norm_silu(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5):
    return group_norm(x, gamma, beta, num_groups, eps, silu=True)
