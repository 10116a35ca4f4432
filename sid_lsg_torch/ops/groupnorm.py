"""GroupNorm (+ fused SiLU) over NCHW: plain PyTorch version + CUDA kernels.

Port of ``sid_lsg_tpu/ops/groupnorm.py``.  Two routes on the card, chosen
by ``gn_plan`` from the shape, dtype and group count alone:

- ``fused``: K8 (``csrc/gn_fused.cu``), one launch that reads x once into
  shared memory, one thread-block cluster per (sample, group), and writes
  the normalised (+SiLU) output; the port of the single-block
  ``_gn_silu_pallas_fwd``.  It takes every map whose group span is at most
  ``_FUSED_MAX_BYTES`` (512 KB): every map of the JAX single-block kernel
  (HW * C * 4 <= 6 MiB with 32 groups), every UNet map and the VAE
  decoder's 64x64 and 128x128 maps.
- ``tiled``: K2 (``csrc/gn_stats.cu``) computes per (sample, group) f32 mean
  and rstd, K3 (``csrc/gn_apply.cu``) normalises, applies the affine and
  optionally SiLU; the port of ``_gn_tiled_pallas_fwd``, for the VAE
  decoder's 256x256 and 512x512 maps.

Each wrapper launches its kernel on a CUDA tensor and runs its plain version
(``gn_stats_ref`` / ``gn_apply_ref`` / ``group_norm_ref``) on a CPU tensor.
The plain versions follow ``_group_norm_ref`` step for step: per-channel
sums first, one-pass moments in f32, the variance clamped at 0, and the
group statistics folded into a per-channel scale and bias.

``group_norm`` is differentiable: its forward follows ``gn_plan`` and its
backward recomputes ``group_norm_ref`` and takes that formula's VJP, as the
JAX package's custom VJP does (``sid_lsg_tpu/ops/groupnorm.py:215-229``);
the backward is plain PyTorch on every device, as the JAX package leaves it
to XLA.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from . import registry
from ._build import check, dtype_code, library, use_kernel

_MAX_CLUSTER = 16  # blocks in a cluster (8 is the portable limit; the H100 takes 16)
# K8's routes, tuned on the card with scripts/torch_gn_sweep.py (the
# numbers are in csrc/gn_fused.cu): it takes group spans up to
# _FUSED_MAX_BYTES, in clusters of at least two blocks; a map of up to
# _FUSED_WAVE_BYTES is read in one wave in slices of up to
# _FUSED_WAVE_CTA_BYTES, a larger one in slices of up to _FUSED_CTA_BYTES.
_FUSED_MAX_BYTES = 512 * 1024
_FUSED_WAVE_BYTES = 24 * 2**20
_FUSED_WAVE_CTA_BYTES = 96 * 1024
_FUSED_CTA_BYTES = 32 * 1024
_SMEM_PER_BLOCK = 227 * 1024 - 1024  # dynamic shared memory K8 may ask of a block
# K2: the share of a span each block of its cluster reads at most.
_STATS_CTA_BYTES = 64 * 1024


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _span(shape: Sequence[int], num_groups: int) -> int:
    c = shape[1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    return c // num_groups * math.prod(shape[2:])


def gn_plan(shape: Sequence[int], dtype: torch.dtype, num_groups: int) -> Tuple[str, int]:
    """The card's route for a GroupNorm over ``shape`` (N, C, ...) in
    ``dtype``: ``("fused", cluster)`` for one K8 launch in clusters of
    ``cluster`` blocks, or ``("tiled", cluster)`` for K2 in clusters of
    ``cluster`` blocks, then K3 (spans above 512 KB, or whose K8 blocks
    would not fit their shared memory)."""
    span_bytes = _span(shape, num_groups) * dtype.itemsize
    if span_bytes <= _FUSED_MAX_BYTES:
        one_wave = shape[0] * num_groups * span_bytes <= _FUSED_WAVE_BYTES
        slice_bytes = _FUSED_WAVE_CTA_BYTES if one_wave else _FUSED_CTA_BYTES
        cluster = min(_MAX_CLUSTER, max(2, _pow2_at_least(-(-span_bytes // slice_bytes))))
        if fused_smem_bytes(shape, dtype, num_groups, cluster) <= _SMEM_PER_BLOCK:
            return "fused", cluster
    return "tiled", _stats_cluster(span_bytes)


def _stats_cluster(span_bytes: int) -> int:
    return min(_MAX_CLUSTER, _pow2_at_least(-(-span_bytes // _STATS_CTA_BYTES)))


def fused_smem_bytes(shape: Sequence[int], dtype: torch.dtype, num_groups: int, cluster: int) -> int:
    """Dynamic shared memory a K8 block asks for (the formula of
    ``csrc/gn_fused.cu:launch``): its slice of the span, padded to 16 bytes,
    then (scale, bias) in f32 of each channel the slice touches."""
    es = dtype.itemsize
    vec = 16 // es
    hw = math.prod(shape[2:])
    cg = shape[1] // num_groups
    chunk = -(-_span(shape, num_groups) // cluster)
    chunk = -(-chunk // vec) * vec
    return -(-chunk * es // 16) * 16 + 8 * min(cg, chunk // hw + 2)


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
    b = x.shape[0]
    span = _span(x.shape, num_groups)
    cluster = _stats_cluster(span * x.element_size())
    code = dtype_code(x)
    x = x.contiguous()
    mean = torch.empty((b, num_groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library().sidlsg_gn_stats_clustered(x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                              b * num_groups, span, cluster, float(eps), code,
                                              stream)
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


def gn_fused(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, num_groups: int,
             eps: float, silu: bool) -> torch.Tensor:
    """Kernel K8 on a CUDA tensor (raises where ``gn_plan`` does not send
    the shape to ``fused``), ``group_norm_ref`` on a CPU tensor."""
    if not use_kernel(x, gamma, beta):
        return group_norm_ref(x, gamma, beta, num_groups, eps, silu)
    route, cluster = gn_plan(x.shape, x.dtype, num_groups)
    if route != "fused":
        raise ValueError(f"gn_fused: a group of x{tuple(x.shape)} in {x.dtype} does not fit a "
                         f"cluster's shared memory (gn_plan: {route})")
    b, c = x.shape[:2]
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gn_fused: affine shapes {tuple(gamma.shape)}, {tuple(beta.shape)} for C={c}")
    code = dtype_code(x)
    x = x.contiguous()
    gamma, beta = (t.float().contiguous() for t in (gamma, beta))
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library().sidlsg_gn_fused(x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                    b, c, num_groups, x.numel() // (b * c), cluster, float(eps),
                                    int(silu), code, stream)
    check(err, "gn_fused")
    registry.record("gn_fused", (tuple(x.shape), str(x.dtype), num_groups, bool(silu)))
    return y


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, silu):
        ctx.save_for_backward(x, gamma, beta)
        ctx.args = (num_groups, eps, silu)
        if gn_plan(x.shape, x.dtype, num_groups)[0] == "fused":
            return gn_fused(x, gamma, beta, num_groups, eps, silu)
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
    """GroupNorm over (N, C, ...) with optional fused SiLU; on the card K8 or
    K2 + K3 as ``gn_plan`` says, differentiable (backward: the VJP of
    ``group_norm_ref``)."""
    return _GroupNorm.apply(x, gamma, beta, num_groups, eps, silu)


def group_norm_silu(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5):
    return group_norm(x, gamma, beta, num_groups, eps, silu=True)
