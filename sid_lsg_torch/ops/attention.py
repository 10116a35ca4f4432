"""Scaled-dot-product attention: plain PyTorch version + CUDA flash forward.

Port of ``sid_lsg_tpu/ops/attention.py``.  ``attention_ref`` is the plain
version (einsum, f32 softmax); ``flash_attn_fwd`` launches kernel K1
(``csrc/flash_attn_fwd.cu``) on a CUDA tensor and runs ``attention_ref`` on a
CPU tensor.  Layout (B, H, S, D).  Causal attention (the CLIP text tower,
S = 77) takes the plain version on every device, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import registry
from ._build import check, dtype_code, library, use_kernel

NEG_INF = -1e30
MAX_HEAD_DIM = {torch.bfloat16: 160, torch.float32: 512}


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None,
                  causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T * scale) v computed in f32; returns (out in q's dtype,
    f32 row logsumexp of the scaled logits)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    return out.to(q.dtype), lse


def flash_attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-causal attention over (B, H, S, D); returns (out, f32 lse (B, H, S_q)).

    A CUDA tensor goes to kernel K1, which takes bf16 with D <= 160 and f32
    with D <= 512 and raises otherwise; a CPU tensor goes to ``attention_ref``.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not use_kernel(q, k, v):
        return attention_ref(q, k, v, scale)
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attn_fwd: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attn_fwd: mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    code = dtype_code(q)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d > MAX_HEAD_DIM[q.dtype]:
        raise ValueError(f"flash_attn_fwd: head dim {d} exceeds {MAX_HEAD_DIM[q.dtype]} for {q.dtype}")
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    out = torch.empty_like(qc)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = library().sidlsg_flash_attn_fwd(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b * h, sq, sk, d, float(scale), code, stream)
    check(err, "flash_attn_fwd")
    registry.record("flash_attn_fwd", (tuple(q.shape), tuple(k.shape), str(q.dtype)))
    return out, lse


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None, causal: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, S, D) tensors."""
    if causal:
        return attention_ref(q, k, v, scale, causal=True)[0]
    return flash_attn_fwd(q, k, v, scale)[0]
