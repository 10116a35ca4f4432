"""Scaled-dot-product attention: plain PyTorch versions + CUDA flash kernels.

Port of ``sid_lsg_tpu/ops/attention.py``.  Layout (B, H, S, D).

- ``attention_ref`` / ``flash_attn_bwd_ref``: the plain versions (einsum,
  f32 softmax; the backward recomputes P from the row logsumexp).
- ``flash_attn_fwd``: kernel K1 (``csrc/flash_attn_fwd.cu``).
- ``flash_attn_bwd``: kernel K4 (``csrc/flash_attn_bwd.cu``), the fused
  backward that autograd runs, as the JAX package's default does.
- ``flash_attn_bwd_dq`` / ``flash_attn_bwd_dkv``: kernels K5 and K6
  (``csrc/flash_attn_bwd_twopass.cu``); ``flash_attn_bwd_twopass`` runs
  both, the deterministic two-pass backward.  The JAX package selects it
  with ``SIDLSG_FLASH_BWD=twopass``; the port keeps it as a separate
  function that checks K4.

Each wrapper launches its kernel on a CUDA tensor and runs its plain
version on a CPU tensor.  ``attention`` goes through the custom op
``sidlsg::flash_attn`` (out, lse), whose autograd formula is the backward
above: a dispatcher op, so a selective-checkpoint policy can keep its
outputs (``models/unet.py`` policy ``flash``).  Causal attention (the CLIP
text tower, S = 77) takes the plain version on every device, as the JAX
package does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import registry
from ._build import check, dtype_code, library, use_kernel

NEG_INF = -1e30
MAX_HEAD_DIM = {torch.bfloat16: 160, torch.float32: 512}  # K1, K4, K5, K6

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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


def flash_attn_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                       lse: torch.Tensor, dout: torch.Tensor, scale: float) -> Grads:
    """(dq, dk, dv) of non-causal attention in f32, returned in q's dtype:
    P recomputed from the forward's row logsumexp, delta = rowsum(dO * O)
    (``sid_lsg_tpu/ops/attention.py:181,201-223``)."""
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, dout))
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale - lse.float()[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    delta = (gf * of).sum(-1)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_qkv(what: str, q, k, v, max_d: int) -> None:
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{what}: mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    dtype_code(q)
    if q.shape[3] > max_d:
        raise ValueError(f"{what}: head dim {q.shape[3]} exceeds {max_d} for {q.dtype}")


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
    _check_qkv("flash_attn_fwd", q, k, v, MAX_HEAD_DIM.get(q.dtype, 0))
    code = dtype_code(q)
    b, h, sq, d = q.shape
    sk = k.shape[2]
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


def _bwd_inputs(what, q, k, v, out, lse, dout):
    _check_qkv(what, q, k, v, MAX_HEAD_DIM.get(q.dtype, 0))
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"{what}: out{tuple(out.shape)} dout{tuple(dout.shape)} "
                         f"lse{tuple(lse.shape)} for q{tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"{what}: out {out.dtype}, dout {dout.dtype}, lse {lse.dtype} "
                        f"for q {q.dtype}")
    return tuple(t.contiguous() for t in (q, k, v, out, lse, dout))


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                   lse: torch.Tensor, dout: torch.Tensor, scale: float) -> Grads:
    """(dq, dk, dv) of ``flash_attn_fwd``: kernel K4 on a CUDA tensor (bf16
    with D <= 160, f32 with D <= 512; raises otherwise), ``flash_attn_bwd_ref``
    on a CPU tensor."""
    if not use_kernel(q, k, v, out, lse, dout):
        return flash_attn_bwd_ref(q, k, v, out, lse, dout, scale)
    q, k, v, out, lse, dout = _bwd_inputs("flash_attn_bwd", q, k, v, out, lse, dout)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq_acc = dq if q.dtype == torch.float32 else torch.empty(q.shape, dtype=torch.float32,
                                                             device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = library().sidlsg_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b * h, sq, sk, d, float(scale), dtype_code(q), stream)
    check(err, "flash_attn_bwd")
    registry.record("flash_attn_bwd", (tuple(q.shape), tuple(k.shape), str(q.dtype)))
    return dq, dk, dv


def flash_attn_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                      lse: torch.Tensor, dout: torch.Tensor, scale: float) -> torch.Tensor:
    """dq by kernel K5 (one block per q-tile, dQ in registers, no atomics)
    on a CUDA tensor; the dq of ``flash_attn_bwd_ref`` on a CPU tensor."""
    if not use_kernel(q, k, v, out, lse, dout):
        return flash_attn_bwd_ref(q, k, v, out, lse, dout, scale)[0]
    q, k, v, out, lse, dout = _bwd_inputs("flash_attn_bwd_dq", q, k, v, out, lse, dout)
    b, h, sq, d = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = library().sidlsg_flash_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b * h, sq, k.shape[2], d, float(scale), dtype_code(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attn_bwd_dq")
    registry.record("flash_attn_bwd_dq", (tuple(q.shape), tuple(k.shape), str(q.dtype)))
    return dq


def flash_attn_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                       lse: torch.Tensor, dout: torch.Tensor,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) by kernel K6 (K4's sweep without dQ) on a CUDA tensor; those
    of ``flash_attn_bwd_ref`` on a CPU tensor."""
    if not use_kernel(q, k, v, out, lse, dout):
        return flash_attn_bwd_ref(q, k, v, out, lse, dout, scale)[1:]
    q, k, v, out, lse, dout = _bwd_inputs("flash_attn_bwd_dkv", q, k, v, out, lse, dout)
    b, h, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = library().sidlsg_flash_attn_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, sq, k.shape[2], d, float(scale),
        dtype_code(q), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attn_bwd_dkv")
    registry.record("flash_attn_bwd_dkv", (tuple(q.shape), tuple(k.shape), str(q.dtype)))
    return dk, dv


def flash_attn_bwd_twopass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                           lse: torch.Tensor, dout: torch.Tensor, scale: float) -> Grads:
    """(dq, dk, dv) by K5 and K6: no atomics, so the result is
    deterministic; ``flash_attn_bwd_ref`` on a CPU tensor."""
    if not use_kernel(q, k, v, out, lse, dout):
        return flash_attn_bwd_ref(q, k, v, out, lse, dout, scale)
    dq = flash_attn_bwd_dq(q, k, v, out, lse, dout, scale)
    return (dq,) + flash_attn_bwd_dkv(q, k, v, out, lse, dout, scale)


# The op that autograd and selective checkpointing see: K1 forward (out,
# lse), K4 backward.  An explicit schema keeps its registration independent
# of annotation parsing.
@torch.library.custom_op("sidlsg::flash_attn", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, float scale) -> (Tensor, Tensor)")
def flash_attn(q, k, v, scale):
    return flash_attn_fwd(q, k, v, scale)


@flash_attn.register_fake
def _flash_attn_fake(q, k, v, scale):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


def _flash_attn_setup(ctx, inputs, output):
    q, k, v, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.scale = scale


def _flash_attn_backward(ctx, dout, dlse):
    del dlse  # lse feeds nothing downstream of the op
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attn_bwd(q, k, v, out, lse, dout, ctx.scale)
    return dq, dk, dv, None


flash_attn.register_autograd(_flash_attn_backward, setup_context=_flash_attn_setup)

FLASH_OP = torch.ops.sidlsg.flash_attn.default


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None, causal: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, H, S, D) tensors, differentiable."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if causal:
        return attention_ref(q, k, v, scale, causal=True)[0]
    return flash_attn(q, k, v, float(scale))[0]
