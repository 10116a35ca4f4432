"""Scaled-dot-product attention: plain PyTorch versions + CUDA flash kernels.

Port of ``sid_lsg_tpu/ops/attention.py``.  Layout (B, H, S, D).

- ``attention_ref`` / ``flash_attn_bwd_ref``: the plain versions (einsum,
  f32 softmax; the backward recomputes P from the row logsumexp).
- ``flash_attn_fwd``: kernel K1 (``csrc/flash_attn_fwd.cu``).
- ``flash_attn_bwd``: kernel K4 (``csrc/flash_attn_bwd.cu``), the fused
  backward: one sweep, dQ summed by bulk reduce-adds in no fixed order.
- ``flash_attn_bwd_dq`` / ``flash_attn_bwd_dkv``: kernels K5 (query rows
  stationary, dQ in registers; ``csrc/flash_attn_bwd_twopass.cu``) and K6
  (K4's sweep without dQ, in ``csrc/flash_attn_bwd.cu``);
  ``flash_attn_bwd_twopass`` runs both in one call on one delta pre-pass,
  the two-pass backward, which has no atomics or reduce-adds and so gives
  the same gradients bit for bit on every run.

Autograd runs K4, or K5 + K6 when ``SIDLSG_FLASH_BWD=twopass``, read at
each backward as the JAX package reads it (``_BWD_MODE``).

Each wrapper launches its kernel on a CUDA tensor and runs its plain
version on a CPU tensor.  ``attention`` goes through the custom op
``sidlsg::flash_attn`` (out, lse), whose autograd formula is the backward
above: a dispatcher op, so a selective-checkpoint policy can keep its
outputs (``models/unet.py`` policy ``flash``).  Causal attention (the CLIP
text tower, S = 77) takes the plain version on every device, as the JAX
package does.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from . import registry
from ._build import check, dtype_code, library, use_kernel

NEG_INF = -1e30
MAX_HEAD_DIM = {torch.bfloat16: 160, torch.float32: 512}  # K1, K4, K5, K6
# K1, K4, K5 and K6 read rows by TMA (bf16) or 16-byte copies (f32): a row of
# the head dim they are given is a multiple of 16 bytes.
HEAD_DIM_MULTIPLE = {torch.bfloat16: 8, torch.float32: 4}

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


def kernel_head_dim(d: int, dtype: torch.dtype) -> int:
    """The head dim K1, K4, K5 and K6 are given for head dim ``d``: ``d`` rounded up
    to a row of 16 bytes (the wrapper pads q, k, v, out and dout with zero
    columns, which change neither scores nor the first ``d`` columns)."""
    m = HEAD_DIM_MULTIPLE[dtype]
    return -(-d // m) * m


def _kernel_operand(t: torch.Tensor, d: int) -> torch.Tensor:
    """``t`` contiguous, zero-padded to head dim ``d`` and 16-byte aligned,
    as the kernels' TMA and 16-byte copies read it."""
    if t.shape[-1] != d:
        t = torch.nn.functional.pad(t, (0, d - t.shape[-1]))
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    dk = kernel_head_dim(d, q.dtype)
    qc, kc, vc = (_kernel_operand(t, dk) for t in (q, k, v))
    out = torch.empty_like(qc)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = library().sidlsg_flash_attn_fwd(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b * h, sq, sk, dk, float(scale), code, stream)
    check(err, "flash_attn_fwd")
    registry.record("flash_attn_fwd", (tuple(q.shape), tuple(k.shape), str(q.dtype)))
    return (out if dk == d else out[..., :d]), lse


def _bwd_inputs(what, q, k, v, out, lse, dout):
    """The inputs of K4, K5 or K6, checked, contiguous and padded to the
    head dim the kernels take; returns them and that head dim."""
    _check_qkv(what, q, k, v, MAX_HEAD_DIM.get(q.dtype, 0))
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"{what}: out{tuple(out.shape)} dout{tuple(dout.shape)} "
                         f"lse{tuple(lse.shape)} for q{tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"{what}: out {out.dtype}, dout {dout.dtype}, lse {lse.dtype} "
                        f"for q {q.dtype}")
    d = kernel_head_dim(q.shape[3], q.dtype)
    q, k, v, out, dout = (_kernel_operand(t, d) for t in (q, k, v, out, dout))
    return q, k, v, out, lse.contiguous(), dout, d


def flash_attn_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                   lse: torch.Tensor, dout: torch.Tensor, scale: float) -> Grads:
    """(dq, dk, dv) of ``flash_attn_fwd``: kernel K4 on a CUDA tensor (bf16
    with D <= 160, f32 with D <= 512; raises otherwise), ``flash_attn_bwd_ref``
    on a CPU tensor."""
    if not use_kernel(q, k, v, out, lse, dout):
        return flash_attn_bwd_ref(q, k, v, out, lse, dout, scale)
    d_in = q.shape[3]
    q, k, v, out, lse, dout, d = _bwd_inputs("flash_attn_bwd", q, k, v, out, lse, dout)
    b, h, sq, _ = q.shape
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
    registry.record("flash_attn_bwd", ((b, h, sq, d_in), (b, h, sk, d_in), str(q.dtype)))
    if d != d_in:
        return dq[..., :d_in], dk[..., :d_in], dv[..., :d_in]
    return dq, dk, dv


def flash_attn_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                      lse: torch.Tensor, dout: torch.Tensor, scale: float) -> torch.Tensor:
    """dq by kernel K5 (query rows stationary, dQ in registers, no atomics;
    the head dim padded as for K4) on a CUDA tensor; the dq of
    ``flash_attn_bwd_ref`` on a CPU tensor."""
    if not use_kernel(q, k, v, out, lse, dout):
        return flash_attn_bwd_ref(q, k, v, out, lse, dout, scale)[0]
    d_in = q.shape[3]
    q, k, v, out, lse, dout, d = _bwd_inputs("flash_attn_bwd_dq", q, k, v, out, lse, dout)
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = library().sidlsg_flash_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b * h, sq, sk, d, float(scale), dtype_code(q),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attn_bwd_dq")
    registry.record("flash_attn_bwd_dq", ((b, h, sq, d_in), (b, h, sk, d_in), str(q.dtype)))
    return dq if d == d_in else dq[..., :d_in]


def flash_attn_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                       lse: torch.Tensor, dout: torch.Tensor,
                       scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) by kernel K6 (K4's sweep without dQ; the head dim padded as
    for K4) on a CUDA tensor; those of ``flash_attn_bwd_ref`` on a CPU
    tensor."""
    if not use_kernel(q, k, v, out, lse, dout):
        return flash_attn_bwd_ref(q, k, v, out, lse, dout, scale)[1:]
    d_in = q.shape[3]
    q, k, v, out, lse, dout, d = _bwd_inputs("flash_attn_bwd_dkv", q, k, v, out, lse, dout)
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = library().sidlsg_flash_attn_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, sq, sk, d, float(scale),
        dtype_code(q), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attn_bwd_dkv")
    registry.record("flash_attn_bwd_dkv", ((b, h, sq, d_in), (b, h, sk, d_in), str(q.dtype)))
    if d != d_in:
        return dk[..., :d_in], dv[..., :d_in]
    return dk, dv


def flash_attn_bwd_twopass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                           lse: torch.Tensor, dout: torch.Tensor, scale: float) -> Grads:
    """(dq, dk, dv) by K5 and K6 in one call, on one delta pre-pass: no
    atomics, so the result is deterministic; ``flash_attn_bwd_ref`` on a
    CPU tensor."""
    if not use_kernel(q, k, v, out, lse, dout):
        return flash_attn_bwd_ref(q, k, v, out, lse, dout, scale)
    d_in = q.shape[3]
    q, k, v, out, lse, dout, d = _bwd_inputs("flash_attn_bwd_twopass", q, k, v, out, lse, dout)
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = library().sidlsg_flash_attn_bwd_twopass(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, sq, sk, d,
        float(scale), dtype_code(q), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attn_bwd_twopass")
    key = ((b, h, sq, d_in), (b, h, sk, d_in), str(q.dtype))
    registry.record("flash_attn_bwd_dq", key)
    registry.record("flash_attn_bwd_dkv", key)
    if d != d_in:
        return dq[..., :d_in], dk[..., :d_in], dv[..., :d_in]
    return dq, dk, dv


# The op that autograd and selective checkpointing see: K1 forward (out,
# lse), K4 backward (K5 + K6 under SIDLSG_FLASH_BWD=twopass).  An explicit
# schema keeps its registration independent of annotation parsing.
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
    twopass = os.environ.get("SIDLSG_FLASH_BWD", "fused") == "twopass"
    bwd = flash_attn_bwd_twopass if twopass else flash_attn_bwd
    dq, dk, dv = bwd(q, k, v, out, lse, dout, ctx.scale)
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
