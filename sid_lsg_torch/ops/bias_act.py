"""Fused bias + activation (+gain, +clamp): plain PyTorch version + CUDA kernel.

Port of ``sid_lsg_tpu/ops/bias_act.py``: y = clamp(gain * act(x + b)) with
``b`` broadcast along ``dim``, for the nine activations of
``activation_funcs`` (same default alphas and gains).  ``bias_act_ref`` is
the plain version; ``bias_act_fwd`` launches kernel K7
(``csrc/bias_act.cu``) on a CUDA tensor and runs the plain version on a CPU
tensor.  ``bias_act`` is differentiable: its backward recomputes the plain
formula and takes its VJP, as the JAX package's custom VJP does.  The bias
is cast to x's dtype, as the JAX kernel path casts it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from . import registry
from ._build import check, dtype_code, library, use_kernel


@dataclasses.dataclass(frozen=True)
class _Act:
    func: Callable[[torch.Tensor, float], torch.Tensor]
    def_alpha: float
    def_gain: float


_SQRT2 = math.sqrt(2)
_SELU_SCALE, _SELU_ALPHA = 1.0507009873554805, 1.6732632423543772

# In the order of the kernel's table (csrc/bias_act.cu).
activation_funcs = {
    "linear": _Act(lambda x, a: x, 0.0, 1.0),
    "relu": _Act(lambda x, a: torch.where(x < 0, torch.zeros_like(x), x), 0.0, _SQRT2),
    "lrelu": _Act(lambda x, a: torch.where(x >= 0, x, x * a), 0.2, _SQRT2),
    "tanh": _Act(lambda x, a: torch.tanh(x), 0.0, 1.0),
    "sigmoid": _Act(lambda x, a: torch.sigmoid(x), 0.0, 1.0),
    "elu": _Act(lambda x, a: F.elu(x), 0.0, 1.0),
    "selu": _Act(lambda x, a: _SELU_SCALE * F.elu(x, _SELU_ALPHA), 0.0, 1.0),
    "softplus": _Act(lambda x, a: torch.logaddexp(x, torch.zeros_like(x)), 0.0, 1.0),
    "swish": _Act(lambda x, a: F.silu(x), 0.0, _SQRT2),
}
_ACT_CODES = {name: i for i, name in enumerate(activation_funcs)}


def _resolve(act: str, alpha: Optional[float], gain: Optional[float],
             clamp: Optional[float]) -> Tuple[_Act, float, float, float]:
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    clamp = float(clamp if clamp is not None else -1.0)
    return spec, alpha, gain, clamp


def _bias_view(x: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    if b.dim() != 1 or b.shape[0] != x.shape[dim]:
        raise ValueError(f"bias_act: bias {tuple(b.shape)} for x {tuple(x.shape)} along dim {dim}")
    return b.to(x.dtype).reshape([-1 if i == dim else 1 for i in range(x.dim())])


def bias_act_ref(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1,
                 act: str = "linear", alpha: Optional[float] = None, gain: Optional[float] = None,
                 clamp: Optional[float] = None) -> torch.Tensor:
    """The plain formula, in x's dtype (JAX ``_bias_act_ref``)."""
    spec, alpha, gain, clamp = _resolve(act, alpha, gain, clamp)
    dim = dim % x.dim()
    if b is not None:
        x = x + _bias_view(x, b, dim)
    x = spec.func(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp >= 0.0:
        x = torch.clamp(x, -clamp, clamp)
    return x


def bias_act_fwd(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1,
                 act: str = "linear", alpha: Optional[float] = None, gain: Optional[float] = None,
                 clamp: Optional[float] = None) -> torch.Tensor:
    """Kernel K7 on a CUDA tensor (f32 or bf16), ``bias_act_ref`` on a CPU tensor."""
    if not use_kernel(*((x,) if b is None else (x, b))):
        return bias_act_ref(x, b, dim, act, alpha, gain, clamp)
    _, alpha, gain, clamp = _resolve(act, alpha, gain, clamp)
    code = dtype_code(x)
    dim = dim % x.dim()
    xc = x.contiguous()
    bc = None if b is None else _bias_view(x, b, dim).reshape(-1).contiguous()
    y = torch.empty_like(xc)
    if xc.numel():
        c = x.shape[dim]
        inner = math.prod(x.shape[dim + 1:])
        err = library().sidlsg_bias_act(
            xc.data_ptr(), None if bc is None else bc.data_ptr(), y.data_ptr(), xc.numel(), c,
            inner, _ACT_CODES[act], alpha, gain, clamp, code,
            torch.cuda.current_stream(x.device).cuda_stream)
        check(err, "bias_act")
        registry.record("bias_act", (tuple(x.shape), str(x.dtype), dim, act, b is not None,
                                     alpha, gain, clamp))
    return y


class _BiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, dim, act, alpha, gain, clamp):
        ctx.save_for_backward(x, b)
        ctx.args = (dim, act, alpha, gain, clamp)
        return bias_act_fwd(x, b, dim, act, alpha, gain, clamp)

    @staticmethod
    def backward(ctx, dy):
        x, b = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            xi = x.detach().requires_grad_(need[0])
            bi = None if b is None else b.detach().requires_grad_(need[1])
            y = bias_act_ref(xi, bi, *ctx.args)
            wanted = [t for t in (xi, bi) if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, dy) if wanted else ())
        gx = next(grads) if need[0] else None
        gb = next(grads) if b is not None and need[1] else None
        return (gx, gb) + (None,) * 5


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1,
             act: str = "linear", alpha: Optional[float] = None, gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """y = clamp(gain * act(x + b)) with b broadcast along ``dim``;
    differentiable (backward: the VJP of ``bias_act_ref``)."""
    if act not in activation_funcs:
        raise ValueError(f"unknown activation {act!r}; expected one of {list(activation_funcs)}")
    return _BiasAct.apply(x, b, dim, act, alpha, gain, clamp)
