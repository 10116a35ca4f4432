"""The port's CUDA kernels (K1 flash attention forward, K2 GroupNorm stats,
K3 GroupNorm apply, K4 fused flash backward, K5 + K6 two-pass flash
backward, K7 bias + activation) against their plain PyTorch versions, and
UNet gradients through them against the CPU's, on the card.

Needs a CUDA device, ``nvcc`` and no JAX; skips where torch finds no card.
On the card's machine run it without the JAX-importing conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py

Tolerances: f32 outputs within atol 1e-4 / rtol 1e-3 of the f32 plain
version; bf16 outputs within atol 2e-2 / rtol 2e-2 of the plain version
computed in f32 from the same bf16 inputs (bf16 keeps 8 bits of mantissa, so
rounding the output alone moves it by up to 2**-8 relative), and every
output within 1e-2 of its plain version in relative L2 norm.  Attention's v
is scaled by sqrt(S_k / e) so that its outputs are of order 1: with
unit-normal q, k, v a typical |out| is sqrt(e / S_k), as small as the bf16
atol at S_k = 4096.  The backward's outputs are linear in dO, and dq, dk and
dv differ in size by orders of magnitude, so each is compared after scaling
by the power of two that brings its plain version to RMS of about 1: the
same as scaling dO by that power, which bf16 represents exactly.  UNet
gradients on the tiny preset in f32: rtol 1e-3 with atol 1e-4 * max|ref|
per tensor (``tests/test_composed_step_gate.py``).  TF32 is off.
"""

import math

import pytest
import torch

from sid_lsg_torch import ops
from sid_lsg_torch.models import TINY
from sid_lsg_torch.models.unet import unet_apply_fn
from sid_lsg_torch.pipeline import random_state_dicts

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-3), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
REL_L2 = 1e-2


def assert_close(got, ref, dtype):
    torch.testing.assert_close(got.float(), ref, **TOL[dtype])
    rel_l2 = ((got.float() - ref).norm() / ref.norm()).item()
    assert rel_l2 <= REL_L2, f"relative L2 error {rel_l2:.3e} above {REL_L2}"


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,b,h,sq,sk,d", [
    (torch.bfloat16, 1, 8, 4096, 4096, 40),
    (torch.bfloat16, 1, 8, 1024, 1024, 40),
    (torch.bfloat16, 2, 8, 256, 77, 80),
    (torch.bfloat16, 1, 8, 64, 64, 160),
    (torch.bfloat16, 2, 5, 300, 300, 64),
    (torch.bfloat16, 1, 2, 100, 77, 36),
    (torch.float32, 1, 1, 1024, 1024, 512),
    (torch.float32, 2, 3, 200, 77, 40),
])
def test_flash_attn_fwd_matches_plain(dev, dtype, b, h, sq, sk, d):
    g = torch.Generator(dev).manual_seed(0)
    q = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, h, sk, d, generator=g, device=dev).to(dtype)
    v = (torch.randn(b, h, sk, d, generator=g, device=dev) * math.sqrt(sk / math.e)).to(dtype)
    before = ops.registry.counts()["flash_attn_fwd"]
    out, lse = ops.flash_attn_fwd(q, k, v)
    torch.cuda.synchronize()
    assert ops.registry.counts()["flash_attn_fwd"] == before + 1
    ref, ref_lse = ops.attention_ref(q.float(), k.float(), v.float())
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert_close(out, ref, dtype)
    assert_close(lse, ref_lse, torch.float32)


def test_flash_attn_fwd_rejects_what_it_does_not_take(dev):
    q = torch.randn(1, 1, 16, 192, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ops.flash_attn_fwd(q, q, q)
    q16 = torch.randn(1, 1, 16, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.flash_attn_fwd(q16, q16, q16)


@pytest.mark.parametrize("dtype,shape,groups,silu", [
    (torch.bfloat16, (2, 320, 32, 32), 32, True),
    (torch.bfloat16, (2, 960, 16, 16), 32, False),
    (torch.float32, (1, 128, 256, 256), 32, True),
    (torch.float32, (2, 64, 7, 9), 8, True),
    (torch.bfloat16, (2, 64, 7, 9), 8, False),
])
def test_group_norm_kernels_match_plain(dev, dtype, shape, groups, silu):
    g = torch.Generator(dev).manual_seed(1)
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    gamma = torch.randn(shape[1], generator=g, device=dev) + 1
    beta = torch.randn(shape[1], generator=g, device=dev)
    mean, rstd = ops.gn_stats(x, groups, 1e-5)
    ref_mean, ref_rstd = ops.gn_stats_ref(x.float(), groups, 1e-5)
    assert_close(mean, ref_mean, torch.float32)
    assert_close(rstd, ref_rstd, torch.float32)
    y = ops.gn_apply(x, ref_mean, ref_rstd, gamma, beta, silu)
    ref = ops.gn_apply_ref(x.float(), ref_mean, ref_rstd, gamma, beta, silu)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape
    assert_close(y, ref, dtype)


def pow2_scale(ref):
    """The power of two that brings ``ref`` to RMS of about 1."""
    rms = ref.float().square().mean().sqrt().item()
    return 2.0 ** round(-math.log2(max(rms, 1e-30)))


def bwd_case(dev, dtype, b, h, sq, sk, d, seed=2):
    g = torch.Generator(dev).manual_seed(seed)
    q = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, h, sk, d, generator=g, device=dev).to(dtype)
    v = (torch.randn(b, h, sk, d, generator=g, device=dev) * math.sqrt(sk / math.e)).to(dtype)
    dout = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
    out, lse = ops.attention_ref(q.float(), k.float(), v.float())
    out = out.to(dtype)
    ref = ops.flash_attn_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse, dout.float(),
                                 d ** -0.5)
    return (q, k, v, out, lse, dout), ref


BWD_SHAPES = [
    (torch.bfloat16, 1, 8, 1024, 1024, 40),
    (torch.bfloat16, 2, 8, 256, 77, 80),
    (torch.bfloat16, 1, 8, 256, 256, 160),
    (torch.bfloat16, 2, 8, 64, 77, 160),
    (torch.bfloat16, 1, 2, 100, 77, 36),
    (torch.bfloat16, 2, 5, 300, 300, 64),
    (torch.float32, 2, 2, 64, 64, 16),
    (torch.float32, 2, 3, 200, 77, 40),
    (torch.float32, 1, 2, 50, 90, 160),
    (torch.float32, 2, 6, 197, 150, 64),
    (torch.float32, 1, 1, 1024, 777, 512),
    (torch.float32, 2, 1, 100, 64, 300),
]


@pytest.mark.parametrize("fn", ["flash_attn_bwd", "flash_attn_bwd_twopass"])
@pytest.mark.parametrize("dtype,b,h,sq,sk,d", BWD_SHAPES)
def test_flash_attn_bwd_matches_plain(dev, fn, dtype, b, h, sq, sk, d):
    args, ref = bwd_case(dev, dtype, b, h, sq, sk, d)
    names = ["flash_attn_bwd"] if fn == "flash_attn_bwd" else ["flash_attn_bwd_dq", "flash_attn_bwd_dkv"]
    before = {n: ops.registry.counts()[n] for n in names}
    got = getattr(ops, fn)(*args, d ** -0.5)
    torch.cuda.synchronize()
    assert all(ops.registry.counts()[n] == before[n] + 1 for n in names)
    for gx, rx in zip(got, ref):
        assert gx.dtype == dtype and gx.shape == rx.shape
        c = pow2_scale(rx)
        assert_close(gx.float() * c, rx * c, dtype)


def test_flash_attn_bwd_twopass_is_deterministic_and_agrees_with_fused(dev):
    args, _ = bwd_case(dev, torch.bfloat16, 2, 8, 1024, 1024, 40)
    a = ops.flash_attn_bwd_twopass(*args, 40 ** -0.5)
    b = ops.flash_attn_bwd_twopass(*args, 40 ** -0.5)
    fused = ops.flash_attn_bwd(*args, 40 ** -0.5)
    for x, y, z in zip(a, b, fused):
        assert torch.equal(x, y)
        c = pow2_scale(x)
        assert_close(z.float() * c, x.float() * c, torch.bfloat16)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 520), (torch.bfloat16, 192)])
def test_flash_attn_bwd_rejects_what_it_does_not_take(dev, dtype, d):
    args, _ = bwd_case(dev, dtype, 1, 1, 16, 16, d)
    with pytest.raises(ValueError):
        ops.flash_attn_bwd(*args, 0.1)
    with pytest.raises(ValueError):
        ops.flash_attn_bwd_twopass(*args, 0.1)


@pytest.mark.parametrize("shape,dim", [((8, 64, 5, 7), 1), ((6, 64), 1), ((3, 10, 48), -1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", list(ops.activation_funcs))
def test_bias_act_kernel_matches_plain(dev, act, dtype, shape, dim):
    g = torch.Generator(dev).manual_seed(5)
    x = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)
    b = torch.randn(shape[dim], generator=g, device=dev).to(dtype)
    for kw in ({}, dict(gain=1.3, clamp=5.0), dict(alpha=0.1)):
        before = ops.registry.counts()["bias_act"]
        y = ops.bias_act_fwd(x, b, dim, act, **kw)
        torch.cuda.synchronize()
        assert ops.registry.counts()["bias_act"] == before + 1
        assert y.dtype == dtype and y.shape == x.shape
        assert_close(y, ops.bias_act_ref(x.float(), b.float(), dim, act, **kw), dtype)
    y = ops.bias_act_fwd(x, None, dim, act)
    assert_close(y, ops.bias_act_ref(x.float(), None, dim, act), dtype)


def test_unet_gradients_on_the_card_match_the_cpu(dev):
    """Autograd through K1/K4 and K2+K3 (backward: the plain formula's VJP):
    every parameter's and the input's gradient of a scalar loss of the tiny
    UNet, f32, card against CPU."""
    params = random_state_dicts(TINY, "cpu", seed=3)["unet"]
    rng = torch.Generator().manual_seed(4)
    x = torch.randn(2, 4, 8, 8, generator=rng)
    t = torch.tensor([37, 625])
    ctx = torch.randn(2, 77, TINY.unet.cross_attention_dim, generator=rng)
    weight = torch.randn(2, 4, 8, 8, generator=rng)
    grads = {}
    for device in ("cpu", "cuda"):
        p = {k: v.to(device).requires_grad_() for k, v in params.items()}
        xi = x.to(device).requires_grad_()
        apply = unet_apply_fn(TINY.unet, torch.float32)
        ops.registry.reset()
        loss = (apply(p, xi, t.to(device), ctx.to(device)) * weight.to(device)).sum()
        g = torch.autograd.grad(loss, [xi] + list(p.values()))
        grads[device] = [y.cpu() for y in g]
        if device == "cuda":
            counts = ops.registry.counts()
            for name in ("flash_attn_fwd", "flash_attn_bwd", "gn_stats", "gn_apply"):
                assert counts[name] > 0, counts
    names = ["x"] + list(params)
    for name, a, b in zip(names, grads["cuda"], grads["cpu"]):
        scale = max(float(b.abs().max()), 1e-8)
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4 * scale, msg=name)
