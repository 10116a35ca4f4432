"""The port's CUDA kernels (K1 flash attention forward, K2 GroupNorm stats,
K3 GroupNorm apply) against their plain PyTorch versions, on the card.

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
atol at S_k = 4096.  TF32 is off.
"""

import math

import pytest
import torch

from sid_lsg_torch import ops

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
