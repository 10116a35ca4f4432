"""The port's CUDA kernels (K1 flash attention forward, K2 GroupNorm stats,
K3 GroupNorm apply, K4 fused flash backward, K5 + K6 two-pass flash
backward (bit for bit the same on two runs), K7 bias + activation on both
of its routes, K8 one-launch GroupNorm(+SiLU)) against
their plain PyTorch versions, and UNet gradients through them against the
CPU's, on the card.

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


# The JAX package's own parity condition for the flash kernels
# (tests/test_pallas_parity.py:22-50): standard-normal f32 q, k, v with no
# scaling of v; forward within atol 2e-5 / rtol 1e-4 of the plain version,
# gradients of sum(sin(out)) within atol 5e-5 / rtol 1e-3.
@pytest.mark.parametrize("sq,sk,d", [(128, 128, 64), (200, 77, 40), (64, 256, 32)])
def test_flash_attn_fwd_f32_at_the_jax_parity_tolerance(dev, sq, sk, d):
    g = torch.Generator(dev).manual_seed(20)
    q, k, v = (torch.randn(2, 3, s_, d, generator=g, device=dev) for s_ in (sq, sk, sk))
    out, _ = ops.flash_attn_fwd(q, k, v)
    ref, _ = ops.attention_ref(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-4)


def test_flash_attn_bwd_f32_at_the_jax_parity_tolerance(dev):
    g = torch.Generator(dev).manual_seed(21)
    q = torch.randn(1, 2, 160, 32, generator=g, device=dev)
    k, v = (torch.randn(1, 2, 96, 32, generator=g, device=dev) for _ in range(2))
    out, lse = ops.attention_ref(q, k, v)
    dout = torch.cos(out)  # d sum(sin(out)) / d out
    got = ops.flash_attn_bwd(q, k, v, out, lse, dout, 32 ** -0.5)
    ref = ops.flash_attn_bwd_ref(q, k, v, out, lse, dout, 32 ** -0.5)
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", got, ref):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=1e-3, msg=f"d{name}")


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


def gn_input(dev, shape, dtype, seed, offset=0):
    """x (2 * normal + 0.5) in ``dtype``, gamma, beta; with ``offset``, x is a
    view ``offset`` elements into its storage (16-byte misaligned)."""
    g = torch.Generator(dev).manual_seed(seed)
    flat = (torch.randn(math.prod(shape) + offset, generator=g, device=dev) * 2 + 0.5).to(dtype)
    x = flat[offset:].view(shape)
    gamma = torch.randn(shape[1], generator=g, device=dev) + 1
    beta = torch.randn(shape[1], generator=g, device=dev)
    return x, gamma, beta


# K8 (one-launch GroupNorm(+SiLU)): UNet and VAE maps of the paths, spans
# that are no multiple of 8 (7x9, 9x5), every cluster size gn_plan uses (2
# for maps of up to 24 MB; 8 and 16 for 32 KB slices of larger ones), f32.
GN_FUSED_CASES = [
    (torch.bfloat16, (4, 320, 64, 64), 32, True),     # cluster 2
    (torch.bfloat16, (4, 320, 64, 64), 32, False),
    (torch.bfloat16, (8, 1280, 8, 8), 32, True),
    (torch.bfloat16, (4, 2560, 16, 16), 32, True),
    (torch.bfloat16, (4, 960, 64, 64), 32, True),     # cluster 8
    (torch.bfloat16, (4, 512, 128, 128), 32, True),   # cluster 16
    (torch.float32, (4, 512, 64, 64), 32, False),     # cluster 8
    (torch.float32, (2, 64, 7, 9), 8, True),
    (torch.bfloat16, (2, 64, 7, 9), 8, False),
    (torch.float32, (2, 40, 9, 5), 4, True),
    (torch.bfloat16, (3, 24, 9, 5), 8, True),
]


@pytest.mark.parametrize("dtype,shape,groups,silu", GN_FUSED_CASES)
@pytest.mark.parametrize("offset", [0, 1])
def test_gn_fused_matches_plain(dev, dtype, shape, groups, silu, offset):
    route, cluster = ops.gn_plan(shape, dtype, groups)
    assert route == "fused"
    x, gamma, beta = gn_input(dev, shape, dtype, seed=11, offset=offset)
    before = ops.registry.counts()["gn_fused"]
    y = ops.gn_fused(x, gamma, beta, groups, 1e-5, silu)
    torch.cuda.synchronize()
    assert ops.registry.counts()["gn_fused"] == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    assert_close(y, ops.group_norm_ref(x.float(), gamma, beta, groups, 1e-5, silu), dtype)


# K2 (one launch, a cluster per span): the VAE's 256x256 and 512x512 maps,
# every cluster size (1, 2, 4, 8, 16 at up to 64 KB a block), odd spans.
GN_STATS_CASES = [
    (torch.bfloat16, (4, 128, 512, 512), 32),   # 2 MB a span: cluster 16
    (torch.bfloat16, (4, 256, 256, 256), 32),   # 1 MB: cluster 16
    (torch.bfloat16, (2, 512, 128, 128), 32),   # 512 KB: cluster 8
    (torch.float32, (2, 320, 64, 64), 32),      # 160 KB: cluster 4
    (torch.bfloat16, (2, 320, 64, 64), 32),     # 80 KB: cluster 2
    (torch.float32, (2, 64, 7, 9), 8),          # cluster 1
    (torch.bfloat16, (3, 24, 9, 5), 8),
]


@pytest.mark.parametrize("dtype,shape,groups", GN_STATS_CASES)
@pytest.mark.parametrize("offset", [0, 1])
def test_gn_stats_matches_plain(dev, dtype, shape, groups, offset):
    x, _, _ = gn_input(dev, shape, dtype, seed=12, offset=offset)
    before = ops.registry.counts()["gn_stats"]
    mean, rstd = ops.gn_stats(x, groups, 1e-5)
    torch.cuda.synchronize()
    assert ops.registry.counts()["gn_stats"] == before + 1
    ref_mean, ref_rstd = ops.gn_stats_ref(x.float(), groups, 1e-5)
    assert_close(mean, ref_mean, torch.float32)
    assert_close(rstd, ref_rstd, torch.float32)


@pytest.mark.parametrize("shape", [(2, 64, 6, 6), (1, 32, 512, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_kernels_clamp_the_variance(dev, shape, dtype):
    """Groups of one constant near 100 (as the CPU test
    ``test_group_norm_clamps_negative_variance_like_jax_ref``): the one-pass
    variance cancels to rounding noise, which the clamp keeps from NaN.
    Output within atol 0.05 of the plain version, the CPU test's tolerance
    and reason; both routes (K8 at 6x6, K2 + K3 at 512x512), and K2 alone."""
    groups = 16
    g = torch.Generator(dev).manual_seed(13)
    consts = 100.0 + torch.rand(shape[0], groups, 1, generator=g, device=dev)
    x = consts.expand(shape[0], groups, math.prod(shape[1:]) // groups).reshape(shape).to(dtype)
    gamma = torch.randn(shape[1], generator=g, device=dev) + 1
    beta = torch.randn(shape[1], generator=g, device=dev)
    route = ops.gn_plan(shape, dtype, groups)[0]
    assert route == ("fused" if shape[2] == 6 else "tiled")
    y = ops.group_norm(x, gamma, beta, groups, 1e-5, False)
    mean, rstd = ops.gn_stats(x, groups, 1e-5)
    ref = ops.group_norm_ref(x.float(), gamma, beta, groups, 1e-5, False)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(mean).all() and torch.isfinite(rstd).all()
    torch.testing.assert_close(y.float(), ref, atol=0.05, rtol=0)


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


@pytest.mark.parametrize("fn", ["flash_attn_bwd", "flash_attn_bwd_twopass", "flash_attn_bwd_dkv"])
@pytest.mark.parametrize("dtype,b,h,sq,sk,d", BWD_SHAPES)
def test_flash_attn_bwd_matches_plain(dev, fn, dtype, b, h, sq, sk, d):
    args, ref = bwd_case(dev, dtype, b, h, sq, sk, d)
    names = {"flash_attn_bwd": ["flash_attn_bwd"], "flash_attn_bwd_dkv": ["flash_attn_bwd_dkv"],
             "flash_attn_bwd_twopass": ["flash_attn_bwd_dq", "flash_attn_bwd_dkv"]}[fn]
    if fn == "flash_attn_bwd_dkv":
        ref = ref[1:]
    before = {n: ops.registry.counts()[n] for n in names}
    got = getattr(ops, fn)(*args, d ** -0.5)
    torch.cuda.synchronize()
    assert all(ops.registry.counts()[n] == before[n] + 1 for n in names)
    for gx, rx in zip(got, ref):
        assert gx.dtype == dtype and gx.shape == rx.shape
        c = pow2_scale(rx)
        assert_close(gx.float() * c, rx * c, dtype)


# Every attention shape of the train step (SD1.5 UNet at microbatch 4: batch
# 4 and, CFG-doubled, 8; self-attention and 77-token cross-attention; head
# dims 40/80/160, 160 at 256 queries, where K6's two-stage Q/dO ring wraps,
# and at 64, one tile) and the SiDA step's f32 heads (the VAE's D = 512, the
# DINO ViT's D = 64).
STEP_SHAPES = [(torch.bfloat16, b, 8, s, sk, d)
               for b in (4, 8) for s, d in ((4096, 40), (1024, 80), (256, 160), (64, 160))
               for sk in (s, 77)] + [(torch.float32, 4, 1, 4096, 4096, 512),
                                     (torch.float32, 4, 6, 197, 197, 64)]


@pytest.mark.parametrize("dtype,b,h,sq,sk,d", STEP_SHAPES)
def test_flash_attn_bwd_twopass_is_deterministic_and_agrees_with_fused(dev, dtype, b, h, sq, sk, d):
    """K5 + K6 give the same bits on two runs (no atomics, no reduce-adds),
    match the plain backward, and agree with K4."""
    args, ref = bwd_case(dev, dtype, b, h, sq, sk, d, seed=11)
    a = ops.flash_attn_bwd_twopass(*args, d ** -0.5)
    b_ = ops.flash_attn_bwd_twopass(*args, d ** -0.5)
    fused = ops.flash_attn_bwd(*args, d ** -0.5)
    torch.cuda.synchronize()
    for x, y, z, r in zip(a, b_, fused, ref):
        assert torch.equal(x, y)
        c = pow2_scale(r)
        assert_close(x.float() * c, r * c, dtype)
        c = pow2_scale(x)
        assert_close(z.float() * c, x.float() * c, dtype)


@pytest.mark.parametrize("b,sq,d", [(8, 4096, 40), (8, 1024, 80)])
def test_flash_attn_bwd_dq_at_cross_attention_over_seeds(dev, b, sq, d):
    """dq at cross-attention (77 keys), where the bf16 rounding of a row's
    largest dS elements is not averaged out: K4 and K5 within the bf16
    tolerance at each of 12 draws (inputs as ``bwd_case`` makes them)."""
    for seed in range(12):
        args, ref = bwd_case(dev, torch.bfloat16, b, 8, sq, 77, d, seed=100 + seed)
        got = (ops.flash_attn_bwd(*args, d ** -0.5)[0], ops.flash_attn_bwd_dq(*args, d ** -0.5))
        torch.cuda.synchronize()
        c = pow2_scale(ref[0])
        for dq in got:
            assert_close(dq.float() * c, ref[0] * c, torch.bfloat16)


# The tile edges of K1 and K4: S_q and S_k that are not multiples of their
# tiles (bf16: 128 queries and 64 keys in K1, 128 keys and 64 queries in K4;
# f32: 32 / 32 in K1, 32 keys and 16 queries in K4), bh below and above the
# 132 SMs, and every head dim the presets reach (bf16 40/64/80/160; f32
# 64/300/512; 36 pads to 40 in the wrapper).
EDGE_SHAPES = [
    (torch.bfloat16, 1, 1, 77, 77, 40),
    (torch.bfloat16, 2, 100, 197, 300, 64),
    (torch.bfloat16, 1, 3, 4097, 77, 80),
    (torch.bfloat16, 1, 2, 300, 4097, 160),
    (torch.bfloat16, 3, 50, 64, 64, 160),
    (torch.bfloat16, 1, 4, 129, 65, 36),
    (torch.float32, 4, 6, 197, 197, 64),
    (torch.float32, 1, 140, 77, 33, 64),
    (torch.float32, 2, 1, 300, 4097, 300),
    (torch.float32, 1, 1, 4097, 1000, 512),
]


@pytest.mark.parametrize("dtype,b,h,sq,sk,d", EDGE_SHAPES)
def test_flash_attn_kernels_at_tile_edges(dev, dtype, b, h, sq, sk, d):
    args, ref = bwd_case(dev, dtype, b, h, sq, sk, d, seed=7)
    q, k, v = args[:3]
    out, lse = ops.flash_attn_fwd(q, k, v)
    ref_out, ref_lse = ops.attention_ref(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert_close(out, ref_out, dtype)
    assert_close(lse, ref_lse, torch.float32)
    got = ops.flash_attn_bwd(*args, d ** -0.5)
    torch.cuda.synchronize()
    for gx, rx in zip(got, ref):
        c = pow2_scale(rx)
        assert_close(gx.float() * c, rx * c, dtype)


# K4 against K5 + K6 (K5 shares no kernel code with it; K6 is its sweep
# without dQ) at the paths' shapes: UNet self- and cross-attention at batch
# 4, the VAE's and the DINO ViT's f32 heads.
@pytest.mark.parametrize("dtype,b,h,sq,sk,d", [
    (torch.bfloat16, 4, 8, 4096, 4096, 40),
    (torch.bfloat16, 4, 8, 4096, 77, 40),
    (torch.bfloat16, 4, 8, 1024, 1024, 80),
    (torch.bfloat16, 4, 8, 256, 256, 160),
    (torch.bfloat16, 4, 8, 64, 64, 160),
    (torch.float32, 4, 1, 4096, 4096, 512),
    (torch.float32, 4, 6, 197, 197, 64),
])
def test_flash_attn_bwd_agrees_with_twopass_at_path_shapes(dev, dtype, b, h, sq, sk, d):
    args, _ = bwd_case(dev, dtype, b, h, sq, sk, d, seed=9)
    fused = ops.flash_attn_bwd(*args, d ** -0.5)
    twopass = ops.flash_attn_bwd_twopass(*args, d ** -0.5)
    torch.cuda.synchronize()
    for x, y in zip(fused, twopass):
        c = pow2_scale(y)
        assert_close(x.float() * c, y.float() * c, dtype)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 520), (torch.bfloat16, 192)])
def test_flash_attn_bwd_rejects_what_it_does_not_take(dev, dtype, d):
    args, _ = bwd_case(dev, dtype, 1, 1, 16, 16, d)
    with pytest.raises(ValueError):
        ops.flash_attn_bwd(*args, 0.1)
    with pytest.raises(ValueError):
        ops.flash_attn_bwd_twopass(*args, 0.1)


@pytest.mark.parametrize("shape,dim", [((8, 64, 5, 7), 1), ((6, 64), 1), ((3, 10, 48), -1),
                                       ((2, 3, 129, 131), 1)])
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


# K7's two routes (the bias on the last axis: rows of C; on axis 1 of
# (outer, C, inner): one bias a row of inner) at row lengths one below, at
# and one above a multiple of its 16-byte vector (4 f32, 8 bf16), with x
# and b at a 16-byte boundary and one element past it.
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("route", ["rows", "per_row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_act_kernel_routes_at_vector_edges(dev, dtype, route, delta, offset):
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    n = 8 * vec + delta
    shape, dim = ((6, n), 1) if route == "rows" else ((3, 5, n), 1)
    g = torch.Generator(dev).manual_seed(17)
    numel = math.prod(shape)
    x = (torch.randn(numel + offset, generator=g, device=dev) * 3).to(dtype)[offset:].view(shape)
    b = torch.randn(shape[dim] + offset, generator=g, device=dev).to(dtype)[offset:]
    assert x.data_ptr() % 16 == offset * x.element_size()
    for act in ("linear", "lrelu", "swish"):
        before = ops.registry.counts()["bias_act"]
        y = ops.bias_act_fwd(x, b, dim, act, gain=1.3, clamp=5.0)
        torch.cuda.synchronize()
        assert ops.registry.counts()["bias_act"] == before + 1
        assert y.dtype == dtype and y.shape == x.shape and y.data_ptr() % 16 == x.data_ptr() % 16
        assert_close(y, ops.bias_act_ref(x.float(), b.float(), dim, act, gain=1.3, clamp=5.0), dtype)


def test_unet_gradients_on_the_card_match_the_cpu(dev):
    """Autograd through K1/K4 and K8, where gn_plan sends every map of the
    tiny UNet (backward: the plain formula's VJP):
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
            for name in ("flash_attn_fwd", "flash_attn_bwd", "gn_fused"):
                assert counts[name] > 0, counts
    names = ["x"] + list(params)
    for name, a, b in zip(names, grads["cuda"], grads["cpu"]):
        scale = max(float(b.abs().max()), 1e-8)
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4 * scale, msg=name)
