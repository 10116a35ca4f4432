"""The port's ops (``sid_lsg_torch.ops``) against the JAX package's kernels.

The plain PyTorch versions, which the CUDA kernels are held to on the card,
are compared here with the Pallas kernels they replace, run in interpret
mode on the CPU as ``tests/test_pallas_parity.py`` runs them, and with the
JAX plain references.  Inputs come from numpy seeds.  Tolerance in f32:
atol 2e-5 / rtol 1e-4 unless a test states another with its reason.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from sid_lsg_tpu import ops as jops  # noqa: E402
from sid_lsg_tpu.ops.attention import _attention_ref as jax_attention_ref  # noqa: E402
from sid_lsg_tpu.ops.attention import _flash_fwd  # noqa: E402
from sid_lsg_tpu.ops.groupnorm import (  # noqa: E402
    _gn_silu_pallas_fwd,
    _gn_tiled_pallas_fwd,
    _group_norm_ref,
)
from sid_lsg_torch import ops  # noqa: E402
from sid_lsg_torch.ops import _build  # noqa: E402

torch.set_num_threads(2)
F32 = dict(atol=2e-5, rtol=1e-4)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _nchw(x_nhwc):
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("b,h,sq,sk,d", [(2, 3, 128, 128, 64), (2, 3, 200, 77, 40), (1, 1, 64, 64, 512)])
def test_attention_ref_matches_pallas_flash(b, h, sq, sk, d):
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = _normal(rng, b, h, sq, d), _normal(rng, b, h, sk, d), _normal(rng, b, h, sk, d)
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        j_out = jops.attention(q, k, v, impl="pallas")
        f_out, f_lse = _flash_fwd(q, k, v, scale, 128, 128)
    out, lse = ops.attention_ref(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **F32)
    np.testing.assert_allclose(out.numpy(), np.asarray(f_out), **F32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(f_lse), **F32)
    # On CPU tensors the kernel wrapper and the dispatcher are the plain version.
    fo, fl = ops.flash_attn_fwd(*map(torch.from_numpy, (q, k, v)))
    torch.testing.assert_close(fo, out, atol=0, rtol=0)
    torch.testing.assert_close(fl, lse, atol=0, rtol=0)
    torch.testing.assert_close(ops.attention(*map(torch.from_numpy, (q, k, v))), out, atol=0, rtol=0)


def test_causal_attention_matches_jax_ref():
    rng = np.random.default_rng(77)
    q, k, v = (_normal(rng, 2, 2, 77, 16) for _ in range(3))
    ref = jax_attention_ref(q, k, v, 16 ** -0.5, True)
    out = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def _gn_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = _normal(rng, *shape) * 2 + 0.5
    c = shape[-1]
    return x, _normal(rng, c) + 1, _normal(rng, c)


def _port_gn(x, gamma, beta, groups, eps, silu):
    y = ops.group_norm(_nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta), groups, eps, silu)
    return _nhwc(y)


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_matches_pallas_single_block(silu):
    x, gamma, beta = _gn_inputs(1, (2, 8, 8, 128))
    with pltpu.force_tpu_interpret_mode():
        ref = _gn_silu_pallas_fwd(x, gamma, beta, 8, 1e-5, silu)
    np.testing.assert_allclose(_port_gn(x, gamma, beta, 8, 1e-5, silu), np.asarray(ref), **F32)


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_matches_pallas_tiled(silu):
    # 9*5 = 45 rows in blocks of 16: three tiles, the last one padded.
    x, gamma, beta = _gn_inputs(2, (2, 9, 5, 128))
    with pltpu.force_tpu_interpret_mode():
        ref = _gn_tiled_pallas_fwd(x, gamma, beta, 16, 1e-6, silu, block=16)
    np.testing.assert_allclose(_port_gn(x, gamma, beta, 16, 1e-6, silu), np.asarray(ref), **F32)


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_matches_jax_ref_sd_channels(silu):
    x, gamma, beta = _gn_inputs(3, (2, 8, 8, 320))
    ref = _group_norm_ref(x, gamma, beta, 32, 1e-5, silu)
    np.testing.assert_allclose(_port_gn(x, gamma, beta, 32, 1e-5, silu), np.asarray(ref), **F32)


@pytest.mark.parametrize("silu", [False, True])
def test_gn_fused_matches_pallas_single_block(silu):
    """K8's wrapper on a CPU tensor (its plain version) against the Pallas
    kernel K8 replaces, at an SD channel count."""
    x, gamma, beta = _gn_inputs(4, (2, 8, 8, 256))
    with pltpu.force_tpu_interpret_mode():
        ref = _gn_silu_pallas_fwd(x, gamma, beta, 32, 1e-5, silu)
    y = ops.gn_fused(_nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta), 32, 1e-5, silu)
    np.testing.assert_allclose(_nhwc(y), np.asarray(ref), **F32)


def _sd15_group_norms():
    """{(shape, dtype, groups, silu): calls} of every GroupNorm of the SD1.5
    serving batch (UNet at batch 4, VAE decode at batch 4) and train step
    (UNet at batch 4 and, CFG-doubled, 8), bf16 compute, from forwards on
    the meta device: no weights, GroupNorm and attention stubbed."""
    from collections import Counter

    from sid_lsg_torch.models import SD15
    from sid_lsg_torch.models.layers import to_compute_dtype
    from sid_lsg_torch.models.unet import UNet2DCondition
    from sid_lsg_torch.models.vae import AutoencoderKL

    seen = {"serving": Counter(), "train": Counter()}
    record = [None]

    def group_norm(x, gamma, beta, num_groups=32, eps=1e-5, silu=False):
        record[0][(tuple(x.shape), x.dtype, num_groups, silu)] += 1
        return x

    def attention(q, k, v, causal=False):
        return q.new_empty(q.shape[:-1] + v.shape[-1:])

    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "group_norm", group_norm)
    mp.setattr(ops, "attention", attention)
    try:
        with torch.device("meta"):
            unet = to_compute_dtype(UNet2DCondition(SD15.unet), torch.bfloat16)
            vae = to_compute_dtype(AutoencoderKL(SD15.vae), torch.bfloat16)
            run = lambda b: unet(torch.empty(b, 4, 64, 64), torch.zeros(b, dtype=torch.long),
                                 torch.empty(b, 77, SD15.unet.cross_attention_dim))
            record[0] = seen["serving"]
            run(4)
            vae.decode(torch.empty(4, 4, 64, 64))
            record[0] = seen["train"]
            run(4)
            run(8)
    finally:
        mp.undo()
    return seen


def test_gn_plan_routes_every_sd15_group_norm():
    """Every map the JAX single-block kernel takes (HW * C * 4 <= 6 MiB) goes
    to K8; the VAE's 256x256 and 512x512 maps go to K2 + K3; K8's slices
    cover the span and each fits the shared memory it asks for."""
    from sid_lsg_torch.ops import groupnorm

    seen = _sd15_group_norms()
    assert sum(seen["serving"].values()) == 91  # 61 in the UNet, 30 in the VAE decoder
    routes = {}
    for key in set(seen["serving"]) | set(seen["train"]):
        shape, dtype, groups, _ = key
        route, cluster = ops.gn_plan(shape, dtype, groups)
        routes[key] = route
        assert cluster in (1, 2, 4, 8, 16), key
        if np.prod(shape[1:]) * 4 <= 6 * 2**20:
            assert route == "fused", key
        if shape[2] >= 256:
            assert route == "tiled", key
        if route == "fused":
            span = shape[1] // groups * np.prod(shape[2:])
            smem = groupnorm.fused_smem_bytes(shape, dtype, groups, cluster)
            assert smem <= groupnorm._SMEM_PER_BLOCK, key
            assert cluster * (smem - 8) >= span * dtype.itemsize, key
    # A span K8's blocks could not hold in their shared memory goes to K2 + K3.
    assert ops.gn_plan((1, 49152, 1, 1), torch.float32, 1)[0] == "tiled"
    fused = sum(n for k, n in seen["serving"].items() if routes[k] == "fused")
    assert fused >= 57  # the serving batch's single-block maps, at least
    assert all(routes[k] == "fused" for k in seen["train"])
    # Every batch size and both dtypes: K8's slices fit the shared memory.
    for shape, _, groups, _ in routes:
        for b in range(1, 17):
            for dtype in (torch.bfloat16, torch.float32):
                route, cluster = ops.gn_plan((b,) + shape[1:], dtype, groups)
                if route == "fused":
                    smem = groupnorm.fused_smem_bytes((b,) + shape[1:], dtype, groups, cluster)
                    assert smem <= groupnorm._SMEM_PER_BLOCK, (b, shape, dtype)


def test_group_norm_clamps_negative_variance_like_jax_ref():
    """Groups of one constant value near 100: the one-pass f32 variance
    E[x^2] - E[x]^2 cancels to rounding noise, negative in some groups, where
    rsqrt(var + eps) without the clamp at 0 gives NaN.  Tolerance atol 0.05:
    with var clamped to 0, |x * scale_c| reaches 100 * |gamma| / sqrt(1e-5),
    about 1e5, where one f32 step is 0.008, so the two implementations'
    outputs agree only to a few such steps."""
    rng = np.random.default_rng(0)
    g, c = 16, 64
    consts = (100.0 + rng.uniform(0, 1, size=(2, 1, 1, g))).astype(np.float32)
    x = np.repeat(np.broadcast_to(consts, (2, 6, 6, g)), c // g, axis=3).astype(np.float32)
    gamma = _normal(rng, c) + 1
    beta = _normal(rng, c)
    xt = _nchw(x)
    xf = xt.reshape(2, c, -1)
    g_sum = xf.sum(2).reshape(2, g, -1).sum(2)
    g_sq = xf.square().sum(2).reshape(2, g, -1).sum(2)
    n = float(xf.shape[2] * (c // g))
    unclamped = g_sq / n - (g_sum / n).square()
    assert (unclamped < -1e-5).any(), "input does not drive the one-pass variance negative"
    out = _port_gn(x, gamma, beta, g, 1e-5, False)
    assert np.isfinite(out).all()
    ref = np.asarray(_group_norm_ref(x, gamma, beta, g, 1e-5, False))
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out, ref, atol=0.05, rtol=0)


def test_entry_points_raise_without_a_card():
    """The default device is the card; where torch finds none, entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sid_lsg_torch.diffusion.ddpm import DDPMScheduler
    from sid_lsg_torch.pipeline import SDPipeline

    with pytest.raises(RuntimeError, match="no CUDA device"):
        SDPipeline.random_init("tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DDPMScheduler()


def test_kernel_wrappers_have_no_fallback_for_other_devices():
    q = torch.empty(1, 1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="device type"):
        ops.flash_attn_fwd(q, q, q)
    x = torch.empty(1, 8, 4, 4, device="meta")
    with pytest.raises(ValueError, match="device type"):
        ops.gn_stats(x, 4, 1e-5)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert _build.source_key() == _build.source_key()
    assert {p.name for p in _build.sources()} >= {"flash_attn_fwd.cu", "gn_stats.cu", "gn_apply.cu"}


@pytest.mark.parametrize("d,dtype,want", [(36, torch.bfloat16, 40), (40, torch.bfloat16, 40),
                                          (160, torch.bfloat16, 160), (300, torch.float32, 300),
                                          (301, torch.float32, 304), (13, torch.float32, 16)])
def test_kernel_head_dim_padding_keeps_attention(d, dtype, want):
    """K1 and K4 take head dims whose rows are 16 bytes; the wrapper pads
    with zero columns, which leave out's first d columns, lse and the
    gradients' first d columns as they were."""
    from sid_lsg_torch.ops.attention import _kernel_operand, kernel_head_dim

    assert kernel_head_dim(d, dtype) == want
    rng = np.random.default_rng(d)
    q, k, v, g = (torch.from_numpy(_normal(rng, 1, 2, n, d)) for n in (5, 7, 7, 5))
    out, lse = ops.attention_ref(q, k, v, d ** -0.5)
    qp, kp, vp, gp = (_kernel_operand(t, want) for t in (q, k, v, g))
    assert qp.shape[-1] == want and qp.data_ptr() % 16 == 0
    out_p, lse_p = ops.attention_ref(qp, kp, vp, d ** -0.5)
    torch.testing.assert_close(out_p[..., :d], out, **F32)
    torch.testing.assert_close(out_p[..., d:], torch.zeros_like(out_p[..., d:]), atol=0, rtol=0)
    torch.testing.assert_close(lse_p, lse, **F32)
    grads = ops.flash_attn_bwd_ref(q, k, v, out, lse, g, d ** -0.5)
    grads_p = ops.flash_attn_bwd_ref(qp, kp, vp, out_p, lse_p, gp, d ** -0.5)
    for a, b in zip(grads_p, grads):
        torch.testing.assert_close(a[..., :d], b, **F32)
