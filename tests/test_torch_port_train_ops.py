"""The port's training-path ops against the JAX package's, on the CPU.

- The flash-attention backward: ``flash_attn_bwd_ref`` (the plain version
  K4, K5 and K6 are held to on the card) and autograd through
  ``ops.attention`` (the custom op ``sidlsg::flash_attn``) against
  ``jax.grad`` through the Pallas kernels in interpret mode, in both of the
  JAX package's backward modes, with ragged tails; ``SIDLSG_FLASH_BWD``
  picks the port's backward as it picks the JAX one.
- GroupNorm(+SiLU) gradients against the VJP of ``_group_norm_ref``.
- ``sid_denoise``, ``snr`` and ``get_velocity`` against JAX.
- UNet remat: each of the six policies against JAX and against no remat,
  with K1's launches, is held in ``tests/test_torch_port_remat.py``.

Inputs come from numpy seeds.  Tolerances (f32): forward atol 2e-5 / rtol
1e-4; gradients atol 5e-5 / rtol 1e-3 (``tests/test_pallas_parity.py``).
"""

import functools
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from sid_lsg_tpu import ops as jops  # noqa: E402
from sid_lsg_tpu.diffusion import ddpm as jax_ddpm  # noqa: E402
from sid_lsg_tpu.diffusion.sampling import sid_denoise as jax_sid_denoise  # noqa: E402
from sid_lsg_tpu.ops.groupnorm import _group_norm_ref  # noqa: E402
from sid_lsg_torch import ops  # noqa: E402
from sid_lsg_torch.diffusion.ddpm import DDPMScheduler, SchedulerConfig, compute_snr  # noqa: E402
from sid_lsg_torch.diffusion.sampling import sid_denoise  # noqa: E402

torch.set_num_threads(2)
F32 = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=5e-5, rtol=1e-3)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("sk", [150, 77])
@pytest.mark.parametrize("mode", ["fused", "twopass"])
def test_attention_backward_matches_pallas(mode, sk, monkeypatch):
    monkeypatch.setenv("SIDLSG_FLASH_BWD", mode)
    rng = np.random.default_rng(sk)
    q, k, v = _normal(rng, 1, 2, 200, 40), _normal(rng, 1, 2, sk, 40), _normal(rng, 1, 2, sk, 40)

    def loss(q_, k_, v_):
        return jnp.sum(jnp.sin(jops.attention(q_, k_, v_, impl="pallas")))

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    # Autograd through the custom op (its backward is flash_attn_bwd_ref here).
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.attention(qt, kt, vt)
    got = torch.autograd.grad(torch.sin(out).sum(), (qt, kt, vt))
    # The plain version called directly, and the K4, K5 + K6, K5 and K6
    # wrappers, which run it for a CPU tensor.
    out_d, lse = ops.attention_ref(*map(torch.from_numpy, (q, k, v)))
    dout = torch.cos(out_d)
    args = (*map(torch.from_numpy, (q, k, v)), out_d, lse, dout, 40 ** -0.5)
    direct = [ops.flash_attn_bwd_ref(*args), ops.flash_attn_bwd(*args),
              ops.flash_attn_bwd_twopass(*args),
              (ops.flash_attn_bwd_dq(*args),) + ops.flash_attn_bwd_dkv(*args)]
    for grads in [got] + direct:
        for a, b, name in zip(grads, ref, "qkv"):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **GRAD,
                                       err_msg=f"d{name} ({mode}, {sk} keys)")


@pytest.mark.parametrize("mode", ["twopass", "fused", "unknown", None])
def test_attention_backward_follows_sidlsg_flash_bwd(mode, monkeypatch):
    """Autograd through ``ops.attention`` reads ``SIDLSG_FLASH_BWD`` at each
    backward, as JAX ``_BWD_MODE`` does: ``twopass`` calls
    ``flash_attn_bwd_twopass`` (K5 + K6 on the card), any other value or
    none calls ``flash_attn_bwd`` (K4); the gradients match the Pallas
    backward that JAX picks under the same variable, in interpret mode."""
    if mode is None:
        monkeypatch.delenv("SIDLSG_FLASH_BWD", raising=False)
    else:
        monkeypatch.setenv("SIDLSG_FLASH_BWD", mode)
    attn_mod = sys.modules["sid_lsg_torch.ops.attention"]
    calls = []
    for name in ("flash_attn_bwd", "flash_attn_bwd_twopass"):
        def spy(*args, _fn=getattr(attn_mod, name), _name=name):
            calls.append(_name)
            return _fn(*args)
        monkeypatch.setattr(attn_mod, name, spy)
    rng = np.random.default_rng(21)
    q, k, v = _normal(rng, 1, 2, 64, 40), _normal(rng, 1, 2, 77, 40), _normal(rng, 1, 2, 77, 40)

    def loss(q_, k_, v_):
        return jnp.sum(jnp.sin(jops.attention(q_, k_, v_, impl="pallas")))

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(torch.sin(ops.attention(qt, kt, vt)).sum(), (qt, kt, vt))
    assert calls == ["flash_attn_bwd_twopass" if mode == "twopass" else "flash_attn_bwd"]
    for a, b, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD, err_msg=f"d{name} ({mode})")


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_gradients_match_jax_vjp(silu):
    rng = np.random.default_rng(5)
    x = _normal(rng, 2, 6, 5, 64) * 2 + 0.5
    gamma, beta = _normal(rng, 64) + 1, _normal(rng, 64)
    dy = _normal(rng, 2, 6, 5, 64)
    y_ref, vjp = jax.vjp(functools.partial(_group_norm_ref, num_groups=16, eps=1e-5, silu=silu),
                         x, gamma, beta)
    ref = vjp(dy)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    gt, bt = torch.from_numpy(gamma).requires_grad_(), torch.from_numpy(beta).requires_grad_()
    y = ops.group_norm(xt, gt, bt, 16, 1e-5, silu)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_ref), **F32)
    got = torch.autograd.grad(y, (xt, gt, bt), torch.from_numpy(dy).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), np.asarray(ref[0]), **GRAD)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **GRAD)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), **GRAD)


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_snr_velocity_and_sid_denoise_match_jax(pred):
    jsched = jax_ddpm.DDPMScheduler(jax_ddpm.SchedulerConfig.sd(pred))
    sched = DDPMScheduler(SchedulerConfig.sd(pred), device="cpu")
    rng = np.random.default_rng(9)
    x, noise = _normal(rng, 3, 8, 8, 4), _normal(rng, 3, 8, 8, 4)
    emb, unc = _normal(rng, 3, 7, 16), _normal(rng, 3, 7, 16)
    t = np.array([20, 500, 979], dtype=np.int32)
    tol = dict(atol=1e-6, rtol=1e-5)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    np.testing.assert_allclose(sched.snr(torch.from_numpy(t)).numpy(), np.asarray(jsched.snr(t)), **tol)
    np.testing.assert_allclose(compute_snr(sched, torch.from_numpy(t)).numpy(),
                               np.asarray(jax_ddpm.compute_snr(jsched, t)), **tol)
    vel = sched.get_velocity(nchw(x), nchw(noise), torch.from_numpy(t)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(vel.numpy(), np.asarray(jsched.get_velocity(x, noise, t)), **tol)

    # A stand-in UNet, elementwise in the latents and per-sample in t and the
    # context, so both layouts compute the same function.
    def j_apply(xx, tt, cc):
        return jnp.tanh(xx) * (1 + tt[:, None, None, None] / 1000) + cc.mean((1, 2))[:, None, None, None]

    def t_apply(xx, tt, cc):
        return torch.tanh(xx) * (1 + tt[:, None, None, None] / 1000) + cc.mean((1, 2))[:, None, None, None]

    for scale in (1.0, 1.5):
        for x0 in (True, False):
            ref = jax_sid_denoise(j_apply, x, noise, emb, unc, t, jsched, guidance_scale=scale,
                                  predict_x0=x0)
            got = sid_denoise(t_apply, nchw(x), nchw(noise), torch.from_numpy(emb),
                              torch.from_numpy(unc), torch.from_numpy(t), sched,
                              guidance_scale=scale, predict_x0=x0)
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), **F32)
