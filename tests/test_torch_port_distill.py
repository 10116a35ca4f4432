"""The port's distillation step against the JAX package's, on the CPU.

Both sides load the committed tiny HF fixture (the port by its diffusers
keys, JAX through ``convert_unet``), with the fake score and the generator
perturbed in HF key space as ``tests/test_composed_step_gate.py`` does, and
consume the same numpy z, noise, t and embeddings (NCHW for the port, NHWC
for JAX).  JAX gradients are carried to HF keys with ``export_unet``
(gradients transform like parameters), which are the port's keys, so every
parameter is compared.

Checked: ``psi_loss`` and ``g_loss`` losses and every gradient against JAX
``make_loss_fns`` for kappa in {1, 1.5} x {epsilon, v_prediction}; the
LoRA psi; NaN-row exclusion; ``make_optimizer`` (adam, adamw, low-mem,
clip) against optax; and one whole port ``train_step`` (2 accumulation
rounds, context dropout, EMA ramp) against the step recomposed from JAX
pieces on the port's own draws.

Tolerances (f32): losses rtol 1e-4; gradients rtol 1e-3 with atol
1e-4 * max|ref| per tensor (whole-UNet gradients).
"""

import os
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from sid_lsg_tpu.diffusion import ddpm as jddpm  # noqa: E402
from sid_lsg_tpu.models import UNet2DCondition as JaxUNet  # noqa: E402
from sid_lsg_tpu.models.configs import TINY as JTINY  # noqa: E402
from sid_lsg_tpu.models.convert import convert_unet, export_unet, load_safetensors  # noqa: E402
from sid_lsg_tpu.training import distill as jdistill  # noqa: E402
from sid_lsg_tpu.training import lora as jlora  # noqa: E402
from sid_lsg_tpu.training import state as jstate  # noqa: E402
from sid_lsg_torch.diffusion.ddpm import DDPMScheduler, SchedulerConfig  # noqa: E402
from sid_lsg_torch.models import TINY  # noqa: E402
from sid_lsg_torch.models.unet import unet_apply_fn  # noqa: E402
from sid_lsg_torch.training.distill import (  # noqa: E402
    DistillConfig,
    draw_round,
    ema_beta,
    make_loss_fns,
    make_train_step,
)
from sid_lsg_torch.training.lora import apply_lora, init_lora, lora_param_count, lora_sites  # noqa: E402
from sid_lsg_torch.training.state import init_state, make_optimizer  # noqa: E402

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_hf_ckpt")
B = 2  # microbatch: kappa != 1 doubles it to 4, so two UNet batch sizes in all
LOSS_RTOL = 1e-4


def _perturb(sd, seed, scale=0.05):
    rs = np.random.RandomState(seed)
    return {k: v + scale * (np.std(v) + 1e-3) * rs.standard_normal(v.shape).astype(np.float32)
            for k, v in sorted(sd.items())}


@pytest.fixture(scope="module")
def s():
    sd = {k: np.asarray(v, np.float32)
          for k, v in load_safetensors(os.path.join(FIXTURE, "unet",
                                                    "diffusion_pytorch_model.safetensors")).items()}
    hf = {"teacher": sd, "fake": _perturb(sd, 1), "g": _perturb(sd, 2)}
    rs = np.random.RandomState(7)
    z = rs.standard_normal((B, 4, 8, 8)).astype(np.float32)
    noise = rs.standard_normal((B, 4, 8, 8)).astype(np.float32)
    emb = (rs.standard_normal((B, 77, 32)) * 0.5).astype(np.float32)
    uncond = np.broadcast_to((rs.standard_normal((77, 32)) * 0.5).astype(np.float32), (B, 77, 32))
    t = rs.randint(20, 980, (B,))
    unet = JaxUNet(JTINY.unet)
    return types.SimpleNamespace(
        hf=hf, jax={k: convert_unet(v, JTINY.unet) for k, v in hf.items()},
        # One jitted UNet apply for the module: its forward and backward
        # compile once per batch size instead of op by op in every test.
        j_apply=jax.jit(lambda p, x, tt, c: unet.apply({"params": p}, x, tt, c)),
        z=z, noise=noise, emb=emb, uncond=np.ascontiguousarray(uncond), t=t,
    )


def _port_params(s, name, grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad) for k, v in s.hf[name].items()}


def _nhwc(x):
    return jnp.asarray(np.transpose(np.asarray(x), (0, 2, 3, 1)))


def _cfgs(kappa, pred, **kw):
    common = dict(latent_size=8, init_timestep=625, cfg_train_fake=kappa, cfg_eval_fake=kappa,
                  cfg_eval_real=kappa, **kw)
    return (DistillConfig(**common), DDPMScheduler(SchedulerConfig.sd(pred), device="cpu"),
            jdistill.DistillConfig(**common), jddpm.DDPMScheduler(jddpm.SchedulerConfig.sd(pred)))


def _assert_grads(port_grads, jax_hf, what):
    assert set(port_grads) == set(jax_hf)
    for k in sorted(jax_hf):
        ref = np.asarray(jax_hf[k], np.float32)
        scale = max(float(np.abs(ref).max()), 1e-8)
        np.testing.assert_allclose(port_grads[k].detach().numpy(), ref, rtol=1e-3, atol=1e-4 * scale,
                                   err_msg=f"{what}: gradient of {k}")


def _psi_both(s, kappa, pred, noise=None, lora=None):
    """psi loss and gradients on both sides; ``lora`` = (port factors, JAX factors)."""
    noise = s.noise if noise is None else noise
    cfg, sched, jcfg, jsched = _cfgs(kappa, pred)
    ft = (lambda pf, teacher: apply_lora(teacher, pf)) if lora else None
    L = make_loss_fns(unet_apply_fn(TINY.unet, torch.float32), sched, cfg, fake_transform=ft)
    fake = lora[0] if lora else _port_params(s, "fake", grad=True)
    args = [torch.from_numpy(x) for x in (s.z, noise, s.emb, s.uncond, s.t)]
    z, noise_t, emb, unc, t = args
    init_t = torch.full((B,), 625)
    with torch.no_grad():
        images = L.generate(_port_params(s, "g"), z, emb, init_t)
    loss, aux = L.psi_loss(fake, _port_params(s, "teacher"), images, noise_t, emb, unc, t, float(B))
    grads = dict(zip(fake, torch.autograd.grad(loss, list(fake.values()))))

    jft = (lambda pf, teacher: jlora.apply_lora(teacher, pf)) if lora else None
    JL = jdistill.make_loss_fns(s.j_apply, jsched, jcfg, fake_transform=jft)
    key = jax.random.PRNGKey(0)
    jimages = jax.lax.stop_gradient(JL.generate(s.jax["g"], _nhwc(s.z), jnp.asarray(s.emb),
                                                jnp.full((B,), 625, jnp.int32), key))
    (jloss, jaux), jgrads = jax.value_and_grad(JL.psi_loss, has_aux=True)(
        lora[1] if lora else s.jax["fake"], s.jax["teacher"], jimages, _nhwc(noise),
        jnp.asarray(s.emb), jnp.asarray(s.uncond), jnp.asarray(s.t, jnp.int32), {}, None, key,
        float(B))
    assert int(aux["n_valid"]) == int(jaux["n_valid"])
    return float(loss.detach()), grads, float(jloss), jgrads


def _g_both(s, kappa, pred, z=None, alpha=1.0):
    z = s.z if z is None else z
    cfg, sched, jcfg, jsched = _cfgs(kappa, pred, alpha=alpha)
    L = make_loss_fns(unet_apply_fn(TINY.unet, torch.float32), sched, cfg)
    g = _port_params(s, "g", grad=True)
    loss, aux = L.g_loss(g, _port_params(s, "fake"), _port_params(s, "teacher"),
                         *[torch.from_numpy(x) for x in (z, s.noise, s.emb, s.uncond, s.t)],
                         torch.full((B,), 625), float(B))
    grads = dict(zip(g, torch.autograd.grad(loss, list(g.values()))))
    JL = jdistill.make_loss_fns(s.j_apply, jsched, jcfg)
    key = jax.random.PRNGKey(3)
    (jloss, jaux), jgrads = jax.value_and_grad(JL.g_loss, has_aux=True)(
        s.jax["g"], s.jax["fake"], s.jax["teacher"], _nhwc(z), _nhwc(s.noise), jnp.asarray(s.emb),
        jnp.asarray(s.uncond), jnp.asarray(s.t, jnp.int32), jnp.full((B,), 625, jnp.int32), key,
        None, key, float(B))
    assert int(aux["n_valid"]) == int(jaux["n_valid"])
    return float(loss.detach()), grads, float(jloss), jgrads


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("kappa", [1.0, 1.5])
def test_psi_loss_and_gradients_match_jax(s, kappa, pred):
    loss, grads, jloss, jgrads = _psi_both(s, kappa, pred)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    _assert_grads(grads, export_unet(jgrads, JTINY.unet), f"psi kappa={kappa} {pred}")


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("kappa", [1.0, 1.5])
def test_g_loss_and_gradients_match_jax(s, kappa, pred):
    loss, grads, jloss, jgrads = _g_both(s, kappa, pred)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    _assert_grads(grads, export_unet(jgrads, JTINY.unet), f"g kappa={kappa} {pred}")


def test_nan_rows_are_excluded_like_jax(s):
    noise = s.noise.copy()
    noise[0] = np.nan
    loss, grads, jloss, jgrads = _psi_both(s, 1.5, "epsilon", noise=noise)
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    _assert_grads(grads, export_unet(jgrads, JTINY.unet), "psi with a NaN noise row")
    z = s.z.copy()
    z[1] = np.inf
    loss, grads, jloss, jgrads = _g_both(s, 1.0, "epsilon", z=z)
    assert np.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in grads.values())
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    _assert_grads(grads, export_unet(jgrads, JTINY.unet), "g with an inf z row")


def test_lora_psi_matches_jax(s):
    jfac = jlora.init_lora(jax.random.PRNGKey(11), s.jax["teacher"], rank=3)
    rs = np.random.RandomState(5)
    jfac = {site: {n: (rs.standard_normal(f[n].shape) * 0.2).astype(np.float32) for n in ("a", "b")}
            for site, f in sorted(jfac.items())}
    # Each JAX site's HF key, by exporting a tree whose site kernels hold markers.
    marker = jax.tree_util.tree_map(lambda p: np.zeros(p.shape, np.float32), s.jax["teacher"])
    for i, site in enumerate(sorted(jfac)):
        node = marker
        for part in site.split("/"):
            node = node[part]
        node["kernel"] = np.full(node["kernel"].shape, float(i + 1), np.float32)
    hf_marked = export_unet(marker, JTINY.unet)
    site_to_key = {}
    for i, site in enumerate(sorted(jfac)):
        (key,) = [k for k, v in hf_marked.items() if k.endswith(".weight") and v.ndim == 2
                  and np.all(v == i + 1)]
        site_to_key[site] = key[:-len(".weight")]
    teacher = _port_params(s, "teacher")
    assert set(lora_sites(teacher)) == set(site_to_key.values())
    init = init_lora(torch.Generator().manual_seed(0), teacher, rank=3)
    assert lora_param_count(init) == sum(f["a"].size + f["b"].size for f in jfac.values())
    assert all(not init[k].any() for k in init if k.endswith(".b"))
    port = {}
    for site, f in jfac.items():
        port[site_to_key[site] + ".a"] = torch.from_numpy(f["a"]).requires_grad_()
        port[site_to_key[site] + ".b"] = torch.from_numpy(f["b"]).requires_grad_()
    loss, grads, jloss, jgrads = _psi_both(s, 1.5, "epsilon", lora=(port, jfac))
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    for site, f in jgrads.items():
        for n in ("a", "b"):
            ref = np.asarray(f[n])
            np.testing.assert_allclose(grads[f"{site_to_key[site]}.{n}"].numpy(), ref, rtol=1e-3,
                                       atol=1e-4 * max(float(np.abs(ref).max()), 1e-8),
                                       err_msg=f"LoRA {site}/{n}")


@pytest.mark.parametrize("kind", ["adam", "adamw", "low_mem", "clip"])
def test_optimizer_matches_optax(kind):
    kw = {"adam": {}, "adamw": dict(weight_decay=0.01), "low_mem": dict(low_mem_state=True),
          "clip": dict(grad_clip_value=0.5, b1=0.9)}[kind]
    rs = np.random.RandomState(3)
    params = {f"p{i}": rs.standard_normal(shape).astype(np.float32)
              for i, shape in enumerate([(5, 7), (11,), (3, 2, 4)])}
    opt = make_optimizer(lr=1e-3, eps=1e-8, **kw)
    jopt = jstate.make_optimizer(lr=1e-3, eps=1e-8, **kw)
    port = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state, jparams = opt.init(port), dict(params)
    jst = jopt.init(jparams)
    for step in range(3):
        grads = {k: (rs.standard_normal(v.shape) * 10 ** rs.uniform(-3, 1)).astype(np.float32)
                 for k, v in params.items()}
        grads["p0"][0, :3] = [np.nan, np.inf, -np.inf]
        upd, jst = jopt.update(grads, jst, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.step(port, [torch.from_numpy(grads[k].copy()) for k in port], state)
        for k in params:
            np.testing.assert_allclose(port[k].numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{kind} step {step} {k}")


def _jax_adam_step(opt, grads, params):
    """One optax update from a fresh state, applied, compiled as one program
    (eagerly, each elementwise op compiles once per parameter shape)."""
    return jax.jit(lambda g, p: optax.apply_updates(p, opt.update(g, opt.init(p), p)[0]))(
        grads, params)


def test_whole_train_step_matches_jax_composition(s):
    """One port train_step (A = 2 rounds of microbatch 2, kappa 1.5 with
    context dropout, EMA ramp from nimg 40) against the same step recomposed
    from JAX ``make_loss_fns``, ``make_optimizer`` and ``ema_beta`` on the
    port's own draws.  Adam's eps is large so each update is close to
    linear in its gradient (eps = 1e-8 makes it ~lr * sign(g)), and the
    parameter changes carry the gradients' tolerance."""
    rounds, mb, lr, eps = 2, B, 10.0, 1e3
    cfg, sched, jcfg, jsched = _cfgs(1.5, "epsilon", batch_size=rounds * mb, context_dropout=0.5)
    rs = np.random.RandomState(21)
    emb_fake = (rs.standard_normal((rounds, mb, 77, 32)) * 0.5).astype(np.float32)
    emb_g = (rs.standard_normal((rounds, mb, 77, 32)) * 0.5).astype(np.float32)
    uncond = (rs.standard_normal((77, 32)) * 0.5).astype(np.float32)

    teacher = _port_params(s, "teacher")
    opt_g, opt_f = make_optimizer(lr=lr, eps=eps), make_optimizer(lr=lr, eps=eps)
    state = init_state(teacher, opt_g, opt_f, resume_nimg=40, params_fake=_port_params(s, "fake"))
    g0 = {k: v.detach().clone() for k, v in state.params_G.items()}
    f0 = {k: v.detach().clone() for k, v in state.params_fake.items()}
    step = make_train_step(unet_apply_fn(TINY.unet, torch.float32), sched, cfg, opt_g, opt_f)
    batch = {"emb_fake": torch.from_numpy(emb_fake), "emb_g": torch.from_numpy(emb_g),
             "uncond_emb": torch.from_numpy(uncond)}
    state, metrics = step(state, teacher, batch, torch.Generator().manual_seed(99))
    assert state.step == 1 and state.nimg == 40 + rounds * mb

    # The port's draws, replayed from the same seed in the step's order.
    gen = torch.Generator().manual_seed(99)
    draws_f = [draw_round(step.loss_fns, cfg, gen, mb, "cpu", True) for _ in range(rounds)]
    draws_g = [draw_round(step.loss_fns, cfg, gen, mb, "cpu", False) for _ in range(rounds)]
    assert any(not bool(d[0].all()) for d in draws_f), "dropout kept every row"

    JL = jdistill.make_loss_fns(s.j_apply, jsched, jcfg)
    jopt_g, jopt_f = (jstate.make_optimizer(lr=lr, eps=eps) for _ in range(2))
    key = jax.random.PRNGKey(0)
    denom = float(rounds * mb)
    unc_b = jnp.broadcast_to(jnp.asarray(uncond), (mb, 77, 32))
    j = lambda x: jnp.asarray(np.asarray(x))
    fake, gp = s.jax["fake"], s.jax["teacher"]
    total, f_loss, f_valid = None, 0.0, 0
    for a, (keep, z, noise, t, init_t) in enumerate(draws_f):
        emb = jnp.where(j(keep)[:, None, None], j(emb_fake[a]), unc_b)
        images = jax.lax.stop_gradient(JL.generate(gp, _nhwc(z), emb, j(init_t).astype(jnp.int32), key))
        (loss, aux), grads = jax.value_and_grad(JL.psi_loss, has_aux=True)(
            fake, s.jax["teacher"], images, _nhwc(noise), emb, unc_b, j(t).astype(jnp.int32), {},
            None, key, denom)
        total = grads if total is None else jax.tree_util.tree_map(jnp.add, total, grads)
        f_loss, f_valid = f_loss + float(loss), f_valid + int(aux["n_valid"])
    fake_new = _jax_adam_step(jopt_f, total, fake)
    total, g_loss, g_valid = None, 0.0, 0
    for a, (_, z, noise, t, init_t) in enumerate(draws_g):
        (loss, aux), grads = jax.value_and_grad(JL.g_loss, has_aux=True)(
            gp, fake_new, s.jax["teacher"], _nhwc(z), _nhwc(noise), j(emb_g[a]), unc_b,
            j(t).astype(jnp.int32), j(init_t).astype(jnp.int32), key, None, key, denom)
        total = grads if total is None else jax.tree_util.tree_map(jnp.add, total, grads)
        g_loss, g_valid = g_loss + float(loss), g_valid + int(aux["n_valid"])
    g_new = _jax_adam_step(jopt_g, total, gp)
    beta = float(jdistill.ema_beta(jcfg, jnp.float32(40.0)))
    ema_new = jax.jit(lambda new, old: jax.tree_util.tree_map(
        lambda p, e: p * (1.0 - beta) + e * beta, new, old))(g_new, gp)

    assert metrics["ema_beta"] == pytest.approx(beta, rel=1e-6) == ema_beta(cfg, 40.0)
    np.testing.assert_allclose(float(metrics["fake_score_loss"]), f_loss / rounds, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["g_loss"]), g_loss / rounds, rtol=LOSS_RTOL)
    assert (int(metrics["fake_valid"]), int(metrics["g_valid"])) == (f_valid, g_valid)
    for name, new, base, ref, ref_base in (
            ("psi", state.params_fake, f0, fake_new, s.hf["fake"]),
            ("G", state.params_G, g0, g_new, s.hf["teacher"]),
            ("EMA", state.ema, g0, ema_new, s.hf["teacher"])):
        ref_hf = export_unet(ref, JTINY.unet)
        delta = {k: new[k].detach() - base[k] for k in new}
        _assert_grads(delta, {k: ref_hf[k] - ref_base[k] for k in ref_hf}, f"{name} change")
