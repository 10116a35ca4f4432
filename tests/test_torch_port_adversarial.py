"""The port's SiDA adversarial training against the JAX package's, on the CPU.

Weights: the committed tiny HF checkpoint (UNet and VAE, through the JAX
converter and ``params_from_jax``) and a JAX ``ProjectedDiscriminator`` on
TINY_VIT (``power_iters=2``) whose parameters are perturbed away from their
initial zeros and ones, carried into the port with ``disc_params_from_jax``.
Inputs come from numpy seeds; random draws that JAX makes inside a function
(DiffAugment, the real-side noise) are replayed from the same keys and fed
to the port as tensors.

Checked: the antialiased resize against ``jax.image.resize`` (512 -> 224 and 16 -> 32),
``diff_augment``, ``SpectralConv1d``, ``BatchNormLocal``, ``DiscHead``, the
DINO taps and the discriminator's logits, ``refresh_spectral_u``, the
encoder-only UNet under every remat policy, the GAN losses, and
``psi_loss`` / ``g_loss`` with the adversarial terms for both towers
(losses and every gradient), the NaN real-row exclusion, the latent corpus
reader and a ``sid_train`` CLI run per tower.

Tolerances (f32): module outputs atol 1e-5 / rtol 1e-4 unless stated;
losses rtol 1e-4; gradients rtol 1e-3 with atol 1e-4 * max|ref| per tensor
(``tests/test_torch_port_distill.py``).  The JAX loss functions run
eagerly around a jitted UNet, encoder and pixel judge (no loss function is
compiled whole).
"""

import json
import os
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sid_lsg_tpu.data import latents as jlatents  # noqa: E402
from sid_lsg_tpu.diffusion import ddpm as jddpm  # noqa: E402
from sid_lsg_tpu.models import AutoencoderKL as JaxVAE  # noqa: E402
from sid_lsg_tpu.models import UNet2DCondition as JaxUNet  # noqa: E402
from sid_lsg_tpu.models import configs as jconfigs  # noqa: E402
from sid_lsg_tpu.models import stylegan_discriminator as jsd  # noqa: E402
from sid_lsg_tpu.models.convert import export_unet, load_sd_checkpoint  # noqa: E402
from sid_lsg_tpu.training import adversarial as jadv  # noqa: E402
from sid_lsg_tpu.training import distill as jdistill  # noqa: E402
from sid_lsg_torch.cli import sid_train  # noqa: E402
from sid_lsg_torch.data.latents import InfiniteLatentIterator, LatentDataset  # noqa: E402
from sid_lsg_torch.diffusion.ddpm import DDPMScheduler, SchedulerConfig  # noqa: E402
from sid_lsg_torch.models import TINY, AutoencoderKL, params_from_jax  # noqa: E402
from sid_lsg_torch.models import stylegan_discriminator as sd  # noqa: E402
from sid_lsg_torch.models.convert import disc_params_from_jax  # noqa: E402
from sid_lsg_torch.models.unet import unet_apply_fn  # noqa: E402
from sid_lsg_torch.training import adversarial  # noqa: E402
from sid_lsg_torch.training.distill import DISC_PREFIX, DistillConfig, make_loss_fns  # noqa: E402

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_hf_ckpt")
B, D = 2, 32  # microbatch, text width of TINY
TOL = dict(atol=1e-5, rtol=1e-4)
LOSS_RTOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _nhwc(x):
    return jnp.asarray(np.transpose(np.asarray(x), (0, 2, 3, 1)))


def _perturb(tree, seed, scale=0.1):
    rs = np.random.RandomState(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    leaves = [np.asarray(v, np.float32) for v in leaves]  # numpy's std: no JAX op per shape
    leaves = [v + scale * (np.std(v) + 0.5) * rs.standard_normal(v.shape).astype(np.float32)
              for v in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def jax_draws(rng, b, h, w):
    """The draws JAX ``diff_augment(rng, x)`` makes, split as it splits them."""
    out = []
    for name in ("color", "translation", "cutout"):
        rng, r1, r2, r3 = jax.random.split(rng, 4)
        if name == "color":
            out += [jax.random.uniform(r, (b, 1, 1, 1)) for r in (r1, r2, r3)]
        elif name == "translation":
            out += [jax.random.randint(r1, (b,), -(h // 8), h // 8 + 1),
                    jax.random.randint(r2, (b,), -(w // 8), w // 8 + 1)]
        else:
            out += [jax.random.randint(r1, (b,), 0, h), jax.random.randint(r2, (b,), 0, w)]
    return sd.DiffAugmentDraws(*(torch.from_numpy(np.array(v)) for v in out))


@pytest.fixture(scope="module")
def s():
    unet, vae, _ = load_sd_checkpoint(FIXTURE, jconfigs.TINY)
    jdisc = jsd.ProjectedDiscriminator(c_dim=D, vit=jsd.TINY_VIT, power_iters=2)
    res = jconfigs.TINY.resolution
    dvars = jax.jit(jdisc.init)(jax.random.PRNGKey(5), jnp.zeros((1, 3, res, res)),
                                jnp.zeros((1, D)))
    dparams = _perturb(dict(dvars["params"]), 11)
    spectral = jax.tree_util.tree_map(np.asarray, dict(dvars["spectral"]))
    port_disc = sd.ProjectedDiscriminator(D, sd.TINY_VIT, power_iters=2)
    port_disc.load_state_dict(disc_params_from_jax(dparams, spectral, sd.TINY_VIT), strict=True)
    port_vae = AutoencoderKL(TINY.vae)
    port_vae.load_state_dict(params_from_jax(vae, TINY, "vae"), strict=True)
    port_disc.requires_grad_(False)
    port_vae.requires_grad_(False)
    hf = {name: export_unet(_perturb(unet, seed, 0.05), jconfigs.TINY.unet)
          for name, seed in (("teacher", 0), ("fake", 1), ("g", 2))}
    hf = {name: {k: np.asarray(v, np.float32) for k, v in tree.items()} for name, tree in hf.items()}
    junet = JaxUNet(jconfigs.TINY.unet)
    return types.SimpleNamespace(
        junet=junet, jvae=JaxVAE(jconfigs.TINY.vae), jvae_params=vae,
        jencode=jax.jit(lambda p, x, t, c: junet.apply({"params": p}, x, t, c, encoder_only=True)),
        jdisc=jdisc, dparams=dparams, spectral=spectral, disc=port_disc, vae=port_vae, hf=hf)


@pytest.mark.parametrize("src,dst", [(512, 224), (16, 32)])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.RandomState(src).uniform(-2, 2, (2, 3, src, src)).astype(np.float32)
    ref = jax.image.resize(_nhwc(x), (2, dst, dst, 3), method="linear")
    got = sd.resize_linear(_t(x), dst)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=2e-6,
                               rtol=1e-5)


def test_diff_augment_matches_jax():
    x = np.random.RandomState(3).uniform(-1, 1, (4, 3, 16, 16)).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    ref = jsd.diff_augment(rng, jnp.asarray(x))
    got = sd.diff_augment(_t(x), jax_draws(rng, 4, 16, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    draws = sd.draw_diff_augment(torch.Generator().manual_seed(0), 4, 16, 16)
    assert all(t.shape[0] == 4 for t in draws)
    assert int(draws.shift_y.abs().max()) <= 2 and int(draws.cy.max()) < 16


def test_head_modules_match_jax(s):
    rs = np.random.RandomState(4)
    x = rs.standard_normal((16, 32, 17)).astype(np.float32)  # two virtual batches of 8
    c = rs.standard_normal((16, D)).astype(np.float32)
    head = jsd.DiscHead(32, D, power_iters=2)
    hv = jax.jit(head.init)(jax.random.PRNGKey(2), x, c)
    hp = _perturb(hv["params"], 5)
    port = sd.ProjectedDiscriminator(D, sd.TINY_VIT, power_iters=2)
    port.load_state_dict(disc_params_from_jax({"head_0": hp}, {"head_0": hv["spectral"]},
                                              sd.TINY_VIT), strict=False)
    ref = head.apply({"params": hp, "spectral": hv["spectral"]}, x, c)
    np.testing.assert_allclose(port.heads["0"](_t(x), _t(c)).detach().numpy(), np.asarray(ref),
                               **TOL)
    conv = port.heads["0"].main1.conv
    jconv = jsd.SpectralConv1d(32, 9, power_iters=2)
    ref = jconv.apply({"params": hp["main1"]["conv"], "spectral": hv["spectral"]["main1"]["conv"]},
                      x)
    np.testing.assert_allclose(conv(_t(x)).detach().numpy(), np.asarray(ref), **TOL)
    bn = jsd.BatchNormLocal()
    ref = bn.apply({"params": hp["main0"]["bn"]}, x)
    np.testing.assert_allclose(port.heads["0"].main0.bn(_t(x)).detach().numpy(), np.asarray(ref),
                               **TOL)


def test_dino_taps_and_logits_match_jax(s):
    rs = np.random.RandomState(6)
    x = rs.uniform(-1, 1, (3, 3, 16, 16)).astype(np.float32)
    c = rs.standard_normal((3, D)).astype(np.float32)
    rng = jax.random.PRNGKey(8)

    @jax.jit
    def jax_side(variables, x, c):
        taps = jsd.DINOViT(jsd.TINY_VIT).apply({"params": variables["params"]["dino"]},
                                               jnp.transpose(x, (0, 2, 3, 1)) * 0.5 + 0.5)
        return taps, [s.jdisc.apply(variables, x, c, rng=key) for key in (None, rng)]

    taps, logits_ref = jax_side({"params": s.dparams, "spectral": s.spectral}, jnp.asarray(x),
                                jnp.asarray(c))
    got = s.disc.dino(_t(x) * 0.5 + 0.5)
    assert sorted(got) == sorted(taps)
    for k in taps:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(taps[k]), atol=1e-4, rtol=1e-4)
    for key, ref in zip((None, rng), logits_ref):
        aug = None if key is None else jax_draws(key, 3, 16, 16)
        logits = s.disc(_t(x), _t(c), aug)
        assert logits.shape == ref.shape == (3, 3 * 16)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_refresh_spectral_u_matches_jax(s):
    heads = {k: v for k, v in s.dparams.items() if k.startswith("head_")}
    ref = jsd.refresh_spectral_u(heads, s.spectral, iters=3)
    got = sd.refresh_spectral_u(sd.head_params(s.disc), sd.spectral_buffers(s.disc), iters=3)
    ref_sd = disc_params_from_jax(heads, jax.tree_util.tree_map(np.asarray, ref), sd.TINY_VIT)
    assert set(got) == {k for k in ref_sd if k.endswith(".u")}
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), **TOL)


@pytest.mark.parametrize("remat", [None, "full", "flash"])
def test_encoder_only_matches_jax(s, remat):
    rs = np.random.RandomState(7)
    x = rs.standard_normal((B, 4, 8, 8)).astype(np.float32)
    t = np.array([37, 625])
    emb = (rs.standard_normal((B, 77, D)) * 0.5).astype(np.float32)
    ref = s.jencode(_jax_unet(s, "teacher"), _nhwc(x), jnp.asarray(t), jnp.asarray(emb))
    params = {k: _t(v).requires_grad_() for k, v in s.hf["teacher"].items()}
    apply = unet_apply_fn(TINY.unet, torch.float32, remat_policy=remat, encoder_only=True)
    feats = apply(params, _t(x), torch.from_numpy(t), _t(emb))
    np.testing.assert_allclose(feats.permute(0, 2, 3, 1).detach().numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)
    used = torch.autograd.grad(adversarial.pooled_logit(feats).sum(), list(params.values()),
                               allow_unused=True)
    names = {k for k, g in zip(params, used) if g is not None}
    assert names and not any(k.startswith(("up_blocks.", "conv_out.", "conv_norm_out."))
                             for k in names)


def test_gan_losses_match_jax():
    logits = np.array([5.0, -5.0, 0.3, -40.0, 40.0], np.float32)
    for kind in ("ns", "hinge"):
        for name in ("d_loss_real", "d_loss_fake", "g_loss"):
            np.testing.assert_allclose(getattr(adversarial, name)(_t(logits), kind).numpy(),
                                       np.asarray(getattr(jadv, name)(logits, kind)), **TOL)
        np.testing.assert_allclose(adversarial.d_loss(_t(logits), _t(-logits), kind).numpy(),
                                   np.asarray(jadv.d_loss(logits, -logits, kind)), **TOL)
    with pytest.raises(ValueError):
        adversarial.d_loss(_t(logits), _t(logits), "wgan")


def _jax_unet(s, name):
    from sid_lsg_tpu.models.convert import convert_unet

    return convert_unet(s.hf[name], jconfigs.TINY.unet)


# The conv biases in front of a BatchNormLocal: the normalisation removes any
# per-channel constant, so their exact gradient is 0 and both sides hold
# rounding noise.  They are held to 1e-6 of the largest head gradient.
STRUCTURAL_ZERO = ("main0.conv.bias", "main1.conv.bias")


def _assert_grads(port, ref, what):
    assert set(port) == set(ref), (what, sorted(set(port) ^ set(ref))[:5])
    heads_max = max([float(np.abs(np.asarray(v)).max()) for k, v in ref.items()
                     if k.startswith(DISC_PREFIX)] or [0.0])
    for k in sorted(ref):
        r = np.asarray(ref[k], np.float32)
        if k.endswith(STRUCTURAL_ZERO):
            assert float(port[k].abs().max()) <= 1e-6 * heads_max, (what, k)
            assert float(np.abs(r).max()) <= 1e-6 * heads_max, (what, k)
            continue
        np.testing.assert_allclose(port[k].detach().numpy(), r, rtol=1e-3,
                                   atol=1e-4 * max(float(np.abs(r).max()), 1e-8),
                                   err_msg=f"{what}: gradient of {k}")


@pytest.fixture(scope="module")
def towers(s):
    """Per tower: the port's loss functions and the JAX ones.  The JAX UNet,
    its encoder and the pixel judge are jitted once for the module (their
    forward and backward compile once per shape, shared by every loss)."""
    out = {}
    sched = jddpm.DDPMScheduler(jddpm.SchedulerConfig.sd("epsilon"))
    apply = jax.jit(lambda p, x, t, c: s.junet.apply({"params": p}, x, t, c))
    pixel_disc, decode_params = jadv.make_pixel_disc(s.jvae, s.jdisc, jconfigs.TINY.vae.scaling_factor)
    for tower in ("encoder", "dino"):
        # kappa = 1 (no CFG doubling) keeps the compiles short; the distill
        # tests cover kappa 1.5.
        common = dict(latent_size=8, adv_weight_D=0.3, adv_weight_G=0.2, adv_tower=tower)
        JL = jdistill.make_loss_fns(apply, sched, jdistill.DistillConfig(**common),
                                    unet_encode=s.jencode, pixel_disc=jax.jit(pixel_disc))
        L = make_loss_fns(unet_apply_fn(TINY.unet, torch.float32),
                          DDPMScheduler(SchedulerConfig.sd("epsilon"), device="cpu"),
                          DistillConfig(**common),
                          unet_encode=unet_apply_fn(TINY.unet, torch.float32, encoder_only=True),
                          pixel_disc=adversarial.make_pixel_disc(s.vae, s.disc,
                                                                 TINY.vae.scaling_factor))
        frozen = None
        if tower == "dino":
            frozen = {"vae": decode_params(s.jvae_params), "dino": s.dparams["dino"],
                      "spectral": s.spectral}
        out[tower] = types.SimpleNamespace(
            L=L, frozen=frozen,
            psi=jax.value_and_grad(JL.psi_loss, has_aux=True),
            g=jax.value_and_grad(JL.g_loss, has_aux=True))
    return out


def _inputs(seed=7):
    rs = np.random.RandomState(seed)
    n = lambda *shape: rs.standard_normal(shape).astype(np.float32)
    return types.SimpleNamespace(
        images=n(B, 4, 8, 8), noise=n(B, 4, 8, 8), z=n(B, 4, 8, 8), emb=n(B, 77, D) * 0.5,
        uncond=np.ascontiguousarray(np.broadcast_to(n(77, D) * 0.5, (B, 77, D))),
        t=rs.randint(20, 980, (B,)), lat_real=n(B, 4, 8, 8), emb_real=n(B, 77, D) * 0.5)


def _psi_both(s, tw, tower, x):
    heads = {k: v for k, v in s.dparams.items() if k.startswith("head_")}
    jfake = _jax_unet(s, "fake") if tower == "encoder" else {"psi": _jax_unet(s, "fake"),
                                                            "disc": heads}
    rng = jax.random.PRNGKey(21)
    (jloss, jaux), jgrads = tw.psi(
        jfake, _jax_unet(s, "teacher"), _nhwc(x.images), _nhwc(x.noise), jnp.asarray(x.emb),
        jnp.asarray(x.uncond), jnp.asarray(x.t, jnp.int32),
        {"lat_real": _nhwc(x.lat_real), "emb_real": jnp.asarray(x.emb_real)}, tw.frozen, rng,
        float(B))
    r_fake, r_real = jax.random.split(rng)
    if tower == "encoder":
        draws = {"noise_real": torch.from_numpy(np.transpose(
            np.asarray(jax.random.normal(r_real, (B, 8, 8, 4))), (0, 3, 1, 2)).copy())}
    else:
        draws = {"aug_fake": jax_draws(r_fake, B, 16, 16), "aug_real": jax_draws(r_real, B, 16, 16)}
    fake = {k: _t(v).requires_grad_() for k, v in s.hf["fake"].items()}
    if tower == "dino":
        fake.update({DISC_PREFIX + k: v.clone().requires_grad_()
                     for k, v in sd.head_params(s.disc).items()})
    adv = {"lat_real": _t(x.lat_real), "emb_real": _t(x.emb_real), **draws}
    loss, aux = tw.L.psi_loss(fake, {k: _t(v) for k, v in s.hf["teacher"].items()}, _t(x.images),
                              _t(x.noise), _t(x.emb), _t(x.uncond), torch.from_numpy(x.t),
                              float(B), adv)
    grads = dict(zip(fake, torch.autograd.grad(loss, list(fake.values()))))
    ref = export_unet(jgrads if tower == "encoder" else jgrads["psi"], jconfigs.TINY.unet)
    if tower == "dino":
        ref.update({DISC_PREFIX + k: v for k, v in disc_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jgrads["disc"]), None, sd.TINY_VIT).items()})
    return loss, aux, grads, jloss, jaux, ref


@pytest.fixture(scope="module")
def psi_clean(s, towers):
    """Per tower, ``_psi_both`` on the clean inputs, computed once for the
    tests that read it."""
    cache = {}

    def get(tower):
        if tower not in cache:
            cache[tower] = _psi_both(s, towers[tower], tower, _inputs())
        return cache[tower]

    return get


@pytest.mark.parametrize("tower", ["encoder", "dino"])
def test_psi_loss_with_adversarial_term_matches_jax(psi_clean, tower):
    loss, aux, grads, jloss, jaux, ref = psi_clean(tower)
    for k in ("adv_d_loss", "d_logit_real", "d_logit_fake"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(grads, ref, f"psi {tower}")


@pytest.mark.parametrize("tower", ["encoder", "dino"])
def test_g_loss_with_adversarial_term_matches_jax(s, towers, tower):
    tw, x = towers[tower], _inputs(8)
    heads = {k: v for k, v in s.dparams.items() if k.startswith("head_")}
    jfake = _jax_unet(s, "fake") if tower == "encoder" else {"psi": _jax_unet(s, "fake"),
                                                            "disc": heads}
    rng = jax.random.PRNGKey(33)
    (jloss, jaux), jgrads = tw.g(
        _jax_unet(s, "g"), jfake, _jax_unet(s, "teacher"), _nhwc(x.z), _nhwc(x.noise),
        jnp.asarray(x.emb), jnp.asarray(x.uncond), jnp.asarray(x.t, jnp.int32),
        jnp.full((B,), 625, jnp.int32), rng, tw.frozen, rng, float(B))
    fake = {k: _t(v) for k, v in s.hf["fake"].items()}
    if tower == "dino":
        fake.update({DISC_PREFIX + k: v for k, v in sd.head_params(s.disc).items()})
    g = {k: _t(v).requires_grad_() for k, v in s.hf["g"].items()}
    adv = {"aug": jax_draws(rng, B, 16, 16)} if tower == "dino" else None
    loss, aux = tw.L.g_loss(g, fake, {k: _t(v) for k, v in s.hf["teacher"].items()}, _t(x.z),
                            _t(x.noise), _t(x.emb), _t(x.uncond), torch.from_numpy(x.t),
                            torch.full((B,), 625), float(B), None, adv)
    grads = dict(zip(g, torch.autograd.grad(loss, list(g.values()))))
    np.testing.assert_allclose(float(aux["adv_g_loss"]), float(jaux["adv_g_loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(grads, export_unet(jgrads, jconfigs.TINY.unet), f"g {tower}")


def test_nan_real_row_is_excluded_like_jax(s, towers, psi_clean):
    """A NaN real-latent row costs only its own d-loss term: the loss and
    every gradient agree with JAX, stay finite, and the adversarial loss
    drops below the clean one."""
    bad = _inputs()
    bad.lat_real[0] = np.nan
    loss_c, aux_c, _, _, _, _ = psi_clean("encoder")
    loss, aux, grads, jloss, jaux, ref = _psi_both(s, towers["encoder"], "encoder", bad)
    assert all(np.isfinite(float(aux[k])) for k in ("adv_d_loss", "d_logit_real", "d_logit_fake"))
    assert float(aux["loss"]) == pytest.approx(float(aux_c["loss"]), rel=1e-6)
    assert float(aux["adv_d_loss"]) < float(aux_c["adv_d_loss"])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    _assert_grads(grads, ref, "psi with a NaN real row")


def test_make_loss_fns_keeps_the_jax_errors():
    apply = unet_apply_fn(TINY.unet, torch.float32)
    sched = DDPMScheduler(SchedulerConfig.sd("epsilon"), device="cpu")
    with pytest.raises(ValueError, match="unet_encode"):
        make_loss_fns(apply, sched, DistillConfig(adv_weight_D=0.1))
    with pytest.raises(ValueError, match="pixel_disc"):
        make_loss_fns(apply, sched, DistillConfig(adv_weight_G=0.1, adv_tower="dino"))
    with pytest.raises(ValueError, match="adv_tower"):
        make_loss_fns(apply, sched, DistillConfig(adv_weight_D=0.1, adv_tower="vgg"))


@pytest.mark.parametrize("sidecar", [False, True])
def test_latent_dataset_matches_jax(tmp_path, sidecar):
    path = str(tmp_path / "latents.npz")
    lat = np.random.RandomState(0).randn(10, 8, 8, 4).astype(np.float16)
    caps = np.array([f"caption {i}" for i in range(10)])
    if sidecar:
        np.savez(path, captions=caps)
        np.save(str(tmp_path / "latents.latents.npy"), lat)
    else:
        np.savez(path, latents=lat, captions=caps)
    ds, jds = LatentDataset(path), jlatents.LatentDataset(path)
    assert len(ds) == 10
    x, c = ds[3]
    assert x.shape == (8, 8, 4) and x.dtype == np.float32 and c == "caption 3"
    it, jit_ = InfiniteLatentIterator(ds, 4, seed=1), jlatents.InfiniteLatentIterator(jds, 4, seed=1)
    for _ in range(4):  # crosses two epochs
        (a, ca), (b, cb) = next(it), next(jit_)
        assert ca == cb
        np.testing.assert_array_equal(a, b)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, foo=np.zeros(3))
    with pytest.raises(ValueError, match="encode_latents"):
        LatentDataset(bad)


@pytest.mark.parametrize("tower", ["encoder", "dino"])
def test_sid_train_cli_runs_sida_for_one_tick(tmp_path, tower):
    sid_train.main(["--outdir", str(tmp_path), "--sd_model", "tiny", "--device", "cpu", "--batch",
                    "2", "--batch-micro", "2", "--tick", "0", "--max-ticks", "0", "--bf16", "0",
                    "--snap", "0", "--dump", "0", "--adv_weight_d", "0.1", "--adv_weight_g", "0.1",
                    "--adv_tower", tower, "--adv_vit", "tiny", "--seed", "3"])
    (rd,) = [tmp_path / n for n in os.listdir(tmp_path)]
    opts = json.loads((rd / "training_options.json").read_text())
    assert (opts["adv_tower"], opts["adv_weight_D"]) == (tower, 0.1)
    (stats,) = [n for n in os.listdir(rd) if n.startswith("stats_")]
    (line,) = [json.loads(x) for x in (rd / stats).read_text().splitlines()]
    assert line["tick"] == 0 and np.isfinite(line["fake_loss"]) and np.isfinite(line["g_loss"])
