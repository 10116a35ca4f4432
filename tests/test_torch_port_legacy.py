"""The port's legacy nets and their ops against the JAX package's, on the CPU.

Inputs come from a numpy seed; the weights are ``randn * 0.1`` from a numpy
seed on the shapes of the JAX nets' parameters (``jax.eval_shape`` of their
init; EDM's zero-initialised output convs would otherwise give outputs of
about 0), carried by ``models.convert.edm_params_from_jax`` /
``stylegan_t_params_from_jax``.  The JAX forwards run under ``jax.jit``.
The nets run in ``eval()``, which is the JAX package's
``deterministic=True``.  Tolerance: f32 atol 2e-4 / rtol 2e-3
(the JAX EDM parity gate, ``tests/test_torch_parity_edm.py``) unless a case
states a tighter one.  Sizes are the JAX tests' tiny ones.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sid_lsg_torch import ops  # noqa: E402
from sid_lsg_torch.models import edm_networks as E  # noqa: E402
from sid_lsg_torch.models import stylegan_t as S  # noqa: E402
from sid_lsg_torch.models.convert import (  # noqa: E402
    edm_params_from_jax,
    normalise_edm_state_dict,
    stylegan_t_params_from_jax,
)
from sid_lsg_tpu import ops as jops  # noqa: E402
from sid_lsg_tpu.models import edm_networks as JE  # noqa: E402
from sid_lsg_tpu.models import stylegan_t as JS  # noqa: E402
from sid_lsg_tpu.models.convert import convert_edm_unet  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=2e-4, rtol=2e-3)
OP_TOL = dict(atol=1e-5, rtol=1e-4)  # one op: the JAX ops tests' tolerance


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return np.asarray(x, np.float32)


def _random_variables(module, seed, *args):
    """``module``'s variables, every parameter drawn as randn * 0.1 from a
    numpy seed on the shapes of its init, the ``stats`` at their zeros."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rs = np.random.RandomState(seed)
    draw = lambda v: (0.1 * rs.standard_normal(v.shape)).astype(np.float32)
    out = {"params": jax.tree_util.tree_map(draw, shapes["params"])}
    if "stats" in shapes:
        out["stats"] = jax.tree_util.tree_map(lambda v: np.zeros(v.shape, v.dtype), shapes["stats"])
    return out


# ---------------------------------------------------------------------------
# upfirdn2d, conv2d_resample, grid_sample, fma


@pytest.mark.parametrize("up,down,pad,flip,taps", [
    (1, 1, (1, 1, 1, 1), False, (4, 4)),
    (2, 1, (2, 1, 2, 1), True, (4, 4)),
    (1, 2, (1, 1, 1, 1), False, (3, 4)),
    (2, 2, (2, 2, 2, 2), False, (4, 4)),
    (1, 1, (-1, -1, -1, -2), False, (4, 4)),
    (2, 1, (2, 1, 2, 1), False, (8,)),
    (1, 2, (3, -1, 0, 2), True, (9,)),
], ids=["pad", "up_flip", "down", "up_down", "crop", "separable_up", "separable_down_crop"])
def test_upfirdn2d_matches_jax(up, down, pad, flip, taps):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    f = rng.rand(*taps).astype(np.float32)
    want = jops.upfirdn2d(jnp.asarray(x), jnp.asarray(f), up=up, down=down, padding=list(pad),
                          flip_filter=flip, gain=1.5)
    got = ops.upfirdn2d(_t(x), _t(f), up=up, down=down, padding=list(pad), flip_filter=flip,
                        gain=1.5)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), **OP_TOL)


@pytest.mark.parametrize("fn", ["filter2d", "upsample2d", "downsample2d"])
@pytest.mark.parametrize("taps", [[1, 1], [1, 3, 3, 1], [1, 2, 3, 4, 4, 3, 2, 1]])
def test_resample_helpers_match_jax(fn, taps):
    x = np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32)
    jf, f = jops.setup_filter(taps), ops.setup_filter(taps)
    np.testing.assert_array_equal(f.numpy(), _np(jf))
    want = getattr(jops, fn)(jnp.asarray(x), jf, padding=1)
    got = getattr(ops, fn)(_t(x), f, padding=1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), **OP_TOL)


@pytest.mark.parametrize("up,down,padding,groups,flip_weight", [
    (2, 1, 1, 1, True), (1, 2, 1, 1, False), (1, 1, 0, 3, True), (2, 1, 0, 1, False)])
def test_conv2d_resample_matches_jax(up, down, padding, groups, flip_weight):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 8, 8).astype(np.float32)
    w = rng.randn(6, 6 // groups, 3, 3).astype(np.float32)
    want = jops.conv2d_resample(jnp.asarray(x), jnp.asarray(w), jops.setup_filter([1, 3, 3, 1]),
                                up=up, down=down, padding=padding, groups=groups,
                                flip_weight=flip_weight)
    got = ops.conv2d_resample(_t(x), _t(w), ops.setup_filter([1, 3, 3, 1]), up=up, down=down,
                              padding=padding, groups=groups, flip_weight=flip_weight)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), **OP_TOL)


def test_grid_sample_matches_jax_inside_and_at_the_border():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 6, 5).astype(np.float32)
    grid = (rng.rand(2, 7, 9, 2) * 2.6 - 1.3).astype(np.float32)  # a third falls outside
    # Corners, the half-pixel border and points just outside it.
    grid[0, 0, :6] = [[-1, -1], [1, 1], [-1.1, 0.5], [1.1, 0.2], [0.3, -1.0 - 1 / 6], [0.9, 1.05]]
    want = jops.grid_sample(jnp.asarray(x), jnp.asarray(grid))
    got = ops.grid_sample(_t(x), _t(grid))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), **OP_TOL)


def test_fma_matches_jax():
    a, b, c = np.random.RandomState(4).randn(3, 4, 5).astype(np.float32)
    np.testing.assert_allclose(ops.fma(_t(a), _t(b), _t(c)).numpy(),
                               _np(jops.fma(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))),
                               atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# SongUNet, DhariwalUNet, the preconditioners


SONG = dict(img_resolution=16, in_channels=3, out_channels=3, model_channels=16,
            channel_mult=(1, 2), num_blocks=1, attn_resolutions=(8,))
SONG_VARIANTS = {
    "ddpmpp": dict(embedding_type="positional", encoder_type="standard", decoder_type="standard",
                   resample_filter=(1, 1)),
    "ncsnpp": dict(embedding_type="fourier", encoder_type="residual", decoder_type="skip",
                   resample_filter=(1, 3, 3, 1), channel_mult_noise=2),
    "skip": dict(embedding_type="positional", encoder_type="skip", decoder_type="skip",
                 resample_filter=(1, 1)),
}
DHARIWAL = dict(img_resolution=16, in_channels=3, out_channels=3, model_channels=16,
                channel_mult=(1, 2), num_blocks=1, attn_resolutions=(8,), label_dim=4)


def _edm_pair(jcls, tcls, kw, seed, x, noise, labels=None, aug=None):
    """(JAX output NCHW, port output) of one net on the same moved weights."""
    jnet = jcls(**kw)
    x_nhwc = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    jlab = None if labels is None else jnp.asarray(labels)
    jaug = None if aug is None else jnp.asarray(aug)
    params = _random_variables(jnet, seed + 100, x_nhwc, jnp.asarray(noise), jlab, jaug)["params"]
    want = jax.jit(jnet.apply)({"params": params}, x_nhwc, jnp.asarray(noise), jlab, jaug)
    net = tcls(**kw).eval()
    net.load_state_dict(edm_params_from_jax(params))
    with torch.no_grad():
        got = net(_t(x), _t(noise), None if labels is None else _t(labels),
                  None if aug is None else _t(aug))
    return np.transpose(_np(want), (0, 3, 1, 2)), got.numpy(), net, params


def _inputs(seed, label_dim=0, augment_dim=0, res=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 3, res, res).astype(np.float32)
    noise = rng.randn(2).astype(np.float32)
    labels = rng.randn(2, label_dim).astype(np.float32) if label_dim else None
    aug = rng.randn(2, augment_dim).astype(np.float32) if augment_dim else None
    return x, noise, labels, aug


@pytest.mark.parametrize("variant", list(SONG_VARIANTS))
def test_song_unet_matches_jax(variant):
    kw = dict(SONG, **SONG_VARIANTS[variant])
    if variant == "ddpmpp":  # the CIFAR-10 cond. config's labels and augment labels
        kw.update(label_dim=10, augment_dim=9)
    x, noise, labels, aug = _inputs(5, kw.get("label_dim", 0), kw.get("augment_dim", 0))
    want, got, _, _ = _edm_pair(JE.SongUNet, E.SongUNet, kw, 0, x, noise, labels, aug)
    assert got.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("width", ["tiny", "two_heads"])
def test_dhariwal_unet_with_labels_matches_jax(width):
    # At the JAX test's width no block reaches 64 channels a head; at
    # model_channels 32 x 4 the 8x8 blocks attend with two heads.
    kw = dict(DHARIWAL, **({} if width == "tiny" else dict(model_channels=32,
                                                           channel_mult=(1, 4))))
    x, noise, labels, _ = _inputs(6, label_dim=4)
    want, got, net, _ = _edm_pair(JE.DhariwalUNet, E.DhariwalUNet, kw, 1, x, noise, labels)
    assert got.shape == (2, 3, 16, 16)
    assert net.dec["8x8_in0"].num_heads == (0 if width == "tiny" else 2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def tiny_song():
    """The JAX tests' tiny SongUNet, its moved params and the port's net."""
    kw = dict(img_resolution=8, in_channels=3, out_channels=3, model_channels=8,
              channel_mult=(1,), num_blocks=1, attn_resolutions=())
    jnet = JE.SongUNet(**kw)
    params = _random_variables(jnet, 7, jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,)))["params"]
    net = E.SongUNet(**kw).eval()
    net.load_state_dict(edm_params_from_jax(params))
    return jnet, params, net


@pytest.mark.parametrize("name", ["vp", "ve", "iddpm", "edm"])
def test_preconditioners_match_jax(tiny_song, name):
    jnet, params, net = tiny_song
    jpre = getattr(JE, JE.PRECONDS[name].__name__)(jnet, params)
    pre = E.PRECONDS[name](net).eval()
    assert (pre.sigma_min, pre.sigma_max) == pytest.approx((jpre.sigma_min, jpre.sigma_max),
                                                           rel=1e-6)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    sigma = np.asarray([0.5, 2.0], np.float32)
    want = jax.jit(jpre.__call__)(jnp.asarray(np.transpose(x, (0, 2, 3, 1))), jnp.asarray(sigma))
    with torch.no_grad():
        got = pre(_t(x), _t(sigma))
    np.testing.assert_allclose(got.numpy(), np.transpose(_np(want), (0, 3, 1, 2)), **TOL)


def test_iddpm_u_table_and_round_sigma_are_jax_bit_for_bit(tiny_song):
    jnet, params, net = tiny_song
    jpre, pre = JE.iDDPMPrecond(jnet, params), E.iDDPMPrecond(net)
    np.testing.assert_array_equal(pre.u.numpy(), np.asarray(jpre.u))
    sig = np.concatenate([np.asarray(jpre.u)[::37], np.geomspace(1e-3, 200, 64)]).astype(np.float32)
    np.testing.assert_array_equal(pre.round_sigma(_t(sig), return_index=True).numpy(),
                                  np.asarray(jpre.round_sigma(jnp.asarray(sig), return_index=True)))
    np.testing.assert_array_equal(pre.round_sigma(_t(sig)).numpy(),
                                  np.asarray(jpre.round_sigma(jnp.asarray(sig))))


def test_edm_layout_state_dict_round_trips_through_normalise():
    """An EDM-layout state dict (the preconditioner's ``model.`` prefix, the
    ``resample_filter`` buffers, iDDPM's ``u``) loads into the port after
    ``normalise_edm_state_dict``; the JAX converter's tree of the same dict
    comes back through ``edm_params_from_jax`` to the same tensors."""
    kw = dict(SONG, **SONG_VARIANTS["ncsnpp"])
    net = E.SongUNet(**kw)
    net.reset_parameters(torch.Generator().manual_seed(3))
    sd = net.state_dict()
    f = torch.tensor([[1.0, 3, 3, 1]]).T @ torch.tensor([[1.0, 3, 3, 1]]) / 64
    edm = {f"model.{k}": v for k, v in sd.items()}
    edm.update({"model.enc.8x8_down.conv0.resample_filter": f[None, None],
                "model.enc.8x8_aux_down.resample_filter": f[None, None],
                "model.dec.16x16_aux_up.resample_filter": f[None, None],
                "u": torch.arange(5.0)})
    norm = normalise_edm_state_dict(edm)
    assert sorted(norm) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(norm[k], sd[k], rtol=0, atol=0)
    back = edm_params_from_jax(convert_edm_unet({k: v.numpy() for k, v in edm.items()}))
    assert sorted(back) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
    fresh = E.SongUNet(**kw)
    fresh.load_state_dict(norm)


# ---------------------------------------------------------------------------
# StyleGAN-T


@pytest.mark.parametrize("up", [1, 2])
@pytest.mark.parametrize("demodulate", [True, False])
def test_modulated_conv2d_matches_jax(up, demodulate):
    rng = np.random.RandomState(9)
    x = rng.randn(2, 4, 8, 8).astype(np.float32)
    w = rng.randn(6, 4, 3, 3).astype(np.float32)
    s = (np.abs(rng.randn(2, 4)) + 0.1).astype(np.float32)
    noise = rng.randn(2, 1, 8 * up, 8 * up).astype(np.float32)
    kw = dict(up=up, padding=1, demodulate=demodulate)
    want = JS.modulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                               noise=jnp.asarray(noise),
                               resample_filter=jops.setup_filter([1, 3, 3, 1]), **kw)
    got = S.modulated_conv2d(_t(x), _t(w), _t(s), noise=_t(noise),
                             resample_filter=ops.setup_filter([1, 3, 3, 1]), **kw)
    assert got.shape == want.shape == (2, 6, 8 * up, 8 * up)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_conditional_generator_matches_jax_with_update_avg_and_truncation():
    kw = dict(z_dim=16, c_dim=8, img_resolution=16, channel_base=512, channel_max=64,
              num_res_blocks=1)
    rng = np.random.RandomState(10)
    z = rng.randn(2, 16).astype(np.float32)
    c = rng.randn(2, 8).astype(np.float32)
    jg = JS.Generator(**kw)
    variables = _random_variables(jg, 11, jnp.asarray(z), jnp.asarray(c))
    g = S.Generator(**kw).eval()
    g.load_state_dict(stylegan_t_params_from_jax(variables))

    want = jax.jit(jg.apply)(variables, jnp.asarray(z), jnp.asarray(c))
    with torch.no_grad():
        got = g(_t(z), _t(c))
    assert got.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)

    # One W-average update, then truncation toward the updated average.
    update = functools.partial(jg.apply, truncation_psi=0.5, update_avg=True, mutable=["stats"])
    want_tr, mutated = jax.jit(update)(variables, jnp.asarray(z), jnp.asarray(c))
    with torch.no_grad():
        got_tr = g(_t(z), _t(c), truncation_psi=0.5, update_avg=True)
    np.testing.assert_allclose(g.mapping.x_avg.numpy(), _np(mutated["stats"]["mapping"]["x_avg"]),
                               atol=1e-6, rtol=1e-5)
    assert float(g.mapping.x_avg.abs().sum()) > 0
    np.testing.assert_allclose(got_tr.numpy(), _np(want_tr), **TOL)
    assert not np.allclose(got_tr.numpy(), got.numpy())


def test_generator_draws_its_noise_from_the_generator_it_is_given():
    g = S.Generator(z_dim=8, c_dim=0, img_resolution=16, channel_base=256, channel_max=16,
                    num_res_blocks=1).eval()
    g.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, S.SynthesisLayer):
                m.noise_strength.fill_(0.5)
        z = torch.randn(2, 8, generator=torch.Generator().manual_seed(1))
        a = g(z, rng=torch.Generator().manual_seed(5))
        b = g(z, rng=torch.Generator().manual_seed(5))
        c = g(z, rng=torch.Generator().manual_seed(6))
        const = g(z)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c) and not torch.allclose(a, const)
