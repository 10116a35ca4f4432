"""The port's models and scheduler against the JAX package's, module by module.

Weights: the committed tiny HF checkpoint, loaded once per module through the
JAX package's converter and carried into the port with ``params_from_jax``.
Inputs come from numpy seeds and go through both packages; the port runs
NCHW on the CPU in f32, so its outputs are transposed to NHWC to compare.
Each test states its f32 tolerance: the towers are deep chains of f32
matmuls whose summation order differs between XLA and PyTorch.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sid_lsg_tpu.diffusion import ddpm as jax_ddpm  # noqa: E402
from sid_lsg_tpu.models import AutoencoderKL as JaxVAE  # noqa: E402
from sid_lsg_tpu.models import CLIPTextModel as JaxText  # noqa: E402
from sid_lsg_tpu.models import UNet2DCondition as JaxUNet  # noqa: E402
from sid_lsg_tpu.models import configs as jax_configs  # noqa: E402
from sid_lsg_tpu.models.convert import load_safetensors, load_sd_checkpoint  # noqa: E402
from sid_lsg_tpu.models.layers import timestep_embedding as jax_timestep_embedding  # noqa: E402
from sid_lsg_torch.diffusion.ddpm import DDPMScheduler, SchedulerConfig  # noqa: E402
from sid_lsg_torch.models import TINY, AutoencoderKL, CLIPTextModel, UNet2DCondition, params_from_jax  # noqa: E402
from sid_lsg_torch.models.layers import timestep_embedding  # noqa: E402
from sid_lsg_torch.models.unet import unet_apply_fn  # noqa: E402

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_hf_ckpt")


@pytest.fixture(scope="module")
def jax_params():
    unet, vae, text = load_sd_checkpoint(FIXTURE, jax_configs.TINY)
    return {"unet": unet, "vae": vae, "text": text}


def _port(module, jax_params, part):
    module.load_state_dict(params_from_jax(jax_params[part], TINY, part), strict=True)
    return module.eval()


def test_tiny_config_is_the_jax_tiny_config():
    for part in ("unet", "vae", "text"):
        assert vars(getattr(TINY, part)) == vars(getattr(jax_configs.TINY, part))


def test_params_from_jax_gives_the_hf_checkpoint_back(jax_params):
    """The JAX tree came from the HF files by transposes only, so carrying it
    into the port must give every HF tensor back exactly, under its HF key."""
    files = {
        "unet": ("unet/diffusion_pytorch_model.safetensors", lambda k: k),
        "vae": ("vae/diffusion_pytorch_model.safetensors", lambda k: k),
        "text": ("text_encoder/model.safetensors", lambda k: k[len("text_model."):]),
    }
    for part, (path, rename) in files.items():
        hf = {rename(k): v for k, v in load_safetensors(os.path.join(FIXTURE, path)).items()}
        hf.pop(None, None)
        sd = params_from_jax(jax_params[part], TINY, part)
        assert set(sd) == set(hf), part
        for k, v in hf.items():
            np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_clip_text_matches_jax(jax_params):
    rng = np.random.default_rng(10)
    ids = rng.integers(0, TINY.text.vocab_size, size=(2, 77)).astype(np.int32)
    text = JaxText(jax_configs.TINY.text)
    ref = jax.jit(lambda p, i: text.apply({"params": p}, i))(jax_params["text"], jnp.asarray(ids))
    port = _port(CLIPTextModel(TINY.text), jax_params, "text")
    with torch.no_grad():
        out = port(torch.from_numpy(ids).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_unet_matches_jax(jax_params):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([625, 37], dtype=np.int32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    unet = JaxUNet(jax_configs.TINY.unet)
    ref = jax.jit(lambda p, a, b, c: unet.apply({"params": p}, a, b, c))(
        jax_params["unet"], x, t, ctx)
    port = _port(UNet2DCondition(TINY.unet), jax_params, "unet")
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("encoder_only", [False, True])
def test_bf16_teacher_matches_jax_bf16_teacher(jax_params, encoder_only):
    """``--teacher-bf16``: every teacher tensor cast to bf16 (norm scales and
    biases included), applied with bf16 compute, on both sides.  The port's
    norms compute in f32 on the bf16-rounded parameters, as flax promotes
    them.  Tolerance: relative L2 <= 3e-2 and max abs <= 3e-2 * max|ref|;
    bf16 rounds at other places in the two frameworks, and the JAX bf16
    output alone is 1.3e-2 in relative L2 from its f32 output."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([625, 37], dtype=np.int32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    teacher = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), jax_params["unet"])
    unet = JaxUNet(jax_configs.TINY.unet, dtype=jnp.bfloat16)
    ref = jax.jit(lambda p, a, b, c: unet.apply({"params": p}, a, b, c, encoder_only=encoder_only))(
        teacher, x, t, ctx)
    ref = np.asarray(ref, np.float32)
    port = {k: v.to(torch.bfloat16) for k, v in params_from_jax(jax_params["unet"], TINY, "unet").items()}
    apply = unet_apply_fn(TINY.unet, torch.bfloat16, encoder_only=encoder_only)
    with torch.no_grad():
        out = apply(port, torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                    torch.from_numpy(ctx))
    assert out.dtype == torch.bfloat16
    assert all(v.dtype == torch.bfloat16 for v in port.values())  # the teacher stays bf16
    got = out.float().permute(0, 2, 3, 1).numpy()
    assert np.linalg.norm(got - ref) <= 3e-2 * np.linalg.norm(ref)
    np.testing.assert_allclose(got, ref, atol=3e-2 * float(np.abs(ref).max()), rtol=0)


def test_vae_decode_matches_jax(jax_params):
    rng = np.random.default_rng(12)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    vae = JaxVAE(jax_configs.TINY.vae)
    ref = jax.jit(lambda p, a: vae.apply({"params": p}, a, method=vae.decode))(
        jax_params["vae"], jnp.asarray(z))
    port = _port(AutoencoderKL(TINY.vae), jax_params, "vae")
    with torch.no_grad():
        out = port.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 37, 625, 999], dtype=np.int32)
    for dim, flip, shift in ((32, True, 0.0), (33, False, 1.0)):
        ref = jax_timestep_embedding(jnp.asarray(t), dim, flip, shift)
        out = timestep_embedding(torch.from_numpy(t), dim, flip, shift)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_scheduler_matches_jax(prediction_type):
    """Tables and the vectorised x0 estimate, in f32 (atol 1e-6 / rtol 1e-5:
    the same f64 tables rounded to f32, then a few f32 operations)."""
    ref = jax_ddpm.DDPMScheduler(jax_ddpm.SchedulerConfig.sd(prediction_type))
    port = DDPMScheduler(SchedulerConfig.sd(prediction_type), device="cpu")
    for name in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
    rng = np.random.default_rng(13)
    x0 = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    noise = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    out = rng.standard_normal((3, 4, 8, 8)).astype(np.float32)
    t = np.array([1, 500, 999], dtype=np.int32)
    tol = dict(atol=1e-6, rtol=1e-5)
    noisy = port.add_noise(*map(torch.from_numpy, (x0, noise, t)))
    np.testing.assert_allclose(noisy.numpy(), np.asarray(ref.add_noise(x0, noise, t)), **tol)
    pred = port.pred_original_sample(*map(torch.from_numpy, (out, t, x0)))
    np.testing.assert_allclose(pred.numpy(), np.asarray(ref.pred_original_sample(out, t, x0)), **tol)
    assert port.scale_model_input(noisy, torch.from_numpy(t)) is noisy
