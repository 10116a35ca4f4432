"""The port's metric stack on the CPU, against the JAX package.

Checked, each on the same numpy inputs and weights in both packages:
InceptionV3 features at 256 and 512 uint8 inputs (one torchvision-layout
state dict through both ``convert_inception``; relative L2 <= 1e-4); the
CLIP scorer's unit-norm image and text features and scores (one open_clip
state dict through both ``convert_open_clip``; atol 1e-5); the port's
Pillow resamplers against Pillow (every byte within 1, at least 99.9%
equal); ``frechet_distance`` and ``compute_pr`` (1e-6 relative);
``CocoCaptionDataset`` on a directory and on a zip; ``fid_clip_test``,
``pr_test`` and ``hpsv2`` end to end on the tiny pipeline (the same noise
latents, stand-in detector and CLIP weights in both; their uint8 images
differ by at most one step, tolerances below); ``sid_metrics --device cpu``
on tiny; the Trainer's metric hook.

Only this test imports ``PIL`` (as the JAX side does): the port does not.
"""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from sid_lsg_tpu.data.mscoco import CocoCaptionDataset as JaxCoco  # noqa: E402
from sid_lsg_tpu.metrics import MetricOptions as JaxMetricOptions  # noqa: E402
from sid_lsg_tpu.metrics import calc_metric as jax_calc_metric  # noqa: E402
from sid_lsg_tpu.metrics import hpsv2 as jax_hpsv2  # noqa: E402
from sid_lsg_tpu.metrics import metric_utils as jax_metric_utils  # noqa: E402
from sid_lsg_tpu.metrics.fid import frechet_distance as jax_frechet  # noqa: E402
from sid_lsg_tpu.metrics.precision_recall import compute_pr as jax_compute_pr  # noqa: E402
from sid_lsg_tpu.models import clip_vision as jclip  # noqa: E402
from sid_lsg_tpu.models import configs as jconfigs  # noqa: E402
from sid_lsg_tpu.models.convert import load_sd_checkpoint as jax_load_sd  # noqa: E402
from sid_lsg_tpu.models.inception import InceptionV3Features as JaxInception  # noqa: E402
from sid_lsg_tpu.models.inception import convert_inception as jax_convert_inception  # noqa: E402
from sid_lsg_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer  # noqa: E402
from sid_lsg_tpu.pipeline import SDPipeline as JaxPipeline  # noqa: E402
from sid_lsg_torch.cli import sid_metrics  # noqa: E402
from sid_lsg_torch.cli.pngio import write_png  # noqa: E402
from sid_lsg_torch.data.mscoco import CocoCaptionDataset  # noqa: E402
from sid_lsg_torch.metrics import MetricOptions, calc_metric  # noqa: E402
from sid_lsg_torch.metrics import hpsv2 as port_hpsv2  # noqa: E402
from sid_lsg_torch.metrics import metric_utils as port_metric_utils  # noqa: E402
from sid_lsg_torch.metrics.fid import frechet_distance  # noqa: E402
from sid_lsg_torch.metrics.precision_recall import compute_pr  # noqa: E402
from sid_lsg_torch.models import TINY, params_from_jax  # noqa: E402
from sid_lsg_torch.models import clip_vision as pclip  # noqa: E402
from sid_lsg_torch.models.inception import InceptionV3Features, convert_inception  # noqa: E402
from sid_lsg_torch.pipeline import SDPipeline  # noqa: E402
from sid_lsg_torch.training.loop import Trainer, TrainConfig  # noqa: E402
from sid_lsg_torch.utils.resample import resize_uint8  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny_hf_ckpt")


def _torchvision_inception_sd(rng) -> dict:
    """A random torchvision-layout InceptionV3 state dict (conv + BN stats)."""
    sd = {}
    for k, v in InceptionV3Features().state_dict().items():
        if k.endswith(".conv.weight"):
            p, cout = k[:-len(".conv.weight")], v.shape[0]
            sd[k] = (rng.randn(*v.shape) * np.sqrt(2.0 / v[0].numel())).astype(np.float32)
            sd[p + ".bn.weight"] = (1 + 0.1 * rng.randn(cout)).astype(np.float32)
            sd[p + ".bn.bias"] = (0.1 * rng.randn(cout)).astype(np.float32)
            sd[p + ".bn.running_mean"] = (0.1 * rng.randn(cout)).astype(np.float32)
            sd[p + ".bn.running_var"] = (1 + 0.1 * rng.rand(cout)).astype(np.float32)
    return sd


def _open_clip_sd(rng, vis_width=64, layers=2, patch=8, img=32, txt_width=64, vocab=100, ctx=8,
                  embed=32):
    """A random open_clip-layout state dict of a small ViT scorer."""
    r = lambda *s: rng.randn(*s).astype(np.float32) * 0.05
    grid = img // patch
    sd = {
        "visual.conv1.weight": r(vis_width, 3, patch, patch),
        "visual.class_embedding": r(vis_width),
        "visual.positional_embedding": r(grid * grid + 1, vis_width),
        "visual.ln_pre.weight": 1 + r(vis_width), "visual.ln_pre.bias": r(vis_width),
        "visual.ln_post.weight": 1 + r(vis_width), "visual.ln_post.bias": r(vis_width),
        "visual.proj": r(vis_width, embed),
        "token_embedding.weight": r(vocab, txt_width),
        "positional_embedding": r(ctx, txt_width),
        "ln_final.weight": 1 + r(txt_width), "ln_final.bias": r(txt_width),
        "text_projection": r(txt_width, embed),
        "logit_scale": np.float32(4.6052),
    }
    for prefix, width in (("visual.transformer.resblocks", vis_width),
                          ("transformer.resblocks", txt_width)):
        for i in range(layers):
            p = f"{prefix}.{i}"
            for ln in ("ln_1", "ln_2"):
                sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = 1 + r(width), r(width)
            sd[f"{p}.attn.in_proj_weight"], sd[f"{p}.attn.in_proj_bias"] = r(3 * width, width), r(3 * width)
            sd[f"{p}.attn.out_proj.weight"], sd[f"{p}.attn.out_proj.bias"] = r(width, width), r(width)
            sd[f"{p}.mlp.c_fc.weight"], sd[f"{p}.mlp.c_fc.bias"] = r(2 * width, width), r(2 * width)
            sd[f"{p}.mlp.c_proj.weight"], sd[f"{p}.mlp.c_proj.bias"] = r(width, 2 * width), r(width)
    return sd


@pytest.fixture(scope="module")
def scorers():
    sd = _open_clip_sd(np.random.RandomState(7))
    jcfg, pcfg = jclip.config_from_open_clip(sd), pclip.config_from_open_clip(sd)
    return (jclip.CLIPScorer(jcfg, params=jclip.convert_open_clip(sd, jcfg)),
            pclip.CLIPScorer(pcfg, state_dict=pclip.convert_open_clip(sd, pcfg), device="cpu"))


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """24 PNG + caption pairs at 40x40 (resized to 32 by LANCZOS)."""
    rng = np.random.RandomState(0)
    d = tmp_path_factory.mktemp("coco")
    for i in range(24):
        smooth = rng.rand(5, 5, 3) * 255
        img = np.asarray(Image.fromarray(smooth.astype(np.uint8)).resize((40, 40), Image.BILINEAR))
        img = np.clip(img.astype(np.int32) + rng.randint(-20, 21, img.shape), 0, 255)
        write_png(str(d / f"img{i:03d}.png"), img.astype(np.uint8))
        (d / f"img{i:03d}.txt").write_text(f"caption number {i}")
    return str(d)


@pytest.fixture(scope="module")
def small_coco_dir(coco_dir, tmp_path_factory):
    """Four of the pairs: the real-image side of the runs through InceptionV3."""
    d = tmp_path_factory.mktemp("coco4")
    for name in sorted(os.listdir(coco_dir))[:8]:
        with open(os.path.join(coco_dir, name), "rb") as f:
            (d / name).write_bytes(f.read())
    return str(d)


@pytest.fixture(scope="module")
def pipes():
    unet, vae, text = jax_load_sd(FIXTURE, jconfigs.TINY)
    jparams = {"unet": unet, "vae": vae, "text": text}
    jpipe = JaxPipeline(jconfigs.TINY, jparams, JaxHashTokenizer(vocab_size=TINY.text.vocab_size))
    sds = {part: params_from_jax(tree, TINY, part) for part, tree in jparams.items()}
    return jpipe, SDPipeline(TINY, sds, device="cpu")


def test_inception_features_match_jax_at_256_and_512():
    rng = np.random.RandomState(0)
    sd = _torchvision_inception_sd(rng)
    model = InceptionV3Features()
    model.load_state_dict(convert_inception(sd), strict=True)
    model.eval()
    jparams = jax_convert_inception(sd)
    apply = jax.jit(lambda p, x: JaxInception().apply({"params": p}, x))
    for res in (256, 512):
        images = rng.randint(0, 256, (2, res, res, 3)).astype(np.uint8)
        ref = np.asarray(apply(jparams, jnp.asarray(images)))
        with torch.no_grad():
            got = model(torch.from_numpy(images)).numpy()
        assert got.shape == (2, 2048)
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel <= 1e-4, (res, rel)


def test_clip_scorer_matches_jax(scorers):
    js, ps = scorers
    rng = np.random.RandomState(1)
    prompts = ["a painting", "a photo of a dog", "x"]
    for images in (rng.randint(0, 256, (3, 64, 48, 3)).astype(np.uint8),  # host preprocess
                   rng.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)):  # the tower's size
        fi, ft = ps.image_features(images).numpy(), ps.text_features(prompts).numpy()
        np.testing.assert_allclose(np.linalg.norm(fi, axis=-1), 1.0, rtol=1e-5)
        np.testing.assert_allclose(fi, np.asarray(js.image_features(images)), atol=1e-5)
        np.testing.assert_allclose(ft, np.asarray(js.text_features(prompts)), atol=1e-5)
        np.testing.assert_allclose(ps.score(images, prompts), np.asarray(js.score(images, prompts)),
                                   atol=1e-5)
    # Float pixels of another size: the tower's own antialiased bicubic resize.
    pixels = rng.randint(0, 256, (2, 48, 40, 3)).astype(np.float32)
    np.testing.assert_allclose(ps.image_features(pixels).numpy(),
                               np.asarray(js.image_features(pixels)), atol=1e-5)
    assert ps.config.vision == pclip.CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=64,
                                                      intermediate_size=128, num_hidden_layers=2,
                                                      num_attention_heads=1, projection_dim=32)
    for name in ("VIT_G_14", "VIT_H_14", "TINY_CLIP"):
        j, p = getattr(jclip, name), getattr(pclip, name)
        assert vars(p.vision) == vars(j.vision) and vars(p.text) == vars(j.text), name


def _within_one(got, ref):
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert got.shape == ref.shape and d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(),
                                                                                  (d == 0).mean())


@pytest.mark.parametrize("kind", ["bicubic", "lanczos"])
def test_resamplers_match_pillow(kind):
    rng = np.random.RandomState(2)
    pil = {"bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS}[kind]
    for (h, w), (oh, ow) in [((512, 512), (256, 256)), ((37, 53), (16, 16)),
                             ((64, 96), (150, 224)), ((100, 50), (33, 77))]:
        images = rng.randint(0, 256, (2, h, w, 3)).astype(np.uint8)
        ref = np.stack([np.asarray(Image.fromarray(i).resize((ow, oh), pil)) for i in images])
        _within_one(resize_uint8(images, (oh, ow), kind), ref)


def test_metric_resizes_match_the_jax_package():
    rng = np.random.RandomState(3)
    batch = rng.randint(0, 256, (3, 37, 53, 3)).astype(np.uint8)
    _within_one(port_metric_utils._resize_uint8(batch, 16), jax_metric_utils._resize_uint8(batch, 16))
    for shape in ((2, 64, 48, 3), (2, 50, 90, 3), (1, 224, 224, 3)):
        images = rng.randint(0, 256, shape).astype(np.uint8)
        got = pclip.openclip_preprocess_uint8(images, 32)
        ref = jclip.openclip_preprocess_uint8(images, 32, workers=1)
        _within_one(np.rint(got * 255).astype(np.uint8), np.rint(ref * 255).astype(np.uint8))


def test_frechet_distance_and_pr_match_jax():
    rng = np.random.RandomState(4)
    a = rng.randn(40, 6)
    b = rng.randn(40, 6) * 1.3 + 0.2
    cov = lambda x: np.cov(x, rowvar=False, bias=True)
    args = (a.mean(0), cov(a), b.mean(0), cov(b))
    np.testing.assert_allclose(frechet_distance(*args), jax_frechet(*args), rtol=1e-6)
    real, gen = rng.randn(50, 8).astype(np.float32), (rng.randn(30, 8) * 1.2).astype(np.float32)
    np.testing.assert_allclose(compute_pr(real, gen, device="cpu"), jax_compute_pr(real, gen),
                               rtol=1e-6)


def test_coco_dataset_from_a_directory_and_a_zip(coco_dir, tmp_path):
    zpath = str(tmp_path / "coco.zip")
    with zipfile.ZipFile(zpath, "w") as zf:
        for name in sorted(os.listdir(coco_dir))[:6]:
            zf.write(os.path.join(coco_dir, name), f"sub/{name}")
    for path, n in ((coco_dir, 24), (zpath, 3)):
        ds, ref = CocoCaptionDataset(path, resolution=32), JaxCoco(path, resolution=32)
        assert len(ds) == len(ref) == n and ds.name == ref.name
        assert ds.captions() == ref.captions()
        for i in (0, n - 1):
            img, cap = ds[i]
            rimg, rcap = ref[i]
            assert cap == rcap and img.dtype == np.uint8 and img.shape == (32, 32, 3)
            _within_one(img, rimg)
        (imgs, caps), = list(ds.batches(8, max_items=3))
        assert imgs.shape == (3, 32, 32, 3) and caps == ref.captions(3)


def _cheap_detector(images):
    """The same stand-in detector in both packages: a fixed random projection."""
    x = np.asarray(images).astype(np.float32).reshape(len(images), -1) / 255.0
    return x @ np.random.RandomState(42).randn(x.shape[1], 16).astype(np.float32)


def _np_latents(seeds, size):
    return np.stack([np.random.RandomState(s).standard_normal((size, size, 4)).astype(np.float32)
                     for s in seeds])


class _NpStacked:
    def __init__(self, seeds):
        self.seeds = list(seeds)

    def randn(self, shape):
        return _np_latents(self.seeds, shape[1])


def test_metrics_end_to_end_match_jax(pipes, scorers, coco_dir, tmp_path, monkeypatch):
    """fid_clip_test, pr_test and hpsv2 on the tiny pipeline in both packages
    from the same weights and the same noise latents (numpy draws by seed in
    both): the generated images differ by at most one uint8 step, so the
    results agree to 1e-3 relative (FID, CLIP, HPSv2) and exactly (the
    precision and recall shares)."""
    jpipe, ppipe = pipes
    js, ps = scorers
    for mod in (jax_metric_utils, jax_hpsv2):
        monkeypatch.setattr(mod, "StackedRandomGenerator", _NpStacked)
    port_latents = lambda seeds, size, device: torch.from_numpy(_np_latents(seeds, size))
    for mod in (port_metric_utils, port_hpsv2):
        monkeypatch.setattr(mod, "seeded_latents", port_latents)
    common = dict(dataset_path=coco_dir, detector=_cheap_detector, batch_size=4, num_gen=8,
                  resolution=32, verbose=False)
    jopts = JaxMetricOptions(pipe=jpipe, clip=js, cache_dir=str(tmp_path / "j"), **common)
    popts = MetricOptions(pipe=ppipe, clip=ps, cache_dir=str(tmp_path / "p"), **common)
    styles = {"photo": ["a cat", "a dog", "a tree"], "anime": ["a fox", "a boat"]}
    jopts.hpsv2_prompts = popts.hpsv2_prompts = styles
    for metric in ("fid_clip_test", "pr_test", "hpsv2"):
        ref = jax_calc_metric(metric, opts=jopts).results
        got = calc_metric(metric, opts=popts).results
        assert set(got) == set(ref), metric
        for k, v in ref.items():
            assert np.isfinite(got[k]), (metric, k)
            if metric == "pr_test":
                assert got[k] == v, (k, got[k], v)
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-3, err_msg=f"{metric}: {k}")


def test_sid_metrics_cli_on_the_cpu(small_coco_dir, tmp_path, monkeypatch):
    """The CLI on the tiny preset with the port's InceptionV3 (random
    weights): ``pr_test``, which needs no 2048-wide matrix square root."""
    monkeypatch.setenv("HOME", str(tmp_path))  # the metric stats cache
    out = tmp_path / "out"
    sid_metrics.main(["--metrics", "pr_test", "--data", small_coco_dir, "--repo_id", "tiny",
                      "--device", "cpu", "--use_bf16", "0", "--outdir", str(out), "--batch", "8",
                      "--num", "8", "--resolution", "32"])
    (line,) = (out / "metric-pr_test.jsonl").read_text().splitlines()
    rec = json.loads(line)
    assert rec["metric"] == "pr_test"
    assert 0.0 <= rec["results"]["pr_test_precision"] <= 1.0
    assert 0.0 <= rec["results"]["pr_test_recall"] <= 1.0
    assert (out / "pr_test_recall.txt").read_text().startswith("pr_test_recall: ")


def test_trainer_hook_writes_the_metric_jsonl(small_coco_dir, tmp_path, monkeypatch):
    """``metrics`` run at the snapshot ticks that are also metric ticks, on
    the EMA generator.  The stand-in detector takes the place of the default
    InceptionV3 (held to JAX above, run by the CLI test), whose 2048-wide
    covariance costs this CPU seconds of ``sqrtm``."""
    monkeypatch.setenv("HOME", str(tmp_path))  # the metric stats cache
    monkeypatch.setattr("sid_lsg_torch.metrics.detectors.inception_detector",
                        lambda weights_path=None, device="cuda": _cheap_detector)
    cfg = TrainConfig(run_dir=str(tmp_path), model="tiny", device="cpu", batch_size=2,
                      microbatch=2, total_kimg=1, kimg_per_tick=0, use_bf16=False,
                      sample_ticks=0, snapshot_ticks=1, state_dump_ticks=0, max_ticks=1,
                      metrics=["fid_test"], metric_data=small_coco_dir, metric_ticks=1)
    tr = Trainer(cfg)
    tr.run()
    (line,) = (tmp_path / "metric-fid_test.jsonl").read_text().splitlines()
    rec = json.loads(line)
    assert np.isfinite(rec["results"]["fid_test"])
    assert rec["snapshot_pkl"].startswith("network-snapshot-")
    assert tr.pipe.generator is None
