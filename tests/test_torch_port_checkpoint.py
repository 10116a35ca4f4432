"""Checkpoint loading of the port on the CPU, against the JAX package and the
committed tiny HF fixture.

Checked: ``SDPipeline.from_pretrained`` on the fixture (strict keys, the
fixture's config, ``golden.npz`` at the fixture test's tolerances, and a
transposed ``conv_in`` that does not reproduce it); ``read_safetensors``
against the ``safetensors`` package; the published files' layout quirks
(legacy VAE attention names, the text tower without its prefix, a
``position_ids`` buffer) and a strict refusal of an unknown key;
``config_from_hf_json`` against JAX's; the VAE encoder's moments against
JAX's; ``CLIPTokenizer`` ids against JAX's (and the word split against the
``regex`` package's on every assigned code point); ``load_generator_params``
on the port's export, the JAX package's export and a reference pickle;
``read_png`` against Pillow; ``encode_latents`` into a corpus that
``LatentDataset`` reads; the ``Trainer`` resumed from a generator file; and
a JAX orbax dump (the plain ``SiDState`` and the pixel judge's
``{'state', 'spectral'}``) carried by ``scripts/jax_dump_to_torch.py`` and
resumed bit for bit, with the port's refusals of an orbax dump naming it.

Only this test imports ``safetensors``, ``PIL`` and ``regex`` (as the JAX
side does): the port itself imports none of them.
"""

import io
import json
import os
import shutil
import struct
import sys
import types
import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402
from safetensors.numpy import load_file  # noqa: E402

from sid_lsg_tpu.models import configs as jconfigs  # noqa: E402
from sid_lsg_tpu.models import tokenizer as jtokenizer  # noqa: E402
from sid_lsg_tpu.models.convert import convert_unet, load_sd_checkpoint as jax_load_sd  # noqa: E402
from sid_lsg_tpu.models.vae import AutoencoderKL as JaxVAE  # noqa: E402
from sid_lsg_tpu.runtime import checkpoint as jcheckpoint  # noqa: E402
from sid_lsg_torch.cli import encode_latents  # noqa: E402
from sid_lsg_torch.cli.pngio import read_png, write_png  # noqa: E402
from sid_lsg_torch.data.latents import LatentDataset  # noqa: E402
from sid_lsg_torch.models import configs  # noqa: E402
from sid_lsg_torch.models.convert import load_sd_checkpoint, unet_params_from_jax  # noqa: E402
from sid_lsg_torch.models.tokenizer import CLIPTokenizer, _split_words  # noqa: E402
from sid_lsg_torch.models.vae import AutoencoderKL  # noqa: E402
from sid_lsg_torch.pipeline import SDPipeline  # noqa: E402
from sid_lsg_torch.runtime.checkpoint import (  # noqa: E402
    export_generator,
    load_generator_params,
    read_safetensors,
    write_safetensors,
)
from sid_lsg_torch.training.loop import Trainer, TrainConfig, resume_training_state  # noqa: E402

torch.set_num_threads(2)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_hf_ckpt")
FILES = {"unet": "unet/diffusion_pytorch_model.safetensors",
         "vae": "vae/diffusion_pytorch_model.safetensors",
         "text": "text_encoder/model.safetensors"}


@pytest.fixture(scope="module")
def pipe():
    return SDPipeline.from_pretrained(FIXTURE, device="cpu")


def _copy_fixture(tmp_path):
    dst = tmp_path / "ckpt"
    shutil.copytree(FIXTURE, dst)
    return dst


def _rewrite(path, fn):
    """Rewrite a safetensors file through ``fn(state dict) -> state dict`` (f16)."""
    sd = fn(read_safetensors(str(path)))
    write_safetensors({k: v.half() for k, v in sd.items()}, str(path))


def _perturbed_unet(seed):
    g = torch.Generator().manual_seed(seed)
    return {k: v + 0.05 * torch.randn(v.shape, generator=g)
            for k, v in sorted(read_safetensors(os.path.join(FIXTURE, FILES["unet"])).items())}


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k].float()), k


def test_from_pretrained_reproduces_the_golden(pipe, tmp_path):
    cfg = pipe.config
    assert (cfg.unet, cfg.vae, cfg.text) == (configs.TINY.unet, configs.TINY.vae, configs.TINY.text)
    assert (cfg.prediction_type, cfg.resolution) == (configs.TINY.prediction_type,
                                                     configs.TINY.resolution)
    golden = np.load(os.path.join(FIXTURE, "golden.npz"))
    emb = pipe.encode_prompts([str(p) for p in golden["prompts"]])
    np.testing.assert_allclose(emb.numpy(), golden["emb"], atol=2e-4, rtol=1e-3)
    x0 = pipe.generate_latents(torch.from_numpy(golden["latents"]), torch.from_numpy(golden["emb"]))
    np.testing.assert_allclose(x0.numpy(), golden["x0"], atol=5e-4, rtol=1e-3)
    imgs = pipe.decode(torch.from_numpy(golden["x0"])).numpy().astype(np.int32)
    assert np.abs(imgs - golden["images"].astype(np.int32)).max() <= 1
    # A copy whose conv_in kernel is transposed (H <-> W) does not reproduce it.
    ckpt = _copy_fixture(tmp_path)
    _rewrite(ckpt / FILES["unet"], lambda sd: {
        **sd, "conv_in.weight": sd["conv_in.weight"].transpose(2, 3).contiguous()})
    bad = SDPipeline.from_pretrained(str(ckpt), device="cpu")
    x0_bad = bad.generate_latents(torch.from_numpy(golden["latents"]),
                                  torch.from_numpy(golden["emb"]))
    assert not np.allclose(x0_bad.numpy(), golden["x0"], atol=5e-4, rtol=1e-3)


def test_from_pretrained_refuses_what_is_not_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="not a local checkpoint directory"):
        SDPipeline.from_pretrained(str(tmp_path / "typo"), device="cpu")
    pipe = SDPipeline.from_pretrained("random:tiny", device="cpu")
    assert pipe.config == configs.TINY


def test_bf16_pipeline_holds_its_f32_parameters_exactly():
    """The norms and the VAE mid attentions keep f32 parameters in a bf16
    pipeline (as the JAX package keeps f32 params): they hold the loaded
    values, not their bf16 rounding."""
    sds = load_sd_checkpoint(FIXTURE)
    sds["unet"]["conv_norm_out.weight"] = sds["unet"]["conv_norm_out.weight"] + 2.0 ** -12
    key = "encoder.mid_block.attentions.0.to_q.weight"
    sds["vae"][key] = sds["vae"][key] * (1.0 + 2.0 ** -12)
    pipe = SDPipeline(configs.TINY, sds, dtype=torch.bfloat16, device="cpu")
    assert pipe.unet.conv_out.weight.dtype == torch.bfloat16
    assert torch.equal(pipe.unet.conv_norm_out.weight, sds["unet"]["conv_norm_out.weight"])
    assert torch.equal(pipe.vae.state_dict()[key], sds["vae"][key])
    assert not torch.equal(sds["vae"][key].bfloat16().float(), sds["vae"][key])


def test_pipeline_inputs_are_nchw_in_memory(pipe):
    """``generate_latents``, ``decode`` and ``encode_images`` hand their
    models NCHW-contiguous inputs whatever the caller's strides (cuDNN rounds
    channels-last convolutions differently in bf16)."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda _, args: seen.append(args[0].is_contiguous()))
             for m in (pipe.unet.conv_in, pipe.vae.post_quant_conv, pipe.vae.encoder.conv_in)]
    try:
        lat = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(0))
        pipe.generate_latents(lat, pipe.encode_prompts(["a", "b"]))
        pipe.decode(lat)
        pipe.encode_images(torch.zeros(2, 16, 16, 3, dtype=torch.uint8))
    finally:
        for h in hooks:
            h.remove()
    assert seen == [True, True, True]


def test_read_safetensors_matches_the_safetensors_package(tmp_path):
    for rel in FILES.values():
        path = os.path.join(FIXTURE, rel)
        ref, got = load_file(path), read_safetensors(path)
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k].dtype == torch.float32 and tuple(got[k].shape) == v.shape
            assert got[k].half().numpy().tobytes() == v.tobytes(), k
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).bfloat16()
    path = str(tmp_path / "bf16.safetensors")
    write_safetensors({"x": x, "y": x.float()}, path)
    back = read_safetensors(path)
    assert torch.equal(back["x"], x.float()) and torch.equal(back["y"], x.float())
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    assert {k: v["dtype"] for k, v in header.items()} == {"x": "BF16", "y": "F32"}
    # Another dtype, and offsets past the end of the file, raise.
    head = json.dumps({"i": {"dtype": "F64", "shape": [1], "data_offsets": [0, 8]}}).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + bytes(8))
    with pytest.raises(ValueError, match="F64"):
        read_safetensors(path)
    head = json.dumps({"f": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + bytes(8))
    with pytest.raises(ValueError, match="offsets"):
        read_safetensors(path)


def test_layout_quirks_load_to_the_same_state_dicts(tmp_path):
    """The published SD1.5 files: the VAE mid attentions under query / key /
    value / proj_attn, the text tower with a position_ids buffer; a text
    tower without its prefix loads too.  An unknown UNet key raises."""
    want = load_sd_checkpoint(FIXTURE)
    ckpt = _copy_fixture(tmp_path)
    legacy = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}

    def rename_vae(sd):
        out = {}
        for k, v in sd.items():
            for new, old in legacy.items():
                k = k.replace(f"attentions.0.{new}.", f"attentions.0.{old}.")
            out[k] = v
        return out

    _rewrite(ckpt / FILES["vae"], rename_vae)
    assert any(".query." in k for k in read_safetensors(str(ckpt / FILES["vae"])))
    text = read_safetensors(str(ckpt / FILES["text"]))
    write_safetensors({**{k: v.half() for k, v in text.items()},
                       "text_model.embeddings.position_ids": torch.arange(77)[None]},
                      str(ckpt / FILES["text"]))
    ids = load_file(str(ckpt / FILES["text"]))["text_model.embeddings.position_ids"]
    assert ids.dtype == np.int64
    _assert_same(load_sd_checkpoint(str(ckpt))["vae"], want["vae"])
    _assert_same(load_sd_checkpoint(str(ckpt))["text"], want["text"])
    _rewrite(ckpt / FILES["text"], lambda sd: {k[len("text_model."):]: v for k, v in sd.items()})
    got = load_sd_checkpoint(str(ckpt))
    for part in ("unet", "vae", "text"):
        _assert_same(got[part], want[part])
    # The JAX loader reads the rewritten directory to the same weights.
    jax_vae = jax_load_sd(str(ckpt), jconfigs.TINY)[1]
    np.testing.assert_array_equal(
        np.asarray(jax_vae["encoder"]["mid_attn"]["attn"]["to_q"]["kernel"]),
        want["vae"]["encoder.mid_block.attentions.0.to_q.weight"].numpy().T)
    pipe = SDPipeline.from_pretrained(str(ckpt), device="cpu")
    assert torch.equal(pipe.vae.decoder.mid_block["attentions"][0].to_q.weight,
                       want["vae"]["decoder.mid_block.attentions.0.to_q.weight"])
    _rewrite(ckpt / FILES["unet"], lambda sd: {**sd, "conv_in.extra": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="conv_in.extra"):
        SDPipeline.from_pretrained(str(ckpt), device="cpu")


@pytest.mark.parametrize("preset", ["fixture", "sd15", "sd21base", "sd21base_no_text"])
def test_config_from_hf_json_matches_jax(tmp_path, preset):
    if preset == "fixture":
        model_dir = FIXTURE
    else:
        model_dir = str(tmp_path / preset)
        configs.write_hf_config_jsons(model_dir, configs.PRESETS[preset.split("_")[0]])
        if preset.endswith("no_text"):
            shutil.rmtree(os.path.join(model_dir, "text_encoder"))
    got, ref = configs.config_from_hf_json(model_dir), jconfigs.config_from_hf_json(model_dir)
    for part in ("unet", "vae", "text"):
        assert vars(getattr(got, part)) == vars(getattr(ref, part)), part
    assert (got.name, got.prediction_type, got.resolution) == (ref.name, ref.prediction_type,
                                                               ref.resolution)
    if preset != "fixture":
        want = configs.PRESETS[preset.split("_")[0]]
        assert (got.unet, got.vae, got.text) == (want.unet, want.vae, want.text)
    assert vars(configs.scaled_unet_config(got.unet, 0.5)) == vars(
        jconfigs.scaled_unet_config(ref.unet, 0.5))


def test_encode_moments_match_jax(pipe):
    x = np.random.default_rng(3).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    vae = JaxVAE(jconfigs.TINY.vae)
    params = jax_load_sd(FIXTURE, jconfigs.TINY)[1]
    moments = jax.jit(lambda p, a: vae.apply({"params": p}, a, method=vae.encode_moments))
    mean_ref, logvar_ref = moments(params, jnp.asarray(x))
    port = AutoencoderKL(configs.TINY.vae)
    port.load_state_dict(load_sd_checkpoint(FIXTURE)["vae"], strict=True)
    with torch.no_grad():
        mean, logvar = port.encode_moments(torch.from_numpy(x).permute(0, 3, 1, 2))
    for got, ref in ((mean, mean_ref), (logvar, logvar_ref)):
        assert tuple(got.shape) == (2, 4, 8, 8)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-4,
                                   rtol=1e-3)
    # encode: the mean without a generator, a draw around it with one.
    with torch.no_grad():
        assert torch.equal(port.encode(torch.from_numpy(x).permute(0, 3, 1, 2)), mean)
        draw = port.encode(torch.from_numpy(x).permute(0, 3, 1, 2),
                           torch.Generator().manual_seed(0))
    assert not torch.equal(draw, mean) and draw.shape == mean.shape


PROMPTS = [
    "A photo of an astronaut riding a horse on the moon",
    "x² + ½ = Ⅻ, 3.14 and 2025!!",
    "café and café",  # é composed and decomposed
    "東京の夜景 🚀🌕 emoji",
    "DON'T stop: it's Bob's, we'll, they've, I'm, you'd, 're",
    "fish &amp; chips &amp;amp; &lt;b&gt; <|startoftext|> a<|endoftext|>b",
    "  tabs\tand\nnewlines  ſ'ſ 'ſ ",
    "a very long prompt " * 30,
    "",
]


def _write_vocab(d, pad_token):
    """A small CLIP vocab: the 512 byte tokens, the two specials and merges
    learnt from a few words."""
    os.makedirs(d, exist_ok=True)
    byte_chars = list(jtokenizer.bytes_to_unicode().values())
    vocab = byte_chars + [c + "</w>" for c in byte_chars]
    merges = ["t h", "th e</w>", "a n", "o n</w>", "r i", "h o", "s t", "st o", "e r</w>",
              "a s", "i n", "in g</w>", "t r", "o n", "m o", "o </w>", "d o", "n '", "' t</w>"]
    for m in merges:
        vocab.append(m.replace(" ", ""))
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({tok: i for i, tok in enumerate(vocab)}, f)
    with open(os.path.join(d, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    if pad_token is not None:
        with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
            json.dump({"pad_token": pad_token}, f)


@pytest.mark.parametrize("pad_token", [None, "!", {"content": "!", "lstrip": False}])
def test_clip_tokenizer_matches_jax(tmp_path, pad_token):
    d = str(tmp_path / "tokenizer")
    _write_vocab(d, pad_token)
    got, ref = CLIPTokenizer(d), jtokenizer.CLIPTokenizer(d)
    assert got.pad_token_id == ref.pad_token_id == (ref.eos_token_id if pad_token is None else 0)
    for p in PROMPTS:
        assert got.encode(p) == ref.encode(p), p
    np.testing.assert_array_equal(got(PROMPTS), ref(PROMPTS))
    if pad_token is None:
        # The word split equals the regex package's on every code point that
        # the interpreter's Unicode database assigns, side by side and apart.
        import unicodedata

        chars = [chr(c) for c in range(0x110000)
                 if unicodedata.category(chr(c)) not in ("Cn", "Cs") and not chr(c).isspace()]
        for sep in ("", " "):
            text = sep.join(chars).lower()
            assert _split_words(text) == ref.pat.findall(text), repr(sep)


def test_load_generator_params_reads_three_sources(tmp_path, pipe):
    hf = _perturbed_unet(1)
    cfg = configs.TINY.unet
    # The port's own export.
    export_generator(hf, str(tmp_path / "port.safetensors"))
    _assert_same(load_generator_params(str(tmp_path / "port.safetensors"), cfg), hf)
    # The JAX package's export (flax paths, HWIO kernels).
    jparams = convert_unet({k: v.numpy() for k, v in hf.items()}, jconfigs.TINY.unet)
    jcheckpoint.export_generator(jparams, str(tmp_path / "jax.safetensors"))
    got = load_generator_params(str(tmp_path / "jax.safetensors"), cfg)
    _assert_same(got, unet_params_from_jax(jparams, cfg))
    _assert_same(got, hf)
    # A reference pickle {'ema': module} whose class is gone at load time.
    mod = types.ModuleType("diffusers")
    sys.modules["diffusers"] = mod

    class UNet2DConditionModel(torch.nn.Module):
        pass

    UNet2DConditionModel.__module__ = "diffusers"
    UNet2DConditionModel.__qualname__ = "UNet2DConditionModel"
    mod.UNet2DConditionModel = UNet2DConditionModel
    try:
        ema = UNet2DConditionModel()
        for k, v in hf.items():
            *path, name = k.split(".")
            owner = ema
            for p in path:
                if p not in owner._modules:
                    owner.add_module(p, torch.nn.Module())
                owner = owner._modules[p]
            owner.register_parameter(name, torch.nn.Parameter(v.clone()))
        torch.save({"ema": ema}, str(tmp_path / "network-snapshot.pkl"))
    finally:
        del sys.modules["diffusers"]
    _assert_same(load_generator_params(str(tmp_path / "network-snapshot.pkl"), cfg), hf)
    assert "diffusers" not in sys.modules
    # Refusals: a directory (it names the orbax converter) and a file with a key too many.
    with pytest.raises(ValueError, match="scripts/jax_dump_to_torch.py"):
        load_generator_params(str(tmp_path), cfg)
    export_generator({**hf, "extra.weight": torch.zeros(1)}, str(tmp_path / "extra.safetensors"))
    with pytest.raises(KeyError, match="extra.weight"):
        load_generator_params(str(tmp_path / "extra.safetensors"), cfg)
    # load_generator: the pipeline samples with the generator, the teacher stays.
    teacher = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    lat = torch.from_numpy(
        np.random.default_rng(4).standard_normal((2, 8, 8, 4)).astype(np.float32))
    emb = pipe.encode_prompts(["a", "b"])
    gen = SDPipeline(configs.TINY, {**load_sd_checkpoint(FIXTURE), "unet": hf}, device="cpu")
    pipe.load_generator(str(tmp_path / "jax.safetensors"))
    try:
        assert torch.equal(pipe.generate_latents(lat, emb), gen.generate_latents(lat, emb))
        _assert_same(pipe.unet.state_dict(), teacher)
    finally:
        pipe.generator = None


def _filtered_png(img, kinds):
    """PNG bytes of ``img`` (H, W, C) with row y filtered by kinds[y % len]."""
    h, w, ch = img.shape
    color = {1: 0, 3: 2, 4: 6}[ch]
    rows, prev = [], np.zeros(w * ch, np.int32)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        kind = kinds[y % len(kinds)]
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            pa, pb = np.abs(prev - upleft), np.abs(left - upleft)
            pc = np.abs(left + prev - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_read_png_matches_pillow(tmp_path, mode):
    ch = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    rs = np.random.RandomState(ch)
    smooth = (np.linspace(0, 200, 23)[None, :, None] + np.linspace(0, 50, 19)[:, None, None]
              + 40 * np.arange(ch)[None, None, :])
    img = np.clip(smooth + rs.randint(0, 6, (19, 23, ch)), 0, 255).astype(np.uint8)
    img[::5] = rs.randint(0, 256, img[::5].shape)
    pil_img = Image.fromarray(img[..., 0] if ch == 1 else img, mode)
    pil_path = str(tmp_path / f"pillow_{mode}.png")
    pil_img.save(pil_path)
    hand_path = str(tmp_path / f"filters_{mode}.png")
    with open(hand_path, "wb") as f:
        f.write(_filtered_png(img, [0, 1, 2, 3, 4]))
    for path in (pil_path, hand_path):
        with Image.open(path) as im:
            ref = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(read_png(path), ref)
    with Image.open(hand_path) as im:
        np.testing.assert_array_equal(np.asarray(im), img[..., 0] if ch == 1 else img)
    # What the reader does not take raises.
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if ch == 1 else img, mode).convert("P").save(buf, format="PNG")
    with open(str(tmp_path / "p.png"), "wb") as f:
        f.write(buf.getvalue())
    with pytest.raises(ValueError, match="colour type 3"):
        read_png(str(tmp_path / "p.png"))


def test_encode_latents_writes_a_corpus_the_dataset_reads(tmp_path, pipe):
    src = tmp_path / "imgs"
    src.mkdir()
    rs = np.random.RandomState(5)
    imgs = rs.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8)
    for i, img in enumerate(imgs):
        write_png(str(src / f"{i:06d}.png"), img)
        (src / f"{i:06d}.txt").write_text(f"caption {i}\n")
    dest = str(tmp_path / "corpus.npz")
    sidecar = encode_latents.main(["--source", str(src), "--dest", dest, "--repo_id", FIXTURE,
                                   "--batch", "2", "--use_bf16", "0", "--device", "cpu"])
    ds = LatentDataset(dest)
    assert len(ds) == 3 and [ds[i][1] for i in range(3)] == ["caption 0", "caption 1", "caption 2"]
    assert np.load(sidecar).dtype == np.float16 and ds.latents.shape == (3, 8, 8, 4)
    want = pipe.encode_images(torch.from_numpy(imgs)).numpy().astype(np.float16)
    np.testing.assert_array_equal(np.asarray(ds.latents), want)
    # A corpus of two resolutions is refused.
    write_png(str(src / "000003.png"), np.zeros((8, 8, 3), np.uint8))
    (src / "000003.txt").write_text("small")
    with pytest.raises(ValueError, match="one resolution"):
        encode_latents.main(["--source", str(src), "--dest", dest, "--repo_id", FIXTURE,
                             "--device", "cpu", "--use_bf16", "0"])


@pytest.mark.parametrize("lora", [False, True])
def test_trainer_resumes_from_a_generator_file(tmp_path, lora):
    hf = _perturbed_unet(2)
    path = str(tmp_path / "network-snapshot-1-000010.safetensors")
    export_generator(hf, path)
    tr = Trainer(TrainConfig(model=FIXTURE, resume=path, device="cpu", batch_size=2, microbatch=2,
                             total_kimg=1, kimg_per_tick=0, state_dump_ticks=0, use_bf16=False,
                             fake_score_use_lora=lora))
    st = tr.state
    _assert_same({k: v.detach() for k, v in st.params_G.items()}, hf)
    _assert_same(st.ema, hf)
    _assert_same(tr.teacher, load_sd_checkpoint(FIXTURE)["unet"])
    if lora:
        assert set(st.params_fake) and all(k.endswith((".a", ".b")) for k in st.params_fake)
    else:
        _assert_same({k: v.detach() for k, v in st.params_fake.items()}, hf)
        ptr = lambda tree: tree["conv_in.weight"].data_ptr()
        assert ptr(st.params_fake) != ptr(st.params_G)
        # A run directory is a training state, not a generator file: the
        # Trainer starts from the checkpoint, and the resume finds no dump.
        (tmp_path / "checkpoints").mkdir()
        tr_dir = Trainer(TrainConfig(model=FIXTURE, resume=str(tmp_path), device="cpu",
                                     batch_size=2, microbatch=2, total_kimg=1, kimg_per_tick=0,
                                     state_dump_ticks=0))
        _assert_same(tr_dir.state.ema, load_sd_checkpoint(FIXTURE)["unet"])
        with pytest.raises(FileNotFoundError, match="no training-state dump"):
            resume_training_state(tr_dir)


def _jax_dump(run_dir, sida):
    """A tiny JAX training state with every leaf drawn from a numpy seed (no
    JAX step compiled), saved through the JAX ``CheckpointManager`` as the
    JAX ``Trainer`` saves it; returns (the state's numpy tree, the step).
    Without the judge both optimizers keep the low-memory state (no first
    moment, the second in bf16)."""
    from sid_lsg_tpu.training.state import init_state, make_optimizer

    params = convert_unet({k: v.numpy() for k, v in _perturbed_unet(5).items()},
                          jconfigs.TINY.unet)
    fake, spectral = None, None
    if sida:
        from sid_lsg_tpu.models.stylegan_discriminator import TINY_VIT, ProjectedDiscriminator

        res, text_dim = jconfigs.TINY.resolution, jconfigs.TINY.unet.cross_attention_dim
        disc = ProjectedDiscriminator(c_dim=text_dim, vit=TINY_VIT, power_iters=3)
        dvars = jax.tree_util.tree_map(  # shapes only: every leaf is drawn below
            lambda v: np.zeros(v.shape, v.dtype),
            jax.eval_shape(disc.init, jax.random.PRNGKey(6), jnp.zeros((1, 3, res, res)),
                           jnp.zeros((1, text_dim))))
        fake = {"psi": params, "disc": {k: v for k, v in dvars["params"].items() if k != "dino"}}
        spectral = dict(dvars["spectral"])
    opt = make_optimizer(low_mem_state=not sida)
    state = init_state(params, opt, opt, params_fake=fake)
    rs = np.random.RandomState(7)
    draw = lambda a: (np.asarray(rs.randint(1, 1000), a.dtype) if np.ndim(a) == 0
                      else rs.standard_normal(np.shape(a)).astype(a.dtype))
    state = jax.tree_util.tree_map(draw, state)
    tree = state if not sida else {"state": state, "spectral": jax.tree_util.tree_map(draw, spectral)}
    step = int(state.step)
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "training_options.json"), "w") as f:
        json.dump({"model": "tiny"}, f)
    mgr = jcheckpoint.CheckpointManager(os.path.join(run_dir, "checkpoints"))
    mgr.save(step, tree)
    mgr.wait()
    mgr.close()
    return jax.tree_util.tree_map(np.asarray, tree), step


@pytest.mark.parametrize("sida", [False, True], ids=["plain_low_mem", "sida_dino"])
def test_jax_orbax_dump_resumes_in_the_port_bit_for_bit(tmp_path, sida):
    from sid_lsg_torch.models.convert import disc_params_from_jax
    from sid_lsg_tpu.models.convert import export_unet

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    try:
        import jax_dump_to_torch
    finally:
        sys.path.pop(0)
    jdir, pdir = str(tmp_path / "jax_run"), str(tmp_path / "port_run")
    tree, step = _jax_dump(jdir, sida)
    base = dict(model="tiny", device="cpu", batch_size=2, microbatch=2, total_kimg=1,
                kimg_per_tick=0, state_dump_ticks=0, use_bf16=False, seed=3,
                low_mem_opt=not sida)
    if sida:
        base.update(adv_weight_G=0.1, adv_weight_D=0.1, adv_tower="dino", adv_vit="tiny")

    # The port refuses the orbax dump itself, naming the script.
    tr = Trainer(TrainConfig(run_dir=str(tmp_path / "r0"), resume=jdir, **base))
    with pytest.raises(ValueError, match="scripts/jax_dump_to_torch.py"):
        resume_training_state(tr)
    with pytest.raises(ValueError, match="scripts/jax_dump_to_torch.py"):
        Trainer(TrainConfig(run_dir=jdir, resume="latest", **base)).restore_state()
    with pytest.raises(ValueError, match="scripts/jax_dump_to_torch.py"):
        load_generator_params(os.path.join(jdir, "checkpoints", str(step)), configs.TINY.unet)

    path = jax_dump_to_torch.main([jdir, pdir])
    assert path == os.path.join(pdir, "checkpoints", str(step), "state.pt")
    tr = Trainer(TrainConfig(run_dir=str(tmp_path / "r1"), resume=pdir, **base))
    rng_before = tr.generator.get_state()
    resume_training_state(tr)
    st, jst = tr.state, tree["state"] if sida else tree
    assert torch.equal(tr.generator.get_state(), rng_before)  # starts from its seed

    def want(part):  # the JAX tree under the port's names: the JAX exporter's HF keys
        if sida and "psi" in part:
            heads = disc_params_from_jax(part["disc"], None, None)
            return {**export_unet(part["psi"], jconfigs.TINY.unet),
                    **{"disc." + k: v.numpy() for k, v in heads.items()}}
        return export_unet(part, jconfigs.TINY.unet)

    def same(got, part):
        if part is None:  # the low-memory state's first moment
            assert got is None
            return
        ref = want(part)
        assert sorted(got) == sorted(ref)
        for k, v in got.items():
            assert str(v.dtype).split(".")[1] == str(np.asarray(ref[k]).dtype), k
            assert torch.equal(v.detach().float(),
                               torch.from_numpy(np.asarray(ref[k], np.float32))), k

    assert (st.step, st.nimg) == (int(jst.step), float(jst.nimg))
    for name in ("params_G", "params_fake", "ema"):
        same(getattr(st, name), getattr(jst, name))
    for name in ("opt_G", "opt_fake"):
        adam = next(a for a in jax.tree_util.tree_leaves(
            getattr(jst, name), is_leaf=lambda a: hasattr(a, "nu")) if hasattr(a, "nu"))
        assert getattr(st, name).count == int(adam.count)
        same(getattr(st, name).mu, adam.mu)
        same(getattr(st, name).nu, adam.nu)
    if sida:
        from sid_lsg_torch.models.stylegan_discriminator import spectral_buffers

        u = spectral_buffers(tr.disc)
        ref = {k: v for k, v in disc_params_from_jax(jst.params_fake["disc"], tree["spectral"],
                                                     None).items() if k.endswith(".u")}
        assert sorted(u) == sorted(ref) and u
        for k in u:
            assert torch.equal(u[k], ref[k]), k
