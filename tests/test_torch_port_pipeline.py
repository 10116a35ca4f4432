"""The port's slice as a whole: prompts -> text tower -> UNet -> x0 -> VAE ->
uint8 images, on the committed tiny checkpoint, against the pinned goldens
and against the JAX ``SDPipeline`` on the same latents; plus the port's
independence from JAX and its generation CLI.

Tolerances as ``tests/test_checkpoint_fixture.py``: embeddings atol 2e-4,
x0 atol 5e-4 (rtol 1e-3), decoded images within one uint8 step.
"""

import ast
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from sid_lsg_tpu.models import configs as jax_configs  # noqa: E402
from sid_lsg_tpu.models.convert import load_sd_checkpoint  # noqa: E402
from sid_lsg_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer  # noqa: E402
from sid_lsg_tpu.pipeline import SDPipeline as JaxPipeline  # noqa: E402
from sid_lsg_torch.cli import generate_onestep  # noqa: E402
from sid_lsg_torch.diffusion.rng import StackedRandomGenerator  # noqa: E402
from sid_lsg_torch.models import TINY, HashTokenizer, params_from_jax  # noqa: E402
from sid_lsg_torch.pipeline import SDPipeline  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny_hf_ckpt")


@pytest.fixture(scope="module")
def jax_params():
    unet, vae, text = load_sd_checkpoint(FIXTURE, jax_configs.TINY)
    return {"unet": unet, "vae": vae, "text": text}


@pytest.fixture(scope="module")
def port_pipe(jax_params):
    sds = {part: params_from_jax(tree, TINY, part) for part, tree in jax_params.items()}
    return SDPipeline(TINY, sds, device="cpu")


def test_golden_generation(port_pipe):
    golden = np.load(os.path.join(FIXTURE, "golden.npz"))
    emb = port_pipe.encode_prompts([str(p) for p in golden["prompts"]])
    np.testing.assert_allclose(emb.numpy(), golden["emb"], atol=2e-4, rtol=1e-3)
    x0 = port_pipe.generate_latents(torch.from_numpy(golden["latents"]), torch.from_numpy(golden["emb"]))
    np.testing.assert_allclose(x0.numpy(), golden["x0"], atol=5e-4, rtol=1e-3)
    imgs = port_pipe.decode(torch.from_numpy(golden["x0"]))
    assert imgs.dtype == torch.uint8 and tuple(imgs.shape) == golden["images"].shape
    diff = np.abs(imgs.numpy().astype(np.int32) - golden["images"].astype(np.int32))
    assert diff.max() <= 1, f"decoded images drifted (max uint8 delta {diff.max()})"


def test_generate_matches_jax_pipeline(port_pipe, jax_params):
    prompts = ["a red fox in the snow", "two boats at dawn", ""]
    latents = np.random.default_rng(21).standard_normal((3, 8, 8, 4)).astype(np.float32)
    ref = JaxPipeline(jax_configs.TINY, jax_params, JaxHashTokenizer(vocab_size=TINY.text.vocab_size))
    assert (HashTokenizer(TINY.text.vocab_size)(prompts) == ref.tokenizer(prompts)).all()
    ref_x0 = ref.generate_latents(jnp.asarray(latents), ref.encode_prompts(prompts))
    x0 = port_pipe.generate_latents(torch.from_numpy(latents), port_pipe.encode_prompts(prompts))
    np.testing.assert_allclose(x0.numpy(), np.asarray(ref_x0), atol=5e-4, rtol=1e-3)
    ref_imgs = ref.generate(prompts, jnp.asarray(latents)).astype(np.int32)
    imgs = port_pipe.generate(prompts, torch.from_numpy(latents)).numpy().astype(np.int32)
    assert np.abs(imgs - ref_imgs).max() <= 1


def test_port_imports_without_jax():
    """The port imports with the JAX package and what the card's machine
    lacks (``regex``, ``PIL``, ``safetensors``, ``click``) blocked."""
    blocked = ("jax", "flax", "sid_lsg_tpu", "regex", "PIL", "safetensors", "click")
    code = (
        "import sys\n"
        f"for name in {blocked!r}:\n"
        f"    sys.modules[name] = None\n"
        "import sid_lsg_torch, sid_lsg_torch.pipeline, sid_lsg_torch.ops, sid_lsg_torch.models\n"
        "import sid_lsg_torch.cli.generate_onestep, sid_lsg_torch.cli.encode_latents\n"
        "import sid_lsg_torch.cli.sid_train, sid_lsg_torch.training.loop\n"
        "import sid_lsg_torch.models.tokenizer, sid_lsg_torch.runtime.checkpoint\n"
        "import sid_lsg_torch.metrics, sid_lsg_torch.metrics.detectors\n"
        "import sid_lsg_torch.cli.sid_metrics, sid_lsg_torch.data.mscoco\n"
        "import sid_lsg_torch.cli.cocodataset_tool, sid_lsg_torch.cli.dataset_tool\n"
        "import sid_lsg_torch.models.inception, sid_lsg_torch.models.clip_vision\n"
        "import sid_lsg_torch.utils.misc, sid_lsg_torch.utils.resample\n"
        "import sid_lsg_torch.models.edm_networks, sid_lsg_torch.models.stylegan_t\n"
        "import sid_lsg_torch.ops.upfirdn2d, sid_lsg_torch.ops.resample_conv\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {blocked!r}\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_no_port_function_defaults_to_the_cpu():
    """Every function and constructor of the port with a ``device``
    parameter defaults to the card (or to torch's default device), never to
    the CPU: the CPU is only where the caller asks for it."""
    import importlib
    import inspect
    import pkgutil

    import sid_lsg_torch

    found = []
    for info in pkgutil.walk_packages(sid_lsg_torch.__path__, "sid_lsg_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            fns = ([obj] if inspect.isfunction(obj) else
                   [v for v in vars(obj).values() if inspect.isfunction(v)]
                   if inspect.isclass(obj) else [])
            for fn in fns:
                for pname, p in inspect.signature(fn).parameters.items():
                    if "device" in pname and str(p.default) == "cpu":
                        found.append(f"{info.name}.{fn.__qualname__}({pname})")
    assert not found, found


def test_port_sources_import_nothing_of_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "sid_lsg_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # kernel build outputs, not sources
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "flax", "sid_lsg_tpu"), (path, m)


def _read_png(path):
    """Minimal decoder for the writer's format: 8-bit RGB, filter-0 rows."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 2) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + w * 3)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_generate_cli_writes_each_seed_png(tmp_path):
    out = tmp_path / "imgs"
    generate_onestep.main(["--outdir", str(out), "--seeds", "3-5", "--batch", "2", "--repo_id", "tiny",
                           "--use_bf16", "false", "--device", "cpu",
                           "--text_prompts", str(tmp_path / "none.txt")])
    assert sorted(os.listdir(out)) == ["000003.png", "000004.png", "000005.png"]
    pipe = SDPipeline.random_init("tiny", device="cpu")
    latents = StackedRandomGenerator([3, 4], "cpu").randn((2, 4, 8, 8)).permute(0, 2, 3, 1)
    expect = pipe.generate(["", ""], latents).numpy()
    for seed, img in zip((3, 4), expect):
        np.testing.assert_array_equal(_read_png(out / f"{seed:06d}.png"), img)
