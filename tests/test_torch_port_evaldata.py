"""The eval-data tools of the port against the JAX package, on the CPU.

Every CLI of the port takes the JAX click command's options (long names,
defaults, flag or value), plus ``--device``.  ``cocodataset_tool``,
``dataset_tool`` and ``generate_onestep``'s npz packer give the JAX tools'
outputs on the same inputs: the pixels as Pillow reads them, bit for bit, the
caption texts, names, counts, ``dataset.json`` and ``arr_0``; their refusals
give the same messages and exit codes.  The inputs are made here from a numpy
seed and written by Pillow (PNG, JPEG), ``zipfile``, ``tarfile`` and ``gzip``.
The JAX tools run in-process and use Pillow alone, so no JAX model compiles.
"""

import importlib

import pytest

pytest.importorskip("jax")
click = pytest.importorskip("click")

# port CLI module -> the JAX package's module of the same name
CLIS = ("generate_onestep", "sid_train", "sid_metrics", "encode_latents", "cocodataset_tool",
        "dataset_tool")


def _click_options(cmd) -> dict:
    """long option name -> (default, is a flag, required) of a click command."""
    out = {}
    for p in cmd.params:
        (name,) = [o for o in p.opts if o.startswith("--")]
        default = p.default
        if default is None or type(default).__name__ == "Sentinel":  # click's UNSET
            default = False if p.is_flag else None
        out[name] = (default, bool(p.is_flag), bool(p.required))
    return out


def _argparse_options(parser) -> dict:
    out = {}
    for a in parser._actions:
        longs = [o for o in a.option_strings if o.startswith("--")]
        if not longs or longs[0] == "--help":
            continue
        (name,) = longs
        out[name] = (a.default, a.nargs == 0, bool(a.required))
    return out


@pytest.mark.parametrize("name", CLIS)
def test_every_port_cli_takes_the_jax_flags(name):
    jax_cmd = importlib.import_module(f"sid_lsg_tpu.cli.{name}").main
    port = importlib.import_module(f"sid_lsg_torch.cli.{name}")
    want, got = _click_options(jax_cmd), _argparse_options(port.build_parser())
    extra = set(got) - set(want)
    assert extra <= {"--device"}, f"{name}: options JAX lacks: {sorted(extra)}"
    assert set(want) <= set(got), f"{name}: JAX options the port lacks: {sorted(set(want) - set(got))}"
    differ = {k: (want[k], got[k]) for k in want if want[k] != got[k]}
    assert not differ, f"{name}: (default, flag, required) JAX vs port: {differ}"
    if "--device" in got:
        assert got["--device"] == ("cuda", False, False)


# --- inputs, made from a numpy seed -------------------------------------------------------

import gzip  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import sys  # noqa: E402
import tarfile  # noqa: E402
import zipfile  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

Image = pytest.importorskip("PIL.Image")

from sid_lsg_tpu.cli import cocodataset_tool as jax_coco  # noqa: E402
from sid_lsg_tpu.cli import dataset_tool as jax_dataset  # noqa: E402
from sid_lsg_tpu.cli import generate_onestep as jax_generate  # noqa: E402
from sid_lsg_torch.cli import cocodataset_tool, dataset_tool, generate_onestep  # noqa: E402
from sid_lsg_torch.cli.pngio import read_png, write_png  # noqa: E402

torch.set_num_threads(2)
RNG_SEED = 17
# (file name, (width, height), Pillow mode); JPEGs and a grey PNG among them
SOURCES = (("b.png", (37, 23), "RGB"), ("a.jpg", (64, 48), "RGB"), ("sub/c.png", (48, 64), "L"),
           ("d.png", (300, 200), "RGB"), ("e.jpeg", (23, 37), "RGB"), ("f.png", (64, 64), "P"),
           ("g.bmp", (40, 41), "RGB"))


def _image(rng, size, mode):
    w, h = size
    # smooth ramps plus noise, so that the resize and the JPEG coder have work
    base = (np.linspace(0, 255, w)[None, :, None] + np.linspace(0, 128, h)[:, None, None]) / 1.5
    arr = np.clip(base + rng.integers(0, 64, (h, w, 3)), 0, 255).astype(np.uint8)
    img = Image.fromarray(arr, "RGB")
    return img.convert(mode) if mode != "RGB" else img


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A folder of Pillow-written images at odd sizes, with a dataset.json."""
    root = tmp_path_factory.mktemp("sources")
    rng = np.random.default_rng(RNG_SEED)
    for name, size, mode in SOURCES:
        os.makedirs(os.path.dirname(root / name), exist_ok=True)
        _image(rng, size, mode).save(root / name)
    labels = [[name, i] for i, (name, _, _) in enumerate(SOURCES) if i % 3]
    (root / "dataset.json").write_text(json.dumps({"labels": labels}))
    return root


@pytest.fixture(scope="module")
def annotations(images):
    """captions_val2014.json layout: ids out of file order, some with two
    captions, one caption with blanks and a newline, one file absent."""
    names = [n for n, _, _ in SOURCES]
    ids = [905, 12, 77, 300, 4, 61, 150]
    imgs = [{"id": i, "file_name": n} for i, n in zip(ids, names)]
    imgs.append({"id": 55, "file_name": "missing.jpg"})
    anns = [{"image_id": 77, "id": 100, "caption": "a caption listed before 77's own"}]
    anns += [{"image_id": i, "id": k, "caption": f"  caption {k} of image {i}\n"}
             for k, i in enumerate(ids + [55])]
    anns[2]["caption"] = " two\nlines "  # id 12's
    anns.append({"image_id": 4, "id": 101, "caption": "a second caption of 4"})
    path = images.parent / "captions_val2014.json"
    path.write_text(json.dumps({"images": imgs, "annotations": anns}))
    return path


def _tree(dest) -> dict:
    """name -> bytes of the files of a folder or zip."""
    dest = str(dest)
    if dest.endswith(".zip"):
        with zipfile.ZipFile(dest) as zf:
            assert all(i.compress_type == zipfile.ZIP_STORED for i in zf.infolist())
            return {n: zf.read(n) for n in zf.namelist()}
    out = {}
    for root, _, files in os.walk(dest):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, dest)] = fh.read()
    return out


def _assert_same_outputs(ref_dest, port_dest) -> int:
    """The same names; PNGs the same pixels as Pillow reads them, other files
    the same bytes.  Returns the number of PNGs."""
    ref, got = _tree(ref_dest), _tree(port_dest)
    assert sorted(got) == sorted(ref)
    for name, data in ref.items():
        if name.endswith(".png"):
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            have = np.asarray(Image.open(io.BytesIO(got[name])).convert("RGB"))
            np.testing.assert_array_equal(have, want, err_msg=name)
        else:
            assert got[name] == data, name
    return sum(n.endswith(".png") for n in ref)


# --- cocodataset_tool ---------------------------------------------------------------------

@pytest.mark.parametrize("kind,max_images", [("folder", None), ("zip", 4)])
def test_convert_coco_matches_jax(images, annotations, tmp_path, kind, max_images):
    ext = ".zip" if kind == "zip" else ""
    runs = {}
    for label, fn in (("jax", jax_coco.convert_coco), ("port", cocodataset_tool.convert_coco)):
        dest, caps = tmp_path / f"{label}{ext}", tmp_path / f"{label}.txt"
        runs[label] = fn(str(images), str(annotations), str(dest), 32, max_images, str(caps))
    n = _assert_same_outputs(tmp_path / f"jax{ext}", tmp_path / f"port{ext}")
    assert runs["port"] == runs["jax"] == n == (max_images or len(SOURCES))
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    lines = (tmp_path / "port.txt").read_text().splitlines()
    assert lines[:4] == ["caption 4 of image 4", "two lines", "caption 5 of image 61",
                         "a caption listed before 77's own"]  # ids 4, 12, 61, 77


def test_cocodataset_cli_matches_jax_and_refuses_a_resolution_not_a_power_of_two(
        images, annotations, tmp_path, capsys):
    common = ["--source", str(images), "--annotations", str(annotations), "--resolution", "16"]
    jax_coco.main(common + ["--dest", str(tmp_path / "jax.zip")], standalone_mode=False)
    want = capsys.readouterr().out.replace(str(tmp_path / "jax.zip"), str(tmp_path / "port.zip"))
    cocodataset_tool.main(common + ["--dest", str(tmp_path / "port.zip")])
    assert capsys.readouterr().out == want
    _assert_same_outputs(tmp_path / "jax.zip", tmp_path / "port.zip")

    bad = ["--source", str(images), "--annotations", str(annotations), "--dest",
           str(tmp_path / "bad"), "--resolution", "48"]
    with pytest.raises(click.UsageError) as ref:
        jax_coco.main(bad, standalone_mode=False)
    with pytest.raises(ValueError) as got:
        cocodataset_tool.convert_coco(str(images), str(annotations), str(tmp_path / "bad"), 48)
    assert str(got.value) == ref.value.message
    with pytest.raises(SystemExit) as got:
        cocodataset_tool.main(bad)
    assert got.value.code == ref.value.exit_code == 2
    assert ref.value.message in capsys.readouterr().err
    assert not (tmp_path / "bad").exists()


# --- dataset_tool -------------------------------------------------------------------------

def _cifar(root, rng):
    path = root / "cifar-10-python.tar.gz"
    with tarfile.open(path, "w:gz") as tar:
        for b in range(1, 6):
            body = pickle.dumps({"data": rng.integers(0, 256, (2, 3072), dtype=np.uint8),
                                 "labels": [int(x) for x in rng.integers(0, 10, 2)]})
            info = tarfile.TarInfo(f"cifar-10-batches-py/data_batch_{b}")
            info.size = len(body)
            tar.addfile(info, io.BytesIO(body))
    return path


def _mnist(root, rng):
    n = 5
    with gzip.open(root / "t10k-labels-idx1-ubyte.gz", "wb") as f:
        f.write(b"\0" * 8 + rng.integers(0, 10, n, dtype=np.uint8).tobytes())
    path = root / "t10k-images-idx3-ubyte.gz"
    with gzip.open(path, "wb") as f:
        f.write(b"\0" * 16 + rng.integers(0, 256, (n, 28, 28), dtype=np.uint8).tobytes())
    return path


@pytest.fixture(scope="module")
def dataset_sources(images, tmp_path_factory):
    root = tmp_path_factory.mktemp("dataset_sources")
    rng = np.random.default_rng(RNG_SEED + 1)
    zpath = root / "images.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        for name, _, _ in SOURCES:
            zf.write(images / name, name)
        zf.writestr("dataset.json", json.dumps({"labels": [["d.png", 3], ["a.jpg", 1]]}))
        zf.writestr("notes.txt", "not an image")
    np.savez(root / "rgb.npz", arr_0=rng.integers(0, 256, (3, 40, 30, 3), dtype=np.uint8))
    np.savez(root / "grey.npz", arr_0=rng.integers(0, 256, (3, 30, 41), dtype=np.uint8))
    np.savez(root / "rgba.npz", arr_0=rng.integers(0, 256, (2, 8, 8, 4), dtype=np.uint8))
    return {"folder": images, "zip": zpath, "npz": root / "rgb.npz", "grey_npz": root / "grey.npz",
            "rgba_npz": root / "rgba.npz", "cifar": _cifar(root, rng), "mnist": _mnist(root, rng)}


@pytest.mark.parametrize("source,resolution,dest,max_images", [
    ("folder", None, "dir", None), ("folder", 32, "zip", None), ("zip", 16, "dir", 5),
    ("npz", 32, "zip", None), ("grey_npz", None, "dir", None), ("grey_npz", 16, "zip", None),
    ("cifar", None, "zip", None), ("mnist", 16, "dir", None), ("mnist", None, "zip", 3)])
def test_dataset_tool_matches_jax(dataset_sources, tmp_path, capsys, source, resolution, dest,
                                  max_images):
    ext = ".zip" if dest == "zip" else ""
    args = ["--source", str(dataset_sources[source])]
    args += ["--resolution", str(resolution)] if resolution else []
    args += ["--max-images", str(max_images)] if max_images else []
    jax_dataset.main(args + ["--dest", str(tmp_path / f"jax{ext}")], standalone_mode=False)
    want = capsys.readouterr().out.replace(str(tmp_path / f"jax{ext}"), str(tmp_path / f"port{ext}"))
    n = dataset_tool.main(args + ["--dest", str(tmp_path / f"port{ext}")])
    assert capsys.readouterr().out == want
    assert _assert_same_outputs(tmp_path / f"jax{ext}", tmp_path / f"port{ext}") == n > 0
    meta = json.loads(_tree(tmp_path / f"port{ext}")["dataset.json"])
    assert (meta["labels"] is None) == (source in ("npz", "grey_npz"))


@pytest.mark.parametrize("source", ["lmdb", "unrecognised"])
def test_dataset_tool_refuses_as_jax_does(tmp_path, capsys, monkeypatch, source):
    monkeypatch.setitem(sys.modules, "lmdb", None)  # neither machine has it
    if source == "lmdb":
        src = tmp_path / "lmdb_dir"
        src.mkdir()
        (src / "data.mdb").write_bytes(b"")
    else:
        src = tmp_path / "images.txt"
        src.write_text("")
    args = ["--source", str(src), "--dest", str(tmp_path / "out")]
    with pytest.raises(click.ClickException) as ref:
        jax_dataset.main(args, standalone_mode=False)
    with pytest.raises(SystemExit) as got:
        dataset_tool.main(args)
    assert got.value.code == ref.value.exit_code == 1
    assert capsys.readouterr().err == f"Error: {ref.value.format_message()}\n"


def test_dataset_tool_refuses_four_channel_npz(dataset_sources, tmp_path, capsys):
    """The reference resizes RGBA through premultiplied alpha and keeps the
    alpha in its PNGs; the port refuses such arrays instead."""
    with pytest.raises(SystemExit) as got:
        dataset_tool.main(["--source", str(dataset_sources["rgba_npz"]), "--dest", str(tmp_path / "o")])
    assert got.value.code == 1
    assert "(2, 8, 8, 4)" in capsys.readouterr().err


# --- generate_onestep --enable_compress_npz -------------------------------------------------

def _png16_rgb(path, rng):
    """A 16-bit RGB PNG (colour type 2), which Pillow opens as 8-bit RGB."""
    import struct
    import zlib

    h, w = 5, 7
    samples = rng.integers(0, 65536, (h, w * 3), dtype=np.uint16).astype(">u2").view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), samples.reshape(h, -1)], axis=1).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_compress_to_npz_matches_jax(tmp_path):
    rng = np.random.default_rng(RNG_SEED + 2)
    folder = tmp_path / "gen"
    for d in ("000000", "001000", "001000/deeper"):
        (folder / d).mkdir(parents=True)
    for i, name in enumerate(["000000/000003.png", "000000/000001.png", "001000/001000.png",
                              "001000/deeper/x.png", "000000/000002.png"]):
        write_png(str(folder / name), rng.integers(0, 256, (5, 7, 3), dtype=np.uint8))
    Image.fromarray(rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)).save(folder / "000000/000004.jpg")
    (folder / "000000/notes.txt").write_text("not an image")
    for num in (50000, 4):
        ref = np.load(jax_generate.compress_to_npz(str(folder), num))["arr_0"]
        os.remove(f"{folder}.npz")
        path = generate_onestep.compress_to_npz(str(folder), num)
        assert path == f"{folder}.npz"
        got = np.load(path)["arr_0"]
        assert got.dtype == np.uint8 and got.shape == ref.shape == (min(num, 6), 5, 7, 3)
        np.testing.assert_array_equal(got, ref)
    sixteen = tmp_path / "sixteen"
    sixteen.mkdir()
    _png16_rgb(sixteen / "a.png", rng)
    ref = np.load(jax_generate.compress_to_npz(str(sixteen)))["arr_0"]
    np.testing.assert_array_equal(np.load(generate_onestep.compress_to_npz(str(sixteen)))["arr_0"], ref)


@pytest.mark.parametrize("mode", ["L", "P", "LA", "RGBA"])
def test_compress_to_npz_refuses_pngs_pillow_opens_in_another_mode(tmp_path, mode):
    """JAX stacks ``np.asarray(Image.open(p))``, which keeps Pillow's mode:
    for these colour types its array is not (H, W, 3), so the port raises
    rather than pack the RGB conversion."""
    folder = tmp_path / "gen"
    folder.mkdir()
    arr = np.random.default_rng(RNG_SEED + 3).integers(0, 256, (6, 5, 3), dtype=np.uint8)
    Image.fromarray(arr).convert(mode).save(folder / "a.png")
    assert np.asarray(Image.open(folder / "a.png")).shape != (6, 5, 3)
    colour = {"L": 0, "P": 3, "LA": 4, "RGBA": 6}[mode]
    with pytest.raises(ValueError, match=f"colour type {colour} at bit depth 8"):
        generate_onestep.compress_to_npz(str(folder))


def test_generate_onestep_packs_the_numstep_folder(tmp_path, capsys):
    out = tmp_path / "out"
    generate_onestep.main(["--outdir", str(out), "--seeds", "0-2", "--batch", "2", "--repo_id", "tiny",
                           "--use_bf16", "false", "--device", "cpu", "--num_steps_eval", "2",
                           "--enable_compress_npz", "true", "--text_prompts", str(tmp_path / "none")])
    folder = tmp_path / "out_numstep2"
    names = sorted(os.listdir(folder))
    assert names == ["000000.png", "000001.png", "000002.png"]
    assert f"packed: {folder}.npz" in capsys.readouterr().out
    arr = np.load(f"{folder}.npz")["arr_0"]
    assert arr.dtype == np.uint8 and arr.shape[0] == 3 and arr.shape[3] == 3
    np.testing.assert_array_equal(arr, np.stack([read_png(str(folder / n)) for n in names]))
