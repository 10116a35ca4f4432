"""Generic image dataset tool of the port.

Port of ``sid_lsg_tpu/cli/dataset_tool.py``: read the images (and labels,
where the source has them) of an image folder (with an optional
``dataset.json``), a ``.zip``, an ``.npz`` (key ``arr_0``), a CIFAR-10
python tarball, an MNIST ``*-images-idx3-ubyte.gz`` with its labels file, or
an LMDB directory; optionally centre-crop and LANCZOS-resize them to
``--resolution``; and write ``{idx:08d}.png`` with a ``dataset.json`` of
``{"labels": [[name, label], ...] or null}`` to a folder or a ``.zip``.
PNG sources are read by ``pngio``; JPEG, BMP and WebP sources need Pillow;
an LMDB source needs ``lmdb`` and Pillow.  Every image is written as RGB.

    python -m sid_lsg_torch.cli.dataset_tool --source cifar-10-python.tar.gz --dest cifar10.zip
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import pickle
import sys
import tarfile
import zipfile
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from .cocodataset_tool import center_crop_resize, open_dest
from .pngio import encode_png
from ..data.mscoco import decode_image

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")

# (name in the source, (H, W, 3) uint8 image, label or None)
Item = Tuple[str, np.ndarray, Optional[int]]


class SourceError(Exception):
    """A source the tool cannot read; the CLI prints it and exits 1."""


def _grey_to_rgb(img: np.ndarray) -> np.ndarray:
    return np.repeat(img[:, :, None], 3, axis=2)


def _iter_folder(source: str) -> Iterator[Item]:
    labels = _load_labels_json(source)
    for root, _, files in os.walk(source):
        for f in sorted(files):
            if f.lower().endswith(_IMG_EXTS):
                p = os.path.join(root, f)
                rel = os.path.relpath(p, source)
                with open(p, "rb") as fh:
                    yield rel, decode_image(f, fh.read()), labels.get(rel)


def _iter_zip(source: str) -> Iterator[Item]:
    with zipfile.ZipFile(source) as zf:
        labels = {}
        if "dataset.json" in zf.namelist():
            with zf.open("dataset.json") as f:
                labels = dict(json.load(f).get("labels") or [])
        for name in sorted(zf.namelist()):
            if name.lower().endswith(_IMG_EXTS):
                yield name, decode_image(name, zf.read(name)), labels.get(name)


def _iter_npz(source: str) -> Iterator[Item]:
    """uint8 (N, H, W) grey or (N, H, W, 3) RGB images.  Grey images are
    written as RGB with the grey repeated, the pixels of the grey PNG the
    reference writes.  Other arrays are refused: the reference resizes RGBA
    through premultiplied alpha and keeps the alpha in its PNGs."""
    arr = np.load(source)["arr_0"]
    if arr.dtype != np.uint8 or not (arr.ndim == 3 or (arr.ndim == 4 and arr.shape[3] == 3)):
        raise SourceError(f"{source}: arr_0 of shape {arr.shape} and dtype {arr.dtype}; the tool "
                          "reads uint8 (N, H, W) grey or (N, H, W, 3) RGB images")
    for i in range(len(arr)):
        yield f"{i:08d}", _grey_to_rgb(arr[i]) if arr.ndim == 3 else arr[i], None


def _iter_cifar10(source: str) -> Iterator[Item]:
    """CIFAR-10 python tarball: 5 train batches of 10k 32x32 RGB + labels."""
    images, labels = [], []
    with tarfile.open(source, "r:gz") as tar:
        for batch in range(1, 6):
            member = tar.getmember(f"cifar-10-batches-py/data_batch_{batch}")
            with tar.extractfile(member) as f:
                data = pickle.load(f, encoding="latin1")
            images.append(np.asarray(data["data"], np.uint8).reshape(-1, 3, 32, 32))
            labels.append(np.asarray(data["labels"]))
    images = np.concatenate(images).transpose(0, 2, 3, 1)  # NCHW -> NHWC
    labels = np.concatenate(labels)
    for i in range(len(images)):
        yield f"{i:08d}", images[i], int(labels[i])


def _iter_mnist(source: str) -> Iterator[Item]:
    """MNIST idx-ubyte gz pair, images zero-padded 28 -> 32 and made RGB;
    the labels file is named after the images file."""
    labels_gz = source.replace("-images-idx3-ubyte.gz", "-labels-idx1-ubyte.gz")
    with gzip.open(source, "rb") as f:
        images = np.frombuffer(f.read(), np.uint8, offset=16).reshape(-1, 28, 28)
    with gzip.open(labels_gz, "rb") as f:
        labels = np.frombuffer(f.read(), np.uint8, offset=8)
    images = np.pad(images, [(0, 0), (2, 2), (2, 2)], "constant")
    for i in range(len(images)):
        yield f"{i:08d}", _grey_to_rgb(images[i]), int(labels[i])


def _iter_lmdb(source: str) -> Iterator[Item]:
    """LMDB of encoded images; a value Pillow cannot decode is skipped."""
    import io

    try:
        import lmdb
    except ImportError as e:
        raise SourceError("LMDB sources need the 'lmdb' package (pip install lmdb)") from e
    from PIL import Image

    env = lmdb.open(source, readonly=True, lock=False)
    with env.begin(write=False) as txn:
        for i, (_key, value) in enumerate(txn.cursor()):
            try:
                with Image.open(io.BytesIO(value)) as img:
                    rgb = np.asarray(img.convert("RGB"), np.uint8)
            except Exception as err:
                print(f"skipping lmdb entry {i}: {err}")
                continue
            yield f"{i:08d}", rgb, None


def iter_source(source: str) -> Iterator[Item]:
    """The items of ``source``, by the kind its path names."""
    if os.path.isdir(source):
        if os.path.exists(os.path.join(source, "data.mdb")):
            return _iter_lmdb(source)
        return _iter_folder(source)
    base = os.path.basename(source)
    if source.endswith(".zip"):
        return _iter_zip(source)
    if source.endswith(".npz"):
        return _iter_npz(source)
    if base.endswith(".tar.gz") and "cifar" in base.lower():
        return _iter_cifar10(source)
    if base.endswith("-images-idx3-ubyte.gz"):
        return _iter_mnist(source)
    raise SourceError(f"unrecognised source {source!r}")


def _load_labels_json(source: str) -> dict:
    cand = os.path.join(source, "dataset.json")
    if os.path.exists(cand):
        with open(cand, encoding="utf-8") as f:
            return dict(json.load(f).get("labels") or [])
    return {}


def convert_dataset(source: str, dest: str, resolution: Optional[int] = None,
                    max_images: Optional[int] = None) -> int:
    """Write the images of ``source`` to ``dest``; returns their number."""
    items = iter_source(source)
    labels_out = []
    count = 0
    with open_dest(dest) as write:
        for _name, img, label in items:
            if max_images is not None and count >= max_images:
                break
            if resolution:
                img = center_crop_resize(img, resolution)
            out_name = f"{count:08d}.png"
            write(out_name, encode_png(img))
            if label is not None:
                labels_out.append([out_name, label])
            count += 1
        write("dataset.json", json.dumps({"labels": labels_out or None}).encode("utf-8"))
    return count


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Image dataset preparation (PyTorch port).")
    p.add_argument("--source", required=True,
                   help="Input folder / .zip / .npz / cifar .tar.gz / mnist images .gz / LMDB dir")
    p.add_argument("--dest", required=True, help="Output folder or .zip")
    p.add_argument("--resolution", type=int, default=None,
                   help="Output side length (center-crop square)")
    p.add_argument("--max-images", dest="max_images", type=int, default=None)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        n = convert_dataset(args.source, args.dest, args.resolution, args.max_images)
    except SourceError as e:
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)
    print(f"wrote {n} images to {args.dest}")
    return n


if __name__ == "__main__":
    main()
