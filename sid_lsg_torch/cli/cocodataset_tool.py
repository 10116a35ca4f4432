"""COCO eval-set tool of the port.

Port of ``sid_lsg_tpu/cli/cocodataset_tool.py``: COCO val2014 images and
``captions_val2014.json`` become the flat eval layout that ``sid_metrics
--data`` and the ``Trainer``'s metric hook read: one square centre-cropped,
LANCZOS-resized PNG per image with a sibling ``.txt`` holding its first
caption, in a folder or a ``.zip``.  The resize is Pillow's, as
``utils.resample`` computes it; PNG sources are read by ``pngio``, JPEG (and
BMP, WebP) sources need Pillow.  ``--captions-out`` also writes the caption
corpus that ``generate_onestep --text_prompts`` reads: line i is the prompt
of seed i, in the order of the eval images.

    python -m sid_lsg_torch.cli.cocodataset_tool --source val2014/ \\
        --annotations annotations/captions_val2014.json --dest coco256.zip --captions-out captions.txt
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import zipfile
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from .pngio import encode_png
from ..data.mscoco import decode_image
from ..utils.resample import resize_uint8

NOT_A_POWER_OF_TWO = "--resolution must be a power of two (reference parity)"


class UsageError(ValueError):
    """A bad argument, which the CLI reports as a usage error (exit 2)."""


def center_crop_resize(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, C) uint8 -> the centred square crop, LANCZOS-resized to
    (size, size), as Pillow's ``crop`` then ``resize`` give it."""
    h, w = img.shape[:2]
    s = min(w, h)
    left, top = (w - s) // 2, (h - s) // 2
    return resize_uint8(img[top:top + s, left:left + s], (size, size), "lanczos")


@contextlib.contextmanager
def open_dest(dest: str) -> Iterator[Callable[[str, bytes], None]]:
    """A writer of named files into the folder ``dest``, or into the
    ``ZIP_STORED`` archive ``dest`` when it ends in ``.zip``; the archive's
    central directory is written even when the block raises, so what was
    converted before a failure stays readable."""
    if not dest.endswith(".zip"):
        os.makedirs(dest, exist_ok=True)

        def write(name: str, data: bytes) -> None:
            with open(os.path.join(dest, name), "wb") as f:
                f.write(data)

        yield write
        return
    if os.path.dirname(dest):
        os.makedirs(os.path.dirname(dest), exist_ok=True)
    with zipfile.ZipFile(dest, "w", zipfile.ZIP_STORED) as zf:
        yield zf.writestr


def convert_coco(source: str, annotations: str, dest: str, resolution: int = 256,
                 max_images: Optional[int] = None, captions_out: Optional[str] = None) -> int:
    """Write ``{n:08d}.png`` / ``.txt`` pairs for the images of
    ``annotations`` found under ``source``, in sorted id order, each with its
    id's first caption (stripped); an id whose file is missing is skipped.
    Returns the number of pairs written."""
    if resolution & (resolution - 1) != 0:
        raise UsageError(NOT_A_POWER_OF_TWO)
    with open(annotations, encoding="utf-8") as f:
        ann = json.load(f)
    file_by_id = {img["id"]: img["file_name"] for img in ann["images"]}
    caption_by_id: dict = {}
    for a in ann["annotations"]:
        caption_by_id.setdefault(a["image_id"], a["caption"].strip())
    count = 0
    captions = []
    with open_dest(dest) as write:
        for image_id in sorted(caption_by_id):
            if max_images is not None and count >= max_images:
                break
            src = os.path.join(source, file_by_id[image_id])
            if not os.path.exists(src):
                continue
            with open(src, "rb") as f:
                img = decode_image(src, f.read())
            write(f"{count:08d}.png", encode_png(center_crop_resize(img, resolution)))
            write(f"{count:08d}.txt", caption_by_id[image_id].encode("utf-8"))
            captions.append(caption_by_id[image_id].replace("\n", " "))
            count += 1
    if captions_out:
        with open(captions_out, "w", encoding="utf-8") as f:
            f.write("\n".join(captions) + "\n")
    return count


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="COCO eval-set preparation (PyTorch port).")
    p.add_argument("--source", required=True, help="COCO val2014 images directory")
    p.add_argument("--annotations", required=True, help="captions_val2014.json")
    p.add_argument("--dest", required=True, help="Output folder or .zip archive (img+txt pairs)")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--max-images", dest="max_images", type=int, default=None)
    p.add_argument("--captions-out", dest="captions_out", default=None,
                   help="Also write the caption corpus (one prompt per line) to this path")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        n = convert_coco(args.source, args.annotations, args.dest, args.resolution,
                         args.max_images, args.captions_out)
    except UsageError as e:
        parser.error(str(e))
    print(f"wrote {n} image+caption pairs to {args.dest}")
    return n


if __name__ == "__main__":
    main()
