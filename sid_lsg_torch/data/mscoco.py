"""MS-COCO eval dataset: paired image + caption files, from a dir or zip.

Port of ``sid_lsg_tpu/data/mscoco.py``: every ``.png`` / ``.jpg`` /
``.jpeg`` under the directory or in the archive, sorted by name, with its
sibling ``<base>.txt`` as the caption (the empty string without one),
NHWC uint8 out, process-strided batches.  PNGs are read by
``cli.pngio.decode_png``; JPEGs need Pillow, as in the JAX package.  An
image whose size is not ``resolution`` squared is resized with Pillow's
LANCZOS as ``utils.resample`` computes it.
"""

from __future__ import annotations

import io
import os
import zipfile
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..cli.pngio import decode_png
from ..utils.resample import resize_uint8

_IMG_EXTS = (".png", ".jpg", ".jpeg")


def decode_image(name: str, data: bytes) -> np.ndarray:
    """Image file bytes -> (H, W, 3) uint8 RGB."""
    if name.lower().endswith(".png"):
        return decode_png(data)
    from PIL import Image  # JPEG only

    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


class _DirBackend:
    def __init__(self, root: str):
        self.root = root
        self.fnames = sorted(
            os.path.relpath(os.path.join(dirpath, f), root)
            for dirpath, _, files in os.walk(root)
            for f in files
        )

    def read(self, fname: str) -> bytes:
        with open(os.path.join(self.root, fname), "rb") as f:
            return f.read()


class _ZipBackend:
    """Zip archive reader; the handle opens lazily and is dropped on
    pickling (a zipfile handle is not fork- or pickle-safe)."""

    def __init__(self, path: str):
        self.path = path
        self._zf: Optional[zipfile.ZipFile] = None
        with zipfile.ZipFile(path) as zf:
            self.fnames = sorted(n for n in zf.namelist() if not n.endswith("/"))

    def read(self, fname: str) -> bytes:
        if self._zf is None:
            self._zf = zipfile.ZipFile(self.path)
        return self._zf.read(fname)

    def __getstate__(self):
        return dict(self.__dict__, _zf=None)


class CocoCaptionDataset:
    """(uint8 HWC image, caption) pairs from a prepared eval folder or zip."""

    def __init__(self, path: str, resolution: Optional[int] = None, max_size: Optional[int] = None):
        self.path = path
        self.resolution = resolution
        if os.path.isdir(path):
            self._backend = _DirBackend(path)
            self.name = os.path.basename(os.path.normpath(path))
        elif os.path.splitext(path)[1].lower() == ".zip":
            self._backend = _ZipBackend(path)
            self.name = os.path.splitext(os.path.basename(path))[0]
        else:
            raise IOError(f"{path!r} must point to a directory or .zip archive")
        names = set(self._backend.fnames)
        self.pairs = []
        for f in self._backend.fnames:
            base, ext = os.path.splitext(f)
            if ext.lower() in _IMG_EXTS:
                txt = base + ".txt"
                self.pairs.append((f, txt if txt in names else None))
        if max_size is not None:
            self.pairs = self.pairs[:max_size]
        if not self.pairs:
            raise FileNotFoundError(f"no images under {path}")

    def __len__(self) -> int:
        return len(self.pairs)

    def _caption(self, txt_name: Optional[str]) -> str:
        if txt_name is None:
            return ""
        return self._backend.read(txt_name).decode("utf-8").strip()

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, str]:
        img_name, txt_name = self.pairs[idx]
        img = decode_image(img_name, self._backend.read(img_name))
        r = self.resolution
        if r is not None and img.shape[:2] != (r, r):
            img = resize_uint8(img, (r, r), "lanczos")
        return img, self._caption(txt_name)

    def batches(self, batch_size: int, process_index: int = 0, process_count: int = 1,
                max_items: Optional[int] = None) -> Iterator[Tuple[np.ndarray, List[str]]]:
        """Process-strided batches (images stacked, captions)."""
        n = len(self) if max_items is None else min(len(self), max_items)
        idxs = list(range(process_index, n, process_count))
        for i in range(0, len(idxs), batch_size):
            imgs, caps = zip(*(self[j] for j in idxs[i:i + batch_size]))
            yield np.stack(imgs), list(caps)

    def captions(self, max_items: Optional[int] = None, allow_missing: bool = False) -> List[str]:
        """Captions of the first ``max_items`` images.  Caption-conditioned
        use must not run on empty strings: an image without a caption raises
        unless ``allow_missing``."""
        n = len(self) if max_items is None else min(len(self), max_items)
        missing = [self.pairs[i][0] for i in range(n) if self.pairs[i][1] is None]
        if missing and not allow_missing:
            raise FileNotFoundError(
                f"{len(missing)}/{n} images under {self.path} have no sibling .txt caption "
                f"(first: {missing[0]!r}); caption-conditioned metrics need one per image - pass "
                "allow_missing=True only for caption-free stats.")
        return [self._caption(self.pairs[i][1]) for i in range(n)]
