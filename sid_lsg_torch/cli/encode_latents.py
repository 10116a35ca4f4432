"""Encode a folder of captioned images into a real-latent corpus for SiDA.

Port of ``sid_lsg_tpu/cli/encode_latents.py``: the same flags, plus
``--device``.  It reads image + sibling ``.txt`` caption pairs (the flat
layout of the data tools, or any such folder), VAE-encodes the images in
batches on the card under ``torch.inference_mode()``, and writes the posterior
means times the VAE's scaling factor (the space the UNet reads) as an f16
``<dest stem>.latents.npy`` sidecar, with the captions in ``--dest``, which
``data.latents.LatentDataset`` streams during training.  Every image must
have one resolution; the tail batch is padded to the batch size.  PNG files
are read by ``pngio.decode_png``; JPEG and WebP need Pillow.

    python -m sid_lsg_torch.cli.encode_latents --source imgs/ --dest corpus.npz --repo_id <dir>
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import int_range, parse_bool
from ..data.mscoco import decode_image

_EXTS = (".png", ".jpg", ".jpeg", ".webp")


def list_pairs(source: str) -> List[Tuple[str, str]]:
    """(image, caption file) pairs of ``source``, sorted by name."""
    pairs = []
    for name in sorted(os.listdir(source)):
        base, ext = os.path.splitext(name)
        txt = os.path.join(source, base + ".txt")
        if ext.lower() in _EXTS and os.path.exists(txt):
            pairs.append((os.path.join(source, name), txt))
    if not pairs:
        raise ValueError(f"{source}: no image/.txt caption pairs found")
    return pairs


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        return decode_image(path, f.read())


def encode_corpus(pipe, pairs: List[Tuple[str, str]], batch: int,
                  progress: bool = True) -> Tuple[np.ndarray, List[str]]:
    """(N, h, w, 4) f16 latents (posterior means times the scaling factor)
    and the N captions of ``pairs``, encoded ``batch`` images at a time."""
    latents, captions, corpus_hw = [], [], None
    for start in range(0, len(pairs), batch):
        chunk = pairs[start:start + batch]
        imgs = []
        for img_path, txt_path in chunk:
            img = read_image(img_path)
            if corpus_hw is None:
                corpus_hw = img.shape[:2]
            elif img.shape[:2] != corpus_hw:
                raise ValueError(f"{img_path}: size {img.shape[1]}x{img.shape[0]} differs from the "
                                 f"corpus's {corpus_hw[1]}x{corpus_hw[0]}; all images must share "
                                 "one resolution")
            imgs.append(img)
            with open(txt_path, encoding="utf-8") as f:
                captions.append(f.read().strip())
        n = len(imgs)
        imgs += imgs[-1:] * (batch - n)  # one batch shape for the whole corpus
        z = pipe.encode_images(torch.from_numpy(np.stack(imgs)))
        latents.append(z[:n].to(torch.float16).cpu().numpy())
        if progress:
            print(f"\rencoded {start + n}/{len(pairs)}", end="", flush=True)
    if progress:
        print("")
    return np.concatenate(latents, axis=0), captions


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Encode captioned images into a SiDA latent corpus "
                                            "(PyTorch port).")
    p.add_argument("--source", required=True, help="Folder of image + sibling .txt caption pairs")
    p.add_argument("--dest", required=True, help="Output .npz path")
    p.add_argument("--repo_id", default="sd15", help="SD checkpoint dir or preset (for the VAE)")
    p.add_argument("--batch", type=int_range(1), default=32)
    p.add_argument("--max_images", type=int_range(1), default=None)
    p.add_argument("--use_bf16", type=parse_bool, default=True)
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Parse, encode, write; returns the sidecar's path."""
    from ..data.latents import write_corpus
    from ..pipeline import SDPipeline

    args = build_parser().parse_args(argv)
    pairs = list_pairs(args.source)[:args.max_images]
    pipe = SDPipeline.from_pretrained(args.repo_id,
                                      dtype=torch.bfloat16 if args.use_bf16 else torch.float32,
                                      device=args.device)
    latents, captions = encode_corpus(pipe, pairs, args.batch)
    sidecar = write_corpus(args.dest, latents, captions)
    print(f"wrote {sidecar}: {latents.shape} float16 (mmap source) and {args.dest}: "
          f"{len(captions)} captions")
    return sidecar


if __name__ == "__main__":
    main()
