"""One-step (or few-step) image generation CLI of the port.

Port of ``sid_lsg_tpu/cli/generate_onestep.py``: seeds map to caption
indices, each seed's latents come from its own
``torch.Generator`` (the reference's ``StackedRandomGenerator``), images are
written as ``{seed:06d}.png`` (optionally in thousand-seed subdirectories),
and a ``_numstep{n}`` suffix marks multistep runs.  ``--repo_id`` names an
HF-layout checkpoint directory or a preset (random weights); ``--network``
loads a distilled generator (a ``network-snapshot-*`` file of either package
or of the reference).  Under torchrun rank p of P writes the seeds at list
positions ``i % P == p``; rank 0 prints.  ``--enable_compress_npz true``
packs the written images into ``{outdir}.npz`` (key ``arr_0``) once every
rank is done, as the reference's FID tools read them.

    python -m sid_lsg_torch.cli.generate_onestep --outdir out --seeds 0-63 --repo_id <dir> \\
        --network network-snapshot-1-000100.safetensors --enable_compress_npz true
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import int_range, parse_bool, parse_int_list
from .pngio import decode_png, write_png
from ..diffusion.rng import StackedRandomGenerator
from ..parallel import runtime


def read_prompt_file(path: str) -> List[str]:
    """One prompt per non-empty line."""
    with open(path, encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def _packed_image(path: str) -> np.ndarray:
    """One image as the JAX package packs it, ``np.asarray(Image.open(path))``:
    a PNG of colour type 2 (RGB, 8 or 16 bits), which Pillow opens as RGB,
    through ``decode_png``; a JPEG through Pillow.  Pillow opens every other
    PNG in a mode of another shape, so those raise."""
    if path.endswith(".png"):
        with open(path, "rb") as f:
            data = f.read()
        if data[12:16] == b"IHDR" and data[25] != 2:
            raise ValueError(f"{path}: a PNG of colour type {data[25]} at bit depth {data[24]}; "
                             "the npz packs colour type 2 (RGB) images alone")
        return decode_png(data)
    from PIL import Image  # JPEG only

    return np.asarray(Image.open(path), dtype=np.uint8)


def compress_to_npz(folder_path: str, num: int = 50000) -> str:
    """Pack the first ``num`` images under ``folder_path`` (every ``.png``,
    ``.jpg`` and ``.jpeg``, by sorted full path) into ``{folder_path}.npz``
    as one ``arr_0`` stack; returns the npz's path."""
    npz_path = f"{folder_path}.npz"
    paths = sorted(
        os.path.join(root, f)
        for root, _, files in os.walk(folder_path)
        for f in files
        if f.endswith((".png", ".jpg", ".jpeg"))
    )[:num]
    np.savez(npz_path, arr_0=np.stack([_packed_image(p) for p in paths]))
    return npz_path


def generate_images(pipe, captions: List[str], seeds: List[int], outdir: str,
                    max_batch_size: int = 16, init_timestep: int = 625, num_steps_eval: int = 1,
                    subdirs: bool = False, custom_seed: bool = False, progress: bool = True,
                    process_index: int = 0, process_count: int = 1) -> int:
    """Generate one image per seed of this process's stride of ``seeds``;
    returns the number written by this process.

    Batch N's images are copied to pinned host memory on the stream right
    after its kernels, and written to disk while the card computes batch N+1.
    """
    if num_steps_eval > 1:
        outdir = f"{outdir}_numstep{num_steps_eval}"
    os.makedirs(outdir, exist_ok=True)
    latent_size = pipe.config.unet.sample_size
    on_cuda = pipe.device.type == "cuda"
    step_gen = torch.Generator(pipe.device).manual_seed(0)
    my_seeds = [s for i, s in enumerate(seeds) if i % process_count == process_index]
    progress = progress and process_index == 0
    written = 0

    def flush(pending) -> int:
        host, done, batch_seeds = pending
        if done is not None:
            done.synchronize()
        images = host.numpy()
        for img, seed in zip(images, batch_seeds):
            d = os.path.join(outdir, f"{seed - seed % 1000:06d}") if subdirs else outdir
            os.makedirs(d, exist_ok=True)
            write_png(os.path.join(d, f"{seed:06d}.png"), img)
        return len(batch_seeds)

    pending = None
    for start in range(0, len(my_seeds), max_batch_size):
        batch_seeds = my_seeds[start:start + max_batch_size]
        # Static batch shape: pad the tail batch with its first seed, drop the extras.
        padded = batch_seeds + batch_seeds[:1] * (max_batch_size - len(batch_seeds))
        rng_seeds = [seeds[i] for i in padded] if custom_seed else padded
        latents = StackedRandomGenerator(rng_seeds, pipe.device).randn(
            (len(padded), 4, latent_size, latent_size)).permute(0, 2, 3, 1)
        prompts = [captions[i % len(captions)] for i in padded]
        images = pipe.generate(prompts, latents, num_steps=num_steps_eval,
                               init_timestep=init_timestep, generator=step_gen)
        host = torch.empty(images.shape, dtype=torch.uint8, pin_memory=on_cuda)
        host.copy_(images, non_blocking=on_cuda)
        done = None
        if on_cuda:
            done = torch.cuda.Event()
            done.record()
        if pending is not None:
            written += flush(pending)
            if progress:
                print(f"  {written}/{len(my_seeds)} images", flush=True)
        pending = (host, done, batch_seeds)
    if pending is not None:
        written += flush(pending)
        if progress:
            print(f"  {written}/{len(my_seeds)} images", flush=True)
    return written


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="One-step SiD-LSG image generation (PyTorch port).")
    p.add_argument("--network", dest="network_path", default=None,
                   help="Generator checkpoint (.safetensors / reference .pkl / .pt / .bin)")
    p.add_argument("--outdir", required=True, help="Where to save images")
    p.add_argument("--seeds", default="0-63", help="Random seeds (e.g. 1,2,5-10); double as caption indices")
    p.add_argument("--subdirs", action="store_true", help="Subdirectory per 1000 seeds")
    p.add_argument("--batch", dest="max_batch_size", type=int_range(1), default=16, help="Maximum batch size")
    p.add_argument("--num", dest="num_samples", type=int_range(1), default=30000, help="Maximum number of images")
    p.add_argument("--init_timestep", type=int_range(0, 999), default=625)
    p.add_argument("--text_prompts", default="prompts/captions.txt", help="Captions file")
    p.add_argument("--repo_id", default="sd15",
                   help="Base SD checkpoint dir, or a preset (sd15/sd21base/tiny) with random "
                        "weights")
    p.add_argument("--use_bf16", type=parse_bool, default=True, help="bf16 activations")
    p.add_argument("--enable_compress_npz", type=parse_bool, default=False,
                   help="Pack the images into {outdir}.npz (arr_0) when done")
    p.add_argument("--num_steps_eval", type=int_range(1), default=1)
    p.add_argument("--custom_seed", type=parse_bool, default=False, help="Map seed list positions to caption indices")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    from ..pipeline import SDPipeline

    args = build_parser().parse_args(argv)
    runtime.init_distributed(args.device)
    seed_list = parse_int_list(args.seeds)[:args.num_samples]
    captions = read_prompt_file(args.text_prompts) if os.path.exists(args.text_prompts) else [""]
    pipe = SDPipeline.from_pretrained(args.repo_id,
                                      dtype=torch.bfloat16 if args.use_bf16 else torch.float32,
                                      device=args.device)
    if args.network_path:
        pipe.load_generator(args.network_path)
    runtime.print0(f'Generating {len(seed_list)} images to "{args.outdir}"...', flush=True)
    generate_images(pipe, captions, seed_list, args.outdir, max_batch_size=args.max_batch_size,
                    init_timestep=args.init_timestep, num_steps_eval=args.num_steps_eval,
                    subdirs=args.subdirs, custom_seed=args.custom_seed,
                    process_index=runtime.get_process_index(),
                    process_count=runtime.get_process_count())
    runtime.sync_hosts("generate-done")
    if args.enable_compress_npz and runtime.get_process_index() == 0:
        outdir = (f"{args.outdir}_numstep{args.num_steps_eval}" if args.num_steps_eval > 1
                  else args.outdir)
        print(f"packed: {compress_to_npz(outdir, args.num_samples)}", flush=True)
    runtime.print0("done.", flush=True)


if __name__ == "__main__":
    main()
