"""Shared metric machinery: dataset and generator feature loops, cached.

Port of ``sid_lsg_tpu/metrics/metric_utils.py`` for one process.
``compute_feature_stats_for_dataset`` keeps the real images' stats in an
md5-keyed cache; ``compute_feature_stats_for_generator`` generates image i
from seed i's latents (drawn as ``generate_onestep`` draws them) and caption
i, resizes it to the eval resolution with Pillow's BICUBIC
(``utils.resample``) and streams it through the detector (and the CLIP
scorer), so a result depends on the generator and the dataset alone.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.mscoco import CocoCaptionDataset
from ..diffusion.rng import StackedRandomGenerator
from ..utils.resample import resize_uint8
from .feature_stats import FeatureStats, ProgressMonitor
from .registry import MetricOptions


def _resize_uint8(images: np.ndarray, size: int) -> np.ndarray:
    """uint8 (N, H, W, 3) -> (N, size, size, 3), Pillow BICUBIC."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    return resize_uint8(images, (size, size), "bicubic")


def seeded_latents(seeds, latent_size: int, device) -> torch.Tensor:
    """(N, s, s, 4) noise latents, seed by seed, as ``generate_onestep`` draws them."""
    return StackedRandomGenerator(seeds, device).randn(
        (len(seeds), 4, latent_size, latent_size)).permute(0, 2, 3, 1)


def compute_feature_stats_for_dataset(opts: MetricOptions, max_items: Optional[int] = None,
                                      capture_all: bool = False, capture_mean_cov: bool = True,
                                      detector_name: str = "inception") -> FeatureStats:
    if not opts.dataset_path:
        raise ValueError("the real-image stats need opts.dataset_path")
    dataset = CocoCaptionDataset(opts.dataset_path, resolution=opts.resolution)
    n = len(dataset) if max_items is None else min(len(dataset), max_items)
    # The detector's weights file is part of the key: other weights, other stats.
    detector_id = (detector_name, os.environ.get("SIDLSG_INCEPTION_WEIGHTS", ""))
    cache_tag = hashlib.md5(repr((os.path.abspath(opts.dataset_path), detector_id, n,
                                  opts.resolution, capture_all)).encode()).hexdigest()
    cache_file = os.path.join(opts.cache_dir, f"real-stats-{dataset.name}-{cache_tag}.npz")
    if os.path.isfile(cache_file):
        return FeatureStats.load(cache_file)
    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=capture_mean_cov, max_items=n)
    progress = ProgressMonitor("dataset features", n, verbose=opts.verbose)
    done = 0
    for images, _ in dataset.batches(opts.batch_size, max_items=n):
        stats.append(np.asarray(opts.detector(images)))
        done += len(images)
        progress.update(done)
    stats.merge_across_processes()
    os.makedirs(opts.cache_dir, exist_ok=True)
    stats.save(cache_file)
    return stats


def compute_feature_stats_for_generator(opts: MetricOptions, max_items: Optional[int] = None,
                                        capture_all: bool = False, capture_mean_cov: bool = True,
                                        with_clip_score: bool = False
                                        ) -> Tuple[FeatureStats, Optional[float]]:
    """Caption-prompted images through the detector; returns (stats, the
    mean CLIP score or None)."""
    if opts.pipe is None:
        raise ValueError("the generator stats need opts.pipe")
    n = opts.num_gen if max_items is None else max_items
    dataset = CocoCaptionDataset(opts.dataset_path) if opts.dataset_path else None
    captions = dataset.captions() if dataset else [""]
    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=capture_mean_cov, max_items=n)
    progress = ProgressMonitor("generator features", n, verbose=opts.verbose)
    clip_sum, clip_count = 0.0, 0
    latent_size = opts.pipe.config.unet.sample_size
    for start in range(0, n, opts.batch_size):
        ids = list(range(start, min(start + opts.batch_size, n)))
        padded = ids + ids[:1] * (opts.batch_size - len(ids))  # one batch shape
        prompts = [captions[i % len(captions)] for i in padded]
        images = opts.pipe.generate(prompts, seeded_latents(padded, latent_size, opts.pipe.device),
                                    num_steps=opts.num_steps_eval,
                                    init_timestep=opts.init_timestep,
                                    generator=torch.Generator().manual_seed(opts.seed))
        images = images.cpu().numpy()[:len(ids)]
        eval_images = _resize_uint8(images, opts.resolution)
        stats.append(np.asarray(opts.detector(eval_images)))
        if with_clip_score and opts.clip is not None:
            scores = np.asarray(opts.clip.score(eval_images, prompts[:len(ids)]))
            clip_sum += float(scores.sum())
            clip_count += len(scores)
        progress.update(ids[-1] + 1)
        if stats.is_full():
            break
    stats.merge_across_processes()
    return stats, (clip_sum / clip_count if clip_count else None)
