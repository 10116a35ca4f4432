"""FID and CLIP-score metrics: the headline eval numbers.

Port of ``sid_lsg_tpu/metrics/fid_and_clip.py``: ``fid30k_full`` /
``fid_clip_30k_full`` (``num_gen`` caption-prompted images against the whole
eval set) and the small ``fid_test`` / ``fid_clip_test`` (8 generated
against 64 real).
"""

from __future__ import annotations

from typing import Optional

from .fid import frechet_distance
from .metric_utils import compute_feature_stats_for_dataset, compute_feature_stats_for_generator
from .registry import MetricOptions, register_metric


def compute_fid_and_clip(opts: MetricOptions, max_real: Optional[int], num_gen: int,
                         with_clip: bool):
    if with_clip and opts.clip is None:
        from .detectors import clip_scorer

        opts.clip = clip_scorer(device=opts.device)
    real_stats = compute_feature_stats_for_dataset(opts, max_items=max_real, capture_mean_cov=True)
    gen_stats, clip_score = compute_feature_stats_for_generator(
        opts, max_items=num_gen, capture_mean_cov=True, with_clip_score=with_clip)
    mu_r, cov_r = real_stats.get_mean_cov()
    mu_g, cov_g = gen_stats.get_mean_cov()
    return frechet_distance(mu_g, cov_g, mu_r, cov_r), clip_score


@register_metric
def fid30k_full(opts: MetricOptions):
    fid, _ = compute_fid_and_clip(opts, max_real=None, num_gen=opts.num_gen, with_clip=False)
    return dict(fid30k_full=fid)


@register_metric
def fid_clip_30k_full(opts: MetricOptions):
    fid, clip = compute_fid_and_clip(opts, max_real=None, num_gen=opts.num_gen, with_clip=True)
    return dict(fid_clip_30k_full=fid, clip_score=clip)


@register_metric
def fid_test(opts: MetricOptions):
    fid, _ = compute_fid_and_clip(opts, max_real=64, num_gen=min(opts.num_gen, 8),
                                  with_clip=False)
    return dict(fid_test=fid)


@register_metric
def fid_clip_test(opts: MetricOptions):
    fid, clip = compute_fid_and_clip(opts, max_real=64, num_gen=min(opts.num_gen, 8),
                                     with_clip=True)
    return dict(fid_clip_test=fid, clip_score_test=clip)
