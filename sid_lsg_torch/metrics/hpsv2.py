"""HPSv2 as a registered metric.

Port of ``sid_lsg_tpu/metrics/hpsv2.py``.  Images are generated over the
HPSv2 benchmark prompts (``opts.hpsv2_prompts``: a ``{style: [prompts]}``
dict or json path; the ``hpsv2`` package where it imports) and scored with
the CLIP scorer (HPSv2 weights through ``SIDLSG_CLIP_WEIGHTS``).

Aggregation: the hpsv2 package scores each style benchmark on its own and
reports one mean per style; the summary number beside them (the paper's
Table 4 average) is the unweighted mean of the style means, not the mean
over all images pooled, so styles with unequal prompt counts (possible under
the ``num_gen`` cap) count equally.  ``num_gen // n_styles`` caps the prompts
per style; the published protocol scores 800 a style (``num_gen >= 3200``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from .metric_utils import seeded_latents
from .registry import MetricOptions, register_metric


def _benchmark_prompts(opts: MetricOptions) -> Dict[str, List[str]]:
    try:
        import hpsv2 as hps  # type: ignore

        return hps.benchmark_prompts("all")
    except ImportError:
        pass
    src = opts.hpsv2_prompts
    if isinstance(src, dict):
        return src
    if isinstance(src, str) and os.path.exists(src):
        with open(src, encoding="utf-8") as f:
            return json.load(f)
    raise RuntimeError("hpsv2 package not installed; set opts.hpsv2_prompts to a "
                       "{style: [prompts]} dict or json path")


@register_metric
def hpsv2(opts: MetricOptions):
    if opts.clip is None:
        from .detectors import clip_scorer

        opts.clip = clip_scorer(device=opts.device)
    all_prompts = _benchmark_prompts(opts)
    per_style = max(opts.num_gen // max(len(all_prompts), 1), 1)
    latent_size = opts.pipe.config.unet.sample_size
    results = {}
    for style, prompts in all_prompts.items():
        prompts = prompts[:per_style]
        scores: List[float] = []
        for start in range(0, len(prompts), opts.batch_size):
            chunk = prompts[start:start + opts.batch_size]
            padded = chunk + chunk[:1] * (opts.batch_size - len(chunk))
            seeds = list(range(start, start + len(padded)))
            images = opts.pipe.generate(padded, seeded_latents(seeds, latent_size, opts.pipe.device),
                                        num_steps=opts.num_steps_eval,
                                        init_timestep=opts.init_timestep,
                                        generator=torch.Generator().manual_seed(opts.seed))
            s = np.asarray(opts.clip.score(images.cpu().numpy(), padded))
            scores.extend(s[:len(chunk)].tolist())
        results[f"hpsv2_{style.replace('-', '_')}"] = float(np.mean(scores))
    results["hpsv2_mean"] = float(np.mean(list(results.values())))
    return results
