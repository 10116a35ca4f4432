"""Metric registry, dispatch and jsonl reporting.

Port of ``sid_lsg_tpu/metrics/registry.py``: ``@register_metric`` keeps a
name -> function table, ``calc_metric`` times one metric and
``report_metric`` prints its line and appends it to
``<run_dir>/metric-<name>.jsonl``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional

from ..utils.util import EasyDict, format_time

_metric_dict: Dict[str, Callable] = {}


def register_metric(fn: Callable) -> Callable:
    if fn.__name__ in _metric_dict:
        raise ValueError(f"metric {fn.__name__!r} is registered twice")
    _metric_dict[fn.__name__] = fn
    return fn


def is_valid_metric(metric: str) -> bool:
    return metric in _metric_dict


def list_valid_metrics():
    return list(_metric_dict.keys())


class MetricOptions:
    """Everything a metric needs.

    - ``pipe``: an ``SDPipeline`` whose generator is the model under eval.
    - ``dataset_path``: a prepared COCO eval folder or zip (image + txt pairs).
    - ``detector``: ``uint8 (B, H, W, 3) -> (B, F)`` features for FID and
      precision/recall; the port's InceptionV3 on ``device`` by default.
    - ``clip``: the joint image/text scorer of the CLIP score and hpsv2.
    - ``device``: where the default detectors run; the pipeline's device,
      else the card.
    """

    def __init__(self, pipe=None, dataset_path: Optional[str] = None,
                 detector: Optional[Callable] = None, clip=None, cache_dir: Optional[str] = None,
                 batch_size: int = 16, num_gen: int = 30000, init_timestep: int = 625,
                 num_steps_eval: int = 1, resolution: int = 256, seed: int = 0,
                 verbose: bool = True, progress=None, device=None):
        self.pipe = pipe
        self.dataset_path = dataset_path
        self._detector = detector
        self.clip = clip
        self.cache_dir = cache_dir or os.path.join(os.path.expanduser("~"), ".cache",
                                                   "sid_lsg_torch")
        self.batch_size = batch_size
        self.num_gen = num_gen
        self.init_timestep = init_timestep
        self.num_steps_eval = num_steps_eval
        self.resolution = resolution
        self.seed = seed
        self.verbose = verbose
        self.progress = progress
        self.device = device or (pipe.device if pipe is not None else "cuda")
        self.hpsv2_prompts = None

    @property
    def detector(self) -> Callable:
        if self._detector is None:
            from .detectors import inception_detector

            self._detector = inception_detector(device=self.device)
        return self._detector


def calc_metric(metric: str, **kwargs: Any) -> EasyDict:
    if not is_valid_metric(metric):
        raise ValueError(f"unknown metric {metric!r}; registered: {list_valid_metrics()}")
    opts = kwargs.pop("opts", None) or MetricOptions(**kwargs)
    start = time.time()
    results = _metric_dict[metric](opts)
    total_time = time.time() - start
    return EasyDict(results=EasyDict(results), metric=metric, total_time=total_time,
                    total_time_str=format_time(total_time), num_gen=opts.num_gen)


def report_metric(result_dict: EasyDict, run_dir: Optional[str] = None,
                  snapshot_pkl: Optional[str] = None) -> None:
    metric = result_dict["metric"]
    if snapshot_pkl is not None and run_dir is not None:
        snapshot_pkl = os.path.relpath(snapshot_pkl, run_dir)
    jsonl_line = json.dumps(dict(result_dict, snapshot_pkl=snapshot_pkl, timestamp=time.time()))
    print(jsonl_line)
    if run_dir is not None and os.path.isdir(run_dir):
        with open(os.path.join(run_dir, f"metric-{metric}.jsonl"), "at") as f:
            f.write(jsonl_line + "\n")
