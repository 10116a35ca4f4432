"""The metric stack of the port: FID, CLIP score, precision/recall, HPSv2.

Port of ``sid_lsg_tpu/metrics``.  Importing the package registers every
metric (``list_valid_metrics``); ``calc_metric(name, opts=MetricOptions(...))``
runs one and ``report_metric`` appends it to ``metric-<name>.jsonl``.
"""

from .feature_stats import FeatureStats, ProgressMonitor
from .fid import compute_fid_from_stats, frechet_distance
from .registry import (
    MetricOptions,
    calc_metric,
    is_valid_metric,
    list_valid_metrics,
    register_metric,
    report_metric,
)

__all__ = [
    "FeatureStats",
    "ProgressMonitor",
    "frechet_distance",
    "compute_fid_from_stats",
    "MetricOptions",
    "calc_metric",
    "is_valid_metric",
    "list_valid_metrics",
    "register_metric",
    "report_metric",
]

from . import fid_and_clip  # noqa: E402,F401  (registers the fid / clip metrics)
from . import precision_recall  # noqa: E402,F401  (registers the pr metrics)
from . import hpsv2  # noqa: E402,F401  (registers hpsv2)
