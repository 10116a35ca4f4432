"""Improved precision and recall (Kynkäänniemi et al.) on detector features.

Port of ``sid_lsg_tpu/metrics/precision_recall.py``: the k-th nearest
neighbour radius of each sample of one set, then the share of the other
set's samples inside any of those balls.  The squared distances are plain
``torch`` matmuls (|a|^2 + |b|^2 - 2 a.b) in row and column chunks on
``device``: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .metric_utils import compute_feature_stats_for_dataset, compute_feature_stats_for_generator
from .registry import MetricOptions, register_metric


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    an = (a * a).sum(dim=1, keepdim=True)
    bn = (b * b).sum(dim=1, keepdim=True)
    return (an + bn.t() - 2.0 * (a @ b.t())).clamp_min(0.0)


def kth_nn_radii(features: np.ndarray, nhood_size: int, row_batch: int = 4096,
                 col_batch: int = 16384, device="cuda") -> np.ndarray:
    """Squared distance to the k-th nearest neighbour (self excluded) per sample."""
    feats = torch.as_tensor(np.asarray(features, np.float32), device=resolve_device(device))
    radii = np.empty(len(feats), np.float32)
    for r0 in range(0, len(feats), row_batch):
        rows = feats[r0:r0 + row_batch]
        d = torch.cat([_sq_dists(rows, feats[c0:c0 + col_batch])
                       for c0 in range(0, len(feats), col_batch)], dim=1)
        k = min(nhood_size + 1, d.shape[1])  # the k + 1 smallest hold the 0 to itself
        radii[r0:r0 + row_batch] = d.topk(k, dim=1, largest=False).values[:, -1].cpu().numpy()
    return radii


def manifold_membership(probes: np.ndarray, manifold: np.ndarray, radii: np.ndarray,
                        row_batch: int = 4096, device="cuda") -> np.ndarray:
    """Whether each probe lies inside any manifold sample's k-NN ball."""
    dev = resolve_device(device)
    man = torch.as_tensor(np.asarray(manifold, np.float32), device=dev)
    rad = torch.as_tensor(np.asarray(radii, np.float32), device=dev)
    hits = np.empty(len(probes), bool)
    for r0 in range(0, len(probes), row_batch):
        rows = torch.as_tensor(np.asarray(probes[r0:r0 + row_batch], np.float32), device=dev)
        hits[r0:r0 + row_batch] = (_sq_dists(rows, man) <= rad[None, :]).any(dim=1).cpu().numpy()
    return hits


def compute_pr(real: np.ndarray, gen: np.ndarray, nhood_size: int = 3, device="cuda"):
    precision = float(manifold_membership(gen, real, kth_nn_radii(real, nhood_size, device=device),
                                          device=device).mean())
    recall = float(manifold_membership(real, gen, kth_nn_radii(gen, nhood_size, device=device),
                                       device=device).mean())
    return precision, recall


@register_metric
def pr30k_full(opts: MetricOptions):
    real = compute_feature_stats_for_dataset(opts, capture_all=True,
                                             capture_mean_cov=False).get_all()
    gen, _ = compute_feature_stats_for_generator(opts, max_items=opts.num_gen, capture_all=True,
                                                 capture_mean_cov=False)
    precision, recall = compute_pr(real, gen.get_all(), device=opts.device)
    return dict(pr30k_precision=precision, pr30k_recall=recall)


@register_metric
def pr_test(opts: MetricOptions):
    real = compute_feature_stats_for_dataset(opts, max_items=32, capture_all=True,
                                             capture_mean_cov=False).get_all()
    gen, _ = compute_feature_stats_for_generator(opts, max_items=8, capture_all=True,
                                                 capture_mean_cov=False)
    precision, recall = compute_pr(real, gen.get_all(), device=opts.device)
    return dict(pr_test_precision=precision, pr_test_recall=recall)
