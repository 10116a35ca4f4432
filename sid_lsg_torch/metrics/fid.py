"""Fréchet distance between feature Gaussians.

Port of ``sid_lsg_tpu/metrics/fid.py``:
``FID = |mu_g - mu_r|^2 + tr(C_g + C_r - 2 (C_g C_r)^{1/2})`` in float64 on
the host, the matrix square root by ``scipy.linalg.sqrtm``.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg


def sqrtm_product_trace(cov_a: np.ndarray, cov_b: np.ndarray) -> float:
    """tr((cov_a cov_b)^{1/2}), real part."""
    s = scipy.linalg.sqrtm(cov_a.astype(np.float64) @ cov_b.astype(np.float64))
    if isinstance(s, tuple):
        s = s[0]
    return float(np.real(np.trace(s)))


def frechet_distance(mu_a, cov_a, mu_b, cov_b) -> float:
    mu_a = np.asarray(mu_a, np.float64)
    mu_b = np.asarray(mu_b, np.float64)
    m = float(np.square(mu_a - mu_b).sum())
    tr_ab = sqrtm_product_trace(np.asarray(cov_a), np.asarray(cov_b))
    return float(m + np.trace(cov_a) + np.trace(cov_b) - 2.0 * tr_ab)


def compute_fid_from_stats(stats_gen, stats_real) -> float:
    mu_g, cov_g = stats_gen.get_mean_cov()
    mu_r, cov_r = stats_real.get_mean_cov()
    return frechet_distance(mu_g, cov_g, mu_r, cov_r)
