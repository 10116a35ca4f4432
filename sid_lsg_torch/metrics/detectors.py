"""Feature detector factories of the metric stack.

Port of ``sid_lsg_tpu/metrics/detectors.py``.  Weights come from the
``SIDLSG_INCEPTION_WEIGHTS`` / ``SIDLSG_CLIP_WEIGHTS`` environment variables
or an explicit path (torch files, read with ``torch.load(weights_only=True)``);
without them the detectors run on random weights from a seed, so the
metrics run offline, and say so on stderr: such numbers do not compare
across machines.
"""

from __future__ import annotations

import functools
import os
import sys
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device


@functools.lru_cache(maxsize=4)
def _inception(weights_path: Optional[str], device: str):
    from ..models.inception import load_inception

    model = load_inception(weights_path, device)
    if not weights_path:
        print("[sid_lsg_torch.metrics] WARNING: InceptionV3 running with random weights (set "
              "SIDLSG_INCEPTION_WEIGHTS for comparable FID).", file=sys.stderr)
    return model


def inception_detector(weights_path: Optional[str] = None, device="cuda") -> Callable:
    """uint8 (B, H, W, 3) -> (B, 2048) float32 FID features (numpy)."""
    weights_path = weights_path or os.environ.get("SIDLSG_INCEPTION_WEIGHTS") or None
    model = _inception(weights_path, str(resolve_device(device)))

    @torch.no_grad()
    def detect(images: np.ndarray) -> np.ndarray:
        return model(torch.from_numpy(np.ascontiguousarray(images))).cpu().numpy()

    return detect


@functools.lru_cache(maxsize=2)
def clip_scorer(weights_path: Optional[str] = None, preset: str = "auto", device="cuda"):
    """The joint CLIP scorer: open_clip ViT-g/14 for the CLIP score, an HPSv2
    ViT-H/14 checkpoint for the hpsv2 metric; the tower comes from the
    checkpoint's own shapes unless ``preset`` names one."""
    from ..models.clip_vision import (TINY_CLIP, VIT_G_14, VIT_H_14, CLIPScorer,
                                      config_from_open_clip, convert_open_clip)

    weights_path = weights_path or os.environ.get("SIDLSG_CLIP_WEIGHTS") or None
    if weights_path:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        cfg = (config_from_open_clip(sd) if preset == "auto"
               else {"vit_g_14": VIT_G_14, "vit_h_14": VIT_H_14, "tiny": TINY_CLIP}[preset])
        return CLIPScorer(cfg, state_dict=convert_open_clip(sd, cfg), device=device)
    print("[sid_lsg_torch.metrics] WARNING: CLIP scorer running with random tiny weights (set "
          "SIDLSG_CLIP_WEIGHTS for comparable CLIP scores).", file=sys.stderr)
    return CLIPScorer(TINY_CLIP, device=device)
