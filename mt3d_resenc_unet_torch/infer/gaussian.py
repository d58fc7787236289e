"""Gaussian patch-importance maps for sliding-window blending.

The reference shipped an nnU-Net-style Gaussian map helper but never wired it
in — its accumulation is uniform count-averaging and the helper itself
crashes on an undefined cache global (reference: inference/helpers.py:8-91,
SURVEY.md §2.6.6). Here Gaussian weighting is first-class: the map is
computed once per (patch_size, sigma_scale), multiplied into predictions
on the device, and accumulated alongside a weight volume so overlap
blending is a true weighted average.

A copy of ``mt3d_resenc_unet_tpu/infer/gaussian.py``, whose package the
port cannot import.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
from scipy.ndimage import gaussian_filter


@lru_cache(maxsize=16)
def gaussian_map(patch_size: Tuple[int, ...], sigma_scale: float = 1.0 / 8,
                 value_scaling_factor: float = 1.0) -> np.ndarray:
    """(D, H, W) float32 map: Gaussian centered in the patch, peak scaled to
    ``value_scaling_factor``, zeros floored to the smallest positive value
    (reference semantics: inference/helpers.py:8-68)."""
    tmp = np.zeros(patch_size, dtype=np.float32)
    center = tuple(d // 2 for d in patch_size)
    tmp[center] = 1.0
    sigmas = [d * sigma_scale for d in patch_size]
    gmap = gaussian_filter(tmp, sigma=sigmas, mode="constant", cval=0.0)
    gmap = gmap / (gmap.max() / value_scaling_factor)
    positive_min = gmap[gmap > 0].min()
    gmap[gmap == 0] = positive_min
    return gmap.astype(np.float32)


def uniform_map(patch_size: Tuple[int, ...]) -> np.ndarray:
    """Uniform weighting — reproduces the reference's count-averaging
    behavior exactly (reference: inference.py:135-157)."""
    return np.ones(patch_size, dtype=np.float32)
