"""Sliding-window inference over an in-memory volume.

The port of the model pass of ``mt3d_resenc_unet_tpu/infer/engine.py``
(``_setup_model_pass``, engine.py:302-397): patches on the sliding-window
grid are normalized as that engine reads them, run through the eval
forward in batches, weighted by the Gaussian importance map on the device,
and blended as ``sum(pred * w) / sum(w)``. Both sums live in device
memory. Zarr I/O, rolling slabs, finalize/quantize and export are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.positions import sliding_window_grid
from ..data.zio import normalize_to_unit
from .gaussian import gaussian_map


def standardize(patch: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Per-patch z-score, non-channelwise — the reference's inference-time
    normalization (dataloading/inference_dataset.py:25 Standardize)."""
    mean = patch.mean()
    std = patch.std()
    return (patch - mean) / np.maximum(std, eps)


def predict_volume(model: torch.nn.Module, volume: np.ndarray,
                   patch: Sequence[int], overlap: float = 0.25,
                   batch_size: int = 2,
                   device: Optional[torch.device] = None,
                   normalization: str = "standardize",
                   sigma_scale: float = 1.0 / 8) -> Dict[str, np.ndarray]:
    """Blend the model's eval predictions over ``volume`` (D, H, W).

    Returns ``{task: (D, H, W, C) float32}``, the Gaussian-weighted average
    of every patch prediction covering each voxel. ``normalization`` is
    ``"standardize"`` (per-patch z-score after the unit scaling, the JAX
    engine's default) or ``"none"``."""
    if normalization not in ("standardize", "none"):
        raise ValueError(f"unknown normalization {normalization!r}")
    if device is None:
        device = next(model.parameters()).device
    patch = tuple(int(p) for p in patch)
    shape = tuple(volume.shape)
    positions = sorted(sliding_window_grid(shape, patch, overlap))
    wmap = torch.from_numpy(gaussian_map(patch, sigma_scale)).to(device)
    tasks = model.plan.tasks
    sums = {t.name: torch.zeros(shape + (t.channels,), dtype=torch.float32,
                                device=device) for t in tasks}
    weight = torch.zeros(shape, dtype=torch.float32, device=device)

    def read(pos):
        z, y, x = pos
        p = normalize_to_unit(
            volume[z:z + patch[0], y:y + patch[1], x:x + patch[2]],
            volume.dtype)
        return standardize(p) if normalization == "standardize" else p

    with torch.inference_mode():
        for i in range(0, len(positions), batch_size):
            chunk = positions[i:i + batch_size]
            host = np.stack([read(pos) for pos in chunk])[..., None]
            outs = model(torch.from_numpy(host).to(device))
            for b, (z, y, x) in enumerate(chunk):
                sl = (slice(z, z + patch[0]), slice(y, y + patch[1]),
                      slice(x, x + patch[2]))
                for t in tasks:
                    sums[t.name][sl] += outs[t.name][b] * wmap[..., None]
                weight[sl] += wmap
        return {t.name: (sums[t.name] / weight[..., None]).cpu().numpy()
                for t in tasks}
