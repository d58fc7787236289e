"""Sliding-window position grids for patch-wise inference.

Semantics match the reference (reference: helpers.py:200-216
``generate_positions`` and dataloading/inference_dataset.py:43-56): start
positions at stride ``patch * (1 - overlap)``, with a forced final position
so the last patch ends exactly at the volume boundary.

A copy of ``mt3d_resenc_unet_tpu/data/positions.py``, whose package the
port cannot import.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def generate_positions(min_val: int, max_val: int, patch_size: int, step: int) -> List[int]:
    """Start indices for 1-D sliding-window coverage of [min_val, max_val)."""
    if max_val - min_val < patch_size:
        raise ValueError(
            f"extent {max_val - min_val} smaller than patch {patch_size}")
    step = max(1, step)
    positions = []
    pos = min_val
    while pos + patch_size <= max_val:
        positions.append(pos)
        pos += step
    last_start = max_val - patch_size
    if last_start > positions[-1]:
        positions.append(last_start)
    return sorted(set(positions))


def sliding_window_grid(
    volume_shape: Sequence[int],
    patch_size: Sequence[int],
    overlap: float = 0.25,
) -> List[Tuple[int, ...]]:
    """All (z, y, x) patch start positions covering the volume."""
    axes_positions = []
    for extent, p in zip(volume_shape, patch_size):
        step = int(round(p * (1.0 - overlap)))
        axes_positions.append(generate_positions(0, extent, p, step))
    grid: List[Tuple[int, ...]] = []
    if len(patch_size) == 3:
        for z in axes_positions[0]:
            for y in axes_positions[1]:
                for x in axes_positions[2]:
                    grid.append((z, y, x))
    else:
        for y in axes_positions[0]:
            for x in axes_positions[1]:
                grid.append((y, x))
    return grid
