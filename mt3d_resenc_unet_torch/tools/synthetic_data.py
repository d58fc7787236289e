"""A seeded synthetic sheet + normals dataset as zarr v2.

    paths = write_sheet_dataset(root, (256, 384, 384), seed=0)

writes ``image.zarr`` (uint8), ``sheet.zarr`` (uint8 in {0, 255}) and
``normals.zarr`` (uint16 (Z, Y, X, 3) from ``encode_normals_u16``) under
``root`` with the port's zarr writer (``compressor``: the JAX package's
default, Blosc zstd-5 bit shuffle, unless given), and returns their paths in
the ``dataset_config.volume_paths`` form. The sheets are wavy layers
``(z + h(y, x)) mod 3 != 0``: two voxels of every three are labelled, and
every labelled slab spans whole patches in y and x, so the patch miner
finds every patch inside the volume at ``min_bbox_percent`` 0.97 and
``min_labeled_ratio`` 0.15. The normals are the layers' unit normals
(nx, ny, nz); the image is the sheet mask blurred by noise.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..data.zio import DEFAULT_COMPRESSOR, create_zarr, encode_normals_u16


def write_sheet_dataset(
        root, shape: Sequence[int], seed: int = 0,
        chunks: Sequence[int] = (64, 64, 64),
        compressor: Optional[Dict[str, Any]] = DEFAULT_COMPRESSOR,
) -> Dict[str, str]:
    d, h, w = (int(s) for s in shape)
    root = Path(root)
    rng = np.random.default_rng(seed)
    amp_y, amp_x = rng.uniform(2.0, 6.0, 2)
    per_y, per_x = rng.uniform(64.0, 160.0, 2)
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    height = (amp_y * np.sin(2 * np.pi * yy / per_y)
              + amp_x * np.sin(2 * np.pi * xx / per_x))           # (H, W)
    dh_dy = amp_y * 2 * np.pi / per_y * np.cos(2 * np.pi * yy / per_y)
    dh_dx = amp_x * 2 * np.pi / per_x * np.cos(2 * np.pi * xx / per_x)
    # the level sets z + h(y, x) = c have normal (dh/dx, dh/dy, 1)
    n = np.stack(np.broadcast_arrays(dh_dx, dh_dy, np.ones_like(height)),
                 axis=-1)
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    normals_plane = encode_normals_u16(n)                         # (H, W, 3)
    offset = np.round(height).astype(np.int64)

    paths = {name: str(root / f"{name}.zarr")
             for name in ("image", "sheet", "normals")}
    image = create_zarr(paths["image"], (d, h, w), np.uint8, chunks,
                        compressor=compressor)
    sheet = create_zarr(paths["sheet"], (d, h, w), np.uint8, chunks,
                        compressor=compressor)
    normals = create_zarr(paths["normals"], (d, h, w, 3), np.uint16,
                          tuple(chunks) + (3,), compressor=compressor)
    for z0 in range(0, d, chunks[0]):
        zs = np.arange(z0, min(d, z0 + chunks[0]))[:, None, None]
        mask = (zs + offset[None]) % 3 != 0
        sheet[z0:z0 + len(zs)] = mask.astype(np.uint8) * np.uint8(255)
        noise = rng.normal(0.0, 30.0, mask.shape)
        image[z0:z0 + len(zs)] = np.clip(
            60.0 + 120.0 * mask + noise, 0, 255).astype(np.uint8)
        normals[z0:z0 + len(zs)] = np.broadcast_to(
            normals_plane, (len(zs), h, w, 3))
    return {"input": paths["image"], "sheet": paths["sheet"],
            "normals": paths["normals"], "ref_label": "sheet"}
