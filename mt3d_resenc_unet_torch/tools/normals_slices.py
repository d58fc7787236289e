"""Export a (3, Z, Y, X) normals zarr as per-Z images
(reference: scripts/write_normals_from_zarr.py:9-72): 16-bit PNG for full
range or 8-bit JPEG for quick viewing.

A copy of ``mt3d_resenc_unet_tpu/tools/normals_slices.py`` onto the port's
``data/zio.py``; images go through ``tools/images.py`` (cv2, else PIL)."""

from __future__ import annotations

import os

import numpy as np

from ..data.zio import open_zarr
from .images import write_image


def write_normals_slices(zarr_path: str, output_dir: str,
                         use_16bit: bool = False) -> int:
    os.makedirs(output_dir, exist_ok=True)
    vol = open_zarr(zarr_path)
    if vol.shape[0] != 3:
        raise ValueError(f"Expected (3, Z, Y, X) normals, got {vol.shape}")
    z_dim = vol.shape[1]
    for z in range(z_dim):
        sl = np.transpose(vol[:, z], (1, 2, 0))
        if use_16bit:
            if sl.dtype != np.uint16:
                sl = np.clip(sl, 0, 65535).astype(np.uint16)
            write_image(os.path.join(output_dir, f"normals_z{z:04d}.png"),
                        np.ascontiguousarray(sl))
        else:
            if sl.dtype == np.uint16:
                sl = (sl // 257).astype(np.uint8)
            write_image(os.path.join(output_dir, f"normals_z{z:04d}.jpg"),
                        np.ascontiguousarray(sl.astype(np.uint8)))
    return z_dim


def main():  # pragma: no cover
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--zarr_path", required=True)
    p.add_argument("--output_dir", default="./normals_slices")
    p.add_argument("--use_16bit", action="store_true")
    a = p.parse_args()
    n = write_normals_slices(a.zarr_path, a.output_dir, a.use_16bit)
    print(f"wrote {n} slices to {a.output_dir}")


if __name__ == "__main__":  # pragma: no cover
    main()
