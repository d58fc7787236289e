"""Chunked bounding-box crop of a zarr volume.

A copy of ``mt3d_resenc_unet_tpu/tools/zarr_crop.py`` (reference:
scripts/zarr_bbox_to_zarr.py:7-162) onto the port's ``data/zio.py``. The
crop is written with ``compressor: null`` by default, so it needs no
package; a compressed input or output goes through tensorstore, as in the
JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..data.zio import create_zarr, open_zarr


def cut_zarr_bounding_box(
    input_path: str,
    output_path: str,
    z_start: int, z_stop: int,
    y_start: int, y_stop: int,
    x_start: int, x_stop: int,
    chunks: Optional[Tuple[int, int, int]] = None,
    compressor=None,
    max_in_flight: int = 16,
) -> str:
    src = open_zarr(input_path)
    sub = (z_stop - z_start, y_stop - y_start, x_stop - x_start)
    if any(s <= 0 for s in sub):
        raise ValueError(f"Empty crop region {sub}")
    if chunks is None:
        chunks = tuple(min(c, s) for c, s in zip(src.chunks[-3:], sub))
    dst = create_zarr(output_path, sub, src.dtype, chunks,
                      compressor=compressor, delete_existing=True)

    pending = []
    cz, cy, cx = chunks
    for z0 in range(0, sub[0], cz):
        for y0 in range(0, sub[1], cy):
            for x0 in range(0, sub[2], cx):
                z1 = min(z0 + cz, sub[0])
                y1 = min(y0 + cy, sub[1])
                x1 = min(x0 + cx, sub[2])
                read = src.read_async(np.s_[
                    z_start + z0:z_start + z1,
                    y_start + y0:y_start + y1,
                    x_start + x0:x_start + x1])
                pending.append((np.s_[z0:z1, y0:y1, x0:x1], read))
                if len(pending) >= max_in_flight:
                    idx, fut = pending.pop(0)
                    dst.write_async(idx, np.asarray(fut.result()))
    writes = []
    for idx, fut in pending:
        writes.append(dst.write_async(idx, np.asarray(fut.result())))
    for wfut in writes:
        wfut.result()
    return output_path
