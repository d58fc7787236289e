"""Debug visualization: per-epoch GIF panels and dataloader TIFF dumps.

A copy of ``mt3d_resenc_unet_tpu/train/visualization.py``; imageio and PIL
stay optional.

Parity with the reference's visual QA tooling
(reference: training/visualization/plotting.py:172-317): a per-Z-slice
two-row panel GIF (top: input + ground truths, bottom: predictions) with
per-slice min-max scaling and 3-channel normals rendered as RGB, plus the
``--debug_dataloader`` TIFF export of exactly what tensors the model sees.

Arrays are channels-last: (D, H, W, C) or batched (1, D, H, W, C).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np

try:
    import imageio.v2 as imageio
    _HAS_IMAGEIO = True
except Exception:  # pragma: no cover
    _HAS_IMAGEIO = False

try:
    from PIL import Image
    _HAS_PIL = True
except Exception:  # pragma: no cover
    _HAS_PIL = False


def _minmax_u8(a: np.ndarray) -> np.ndarray:
    a = a.astype(np.float32)
    lo, hi = float(a.min()), float(a.max())
    if hi - lo < 1e-8:
        return np.zeros(a.shape, np.uint8)
    return ((a - lo) / (hi - lo) * 255.0).astype(np.uint8)


def slice_to_rgb(sl: np.ndarray, is_normals: bool = False) -> np.ndarray:
    """(H, W, C) slice -> (H, W, 3) uint8. Normals map [-1,1] -> [0,255]
    channelwise (reference: plotting.py:25-111 convert_slice_to_bgr)."""
    if sl.ndim == 2:
        sl = sl[..., None]
    c = sl.shape[-1]
    if is_normals and c == 3:
        rgb = np.clip((sl + 1.0) * 127.5, 0, 255).astype(np.uint8)
        return rgb
    if c == 1:
        g = _minmax_u8(sl[..., 0])
        return np.stack([g, g, g], axis=-1)
    if c >= 3:
        return np.stack([_minmax_u8(sl[..., i]) for i in range(3)], axis=-1)
    g = _minmax_u8(sl[..., 0])
    return np.stack([g, g, g], axis=-1)


def _squeeze_batch(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a[0] if a.ndim == 5 else a


def save_debug_gif(
    input_volume: np.ndarray,
    targets_dict: Mapping[str, np.ndarray],
    outputs_dict: Mapping[str, np.ndarray],
    tasks_dict: Mapping[str, Mapping],
    epoch: int,
    save_path: str,
    fps: int = 8,
) -> Optional[str]:
    """Two-row per-slice panel GIF (reference: plotting.py:172-275)."""
    if not _HAS_IMAGEIO:
        return None
    inp = _squeeze_batch(input_volume)
    tnames = list(tasks_dict.keys())
    depth = inp.shape[0]
    frames = []
    for z in range(depth):
        top = [slice_to_rgb(inp[z])]
        bottom = [np.zeros_like(top[0])]
        for t in tnames:
            is_n = t.lower() == "normals"
            gt = _squeeze_batch(np.asarray(targets_dict[t]))
            pr = _squeeze_batch(np.asarray(outputs_dict[t]))
            top.append(slice_to_rgb(gt[z], is_n))
            bottom.append(slice_to_rgb(pr[z], is_n))
        h = max(p.shape[0] for p in top + bottom)
        w = max(p.shape[1] for p in top + bottom)

        def padto(p):
            out = np.zeros((h, w, 3), np.uint8)
            out[: p.shape[0], : p.shape[1]] = p
            return out

        frame = np.concatenate([
            np.concatenate([padto(p) for p in top], axis=1),
            np.concatenate([padto(p) for p in bottom], axis=1),
        ], axis=0)
        frames.append(frame)
    imageio.mimsave(save_path, frames, duration=int(1000 / fps), loop=0)
    return save_path


def log_3d_slices_as_images(writer, tag: str, volume: np.ndarray, step: int,
                            max_slices: int = 8,
                            is_normals: bool = False) -> None:
    """Log evenly spaced Z slices of a (D, H, W, C) volume as TensorBoard
    images (reference: plotting.py:115-170)."""
    if writer is None or getattr(writer, "_tb", None) is None:
        return
    vol = _squeeze_batch(volume)
    depth = vol.shape[0]
    zs = np.linspace(0, depth - 1, min(max_slices, depth)).astype(int)
    for i, z in enumerate(zs):
        rgb = slice_to_rgb(vol[z], is_normals)
        writer._tb.add_image(f"{tag}/z{i}", rgb, step, dataformats="HWC")


def export_data_dict_as_tif(dataset, num_batches: int, out_dir: str) -> None:
    """Dump the first N dataset samples as multipage TIFFs — the
    ``--debug_dataloader`` path (reference: train.py:137-144,
    plotting.py:285-317)."""
    if not _HAS_PIL:
        raise RuntimeError("PIL unavailable; cannot export debug TIFFs")
    os.makedirs(out_dir, exist_ok=True)
    n = min(num_batches, len(dataset))
    for i in range(n):
        data = dataset[i]
        for key, arr in data.items():
            arr = np.asarray(arr)
            if arr.ndim == 4:  # (D, H, W, C)
                is_n = key.lower() == "normals"
                pages = [Image.fromarray(slice_to_rgb(arr[z], is_n))
                         for z in range(arr.shape[0])]
            else:
                pages = [Image.fromarray(_minmax_u8(arr[z]))
                         for z in range(arr.shape[0])]
            path = Path(out_dir) / f"sample{i:03d}_{key}.tif"
            pages[0].save(path, save_all=True, append_images=pages[1:])
