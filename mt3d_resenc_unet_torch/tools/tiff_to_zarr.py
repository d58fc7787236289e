"""Image-stack -> zarr converters (offline data prep).

Capability parity with the reference converters:
* segment folders with ``layers/`` (+ ``inklabels/``) image stacks ->
  a zarr group with ``layers.zarr`` / ``inklabels.zarr`` uint8 arrays,
  filename-integer index matching, 16->8-bit scaling, optional
  distance-from-edge label erosion
  (reference: scripts/segment_and_label_to_zarr.py:23-195);
* generic TIFF/PNG z-stacks -> chunk-aligned zarr with a thread pool
  (reference: tasks/normals/slices_to_zarr.py:60-233; threads replace the
  reference's process pool — cv2/PIL decoding releases the GIL).

A copy of ``mt3d_resenc_unet_tpu/tools/tiff_to_zarr.py`` onto the port's
``data/zio.py``: the arrays are written with ``compressor: null``, which
needs no package, so data prepared on a machine without tensorstore is
read there (the JAX tool writes Blosc; the values are the same). Each
image is one z-slice of its chunks; the store's chunk lock lets the
threads write slices of one chunk at once.
"""

from __future__ import annotations

import glob
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

from scipy import ndimage as ndi

from ..data.zio import create_zarr

_IMG_EXTS = ("*.tif", "*.TIF", "*.png", "*.PNG", "*.jpg", "*.JPG",
             "*.jpeg", "*.JPEG")


def natural_sort_key(s: str):
    return [int(t) if t.isdigit() else t.lower()
            for t in re.split(r"(\d+)", s)]


def extract_first_int(name: str) -> Optional[int]:
    m = re.search(r"(\d+)", name)
    return int(m.group(1)) if m else None


def _read_gray(path: str) -> np.ndarray:
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE | cv2.IMREAD_ANYDEPTH)
        if img is None:
            raise ValueError(f"Could not read image: {path}")
        return img
    from PIL import Image
    return np.asarray(Image.open(path).convert("I"))


def _to_uint8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint16:
        return (img // 257).astype(np.uint8)
    if img.dtype != np.uint8:
        lo, hi = float(img.min()), float(img.max())
        if hi <= lo:
            return np.zeros(img.shape, np.uint8)
        return ((img - lo) / (hi - lo) * 255).astype(np.uint8)
    return img


def erode_label_from_edge(label: np.ndarray, fraction: float = 0.05) -> np.ndarray:
    """Zero out label pixels within ``fraction`` of the max distance from the
    labeled region's edge (the reference's optional erosion step)."""
    mask = label > 0
    if not mask.any():
        return label
    dist = ndi.distance_transform_edt(mask)
    out = label.copy()
    out[dist <= dist.max() * fraction] = 0
    return out


def stack_images_to_zarr(
    input_folder: str,
    start: int,
    stop: int,
    layers_only: bool = False,
    erode: bool = False,
    chunks: Tuple[int, int, int] = (64, 256, 256),
    num_threads: int = 8,
) -> str:
    """layers/ + inklabels/ folders -> ``{folder}.zarr`` group.

    Layers are matched by the integer embedded in each filename; inklabels by
    natural-sort position (reference: segment_and_label_to_zarr.py:47-118).
    """
    layer_files: List[str] = []
    for ext in _IMG_EXTS:
        layer_files.extend(glob.glob(os.path.join(input_folder, "layers", ext)))
    if not layer_files:
        raise ValueError(f"No layer images found in {input_folder}/layers")
    layer_files.sort(key=natural_sort_key)
    layer_dict = {extract_first_int(os.path.basename(f)): f
                  for f in layer_files}
    layer_dict.pop(None, None)
    if start not in layer_dict:
        raise ValueError(f"No layer file with index {start} in "
                         f"{input_folder}/layers")

    first = _read_gray(layer_dict[start])
    h, w = first.shape
    num_slices = stop - start + 1

    parent = os.path.dirname(os.path.abspath(input_folder))
    name = os.path.basename(os.path.abspath(input_folder))
    group_path = os.path.join(parent, f"{name}.zarr")

    chunks = (min(chunks[0], num_slices), min(chunks[1], h), min(chunks[2], w))
    layers_arr = create_zarr(os.path.join(group_path, "layers.zarr"),
                             (num_slices, h, w), np.uint8, chunks,
                             compressor=None, delete_existing=True)

    def write_layer(i):
        idx = start + i
        path = layer_dict.get(idx)
        if path is None:
            return
        img = _to_uint8(_read_gray(path))
        layers_arr[i] = img

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        list(pool.map(write_layer, range(num_slices)))

    if not layers_only:
        ink_files = sorted(
            glob.glob(os.path.join(input_folder, "inklabels", "*.png")),
            key=natural_sort_key)
        if not ink_files:
            raise ValueError(f"No inklabels found in {input_folder}/inklabels")
        ink_arr = create_zarr(os.path.join(group_path, "inklabels.zarr"),
                              (num_slices, h, w), np.uint8, chunks,
                              compressor=None, delete_existing=True)

        def write_ink(i):
            if start + i >= len(ink_files):
                return
            img = _to_uint8(_read_gray(ink_files[start + i]))
            if erode:
                img = erode_label_from_edge(img)
            ink_arr[i] = img

        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            list(pool.map(write_ink, range(num_slices)))

    return group_path


def slices_to_zarr(
    input_dir: str,
    output_zarr: str,
    pattern: str = "*.tif",
    chunks: Optional[Tuple[int, ...]] = None,
    dtype=None,
    num_threads: int = 8,
    binarize: bool = False,
) -> str:
    """Generic z-stack of (possibly multichannel) images -> zarr array
    (reference: tasks/normals/slices_to_zarr.py:60-233). Multichannel slices
    produce a (Z, Y, X, C) array (channels-last, this framework's layout)."""
    files = sorted(glob.glob(os.path.join(input_dir, pattern)),
                   key=natural_sort_key)
    if not files:
        raise ValueError(f"No files matching {pattern} in {input_dir}")

    def read(path):
        if cv2 is not None:
            img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            if img is None:
                raise ValueError(f"Could not read {path}")
            if img.ndim == 3:
                img = img[..., ::-1]  # BGR -> RGB
            return img
        from PIL import Image
        return np.asarray(Image.open(path))

    first = read(files[0])
    z = len(files)
    shape = (z,) + first.shape
    out_dtype = np.dtype(dtype) if dtype is not None else first.dtype
    if chunks is None:
        chunks = (min(64, z), min(256, shape[1]), min(256, shape[2]))
        if len(shape) == 4:
            chunks = chunks + (shape[3],)
    arr = create_zarr(output_zarr, shape, out_dtype, chunks,
                      compressor=None, delete_existing=True)

    def write(i):
        img = read(files[i]).astype(out_dtype)
        if binarize:
            img = (img > 0).astype(out_dtype)
        arr[i] = img

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        list(pool.map(write, range(z)))
    return output_zarr
