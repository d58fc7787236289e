"""Zarr patch dataset for multi-task training.

A copy of ``mt3d_resenc_unet_tpu/data/dataset.py`` (``ZarrPatchDataset``,
wire and non-wire), with one difference: without ``ml_dtypes`` numpy has no
bf16, so in wire mode a FLOAT image leaves here as float32 and
``data/pipeline.py::device_prefetch`` casts it to bf16 in its pin step
(``bf16_keys``). Both casts round to nearest even, so the batch on the
device is bit-identical to the JAX package's.

Parity with the reference ZarrSegmentationDataset3D
(reference: dataloading/dataset.py:18-227):

* per-volume path dicts with a ``ref_label`` selector driving valid-patch
  mining with JSON cache (dataset.py:53-98);
* dtype normalization uint8/255, uint16/65535 (dataset.py:125-131);
* normals decode uint16 -> [-1,1] via /32767.5 - 1 (dataset.py:147-155);
* optional binarize + spherical dilation of labels (dataset.py:163-165);
* intensity augmentations on image only + volumetric cutout
  (dataset.py:176-209), extended with the normals-aware geometric
  transforms the reference shipped but never wired in;
* emits a dict of arrays channels-LAST (D, H, W, C) instead of the
  reference's (C, Z, Y, X).

Volumes are opened once and shared across the loader threads (the numpy
zarr reader and tensorstore are both safe to read from many threads).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy import ndimage as ndi

from .augment import AugmentationPipeline
from .patches import PatchCache, find_valid_patches
from .zio import (Volume, decode_normals, normalize_to_unit, open_zarr,
                  to_ram, volume_nbytes)


def _ball(radius: int) -> np.ndarray:
    """Spherical structuring element (replacement for
    skimage.morphology.ball; reference: dataset.py:9,165)."""
    r = int(radius)
    zz, yy, xx = np.mgrid[-r:r + 1, -r:r + 1, -r:r + 1]
    return (zz ** 2 + yy ** 2 + xx ** 2) <= r ** 2


_BALL5 = None


def dilate_binary(mask: np.ndarray, radius: int = 5) -> np.ndarray:
    global _BALL5
    if _BALL5 is None or _BALL5.shape[0] != 2 * radius + 1:
        _BALL5 = _ball(radius)
    return ndi.binary_dilation(mask, structure=_BALL5).astype(np.float32)


@dataclasses.dataclass
class VolumeEntry:
    input: Volume
    targets: Dict[str, Volume]
    ref_label_key: str


class ZarrPatchDataset:
    """Index-addressable patch sampler over N volumes."""

    def __init__(self, mgr, *, augment: bool = True,
                 pipeline: Optional[AugmentationPipeline] = None,
                 seed: int = 0, wire: bool = False):
        self.mgr = mgr
        self.patch_size = tuple(mgr.train_patch_size)
        self.tasks = mgr.tasks
        self.dilate_label = mgr.dilate_label
        self.augment = augment
        self.pipeline = pipeline or AugmentationPipeline()
        self.seed = seed
        # wire mode: emit samples in their compact STORED dtypes (uint8
        # masks, uint16-encoded normals, bf16 image) for cheap host->device
        # transfer; the step decodes on the device (train/step.py
        # decode_wire) with arithmetic identical to the host LUTs in zio.py
        self.wire = wire

        opened: Dict[str, Volume] = {}   # dedupe by path (shared targets)

        def _open(path: str) -> Volume:
            if path not in opened:
                opened[path] = open_zarr(path)
            return opened[path]

        self.volumes: List[VolumeEntry] = []
        for vol_idx, vol_info in enumerate(mgr.volume_paths):
            ref_label_key = vol_info.get("ref_label", "sheet")
            targets = {}
            for task_name in self.tasks.keys():
                if task_name not in vol_info:
                    raise ValueError(
                        f"Volume {vol_idx} missing path for '{task_name}'")
                targets[task_name] = _open(vol_info[task_name])
            self.volumes.append(VolumeEntry(
                input=_open(vol_info["input"]),
                targets=targets,
                ref_label_key=ref_label_key,
            ))

        # hold whole volumes in host RAM when the config allows: per-sample
        # reads become strided numpy slices instead of zarr chunk
        # fetch + decode — ~4x cheaper on few-core hosts where the read path
        # starves the chip (core/config.py ram_cache_volumes)
        rcv = getattr(mgr, "ram_cache_volumes", "auto")
        total = sum(volume_nbytes(v) for v in opened.values())
        budget = float(getattr(mgr, "ram_cache_budget_gb", 4.0)) * 2 ** 30
        if rcv is True or (rcv == "auto" and total <= budget):
            ram = {p: to_ram(v) for p, v in opened.items()}
            for entry in self.volumes:
                entry.input = ram[entry.input.path]
                entry.targets = {k: ram[v.path]
                                 for k, v in entry.targets.items()}

        cache = PatchCache(mgr.cache_folder, mgr.model_name, self.patch_size)
        patches = cache.load() if mgr.use_cache else None
        if patches is None:
            patches = []
            for vol_idx, entry in enumerate(self.volumes):
                vol_patches = find_valid_patches(
                    entry.targets[entry.ref_label_key],
                    patch_size=self.patch_size,
                    bbox_threshold=mgr.min_bbox_percent,
                    label_threshold=mgr.min_labeled_ratio,
                )
                for p in vol_patches:
                    p["volume_idx"] = vol_idx
                patches.extend(vol_patches)
            if mgr.use_cache:
                cache.save(patches)
        self.all_valid_patches = patches

    def __len__(self) -> int:
        return len(self.all_valid_patches)

    # ------------------------------------------------------------------
    def _read_patch(self, vol: Volume, zyx, *, is_normals: bool,
                    raw: bool = False) -> np.ndarray:
        z0, y0, x0 = zyx
        dz, dy, dx = self.patch_size
        shape = vol.shape
        if len(shape) == 3:
            data = vol[z0:z0 + dz, y0:y0 + dy, x0:x0 + dx]
        elif len(shape) == 4 and shape[-1] <= 8:
            # stored channels-last (Z, Y, X, C)
            data = vol[z0:z0 + dz, y0:y0 + dy, x0:x0 + dx, :]
        elif len(shape) == 4:
            # stored channels-first (C, Z, Y, X) -> to channels-last
            data = vol[:, z0:z0 + dz, y0:y0 + dy, x0:x0 + dx]
            data = np.moveaxis(data, 0, -1)
        else:
            raise ValueError(f"Unsupported volume rank: {shape}")
        if raw:
            return np.asarray(data)
        if is_normals:
            return decode_normals(data, vol.dtype)
        return normalize_to_unit(data, vol.dtype)

    def get_raw(self, idx: int) -> Dict[str, np.ndarray]:
        """Sample without augmentation; channels-last float32 (or compact
        stored dtypes in wire mode — uint8 masks, uint16-encoded normals)."""
        info = self.all_valid_patches[idx]
        entry = self.volumes[info["volume_idx"]]
        zyx = tuple(int(v) for v in info["start_pos"])

        wire = self.wire
        img = self._read_patch(
            entry.input, zyx, is_normals=False,
            raw=wire and entry.input.dtype in (np.uint8, np.uint16))
        if img.ndim == 3:
            img = img[..., None]
        data: Dict[str, np.ndarray] = {"image": img}

        for task_name, tvol in entry.targets.items():
            is_normals = task_name.lower() == "normals"
            # wire-eligible targets keep their stored integer dtype; the
            # device decode (u8/255, u16/65535, normals u16/32767.5-1) is
            # arithmetic-identical to the zio.py host LUTs
            raw = wire and (
                (is_normals and tvol.dtype == np.uint16) or
                (not is_normals and not self.dilate_label
                 and tvol.dtype in (np.uint8, np.uint16)))
            t = self._read_patch(tvol, zyx, is_normals=is_normals, raw=raw)
            if not is_normals:
                if self.dilate_label:
                    t = dilate_binary(t > 0)
                    if wire:
                        # {0,1} floats -> uint8 {0,255}: /255 decodes exactly
                        t = (t > 0.5).astype(np.uint8) * np.uint8(255)
                if t.ndim == 3:
                    t = t[..., None]
            if not raw and t.dtype != np.uint8:
                t = np.asarray(t, dtype=np.float32)
            data[task_name] = t
        return data

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        data = self.get_raw(idx)
        if self.augment:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, idx, len(self)]))
            data = self.pipeline(data, rng)
        if self.wire:
            # a float image stays float32 here; the pin step casts it to
            # bf16 (device_prefetch bf16_keys)
            return {k: np.ascontiguousarray(v) for k, v in data.items()}
        return {k: np.ascontiguousarray(v, dtype=np.float32)
                for k, v in data.items()}

    def set_seed(self, seed: int) -> None:
        """Reseed augmentation randomness (per epoch)."""
        self.seed = seed
