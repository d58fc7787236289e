"""Sliding-window zarr inference engine.

The port of ``mt3d_resenc_unet_tpu/infer/engine.py`` (reference:
inference.py:14-308), zarr in, zarr out:

* overlapping patch grid with forced terminal coverage, visited in z-major
  order; batched eval forward (``torch.inference_mode``) with per-task
  activations, each prediction multiplied by the Gaussian importance map
  on the device;
* three model passes, chosen by ``_run_model_pass``: whole-volume
  accumulation in device memory (raw stored bytes up, decode and
  standardize on the card, quantized finals down), a rolling z-slab in
  host RAM flushed to ``{tgt}_sum`` / ``{tgt}_count`` once per z-row, and
  disjoint (z, y-band) tiles sized to the host-RAM budget, resumable from
  a per-tile watermark;
* finalize (normals renormalized to unit length, everything else
  sum/weight), quantize (``{tgt}_final`` uint8, or uint16 in the 32767.5
  codec for normals) and per-Z JPEG export, also runnable on an existing
  store (``tools/standalone_finalize.py``, ``--postprocess_only``).

Multi-process (a process group from ``parallel.distributed.initialize``,
one device a rank), as the JAX engine: the model pass is always tiled,
rank r takes the tiles ``tiles[r::n]`` and keeps its own watermark
(``.model_pass_progress.p{r}.json``); every rank checks the overwrite
guard, then rank 0 alone creates the stores between two barriers and the
others open them; after the pass, a barrier, rank 0 finalizes, quantizes
and exports, and a last barrier. Adjacent tiles of two ranks may share a
store chunk: ``data/zio.py`` locks a chunk around the read-modify-write
of a partial write, so no update is lost.

Differences from the JAX engine: every store it creates is a local zarr v2
array with ``compressor: null`` (the card's machine has no tensorstore;
the values are the JAX engine's, the bytes on disk are not Blosc); each
rank's forward runs on its one device, with no mesh sharding inside a
process; the last batch is not padded to a static shape.
``predict_volume`` blends over a volume held in memory and returns the
blend.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import ConfigManager, resolve_device, set_precision
from ..data.positions import sliding_window_grid
from ..data.zio import (Volume, create_zarr, normalize_to_unit, open_zarr,
                        zarr_exists)
from ..models.network import ResEncUNet
from ..parallel.distributed import (is_main_process, process_count,
                                    process_index, sync_global_devices)
from ..train.checkpoint import load_params_any, merge_params_nonstrict
from ..utils import native
from .gaussian import gaussian_map, uniform_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# batches read ahead of the forward by the loader threads
_WINDOW = 3


def standardize(patch: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    """Per-patch z-score, non-channelwise — the reference's inference-time
    normalization (dataloading/inference_dataset.py:25 Standardize)."""
    mean = patch.mean()
    std = patch.std()
    return (patch - mean) / np.maximum(std, eps)


def _is_normals(name: str, channels: int) -> bool:
    return name.lower() == "normals" and channels == 3


def _renormalize(s: torch.Tensor, covered: torch.Tensor) -> torch.Tensor:
    """(..., 3) sums -> unit vectors where ``covered``; the divisor is the
    true magnitude (floored at 1e-30), as native/hostops.cpp divides."""
    mag = torch.sqrt(torch.sum(s * s, dim=-1, keepdim=True)).clamp_min(1e-30)
    return torch.where(covered[..., None], s / mag, s)


def predict_volume(model: torch.nn.Module, volume: np.ndarray,
                   patch: Sequence[int], overlap: float = 0.25,
                   batch_size: int = 2,
                   device: Optional[torch.device] = None,
                   normalization: str = "standardize",
                   sigma_scale: float = 1.0 / 8) -> Dict[str, np.ndarray]:
    """Blend the model's eval predictions over ``volume`` (D, H, W).

    Returns ``{task: (D, H, W, C) float32}``: for a 3-channel head named
    ``normals`` the Gaussian-weighted sum of the patch predictions
    renormalized to unit length (as ``finalize_overlaps`` does), for every
    other head their Gaussian-weighted mean. Both sums live in device
    memory. ``normalization`` is ``"standardize"`` (per-patch z-score after
    the unit scaling, the engine's default) or ``"none"``."""
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
        out = {}
        for t in tasks:
            s = sums[t.name]
            out[t.name] = (_renormalize(s, weight > 0)
                           if _is_normals(t.name, t.channels)
                           else s / weight[..., None]).cpu().numpy()
        return out


# ----------------------------------------------------------------------
# host-side accumulation
# ----------------------------------------------------------------------

class _RollingAccumulator:
    """Accumulates weighted patches into a RAM slab ordered by z and flushes
    finished z-rows to the sum/count stores exactly once."""

    def __init__(self, sum_vol: Volume, cnt_vol: Volume, channels: int,
                 vol_shape: Tuple[int, int, int], patch_z: int):
        self.sum_vol = sum_vol
        self.cnt_vol = cnt_vol
        self.c = channels
        self.zmax, self.ymax, self.xmax = vol_shape
        self.patch_z = patch_z
        self.z0 = 0           # global z of slab row 0
        self.flushed = 0      # everything < flushed is on disk
        # patches arrive in nondecreasing z order and flush_until() compacts
        # the slab on every z-step, so the live window never exceeds one
        # patch depth; _grow_to stays as a safety net for unsorted feeds
        depth = patch_z
        self.sum = np.zeros((channels, depth, self.ymax, self.xmax), np.float32)
        self.cnt = np.zeros((depth, self.ymax, self.xmax), np.float32)
        # actual peak allocation — live slab + copied in-flight write blocks
        # + the compaction transient, so the engine's RAM-budget accounting
        # reflects what was allocated, not an estimate
        self.peak_bytes = self.sum.nbytes + self.cnt.nbytes
        self._pending: List[Tuple[Any, int]] = []

    def _grow_to(self, z_end: int) -> None:
        need = z_end - self.z0
        if need > self.sum.shape[1]:
            extra = need - self.sum.shape[1]
            self.sum = np.concatenate(
                [self.sum, np.zeros((self.c, extra, self.ymax, self.xmax),
                                    np.float32)], axis=1)
            self.cnt = np.concatenate(
                [self.cnt, np.zeros((extra, self.ymax, self.xmax),
                                    np.float32)], axis=0)
        self.peak_bytes = max(self.peak_bytes,
                              self.sum.nbytes + self.cnt.nbytes)

    def add(self, z: int, y: int, x: int, weighted_pred: np.ndarray,
            weight: np.ndarray) -> None:
        """weighted_pred: (C, pz, py, px) already multiplied by the map;
        weight: (pz, py, px)."""
        pz = weighted_pred.shape[1]
        if z > self.flushed:
            # all patches are fed in nondecreasing z order, so rows < z are
            # final once we see a patch starting at z
            self.flush_until(z)
        self._grow_to(z + pz)
        native.accumulate_patch(self.sum, self.cnt,
                                np.ascontiguousarray(weighted_pred),
                                weight, z - self.z0, y, x)

    def flush_until(self, z_end: int) -> None:
        z_end = min(z_end, self.zmax)
        if z_end <= self.flushed:
            return
        a, b = self.flushed - self.z0, z_end - self.z0
        # COPY the flushed rows: an async write holding a view would pin the
        # whole pre-compaction slab until the write retires
        sum_block = np.ascontiguousarray(self.sum[:, a:b])
        cnt_block = np.ascontiguousarray(self.cnt[a:b])
        live = self.sum.nbytes + self.cnt.nbytes
        if self.c == 1:
            self._pending.append(
                (self.sum_vol.write_async(np.s_[self.flushed:z_end],
                                          sum_block[0]),
                 sum_block.nbytes))
        else:
            self._pending.append(
                (self.sum_vol.write_async(np.s_[:, self.flushed:z_end],
                                          sum_block),
                 sum_block.nbytes))
        self._pending.append(
            (self.cnt_vol.write_async(np.s_[self.flushed:z_end], cnt_block),
             cnt_block.nbytes))
        # retire completed writes, keep at most 4 in flight
        while len(self._pending) > 4:
            self._pending.pop(0)[0].result()
        pending_bytes = sum(nb for _, nb in self._pending)
        # drop flushed rows; old + tail copy are transiently both alive
        tail_sum = self.sum[:, b:].copy()
        tail_cnt = self.cnt[b:].copy()
        self.peak_bytes = max(
            self.peak_bytes,
            live + tail_sum.nbytes + tail_cnt.nbytes + pending_bytes)
        self.sum = tail_sum
        self.cnt = tail_cnt
        self.z0 = z_end
        self.flushed = z_end

    def finish(self) -> None:
        self.flush_until(self.zmax)
        for fut, _ in self._pending:
            fut.result()
        self._pending.clear()


def _create_sum_count(store_path: str, name: str, channels: int,
                      in_shape, patch, open_existing: bool = False):
    """``{name}_sum`` / ``{name}_count`` float32 stores chunked at patch size
    (reference: inference.py:76-113); in resume mode existing stores are
    reopened writable."""
    if channels == 1:
        out_shape: Tuple[int, ...] = tuple(in_shape)
        chunks: Tuple[int, ...] = tuple(patch)
    else:
        out_shape = (channels,) + tuple(in_shape)
        chunks = (channels,) + tuple(patch)
    sum_path = os.path.join(store_path, f"{name}_sum")
    cnt_path = os.path.join(store_path, f"{name}_count")
    if open_existing and zarr_exists(sum_path):
        return (open_zarr(sum_path, writable=True),
                open_zarr(cnt_path, writable=True))
    sum_vol = create_zarr(sum_path, out_shape, np.float32, chunks,
                          compressor=None)
    cnt_vol = create_zarr(cnt_path, tuple(in_shape), np.float32, tuple(patch),
                          compressor=None)
    return sum_vol, cnt_vol


def should_device_accumulate(dev_mode, *, resume: bool, process_count: int,
                             n_local_devices: int, backend: str,
                             accum_bytes: int, budget_bytes: int) -> bool:
    """Dispatch predicate for whole-volume on-device accumulation.

    ``"auto"`` engages only when it is the fastest option: a CUDA device
    (on the CPU the "device" IS the host), one device, and accumulators
    that fit the device-memory budget. ``True`` forces the path anywhere
    (tests); resume and multi-process runs always take the tile path
    (watermarks are tile-granular, tiles partition across processes)."""
    if resume or process_count != 1:
        return False
    if dev_mode is True:
        return True
    return (dev_mode == "auto"
            and backend == "cuda"
            and n_local_devices == 1
            and accum_bytes <= budget_bytes)


def _overwrite_guard(store_path: str) -> None:
    """The exists-guard (reference: inference.py:70-74)."""
    if os.path.isdir(store_path):
        raise FileExistsError(
            f"Zarr store '{store_path}' already exists. "
            "Aborting to prevent overwrite (pass --resume to continue "
            "an interrupted run).")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fetch_async(outs: Dict[str, torch.Tensor], device: torch.device):
    """Start the device-to-host copy of ``outs``; returns (host tensors, an
    event that the copies are done, or None on the CPU). Waiting on the
    event, not on the stream, lets the next batch's forward, queued after
    the copies, run on while the host accumulates this one."""
    host = {n: t.to("cpu", non_blocking=True) for n, t in outs.items()}
    if device.type != "cuda":
        return host, None
    done = torch.cuda.Event()
    done.record()
    return host, done


def _wait_host(fetched) -> Dict[str, np.ndarray]:
    host, done = fetched
    if done is not None:
        done.synchronize()
    return {n: t.numpy() for n, t in host.items()}


def _upload(raw: np.ndarray, device: torch.device) -> torch.Tensor:
    """Raw stored samples to the device in a dtype whose cast to fp32
    torch supports: uint16 travels as its int16 bit pattern (2 bytes a
    voxel) and is widened on the device."""
    if raw.dtype == np.uint16:
        return torch.from_numpy(raw.view(np.int16)).to(device)
    return torch.from_numpy(raw).to(device)


def _decode(raw: torch.Tensor, in_dtype: np.dtype,
            standardize_on: bool) -> torch.Tensor:
    """(B, pz, py, px) stored samples -> (B, pz, py, px, 1) fp32 model
    input: the unit scaling of ``normalize_to_unit`` and the per-patch
    population z-score of ``standardize``, on the device."""
    if in_dtype == np.uint16:
        x = (raw.to(torch.int32) & 0xFFFF).to(torch.float32) / 65535.0
    elif in_dtype == np.uint8:
        x = raw.to(torch.float32) / 255.0
    else:
        x = raw.to(torch.float32)
    if standardize_on:
        ax = tuple(range(1, x.ndim))
        mean = x.mean(dim=ax, keepdim=True)
        std = x.std(dim=ax, correction=0, keepdim=True)
        x = (x - mean) / std.clamp_min(1e-10)
    return x[..., None]


def _finalize_device(sums: Dict[str, torch.Tensor], wsum: torch.Tensor,
                     chans: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """Device mirror of native.finalize_average / renormalize_vectors +
    quantize_u8 / encode_normals_u16 (native/hostops.cpp:70-121): average
    (or unit-renormalize normals) where weight > 0, then clip and truncate.
    Normals come out as int32 codes, the rest as uint8."""
    finals = {}
    covered = wsum > 0.0
    for n, s in sums.items():
        if _is_normals(n, chans[n]):
            v = _renormalize(s, covered)
            q = torch.clamp((v + 1.0) * 32767.5, 0.0, 65535.0)
            finals[n] = q.to(torch.int32)
        else:
            inv = torch.where(covered, 1.0 / torch.where(covered, wsum, 1.0),
                              0.0)
            a = s * inv[..., None]
            finals[n] = torch.clamp(a * 255.0, 0.0, 255.0).to(torch.uint8)
    return finals


def _channels_first(t: torch.Tensor) -> np.ndarray:
    """(D, H, W, C) device tensor -> host (C, D, H, W), or (D, H, W) for
    one channel: the stores' layout."""
    if t.shape[-1] == 1:
        return t[..., 0].cpu().numpy()
    return t.permute(3, 0, 1, 2).contiguous().cpu().numpy()


class ZarrInferenceEngine:
    """Config-driven inference (entry parity: inference.py:14-29). Runs on
    ``resolve_device(device)``: the first CUDA card unless
    ``device="cpu"`` is given, and raises ``RuntimeError`` without a card.

    After ``infer``: ``last_mode`` is the model pass that ran (``"device"``,
    ``"rolling"`` or ``"tiled"``, None for ``postprocess_only``),
    ``last_phases`` its seconds by phase (``build``, ``load_params``,
    ``setup`` from the start to the weights on the device, ``first_step``,
    ``loop`` after it, ``read_wait`` the loop's waits for the host's next
    batch, ``finalize``, ``fetch_write``), and ``max_slab_bytes`` the peak
    host accumulation slab."""

    def __init__(self, config_file: Optional[str] = None,
                 write_layers: bool = False, postprocess_only: bool = False,
                 config_dict: Optional[Dict[str, Any]] = None,
                 verbose: bool = False, resume: bool = False, device=None):
        self.device = resolve_device(device)
        set_precision()
        self.mgr = ConfigManager(config_file, config_dict, verbose=verbose)
        self.write_layers = write_layers
        self.postprocess_only = postprocess_only
        # resume a killed model pass from its tile watermark (tiled mode)
        self.resume = resume
        # peak accumulation-slab allocation, for RAM-budget verification
        self.max_slab_bytes = 0
        # optional hook called after each completed tile (fault-injection in
        # tests; also a natural progress-callback extension point)
        self.tile_callback = None
        self.last_mode: Optional[str] = None
        self.last_phases: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def _build_model(self):
        import dataclasses as _dc
        plan = self.mgr.build_plan(self.device)
        # inference always consumes the single full-resolution head; the seg
        # params for deeper stages exist either way (models/network.py), so
        # DS-trained checkpoints load unchanged
        if plan.deep_supervision:
            plan = _dc.replace(plan, deep_supervision=False)
        if tuple(self.mgr.infer_patch_size) != tuple(plan.patch_size):
            plan = _dc.replace(
                plan, patch_size=tuple(self.mgr.infer_patch_size))
            plan.validate_patch(self.mgr.infer_patch_size)
        model = ResEncUNet(plan, dtype=_DTYPES.get(self.mgr.compute_dtype,
                                                   torch.bfloat16))
        return plan, model

    def _load_params(self, model) -> None:
        """The checkpoint's parameters into ``model`` (non-strict merge over
        its fresh ones; strict unless ``load_strict: false``)."""
        ckpt_path = self.mgr.infer_checkpoint_path or self.mgr.checkpoint_path
        if ckpt_path is None:
            raise ValueError("inference requires a checkpoint_path")
        restored = load_params_any(ckpt_path)
        merged, stats = merge_params_nonstrict(model.state_dict(), restored)
        if self.mgr.load_strict:
            if stats["kept_fresh"] or stats["shape_mismatch"]:
                raise ValueError(
                    f"strict load failed: {stats} (set load_strict: false "
                    f"for partial/multi-task reuse)")
        else:
            print(f"[infer] non-strict load: {stats}")
        model.load_state_dict(merged)

    def _model_on_device(self, phase: Dict[str, float], t0: float):
        """Build the model, load its weights and move it to the device,
        timing each step into ``phase``."""
        _, model = self._build_model()
        phase["build"] = time.perf_counter() - t0
        self._load_params(model)
        phase["load_params"] = time.perf_counter() - t0 - phase["build"]
        model.to(self.device)
        _sync(self.device)
        phase["setup"] = time.perf_counter() - t0
        return model

    def _prefetch(self, pool: ThreadPoolExecutor, make_batch, n_batches: int,
                  phase: Dict[str, float]):
        """Yields ``make_batch(b)`` for b in order while the pool reads up
        to ``_WINDOW`` batches ahead; the waits go to
        ``phase["read_wait"]``."""
        futs = {b: pool.submit(make_batch, b)
                for b in range(min(_WINDOW, n_batches))}
        for b in range(n_batches):
            t = time.perf_counter()
            item = futs.pop(b).result()
            phase["read_wait"] += time.perf_counter() - t
            if b + _WINDOW < n_batches:
                futs[b + _WINDOW] = pool.submit(make_batch, b + _WINDOW)
            yield item

    # ------------------------------------------------------------------
    def infer(self) -> str:
        mgr = self.mgr
        store_path = os.path.join(mgr.infer_output_path, "predictions.zarr")
        targets = mgr.infer_output_targets
        self.last_mode = None
        self.last_phases = {}

        postprocess_done = False
        if not self.postprocess_only:
            postprocess_done = bool(self._run_model_pass(store_path, targets))

        # every process must have written its tiles before postprocessing;
        # one writer finalizes (the sums are a single shared store)
        sync_global_devices("infer_model_pass_done")
        if is_main_process():
            if not postprocess_done:  # device-accum mode wrote finals
                t = time.perf_counter()
                finalize_overlaps(store_path, targets)
                self.last_phases["finalize"] = time.perf_counter() - t
                t = time.perf_counter()
                quantize_final(store_path, targets)
                self.last_phases["fetch_write"] = time.perf_counter() - t
            if self.write_layers:
                export_z_slices(store_path, targets, mgr.infer_output_path)
        sync_global_devices("infer_postprocess_done")
        return store_path

    # ------------------------------------------------------------------
    def _setup_model_pass(self, targets: Dict[str, Dict],
                          phase: Dict[str, float], t0: float):
        """Shared host-path machinery: the model on the device, a forward
        that weights its outputs by the Gaussian map on the device and
        starts their copy to the host, the patch reader, the grid."""
        mgr = self.mgr
        model = self._model_on_device(phase, t0)

        input_vol = open_zarr(mgr.infer_input_path)
        in_shape = input_vol.shape[-3:]
        patch = tuple(mgr.infer_patch_size)

        input_data = None
        if mgr.infer_load_all:
            input_data = input_vol.read_all()
            if input_data.ndim > 3:
                input_data = input_data.reshape(input_data.shape[-3:])

        positions = sliding_window_grid(in_shape, patch, mgr.infer_overlap)
        positions.sort()  # deterministic z-major order

        if mgr.infer_gaussian_blend:
            wmap = gaussian_map(patch, mgr.infer_gaussian_sigma_scale)
        else:
            wmap = uniform_map(patch)
        device = self.device
        wmap_dev = torch.from_numpy(wmap).to(device)

        def forward(host_batch):
            with torch.inference_mode():
                outs = model(torch.from_numpy(host_batch).to(device))
                return _fetch_async(
                    {name: outs[name].float() * wmap_dev[None, ..., None]
                     for name in targets}, device)

        normalization = mgr.infer_normalization

        def read_patch(pos):
            z, y, x = pos
            sl = np.s_[z:z + patch[0], y:y + patch[1], x:x + patch[2]]
            if input_data is not None:
                raw = input_data[sl]
            else:
                raw = input_vol[sl]
                if raw.ndim > 3:
                    raw = raw.reshape(raw.shape[-3:])
            p = normalize_to_unit(raw, input_vol.dtype)
            if normalization == "standardize":
                p = standardize(p)
            return p[..., None]

        return forward, read_patch, positions, patch, in_shape, wmap

    def _rolling_slab_bytes(self, targets, in_shape, patch,
                            overlap: float) -> int:
        """Peak host RAM of the rolling accumulator, from the ACTUAL grid:
        live slab (patch_z rows) + compaction tail copy (patch_z - step) +
        up to 4 copied in-flight write blocks (2 z-steps of sum + count).
        Total = (2*patch_z + step) rows per (channels+1) float32 planes."""
        z, y, x = in_shape
        pz = patch[0]
        step = max(1, min(pz, int(round(pz * (1.0 - overlap)))))
        rows = 2 * pz + step
        total = 0
        for info in targets.values():
            c = int(info["channels"])
            total += (c + 1) * rows * y * x * 4
        return total

    def _device_accum_bytes(self, targets, in_shape) -> int:
        """Device bytes of the on-device accumulators: per-target f32 sums +
        one shared f32 weight volume."""
        n = int(np.prod(in_shape))
        total = n * 4
        for info in targets.values():
            total += int(info["channels"]) * n * 4
        return total

    def _run_model_pass(self, store_path: str, targets: Dict[str, Dict]):
        """Dispatch, fastest first:

        * whole-volume ON-DEVICE accumulation when the f32 accumulators fit
          the device-memory budget (raw input bytes up, quantized finals
          down);
        * full-plane rolling host accumulation when the slab fits host RAM;
        * disjoint (z, y-band) tiles otherwise (and always in --resume mode,
          whose watermark is tile-granular)."""
        mgr = self.mgr
        budget = int(mgr.infer_host_ram_budget_gb * 2 ** 30)
        input_vol = open_zarr(mgr.infer_input_path)
        in_shape = input_vol.shape[-3:]
        patch = tuple(mgr.infer_patch_size)
        # each process drives one device
        dev_ok = should_device_accumulate(
            mgr.infer_device_accumulate, resume=self.resume,
            process_count=process_count(), n_local_devices=1,
            backend=self.device.type,
            accum_bytes=self._device_accum_bytes(targets, in_shape),
            budget_bytes=int(mgr.infer_device_accum_budget_gb * 2 ** 30))
        if dev_ok:
            try:
                return self._run_model_pass_device(store_path, targets)
            except torch.cuda.OutOfMemoryError as e:
                # the forward stays on the card; only the sums move
                print(f"[infer] device accumulation out of memory ({e}); "
                      "falling back to host accumulation")
            torch.cuda.empty_cache()
        # multi-process runs always tile: tiles partition cleanly across
        # processes, while the rolling z-sweep is inherently sequential
        needs_tiles = (self.resume or process_count() > 1 or
                       self._rolling_slab_bytes(targets, in_shape, patch,
                                                mgr.infer_overlap) > budget)
        if needs_tiles:
            return self._run_model_pass_tiled(store_path, targets, budget)
        return self._run_model_pass_rolling(store_path, targets)

    def _run_model_pass_device(self, store_path: str,
                               targets: Dict[str, Dict]) -> bool:
        """Whole-volume accumulation in device memory: decode, standardize,
        forward, Gaussian weighting, overlap scatter-add, finalize (average
        / renormalize) and quantization ALL run on the device; the host
        only ships raw input patches up (stored dtype — 4x fewer bytes than
        f32) and the quantized ``{tgt}_final`` arrays down.

        Returns True: finals are written and postprocess is already done
        (unless ``write_sums`` asked for host-side postprocess artifacts, in
        which case raw sums/counts are persisted and False is returned so
        the normal finalize/quantize pass runs)."""
        t0 = time.perf_counter()
        phase = {"read_wait": 0.0}
        self.last_phases = phase
        mgr = self.mgr
        device = self.device
        model = self._model_on_device(phase, t0)

        input_vol = open_zarr(mgr.infer_input_path)
        in_shape = tuple(input_vol.shape[-3:])
        patch = tuple(mgr.infer_patch_size)
        positions = sliding_window_grid(in_shape, patch, mgr.infer_overlap)
        positions.sort()
        if mgr.infer_gaussian_blend:
            wmap = gaussian_map(patch, mgr.infer_gaussian_sigma_scale)
        else:
            wmap = uniform_map(patch)
        wmap_dev = torch.from_numpy(wmap).to(device)

        _overwrite_guard(store_path)

        in_dtype = np.dtype(input_vol.dtype)
        standardize_on = mgr.infer_normalization == "standardize"
        names = list(targets)
        chans = {n: int(targets[n]["channels"]) for n in names}

        sums = {n: torch.zeros(in_shape + (chans[n],), dtype=torch.float32,
                               device=device) for n in names}
        wsum = torch.zeros(in_shape, dtype=torch.float32, device=device)

        batch_size = mgr.infer_batch_size
        n = len(positions)
        n_batches = (n + batch_size - 1) // batch_size

        def make_batch(b):
            raws = []
            for (z, y, x0) in positions[b * batch_size:(b + 1) * batch_size]:
                raw = input_vol[z:z + patch[0], y:y + patch[1],
                                x0:x0 + patch[2]]
                if raw.ndim > 3:
                    raw = raw.reshape(raw.shape[-3:])
                raws.append(raw)
            return np.stack(raws)

        done = 0
        t1 = time.perf_counter()
        with ThreadPoolExecutor(
                max_workers=max(1, mgr.infer_num_dataloader_workers)) as pool, \
                torch.inference_mode():
            batches = self._prefetch(pool, make_batch, n_batches, phase)
            for b, raw_b in enumerate(batches):
                x = _decode(_upload(raw_b, device), in_dtype, standardize_on)
                outs = model(x)
                weighted = {nm: outs[nm].float() * wmap_dev[None, ..., None]
                            for nm in names}
                bp = positions[b * batch_size:(b + 1) * batch_size]
                for i, (z, y, x0) in enumerate(bp):
                    sl = np.s_[z:z + patch[0], y:y + patch[1],
                               x0:x0 + patch[2]]
                    for nm in names:
                        sums[nm][sl] += weighted[nm][i]
                    wsum[sl] += wmap_dev
                if b == 0:
                    _sync(device)
                    phase["first_step"] = time.perf_counter() - t1
                done += len(bp)
                if b % 20 == 0:
                    print(f"[infer] {done}/{n} patches (device accum)")
            _sync(device)
        phase["loop"] = (time.perf_counter() - t1
                         - phase.get("first_step", 0.0))
        self.last_mode = "device"

        if mgr.infer_write_sums:
            # persist raw sums/counts for --postprocess_only reuse and let
            # the standard host finalize/quantize produce the finals
            t3 = time.perf_counter()
            host_w = wsum.cpu().numpy()
            for name in names:
                sum_vol, cnt_vol = _create_sum_count(store_path, name,
                                                     chans[name], in_shape,
                                                     patch)
                sum_vol[...] = _channels_first(sums[name])
                cnt_vol[...] = host_w
            phase["fetch_write"] = time.perf_counter() - t3
            print(f"[infer] model pass complete (device accum, sums "
                  f"persisted): {n} patches -> {store_path}")
            return False

        t2 = time.perf_counter()
        with torch.inference_mode():
            finals = _finalize_device(sums, wsum, chans)
        del sums, wsum
        _sync(device)
        phase["finalize"] = time.perf_counter() - t2
        t3 = time.perf_counter()
        os.makedirs(store_path, exist_ok=True)
        for name in names:
            c = chans[name]
            host_q = _channels_first(finals.pop(name))
            if _is_normals(name, c):
                host_q = host_q.astype(np.uint16)
            out_shape = (c,) + in_shape if c > 1 else in_shape
            chunk = (c,) + patch if c > 1 else patch
            final_vol = create_zarr(
                os.path.join(store_path, f"{name}_final"), out_shape,
                host_q.dtype, chunk, compressor=None, delete_existing=True)
            final_vol[...] = host_q
            # mark finalized so --postprocess_only / standalone finalize
            # treat the store as already averaged
            with open(os.path.join(store_path, f".finalized_{name}"),
                      "w") as f:
                f.write("finalized on device\n")
        with open(os.path.join(store_path, ".finalized"), "w") as f:
            f.write("finalized on device\n")
        phase["fetch_write"] = time.perf_counter() - t3
        print("[infer] device-accum phases: " + ", ".join(
            f"{k}={v:.1f}s" for k, v in phase.items()))
        print(f"[infer] model pass + finalize + quantize complete (device "
              f"accum): {n} patches -> {store_path}")
        return True

    def _run_model_pass_rolling(self, store_path: str,
                                targets: Dict[str, Dict]):
        t0 = time.perf_counter()
        phase = {"read_wait": 0.0}
        self.last_phases = phase
        mgr = self.mgr
        (forward, read_patch, positions, patch, in_shape,
         wmap) = self._setup_model_pass(targets, phase, t0)
        batch_size = mgr.infer_batch_size

        _overwrite_guard(store_path)

        # sum/count stores per target (reference: inference.py:76-113)
        accums: Dict[str, _RollingAccumulator] = {}
        for name, info in targets.items():
            c = int(info["channels"])
            sum_vol, cnt_vol = _create_sum_count(store_path, name, c,
                                                 in_shape, patch)
            accums[name] = _RollingAccumulator(sum_vol, cnt_vol, c, in_shape,
                                               patch[0])

        n = len(positions)
        n_batches = (n + batch_size - 1) // batch_size

        def make_batch(b):
            batch_pos = positions[b * batch_size:(b + 1) * batch_size]
            return batch_pos, np.stack([read_patch(p) for p in batch_pos])

        # host pipeline: loader threads read/normalize the next batches and
        # the host accumulates batch b-1 while the device runs batch b (the
        # reference used DataLoader workers, inference.py:55-63). Every
        # store write happens on this thread: the numpy zarr backend
        # rewrites whole chunks, so two writers of one chunk would race.
        done = 0
        t1 = time.perf_counter()
        with ThreadPoolExecutor(
                max_workers=max(1, mgr.infer_num_dataloader_workers)) as pool:
            pending = None  # (batch_pos, fetched outputs) in flight
            batches = self._prefetch(pool, make_batch, n_batches, phase)
            for b, (batch_pos, host_batch) in enumerate(batches):
                fetched = forward(host_batch)
                if pending is not None:
                    self._drain(pending, targets, accums, wmap)
                    done += len(pending[0])
                pending = (batch_pos, fetched)
                if b == 0:
                    _sync(self.device)
                    phase["first_step"] = time.perf_counter() - t1
                if b % 20 == 0:
                    print(f"[infer] {done}/{n} patches")
            if pending is not None:
                self._drain(pending, targets, accums, wmap)
                done += len(pending[0])

        for acc in accums.values():
            acc.finish()
        phase["loop"] = (time.perf_counter() - t1
                         - phase.get("first_step", 0.0))
        self.last_mode = "rolling"
        # record the REAL peak allocation (must stay within the static
        # _rolling_slab_bytes budget estimate used for mode selection)
        self.max_slab_bytes = max(self.max_slab_bytes,
                                  sum(a.peak_bytes for a in accums.values()))
        print(f"[infer] model pass complete: {n} patches -> {store_path}")

    @staticmethod
    def _drain(pending, targets, accums, wmap):
        batch_pos, fetched = pending
        weighted = _wait_host(fetched)
        for i, (z, y, x) in enumerate(batch_pos):
            for name in targets:
                pred = np.moveaxis(weighted[name][i], -1, 0)  # (C,pz,py,px)
                accums[name].add(z, y, x, pred, wmap)

    # ------------------------------------------------------------------
    # tiled model pass: host-RAM-bounded + resumable
    # ------------------------------------------------------------------
    def _run_model_pass_tiled(self, store_path: str, targets: Dict[str, Dict],
                              budget: int):
        """Process the volume as DISJOINT (z-block, y-band) tiles, each
        accumulated wholly in RAM and written with plain (non-RMW) writes.

        Properties that the rolling path cannot offer:
        * peak slab memory = one tile, sized to ``host_ram_budget_gb`` —
          scroll-scale planes (8k x 8k and up) never materialize in full;
        * idempotent tiles: a crash loses only the current tile, and
          ``--resume`` continues from the per-tile watermark
          (``.model_pass_progress.json``) with bit-identical results.

        Patches whose extent crosses a tile boundary are re-run for each tile
        they touch (only their intersecting slice is accumulated); tiles are
        sized >> patch so the duplicated forward fraction stays small.
        Rank r of n owns the tiles ``tiles[r::n]`` and its own watermark."""
        t0 = time.perf_counter()
        phase = {"read_wait": 0.0}
        self.last_phases = phase
        mgr = self.mgr
        (forward, read_patch, positions, patch, in_shape,
         wmap) = self._setup_model_pass(targets, phase, t0)
        batch_size = mgr.infer_batch_size
        zmax, ymax, xmax = in_shape
        pz, py, px = patch

        # tile shape: z-block of 2 patches, y-band sized to the budget
        chans = sum(int(i["channels"]) + 1 for i in targets.values())
        tz = min(zmax, 2 * pz)
        band = budget // (chans * 4 * tz * xmax)
        band = max(py, min(ymax, int(band)))
        tiles = [(z0, min(z0 + tz, zmax), y0, min(y0 + band, ymax))
                 for z0 in range(0, zmax, tz)
                 for y0 in range(0, ymax, band)]
        # each process owns a disjoint round-robin subset of the tiles; a
        # band that is not a chunk multiple shares chunks between ranks,
        # which the store's chunk lock keeps whole
        rank, n_proc = process_index(), process_count()
        my_tiles = tiles[rank::n_proc]
        progress_name = (".model_pass_progress.json" if n_proc == 1
                         else f".model_pass_progress.p{rank}.json")
        progress_path = os.path.join(store_path, progress_name)

        done_tiles = set()
        if self.resume and os.path.exists(progress_path):
            with open(progress_path) as f:
                prog = json.load(f)
            if prog.get("grid") != [list(in_shape), list(patch),
                                    mgr.infer_overlap]:
                raise ValueError(
                    "--resume: existing progress file was written for a "
                    "different volume/patch/overlap configuration")
            done_tiles = {tuple(t) for t in prog.get("tiles_done", [])}
            print(f"[infer] resuming: {len(done_tiles)}/{len(my_tiles)} "
                  f"tiles already complete")
        elif self.resume and os.path.isdir(store_path):
            # rolling-mode runs leave no progress file; resuming them would
            # silently double-count
            raise RuntimeError(
                f"--resume: '{store_path}' exists but has no "
                f"{progress_name} watermark — it was written by a "
                "rolling-mode (in-RAM) model pass, which cannot be resumed. "
                "Delete the store and rerun.")
        elif os.path.isdir(store_path):
            raise FileExistsError(
                f"Zarr store '{store_path}' already exists. "
                "Aborting to prevent overwrite (pass --resume to continue "
                "an interrupted tiled run).")

        # every process has checked the store as it was; a barrier BEFORE
        # creation, or a slow process would see rank 0's fresh store and
        # take it for an overwrite. One writer creates the stores, the
        # others open them after a second barrier.
        sync_global_devices("infer_guard_checked")
        if rank == 0:
            vols = {name: _create_sum_count(store_path, name,
                                            int(info["channels"]), in_shape,
                                            patch, open_existing=self.resume)
                    for name, info in targets.items()}
        sync_global_devices("infer_stores_created")
        if rank != 0:
            vols = {name: _create_sum_count(store_path, name,
                                            int(info["channels"]), in_shape,
                                            patch, open_existing=True)
                    for name, info in targets.items()}

        def _write_progress():
            tmp = progress_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"grid": [list(in_shape), list(patch),
                                    mgr.infer_overlap],
                           "tiles_done": sorted(done_tiles)}, f)
            os.replace(tmp, progress_path)

        t1 = time.perf_counter()
        pool = ThreadPoolExecutor(
            max_workers=max(1, mgr.infer_num_dataloader_workers))
        try:
            for tile in my_tiles:
                tz0, tz1, ty0, ty1 = tile
                if tile in done_tiles:
                    continue
                tile_pos = [p for p in positions
                            if p[0] < tz1 and p[0] + pz > tz0
                            and p[1] < ty1 and p[1] + py > ty0]
                slabs = {}
                slab_bytes = 0
                for name, info in targets.items():
                    c = int(info["channels"])
                    s = np.zeros((c, tz1 - tz0, ty1 - ty0, xmax), np.float32)
                    cn = np.zeros((tz1 - tz0, ty1 - ty0, xmax), np.float32)
                    slabs[name] = (s, cn)
                    slab_bytes += s.nbytes + cn.nbytes
                self.max_slab_bytes = max(self.max_slab_bytes, slab_bytes)

                n_batches = (len(tile_pos) + batch_size - 1) // batch_size

                def make_batch(b):
                    bp = tile_pos[b * batch_size:(b + 1) * batch_size]
                    return bp, np.stack([read_patch(p) for p in bp])

                def _accumulate(bp, fetched):
                    weighted = _wait_host(fetched)
                    for i, (z, y, x) in enumerate(bp):
                        iz0, iz1 = max(z, tz0), min(z + pz, tz1)
                        iy0, iy1 = max(y, ty0), min(y + py, ty1)
                        wsl = np.s_[iz0 - z:iz1 - z, iy0 - y:iy1 - y, :]
                        ssl = np.s_[iz0 - tz0:iz1 - tz0,
                                    iy0 - ty0:iy1 - ty0, x:x + px]
                        for name in targets:
                            pred = np.moveaxis(weighted[name][i], -1, 0)
                            s, cn = slabs[name]
                            s[(slice(None),) + ssl] += pred[(slice(None),) + wsl]
                            cn[ssl] += wmap[wsl]

                # host accumulation of batch b-1 overlaps the device forward
                # of batch b (same double-buffering as the rolling path)
                pending = None
                batches = self._prefetch(pool, make_batch, n_batches, phase)
                for b, (bp, host_batch) in enumerate(batches):
                    fetched = forward(host_batch)
                    if pending is not None:
                        _accumulate(*pending)
                    pending = (bp, fetched)
                    if "first_step" not in phase:
                        _sync(self.device)
                        phase["first_step"] = time.perf_counter() - t1
                if pending is not None:
                    _accumulate(*pending)

                # plain writes into the tile's exclusive region (idempotent),
                # on this thread only (see the rolling path)
                futs_w = []
                for name, info in targets.items():
                    c = int(info["channels"])
                    sum_vol, cnt_vol = vols[name]
                    s, cn = slabs[name]
                    region = np.s_[tz0:tz1, ty0:ty1]
                    if c == 1:
                        futs_w.append(sum_vol.write_async(region, s[0]))
                    else:
                        futs_w.append(sum_vol.write_async(
                            (slice(None),) + region, s))
                    futs_w.append(cnt_vol.write_async(region, cn))
                for f in futs_w:
                    f.result()
                done_tiles.add(tile)
                _write_progress()
                print(f"[infer] tile z[{tz0}:{tz1}] y[{ty0}:{ty1}]: "
                      f"{len(tile_pos)} patches "
                      f"({len(done_tiles)}/{len(my_tiles)} tiles)")
                if self.tile_callback is not None:
                    self.tile_callback(tile)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
        phase["loop"] = (time.perf_counter() - t1
                         - phase.get("first_step", 0.0))
        self.last_mode = "tiled"
        print(f"[infer] tiled model pass complete: {len(tiles)} tiles -> "
              f"{store_path}")


# ----------------------------------------------------------------------
# finalize / quantize / export — also runnable standalone on an existing
# store (reference: scripts/standalone_inf_average.py:7-138)
# ----------------------------------------------------------------------

def finalize_overlaps(store_path: str, targets: Dict[str, Dict],
                      skip_average: bool = False) -> None:
    """Overlap resolution in place on ``{tgt}_sum``: normals are renormalized
    to unit vectors (never averaged), everything else becomes sum/weight
    (reference: inference.py:166-210).

    Idempotent: a ``.finalized_{target}`` marker is written in the store the
    moment each target's averaging completes (plus a legacy ``.finalized``
    once all are done), so repeated ``--postprocess_only`` runs — including
    reruns after a mid-finalize crash — never re-average an already-averaged
    target. The reference silently corrupts its sums when postprocess runs
    twice (dividing an already-averaged volume by the counts again)."""
    legacy_marker = os.path.join(store_path, ".finalized")
    legacy_done = os.path.exists(legacy_marker)
    for name, info in targets.items():
        marker = os.path.join(store_path, f".finalized_{name}")
        if legacy_done or os.path.exists(marker):
            print(f"[infer] target '{name}' already finalized; skipping "
                  f"(delete {os.path.basename(marker)} to force)")
            continue
        c = int(info["channels"])
        sum_vol = open_zarr(os.path.join(store_path, f"{name}_sum"),
                            writable=True)
        cnt_vol = open_zarr(os.path.join(store_path, f"{name}_count"))
        z = sum_vol.shape[-3]
        cz = sum_vol.chunks[-3]

        for z0 in range(0, z, cz):
            z1 = min(z0 + cz, z)
            if c == 1:
                sblock = sum_vol[z0:z1][None]
            else:
                sblock = sum_vol[:, z0:z1]
            cblock = cnt_vol[z0:z1]
            if _is_normals(name, c):
                # renormalize to unit length; the divisor is the true
                # magnitude (not magnitude+eps as in the reference,
                # inference.py:196) because Gaussian edge weights make sums
                # arbitrarily small while their direction stays exact
                native.renormalize_vectors(sblock, cblock)
            elif not skip_average:
                native.finalize_average(sblock, cblock)
            if c == 1:
                sum_vol[z0:z1] = sblock[0]
            else:
                sum_vol[:, z0:z1] = sblock
        with open(marker, "w") as f:
            f.write("overlap averaging applied\n")
    if not legacy_done:
        with open(legacy_marker, "w") as f:
            f.write("overlap averaging applied to all targets\n")


def quantize_final(store_path: str, targets: Dict[str, Dict]) -> None:
    """Cast finalized float sums to ``{tgt}_final``: uint16 for normals
    ([-1,1] -> 32767.5 codec), uint8 otherwise ([0,1] -> 255)
    (reference: inference.py:212-263)."""
    for name, info in targets.items():
        sum_path = os.path.join(store_path, f"{name}_sum")
        if not zarr_exists(sum_path):
            if zarr_exists(os.path.join(store_path, f"{name}_final")):
                # device-accumulated store: finals were quantized on device
                # and no sums persisted (inference_config.write_sums)
                print(f"[infer] '{name}': no sums in store but finals "
                      f"present (device-accumulated run); nothing to do")
                continue
            raise FileNotFoundError(
                f"{sum_path} missing — the store has neither sums nor "
                f"finals for target '{name}'")
        sum_vol = open_zarr(sum_path)
        is_normals = name.lower() == "normals"
        final_dtype = np.uint16 if is_normals else np.uint8
        # overwrite any previous final dataset: postprocess-only reruns
        # recompute finals from the persisted sums (reference semantics:
        # inference.py:159-161, 225-233)
        final_vol = create_zarr(
            os.path.join(store_path, f"{name}_final"), sum_vol.shape,
            final_dtype, sum_vol.chunks, compressor=None,
            delete_existing=True)
        z = sum_vol.shape[-3]
        cz = sum_vol.chunks[-3]
        for z0 in range(0, z, cz):
            z1 = min(z0 + cz, z)
            block = np.ascontiguousarray(sum_vol[..., z0:z1, :, :])
            if is_normals:
                q = native.encode_normals_u16(block)
            else:
                q = native.quantize_u8(block)
            final_vol[..., z0:z1, :, :] = q


def export_z_slices(store_path: str, targets: Dict[str, Dict],
                    output_path: str) -> None:
    """Per-Z JPEG export of ``{tgt}_final`` (reference: inference.py:265-289)."""
    import cv2

    slices_dir = os.path.join(output_path, "z_slices")
    os.makedirs(slices_dir, exist_ok=True)
    for name in targets:
        tdir = os.path.join(slices_dir, name)
        os.makedirs(tdir, exist_ok=True)
        final_vol = open_zarr(os.path.join(store_path, f"{name}_final"))
        shape = final_vol.shape
        if len(shape) == 4:
            for z in range(shape[1]):
                sl = final_vol[:, z]
                if sl.dtype == np.uint16:
                    sl = (sl / 257).astype(np.uint8)
                if sl.shape[0] == 3:
                    sl = np.transpose(sl, (1, 2, 0))
                cv2.imwrite(os.path.join(tdir, f"{z}.jpg"), sl)
        else:
            for z in range(shape[0]):
                sl = final_vol[z].astype(np.uint8)
                cv2.imwrite(os.path.join(tdir, f"{z}.jpg"), sl)


# The reference's class name (inference.py:14)
ZarrInferenceHandler = ZarrInferenceEngine
