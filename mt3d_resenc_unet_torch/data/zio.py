"""Chunked volume IO on zarr v2 arrays.

The port of ``mt3d_resenc_unet_tpu/data/zio.py``, with the same API
(``Volume``, ``RamVolume``, ``to_ram``, ``volume_nbytes``, ``open_zarr``,
``create_zarr``, ``zarr_exists``, ``normalize_to_unit``, the normals codec)
and the same decode arithmetic. Two backends behind ``Volume``:

* a local zarr v2 array with ``compressor: null`` is read and written by
  numpy alone: one ``.zarray`` JSON plus one raw C-order file per chunk,
  named ``i.j.k`` (or ``i/j/k`` with ``dimension_separator: "/"``), edge
  chunks stored at full size, a missing chunk reading as the fill value.
  That needs nothing installed, and round-trips with the JAX package's
  ``create_zarr(..., compressor=None)`` and ``open_zarr``;
* any other store (Blosc or zstd chunks, http(s)/s3/gs URLs, ``memory://``)
  goes through tensorstore when it is importable, as in the JAX package;
  without it, opening one raises an ``ImportError`` naming the package and
  the store.

The numpy backend writes a chunk that a region covers whole by replacing
its file, and a chunk that it covers in part by read-modify-write under an
exclusive ``fcntl.flock`` of the chunk's lock file (``.{key}.lock`` beside
it): writers of disjoint parts of one chunk, in threads or processes,
take turns and lose no update. The reads are thread-safe.
"""

from __future__ import annotations

import dataclasses
import fcntl
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

# Blosc zstd level 5 with bitshuffle — the reference's compressor for all
# prediction stores (reference: inference.py:92).
DEFAULT_COMPRESSOR = {"id": "blosc", "cname": "zstd", "clevel": 5, "shuffle": 2}

_DTYPE_TO_ZARR = {
    np.dtype("uint8"): "|u1",
    np.dtype("uint16"): "<u2",
    np.dtype("uint32"): "<u4",
    np.dtype("int8"): "|i1",
    np.dtype("int16"): "<i2",
    np.dtype("int32"): "<i4",
    np.dtype("int64"): "<i8",
    np.dtype("float32"): "<f4",
    np.dtype("float64"): "<f8",
}
_REMOTE = ("http://", "https://", "s3://", "gs://", "memory://")


def _kvstore_spec(path: str) -> Dict[str, Any]:
    """Map a path/URL to a tensorstore kvstore spec (JAX zio.py:39-56)."""
    if path.startswith(("http://", "https://")):
        return {"driver": "http", "base_url": path.rstrip("/")}
    if path.startswith("s3://"):
        bucket, _, prefix = path[len("s3://"):].partition("/")
        return {"driver": "s3", "bucket": bucket, "path": prefix}
    if path.startswith("gs://"):
        bucket, _, prefix = path[len("gs://"):].partition("/")
        return {"driver": "gcs", "bucket": bucket, "path": prefix}
    if path.startswith("memory://"):
        return {"driver": "memory", "path": path[len("memory://"):]}
    return {"driver": "file", "path": os.path.abspath(path)}


def _tensorstore(path: str, why: str):
    try:
        import tensorstore as ts
    except ImportError as exc:
        raise ImportError(
            f"zarr store {path!r} ({why}) needs the tensorstore package; "
            "without it only local uncompressed zarr v2 arrays "
            "(compressor: null) can be read and written") from exc
    return ts


# ------------------------------------------------------ numpy zarr v2 store

def _ranges(idx, shape) -> Tuple[list, list]:
    """A basic index (ints, unit-step slices, one Ellipsis) -> per-axis
    (start, stop) and the axes an int removes."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    if any(i is Ellipsis for i in idx):
        k = idx.index(Ellipsis)
        fill = (slice(None),) * (len(shape) - len(idx) + 1)
        idx = idx[:k] + fill + idx[k + 1:]
    idx = idx + (slice(None),) * (len(shape) - len(idx))
    if len(idx) != len(shape):
        raise IndexError(f"too many indices for shape {shape}")
    ranges, dropped = [], []
    for axis, (i, n) in enumerate(zip(idx, shape)):
        if isinstance(i, slice):
            start, stop, step = i.indices(n)
            if step != 1:
                raise IndexError("zarr slices need step 1")
            ranges.append((start, max(start, stop)))
        else:
            i = int(i)
            if i < 0:
                i += n
            if not 0 <= i < n:
                raise IndexError(f"index {i} out of range for axis {axis}")
            ranges.append((i, i + 1))
            dropped.append(axis)
    return ranges, dropped


class _RawZarr:
    """A local zarr v2 array with uncompressed chunks, by numpy."""

    def __init__(self, path: str, meta: Dict[str, Any]):
        self.path = path
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.fill_value = meta.get("fill_value") or 0
        self.sep = meta.get("dimension_separator") or "."
        if meta.get("order", "C") != "C" or meta.get("filters"):
            raise ValueError(f"{path}: only C-order zarr arrays without "
                             "filters are read without tensorstore")

    def _chunk_file(self, key) -> str:
        return os.path.join(self.path, self.sep.join(str(k) for k in key))

    def _read_chunk(self, key) -> np.ndarray:
        try:
            flat = np.fromfile(self._chunk_file(key), dtype=self.dtype)
        except FileNotFoundError:
            return np.full(self.chunks, self.fill_value, self.dtype)
        return flat.reshape(self.chunks)

    def _overlaps(self, ranges):
        """(chunk key, slice in the chunk, slice in the region) of every
        chunk the region touches."""
        per_axis = []
        for (a, b), c in zip(ranges, self.chunks):
            per_axis.append([(k, slice(max(a, k * c) - k * c,
                                       min(b, (k + 1) * c) - k * c),
                              slice(max(a, k * c) - a, min(b, (k + 1) * c) - a))
                             for k in range(a // c, -(-b // c))])
        for combo in np.ndindex(*(len(p) for p in per_axis)):
            parts = [per_axis[ax][i] for ax, i in enumerate(combo)]
            yield (tuple(p[0] for p in parts), tuple(p[1] for p in parts),
                   tuple(p[2] for p in parts))

    def read(self, idx) -> np.ndarray:
        ranges, dropped = _ranges(idx, self.shape)
        out = np.empty([b - a for a, b in ranges], self.dtype)
        if out.size:
            for key, in_chunk, in_out in self._overlaps(ranges):
                out[in_out] = self._read_chunk(key)[in_chunk]
        return out.reshape([n for ax, n in enumerate(out.shape)
                            if ax not in dropped])

    def write(self, idx, value) -> None:
        ranges, dropped = _ranges(idx, self.shape)
        full = [b - a for a, b in ranges]
        kept = [n for ax, n in enumerate(full) if ax not in dropped]
        value = np.broadcast_to(np.asarray(value, self.dtype),
                                kept).reshape(full)
        for key, in_chunk, in_out in self._overlaps(ranges):
            path = self._chunk_file(key)
            if self.sep == "/":
                os.makedirs(os.path.dirname(path), exist_ok=True)
            if all(s.stop - s.start == c
                   for s, c in zip(in_chunk, self.chunks)):
                chunk = np.full(self.chunks, self.fill_value, self.dtype)
                chunk[in_chunk] = value[in_out]
                self._replace_chunk(path, chunk)
                continue
            lock = os.path.join(os.path.dirname(path),
                                f".{os.path.basename(path)}.lock")
            fd = os.open(lock, os.O_RDWR | os.O_CREAT, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                chunk = self._read_chunk(key).copy()
                chunk[in_chunk] = value[in_out]
                self._replace_chunk(path, chunk)
            finally:
                os.close(fd)   # releases the lock

    @staticmethod
    def _replace_chunk(path: str, chunk: np.ndarray) -> None:
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        np.ascontiguousarray(chunk).tofile(tmp)
        os.replace(tmp, path)


class _TsStore:
    """A tensorstore handle with the interface of :class:`_RawZarr`."""

    def __init__(self, store, path: str):
        self.store, self.path = store, path
        self.shape = tuple(store.shape)
        self.dtype = np.dtype(store.dtype.numpy_dtype)
        self.chunks = tuple(store.chunk_layout.read_chunk.shape)

    def read(self, idx) -> np.ndarray:
        return np.asarray(self.store[idx].read().result())

    def write(self, idx, value) -> None:
        self.store[idx].write(value).result()


class _ReadyFuture:
    """A finished future, for the synchronous numpy backend."""

    __slots__ = ("_value",)

    def __init__(self, value=None):
        self._value = value

    def result(self):
        return self._value


@dataclasses.dataclass
class Volume:
    """A zarr array on either backend (the JAX package's ``Volume``)."""

    store: Any
    path: str

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.store.shape

    @property
    def dtype(self) -> np.dtype:
        return self.store.dtype

    @property
    def chunks(self) -> Tuple[int, ...]:
        return self.store.chunks

    def __getitem__(self, idx) -> np.ndarray:
        return self.store.read(idx)

    def read_async(self, idx):
        """Begin a read; returns a future with .result()."""
        if isinstance(self.store, _TsStore):
            return self.store.store[idx].read()
        return _ReadyFuture(self.store.read(idx))

    def __setitem__(self, idx, value) -> None:
        self.store.write(idx, value)

    def write_async(self, idx, value):
        if isinstance(self.store, _TsStore):
            return self.store.store[idx].write(value)
        self.store.write(idx, value)
        return _ReadyFuture()

    def read_all(self) -> np.ndarray:
        return self.store.read(...)


@dataclasses.dataclass
class RamVolume:
    """A Volume fully resident in host RAM (read-only): per-sample reads
    cost a strided slice copy instead of chunk reads (JAX zio.py:107-141)."""

    data: np.ndarray
    path: str

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.data.shape

    @property
    def dtype(self) -> np.dtype:
        return self.data.dtype

    @property
    def chunks(self) -> Tuple[int, ...]:
        return self.data.shape

    def __getitem__(self, idx) -> np.ndarray:
        return self.data[idx]

    def read_async(self, idx):
        return _ReadyFuture(self.data[idx])

    def read_all(self) -> np.ndarray:
        return self.data


def volume_nbytes(vol) -> int:
    """Stored (decompressed) size of a volume in bytes."""
    return int(np.prod(vol.shape)) * np.dtype(vol.dtype).itemsize


def to_ram(vol) -> RamVolume:
    """Materialize a Volume into host RAM (no-op for RamVolume)."""
    if isinstance(vol, RamVolume):
        return vol
    return RamVolume(data=np.ascontiguousarray(vol.read_all()), path=vol.path)


def _local_meta(path: str) -> Optional[Dict[str, Any]]:
    """The ``.zarray`` of a local array, or None."""
    if path.startswith(_REMOTE):
        return None
    meta = Path(path) / ".zarray"
    if not meta.is_file():
        return None
    return json.loads(meta.read_text())


def _open_ts(path: str, writable: bool, why: str) -> Volume:
    ts = _tensorstore(path, why)
    spec = {"driver": "zarr", "kvstore": _kvstore_spec(path)}
    store = ts.open(spec, open=True, read=True, write=writable).result()
    return Volume(store=_TsStore(store, path), path=path)


def open_zarr(path: str, *, component: Optional[str] = None,
              writable: bool = False) -> Volume:
    """Open an existing zarr v2 array (local or remote). ``component``
    selects an array inside a group; a group without one opens its
    multiscale level "0" (JAX zio.py:156-176)."""
    full = path if component is None else os.path.join(path, component)
    meta = _local_meta(full)
    if meta is not None:
        if meta.get("compressor") is None:
            return Volume(store=_RawZarr(full, meta), path=full)
        return _open_ts(full, writable,
                        f"compressor {meta['compressor'].get('id')}")
    if component is None and _local_meta(os.path.join(path, "0")) is not None:
        return open_zarr(path, component="0", writable=writable)
    if not full.startswith(_REMOTE):
        raise FileNotFoundError(f"no zarr array at {full}")
    try:
        return _open_ts(full, writable, "remote store")
    except ImportError:
        raise
    except Exception:
        if component is None:
            return open_zarr(path, component="0", writable=writable)
        raise


def create_zarr(
    path: str,
    shape: Sequence[int],
    dtype,
    chunks: Sequence[int],
    *,
    compressor: Optional[Dict[str, Any]] = DEFAULT_COMPRESSOR,
    fill_value: Any = 0,
    delete_existing: bool = False,
    allow_existing: bool = False,
) -> Volume:
    """Create a zarr v2 array (bit-compatible with the reference's stores).
    ``compressor=None`` on a local path needs no package."""
    dt = np.dtype(dtype)
    metadata = {
        "shape": list(shape),
        "chunks": list(chunks),
        "dtype": _DTYPE_TO_ZARR[dt],
        "compressor": compressor,
        "fill_value": fill_value,
    }
    if compressor is not None or path.startswith(_REMOTE):
        ts = _tensorstore(path, "compressed or remote")
        spec = {"driver": "zarr", "kvstore": _kvstore_spec(path),
                "metadata": metadata}
        store = ts.open(spec, create=True, delete_existing=delete_existing,
                        open=allow_existing).result()
        return Volume(store=_TsStore(store, path), path=path)
    root = Path(path)
    if root.exists():
        if delete_existing:
            shutil.rmtree(root)
        elif allow_existing and _local_meta(path) is not None:
            return open_zarr(path, writable=True)
        else:
            raise FileExistsError(f"zarr array exists at {path}")
    root.mkdir(parents=True)
    metadata.update(zarr_format=2, order="C", filters=None,
                    dimension_separator=".")
    (root / ".zarray").write_text(json.dumps(metadata, indent=2))
    return Volume(store=_RawZarr(path, metadata), path=path)


def zarr_exists(path: str) -> bool:
    if _local_meta(path) is not None:
        return True
    if not path.startswith(_REMOTE):
        return False
    try:
        _open_ts(path, False, "remote store")
        return True
    except ImportError:
        raise
    except Exception:
        return False


# Decode tables (JAX zio.py:217-268): integer stores decode by one gather.
_U8_UNIT_LUT = np.arange(256, dtype=np.float32) / 255.0
_U16_UNIT_LUT = np.arange(65536, dtype=np.float32) / 65535.0


def normalize_to_unit(data: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """Input normalization: uint8/255, uint16/65535 through lookup tables,
    pass-through floats (reference: dataloading/dataset.py:125-131)."""
    if dtype == np.uint8:
        return _U8_UNIT_LUT[data]
    if dtype == np.uint16:
        return _U16_UNIT_LUT[data]
    return data.astype(np.float32)


# Normals codec (JAX zio.py:238-268): encode u16 = clip((v + 1) * 32767.5,
# 0, 65535); decode v = (u - 32767.5) / 32767.5. That grouping makes fp32
# negation exact in encoded space: decode(65535 - u) == -decode(u), bit for
# bit, which the wire-format geometric flips rely on (data/augment.py).
NORMALS_SCALE = 32767.5
_NORMALS_LUT = ((np.arange(65536, dtype=np.float32) - NORMALS_SCALE)
                / NORMALS_SCALE)


def encode_normals_u16(vec: np.ndarray) -> np.ndarray:
    q = (vec.astype(np.float32) + 1.0) * NORMALS_SCALE
    return np.clip(q, 0, 65535).astype(np.uint16)


def decode_normals(data: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """uint16 -> [-1, 1] through the table; other dtypes assumed in [0, 1]
    -> *2 - 1 (reference: dataloading/dataset.py:147-152)."""
    if dtype == np.uint16:
        return _NORMALS_LUT[data]
    return data.astype(np.float32) * 2.0 - 1.0
