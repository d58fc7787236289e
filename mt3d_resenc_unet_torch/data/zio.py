"""Chunked volume IO on zarr v2 arrays.

The port of ``mt3d_resenc_unet_tpu/data/zio.py``, with the same API
(``Volume``, ``RamVolume``, ``to_ram``, ``volume_nbytes``, ``open_zarr``,
``create_zarr``, ``zarr_exists``, ``normalize_to_unit``, the normals codec)
and the same decode arithmetic. Two backends behind ``Volume``:

* a zarr v2 array (C or F order, no filters) whose compressor
  ``data/codec.py`` handles -- none, Blosc (zstd, lz4, lz4hc, blosclz,
  snappy and zlib streams, any shuffle), zstd, zlib, gzip or bz2: every
  compressor tensorstore's zarr driver has -- is read and written by this
  module and the port's own C++ codec: one ``.zarray`` JSON plus one chunk
  per key, named ``i.j.k`` (or ``i/j/k`` with ``dimension_separator: "/"``),
  edge chunks stored at full size, a missing chunk reading as the fill
  value. The keys live in one of three key-value stores (:class:`_FileKV`,
  :class:`_HttpKV`, :class:`_MemoryKV`): a local directory; an ``http://``
  or ``https://`` URL, read-only, through the standard library's
  ``http.client`` with one kept-alive connection a thread (a 404 is a
  missing key, as tensorstore's http kvstore has it), where ``s3://bucket/
  prefix`` reads ``https://bucket.s3.amazonaws.com/prefix`` and ``gs://
  bucket/prefix`` ``https://storage.googleapis.com/bucket/prefix`` (public
  objects: no credentials are sent); and ``memory://``, which
  ``create_zarr`` makes anew at each call and ``open_zarr`` never finds, as
  each tensorstore open of the JAX package gets its own memory kvstore.
  These stores and the JAX package's (tensorstore's) read each other bit
  for bit, and ``create_zarr`` writes the ``.zarray`` tensorstore writes
  for the same arguments (the default compressor, Blosc zstd-5 bit
  shuffle, included);
* any other array (filters, a compressor or Blosc stream that neither
  this module nor tensorstore knows) goes to tensorstore when it is
  importable, as in the JAX package, which refuses it too; without it,
  opening one raises an ``ImportError`` that names the store and says
  so.

The port's backend reads or writes (and decodes or encodes) the chunks of
one read or write in parallel on a thread pool (the codec releases the
GIL), and ``Volume.read_async`` / ``write_async`` return futures of a second
pool, as tensorstore's do. It writes a chunk that a region covers whole by
replacing it, and a chunk that it covers in part by read-modify-write under
the key's lock: in a directory an exclusive ``fcntl.flock`` of the chunk's
lock file (``.{key}.lock`` beside it), so writers of disjoint parts of one
chunk, in threads or processes, take turns and lose no update. The reads
are thread-safe.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import http.client
import json
import math
import os
import shutil
import threading
import urllib.parse
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from . import codec

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
# The keys tensorstore fills in when it writes a compressor to .zarray.
_COMPRESSOR_DEFAULTS = {
    "blosc": {"blocksize": 0, "clevel": 5, "cname": "lz4", "shuffle": -1},
    "zstd": {"level": 1}, "zlib": {"level": 1}, "gzip": {"level": 1},
    "bz2": {"level": 1},
}


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
            f"zarr store {path!r} ({why}) is not one the port's codec reads "
            "(C or F order, no filters, compressor none or "
            f"{', '.join(codec.COMPRESSOR_IDS)}), and tensorstore, which is "
            "not installed, cannot read it either: its zarr driver has the "
            "same compressors and refuses filters") from exc
    return ts


# ------------------------------------------------------------ thread pools

_pools: Dict[str, ThreadPoolExecutor] = {}
_pools_lock = threading.Lock()


def _pool(name: str) -> ThreadPoolExecutor:
    """``chunks`` decodes / encodes the chunks of one read or write; ``io``
    runs ``read_async`` / ``write_async`` (whose reads then use
    ``chunks``: a task of one pool never waits on its own pool)."""
    with _pools_lock:
        pool = _pools.get(name)
        if pool is None:
            pool = ThreadPoolExecutor(min(16, os.cpu_count() or 4),
                                      thread_name_prefix=f"zio-{name}")
            _pools[name] = pool
        return pool


def _forget_pools() -> None:
    """A forked child has none of its parent's pool threads."""
    global _pools_lock
    _pools.clear()
    _pools_lock = threading.Lock()


os.register_at_fork(after_in_child=_forget_pools)


def _each(fn: Callable, items: list) -> None:
    if len(items) > 1:
        for _ in _pool("chunks").map(fn, items):
            pass
    elif items:
        fn(items[0])


# ------------------------------------------------------ local zarr v2 store

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


def _fill_value(value, dtype: np.dtype):
    """A ``.zarray`` fill value as tensorstore writes it (floats as floats,
    non-finite ones as strings)."""
    if value is None:
        return None
    if dtype.kind == "f":
        value = float(value)
        if math.isnan(value):
            return "NaN"
        if math.isinf(value):
            return "Infinity" if value > 0 else "-Infinity"
        return value
    return int(value)


def _parse_fill(value, dtype: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf,
                "-Infinity": -np.inf}[value]
    return np.asarray(value).astype(dtype)


def _normalize_compressor(compressor):
    """The compressor as tensorstore writes it to ``.zarray``."""
    if compressor is None:
        return None
    defaults = _COMPRESSOR_DEFAULTS.get(compressor.get("id"), {})
    return {**defaults, **compressor}


def _local_codec(meta: Dict[str, Any]) -> bool:
    """Whether this module reads and writes the array itself."""
    return (meta.get("order", "C") in ("C", "F") and not meta.get("filters")
            and codec.supported(meta.get("compressor")))


# ------------------------------------------------------ key-value stores

class _FileKV:
    """The keys of an array as files under its directory."""

    writable = True

    def __init__(self, root: str):
        self.root = root

    def _file(self, key: str) -> str:
        return os.path.join(self.root, key)

    def read(self, key: str) -> Optional[bytes]:
        try:
            with open(self._file(key), "rb") as f:
                return f.read()
        except (FileNotFoundError, NotADirectoryError):
            return None

    def write(self, key: str, data: bytes) -> None:
        """Replace the key's file whole (a temporary file renamed over it)."""
        path = self._file(key)
        if "/" in key:
            os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    @contextlib.contextmanager
    def locked(self, key: str):
        """An exclusive ``fcntl.flock`` of the key's lock file, held by
        threads and processes in turn."""
        path = self._file(key)
        if "/" in key:
            os.makedirs(os.path.dirname(path), exist_ok=True)
        lock = os.path.join(os.path.dirname(path),
                            f".{os.path.basename(path)}.lock")
        fd = os.open(lock, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)   # releases the lock


class _MemoryKV:
    """An in-process store of one ``create_zarr("memory://...")`` call."""

    writable = True

    def __init__(self):
        self.data: Dict[str, bytes] = {}
        self.lock = threading.Lock()

    def read(self, key: str) -> Optional[bytes]:
        return self.data.get(key)

    def write(self, key: str, data: bytes) -> None:
        self.data[key] = data

    def locked(self, key: str):
        return self.lock


def http_url(path: str) -> str:
    """The HTTP(S) base URL of a remote store: ``s3://bucket/prefix`` and
    ``gs://bucket/prefix`` by their public endpoints."""
    if path.startswith("s3://"):
        bucket, _, prefix = path[len("s3://"):].partition("/")
        return f"https://{bucket}.s3.amazonaws.com/{prefix}".rstrip("/")
    if path.startswith("gs://"):
        return ("https://storage.googleapis.com/"
                + path[len("gs://"):]).rstrip("/")
    return path.rstrip("/")


class _HttpKV:
    """The keys of an array under an HTTP(S) base URL, read-only: ``GET
    {base}/{key}``, a 404 a missing key, any other status or a body shorter
    than its ``Content-Length`` an ``OSError`` naming the URL. Each thread
    keeps one connection to the host, reopened once where the server closed
    it between requests."""

    writable = False

    def __init__(self, url: str):
        self.url = url
        parts = urllib.parse.urlsplit(url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"not an http(s) URL: {url!r}")
        self.https = parts.scheme == "https"
        self.host, self.port = parts.hostname, parts.port
        self.prefix = parts.path.rstrip("/")
        self.local = threading.local()

    def _connection(self, fresh: bool = False) -> http.client.HTTPConnection:
        conn = getattr(self.local, "conn", None)
        if conn is None or fresh:
            if conn is not None:
                conn.close()
            cls = (http.client.HTTPSConnection if self.https
                   else http.client.HTTPConnection)
            conn = cls(self.host, self.port, timeout=60)
            self.local.conn = conn
        return conn

    def read(self, key: str) -> Optional[bytes]:
        target = f"{self.prefix}/{urllib.parse.quote(key)}"
        url = f"{self.url}/{key}"
        for attempt in (0, 1):
            conn = self._connection(fresh=attempt == 1)
            try:
                conn.request("GET", target)
                resp = conn.getresponse()
                body = resp.read()
                break
            except (http.client.RemoteDisconnected, ConnectionResetError,
                    BrokenPipeError):
                if attempt == 1:
                    raise
            except http.client.IncompleteRead as exc:
                conn.close()
                raise OSError(f"GET {url}: body cut short ({len(exc.partial)}"
                              f" bytes of {exc.expected + len(exc.partial)})"
                              ) from exc
        if resp.status == 404:
            return None
        if resp.status != 200:
            raise OSError(f"GET {url}: HTTP {resp.status} {resp.reason}")
        return body

    def write(self, key: str, data: bytes) -> None:
        raise OSError(f"{self.url}: an http(s) store is read-only")

    def locked(self, key: str):
        raise OSError(f"{self.url}: an http(s) store is read-only")


class _LocalZarr:
    """A zarr v2 array by numpy and the port's codec, its keys in ``kv``
    (the directory ``path`` by default)."""

    def __init__(self, path: str, meta: Dict[str, Any], kv=None):
        self.path = path
        self.kv = _FileKV(path) if kv is None else kv
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.compressor = meta.get("compressor")
        self.fill_value = _parse_fill(meta.get("fill_value"), self.dtype)
        self.sep = meta.get("dimension_separator") or "."
        # an F-order chunk stores the transpose of its C-order bytes
        self.fortran = meta.get("order", "C") == "F"
        self.stored = self.chunks[::-1] if self.fortran else self.chunks
        if not _local_codec(meta):
            raise ValueError(f"{path}: only C- or F-order zarr arrays "
                             "without filters, with a compressor "
                             "data/codec.py handles, are read without "
                             "tensorstore")

    def _key(self, key) -> str:
        return self.sep.join(str(k) for k in key)

    def _read_chunk(self, key) -> np.ndarray:
        """The chunk's values; read-only where they are the stored bytes
        (no compressor), to spare a copy."""
        name = self._key(key)
        data = self.kv.read(name)
        if data is None:
            return np.full(self.chunks, self.fill_value, self.dtype)
        if self.compressor is None and len(data) == np.prod(
                self.chunks) * self.dtype.itemsize:
            chunk = np.frombuffer(data, self.dtype).reshape(self.stored)
        else:
            chunk = np.empty(self.stored, self.dtype)
            try:
                codec.decode_chunk_into(self.compressor, data, chunk)
            except ValueError as exc:
                raise ValueError(f"{self.path}/{name}: {exc}") from exc
        return chunk.T if self.fortran else chunk

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

        def one(part):
            key, in_chunk, in_out = part
            out[in_out] = self._read_chunk(key)[in_chunk]

        if out.size:
            _each(one, list(self._overlaps(ranges)))
        return out.reshape([n for ax, n in enumerate(out.shape)
                            if ax not in dropped])

    def write(self, idx, value) -> None:
        ranges, dropped = _ranges(idx, self.shape)
        full = [b - a for a, b in ranges]
        kept = [n for ax, n in enumerate(full) if ax not in dropped]
        value = np.broadcast_to(np.asarray(value, self.dtype),
                                kept).reshape(full)

        def one(part):
            key, in_chunk, in_out = part
            if all(s.stop - s.start == c
                   for s, c in zip(in_chunk, self.chunks)):
                chunk = np.full(self.chunks, self.fill_value, self.dtype)
                chunk[in_chunk] = value[in_out]
                self._replace_chunk(key, chunk)
                return
            with self.kv.locked(self._key(key)):
                chunk = self._read_chunk(key)
                if not chunk.flags.writeable:
                    chunk = chunk.copy()
                chunk[in_chunk] = value[in_out]
                self._replace_chunk(key, chunk)

        if not self.kv.writable:
            raise OSError(f"{self.path}: the store is read-only")
        _each(one, list(self._overlaps(ranges)))

    def _replace_chunk(self, key, chunk: np.ndarray) -> None:
        self.kv.write(self._key(key), codec.encode_chunk_array(
            self.compressor,
            np.ascontiguousarray(chunk.T if self.fortran else chunk),
            self.dtype.itemsize))


class _TsStore:
    """A tensorstore handle with the interface of :class:`_LocalZarr`."""

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
    """A finished future, for ``RamVolume``."""

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

    def read_async(self, idx) -> Future:
        """Begin a read; returns a future with .result()."""
        if isinstance(self.store, _TsStore):
            return self.store.store[idx].read()
        return _pool("io").submit(self.store.read, idx)

    def __setitem__(self, idx, value) -> None:
        self.store.write(idx, value)

    def write_async(self, idx, value) -> Future:
        """Begin a write; ``value`` must not change until the future is
        done."""
        if isinstance(self.store, _TsStore):
            return self.store.store[idx].write(value)
        return _pool("io").submit(self.store.write, idx, value)

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


_HTTP = ("http://", "https://", "s3://", "gs://")


def _kv(path: str):
    """The key-value store of a path or URL (``memory://`` has none to
    open)."""
    if path.startswith(_HTTP):
        return _HttpKV(http_url(path))
    return _FileKV(path)


def _meta(kv) -> Optional[Dict[str, Any]]:
    """The ``.zarray`` of an array in ``kv``, or None."""
    data = kv.read(".zarray")
    return None if data is None else json.loads(data)


def _open_ts(path: str, writable: bool, why: str) -> Volume:
    ts = _tensorstore(path, why)
    spec = {"driver": "zarr", "kvstore": _kvstore_spec(path)}
    store = ts.open(spec, open=True, read=True, write=writable).result()
    return Volume(store=_TsStore(store, path), path=path)


def open_zarr(path: str, *, component: Optional[str] = None,
              writable: bool = False) -> Volume:
    """Open an existing zarr v2 array (a local path or an http(s), s3 or
    gs URL). ``component`` selects an array inside a group; a group without
    one opens its multiscale level "0" (JAX zio.py:156-176). A
    ``memory://`` array is never found (each open of the JAX package's gets
    a new, empty memory kvstore): ``ValueError``."""
    full = path if component is None else f"{path.rstrip('/')}/{component}"
    if full.startswith("memory://"):
        raise ValueError(f"NOT_FOUND: no zarr array at {full} (a memory:// "
                         "store lives only in the volume create_zarr "
                         "returned)")
    kv = _kv(full)
    meta = _meta(kv)
    if meta is not None:
        if _local_codec(meta):
            return Volume(store=_LocalZarr(full, meta, kv), path=full)
        return _open_ts(full, writable, "compressor "
                        f"{meta.get('compressor')}, filters "
                        f"{meta.get('filters')}")
    if component is None and _meta(_kv(f"{path.rstrip('/')}/0")) is not None:
        return open_zarr(path, component="0", writable=writable)
    raise FileNotFoundError(f"no zarr array at {full}")


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
    A local path or ``memory://`` (a new in-process store at each call)
    with a compressor ``data/codec.py`` handles needs no package; its
    ``.zarray`` is the one tensorstore writes. An http(s), s3 or gs URL is
    read-only: ``OSError``."""
    dt = np.dtype(dtype)
    metadata = {
        "shape": list(shape),
        "chunks": list(chunks),
        "dtype": _DTYPE_TO_ZARR[dt],
        "compressor": compressor,
        "fill_value": fill_value,
    }
    if path.startswith(_HTTP):
        raise OSError(f"{path}: an http(s), s3 or gs store is read-only")
    if not codec.supported(compressor):
        ts = _tensorstore(path, f"compressor {compressor}")
        spec = {"driver": "zarr", "kvstore": _kvstore_spec(path),
                "metadata": metadata}
        store = ts.open(spec, create=True, delete_existing=delete_existing,
                        open=allow_existing).result()
        return Volume(store=_TsStore(store, path), path=path)
    metadata.update(compressor=_normalize_compressor(compressor),
                    fill_value=_fill_value(fill_value, dt), zarr_format=2,
                    order="C", filters=None, dimension_separator=".")
    if path.startswith("memory://"):
        kv = _MemoryKV()
    else:
        root = Path(path)
        if root.exists():
            if delete_existing:
                shutil.rmtree(root)
            elif allow_existing and _meta(_FileKV(path)) is not None:
                return open_zarr(path, writable=True)
            else:
                raise FileExistsError(f"zarr array exists at {path}")
        root.mkdir(parents=True)
        kv = _FileKV(path)
    kv.write(".zarray", json.dumps(metadata, sort_keys=True).encode())
    return Volume(store=_LocalZarr(path, metadata, kv), path=path)


def zarr_exists(path: str) -> bool:
    """Whether an array opens at ``path``: its ``.zarray`` is there (never
    for ``memory://``, as in the JAX package); a remote store that fails to
    answer counts as none, as tensorstore's failed open does there."""
    if path.startswith("memory://"):
        return False
    try:
        return _meta(_kv(path)) is not None
    except (OSError, ValueError):
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
