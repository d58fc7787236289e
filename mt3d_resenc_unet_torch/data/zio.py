"""Chunked volume IO on zarr v2 arrays.

The port of ``mt3d_resenc_unet_tpu/data/zio.py``, with the same API
(``Volume``, ``RamVolume``, ``to_ram``, ``volume_nbytes``, ``open_zarr``,
``create_zarr``, ``zarr_exists``, ``normalize_to_unit``, the normals codec)
and the same decode arithmetic, without tensorstore:

* a zarr v2 array (C or F order, no filters) whose compressor
  ``data/codec.py`` handles -- none, Blosc (zstd, lz4, lz4hc, blosclz,
  snappy and zlib streams, any shuffle), zstd, zlib, gzip or bz2: every
  compressor tensorstore's zarr driver has -- is read and written by this
  module and the port's own C++ codec: one ``.zarray`` JSON plus one chunk
  per key, named ``i.j.k`` (or ``i/j/k`` with ``dimension_separator: "/"``),
  edge chunks stored at full size, a missing chunk reading as the fill
  value. The keys live in one of five key-value stores: a local directory
  (:class:`_FileKV`); an ``http://`` or ``https://`` URL (:class:`_HttpKV`),
  read-only, as tensorstore's http kvstore (a 404 is a missing key); an
  ``s3://bucket/prefix`` (:class:`_S3KV`) or ``gs://bucket/prefix``
  (:class:`_GcsKV`) bucket, read and written through the REST and JSON
  APIs as tensorstore's s3 and gcs kvstores send them, signed with the
  user's AWS credentials (SigV4) or a Google bearer token, found where
  tensorstore finds them (``data/remote_auth.py``), unsigned where there
  are none; and ``memory://`` (:class:`_MemoryKV`), which ``create_zarr``
  makes anew at each call and ``open_zarr`` never finds, as each
  tensorstore open of the JAX package gets its own memory kvstore. The
  remote stores go through the standard library's ``http.client``, one
  kept-alive connection a thread. These stores and the JAX package's
  (tensorstore's) read each other bit for bit, and ``create_zarr`` writes
  the objects tensorstore writes for the same arguments (the ``.zarray``
  and the default compressor, Blosc zstd-5 bit shuffle, included);
* any other array (filters, a compressor or Blosc stream that neither
  this module nor tensorstore knows) raises a ``ValueError`` that names
  the store: the JAX package's tensorstore refuses it too.

This module reads or writes (and decodes or encodes) the chunks of
one read or write in parallel on a thread pool (the codec releases the
GIL), and ``Volume.read_async`` / ``write_async`` return futures of a second
pool, as tensorstore's do. It writes a chunk that a region covers whole by
replacing it, and a chunk that it covers in part by read-modify-write
(``update``): in a directory under an exclusive ``fcntl.flock`` of the
chunk's lock file (``.{key}.lock`` beside it); in a bucket by
compare-and-swap, the object written only if its ETag or generation is
still the one read (``If-Match`` / ``ifGenerationMatch``), read again where
another writer came first. Writers of disjoint parts of one chunk, in
threads or processes, lose no update. The reads are thread-safe.
"""

from __future__ import annotations

import dataclasses
import fcntl
import hashlib
import http.client
import json
import math
import os
import random
import shutil
import threading
import time
import urllib.parse
from xml.etree import ElementTree
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from . import codec, remote_auth

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


def _unreadable(path: str, why: str) -> ValueError:
    return ValueError(
        f"zarr store {path!r} ({why}) is not one the port reads (C or F "
        "order, no filters, compressor none or "
        f"{', '.join(codec.COMPRESSOR_IDS)}); tensorstore, which the JAX "
        "package opens it with, cannot read it either: its zarr driver has "
        "the same compressors and refuses filters")


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

    def update(self, key: str, fn: Callable) -> None:
        """Write ``fn(value or None)`` under an exclusive ``fcntl.flock`` of
        the key's lock file, held by threads and processes in turn."""
        path = self._file(key)
        if "/" in key:
            os.makedirs(os.path.dirname(path), exist_ok=True)
        lock = os.path.join(os.path.dirname(path),
                            f".{os.path.basename(path)}.lock")
        fd = os.open(lock, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            self.write(key, fn(self.read(key)))
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

    def update(self, key: str, fn: Callable) -> None:
        with self.lock:
            self.data[key] = fn(self.data.get(key))


class _Remote:
    """Requests to one HTTP(S) host, one kept-alive connection a thread,
    reopened once where the server closed it between requests. A 429 or
    5xx answer is retried ``attempts - 1`` times with a doubling pause.
    An error names the method, the URL and the status, never a request's
    headers or an answer's body."""

    writable = True
    attempts = 4
    backoff_s = 0.05

    def _connect(self, base: str) -> None:
        parts = urllib.parse.urlsplit(base)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"not an http(s) URL: {base!r}")
        self.https = parts.scheme == "https"
        self.host, self.port = parts.hostname, parts.port
        default = 443 if self.https else 80
        self.netloc = self.host if self.port in (None, default) \
            else f"{self.host}:{self.port}"
        self.origin = f"{parts.scheme}://{self.netloc}"
        self.base_path = parts.path.rstrip("/")
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

    def _headers(self, method: str, target: str, body: bytes,
                 headers: Dict[str, str]) -> Dict[str, str]:
        return headers

    def _call(self, method: str, target: str, body: bytes = b"",
              headers: Optional[Dict[str, str]] = None):
        """(status, reason, response headers, body) of one request."""
        body = bytes(body)          # the codec's chunks are numpy buffers
        for attempt in range(self.attempts):
            sent = self._headers(method, target, body, dict(headers or {}))
            for fresh in (False, True):
                conn = self._connection(fresh=fresh)
                try:
                    conn.request(method, target, body=body or None,
                                 headers=sent)
                    resp = conn.getresponse()
                    data = resp.read()
                    break
                except (http.client.RemoteDisconnected, ConnectionResetError,
                        BrokenPipeError):
                    if fresh:
                        raise
                except http.client.IncompleteRead as exc:
                    conn.close()
                    raise OSError(
                        f"{method} {self._url(target)}: body cut short "
                        f"({len(exc.partial)} bytes of "
                        f"{exc.expected + len(exc.partial)})") from None
            transient = resp.status == 429 or resp.status >= 500
            if not transient or attempt == self.attempts - 1:
                return resp.status, resp.reason, resp.headers, data
            time.sleep(self.backoff_s * 2 ** attempt)

    def _url(self, target: str) -> str:
        return self.origin + target.split("?", 1)[0]

    def _fail(self, method: str, target: str, status: int, reason: str):
        return OSError(f"{method} {self._url(target)}: HTTP {status} {reason}")

    def update(self, key: str, fn: Callable) -> None:
        """Write ``fn(value or None)`` by compare-and-swap: read the key
        with its version, write only if the version still holds, and read
        again where another writer came first (HTTP 412). Writers of one
        key in any number of processes lose no update."""
        for attempt in range(_CAS_ATTEMPTS):
            data, version = self.read_versioned(key)
            if self.write_if(key, fn(data), version):
                return
            time.sleep(random.uniform(0, 0.002 * min(attempt + 1, 10)))
        raise OSError(f"{self.url}/{key}: gave up after {_CAS_ATTEMPTS} "
                      "conditional writes that others overtook")

    def read(self, key: str) -> Optional[bytes]:
        return self.read_versioned(key)[0]

    def write(self, key: str, data: bytes) -> None:
        self.write_if(key, data, _ANY)


_CAS_ATTEMPTS = 200
_ANY = object()     # write_if without a condition


class _HttpKV(_Remote):
    """The keys of an array under an HTTP(S) base URL, read-only, as
    tensorstore's http kvstore: ``GET {base}/{key}``, a 404 a missing key,
    any other status or a body shorter than its ``Content-Length`` an
    ``OSError`` naming the URL. No retry."""

    writable = False
    attempts = 1

    def __init__(self, url: str):
        self.url = url
        self._connect(url)

    def read(self, key: str) -> Optional[bytes]:
        target = f"{self.base_path}/{urllib.parse.quote(key)}"
        status, reason, _, body = self._call("GET", target)
        if status == 404:
            return None
        if status != 200:
            raise OSError(f"GET {self.url}/{key}: HTTP {status} {reason}")
        return body

    def write(self, key: str, data: bytes) -> None:
        raise OSError(f"{self.url}: an http(s) store is read-only")

    update = write


def s3_endpoint(bucket: str, region: Optional[str] = None) -> str:
    """The base URL of a bucket's objects, as tensorstore's s3 kvstore
    forms it: ``https://{bucket}.s3.amazonaws.com`` before the bucket's
    region is known (the unsigned ``HEAD`` that asks it),
    ``https://{bucket}.s3.{region}.amazonaws.com`` after; path style,
    ``https://s3.{region}.amazonaws.com/{bucket}``, for a name with a dot,
    which the endpoints' certificates do not cover."""
    if "." in bucket:
        return f"https://s3.{region or 'us-east-1'}.amazonaws.com/{bucket}"
    if region is None:
        return f"https://{bucket}.s3.amazonaws.com"
    return f"https://{bucket}.s3.{region}.amazonaws.com"


_s3_regions: Dict[str, str] = {}
_s3_regions_lock = threading.Lock()


def _s3_region(bucket: str) -> str:
    """The bucket's region from an unsigned ``HEAD`` of its global
    endpoint (``x-amz-bucket-region``, whatever the status), kept per
    endpoint; ``us-east-1`` where the answer has none, as tensorstore,
    unless it is a 429 or 5xx, which raises."""
    url = s3_endpoint(bucket)
    with _s3_regions_lock:
        region = _s3_regions.get(url)
    if region is None:
        try:
            status, headers, _ = remote_auth.request_once("HEAD", url,
                                                          timeout=60)
        except OSError as exc:
            raise OSError(f"HEAD {url}: {type(exc).__name__}: {exc}") \
                from None
        region = headers.get("x-amz-bucket-region")
        if region is None and (status == 429 or status >= 500):
            raise OSError(f"HEAD {url}: HTTP {status} (the bucket's region)")
        region = region or "us-east-1"
        with _s3_regions_lock:
            _s3_regions[url] = region
    return region


def _join(prefix: str, key: str) -> str:
    return f"{prefix}/{key}" if prefix else key


class _S3KV(_Remote):
    """The keys of an array in an S3 bucket, each an object
    ``{prefix}/{key}``, through the REST API as tensorstore's s3 kvstore
    sends it: every request signed with AWS SigV4 (``remote_auth``) where
    credentials are found, unsigned where none are; ``GET`` (a 404 a
    missing key), ``PUT`` (``If-None-Match: *`` or ``If-Match: <ETag>``
    where conditional), ListObjectsV2 and ``DELETE``. The endpoint is
    :func:`s3_endpoint` of the bucket's region, asked at the first
    request."""

    def __init__(self, bucket: str, prefix: str):
        self.bucket, self.prefix = bucket, prefix.strip("/")
        self.url = f"s3://{bucket}/{self.prefix}".rstrip("/")
        self.credentials = remote_auth.aws_credentials()
        self.region: Optional[str] = None
        self.init_lock = threading.Lock()

    def _ready(self) -> None:
        if self.region is not None:         # set last: the rest is there
            return
        with self.init_lock:
            if self.region is None:
                region = _s3_region(self.bucket)
                self._connect(s3_endpoint(self.bucket, region))
                self.region = region

    def _headers(self, method, target, body, headers):
        path, _, query = target.partition("?")
        return remote_auth.s3_headers(
            method, self.netloc, path, query, headers,
            hashlib.sha256(body).hexdigest() if body
            else remote_auth.EMPTY_SHA256, self.credentials, self.region)

    def _target(self, key: str) -> str:
        return (f"{self.base_path}/"
                f"{urllib.parse.quote(_join(self.prefix, key), safe='/~')}")

    def read_versioned(self, key: str):
        """(bytes, ETag), or (None, None) for a missing key."""
        self._ready()
        target = self._target(key)
        status, reason, headers, body = self._call(
            "GET", target, headers={"x-amz-checksum-mode": "ENABLED"})
        if status == 404:
            return None, None
        if status != 200:
            raise self._fail("GET", target, status, reason)
        return body, headers.get("ETag")

    def write_if(self, key: str, data: bytes, version) -> bool:
        """``PUT`` the object; where ``version`` is not ``_ANY``, only if
        it is still that ETag (None: only if there is none). False where
        the condition failed."""
        self._ready()
        target = self._target(key)
        headers = {"content-length": str(len(data)),
                   "content-type": "application/octet-stream"}
        if version is None:
            headers["if-none-match"] = "*"
        elif version is not _ANY:
            headers["if-match"] = version
        status, reason, _, _ = self._call("PUT", target, data, headers)
        if status in (412, 409) and version is not _ANY:
            return False
        if status != 200:
            raise self._fail("PUT", target, status, reason)
        return True

    def list(self):
        """Every key of the store (ListObjectsV2, each page)."""
        self._ready()
        full = f"{self.prefix}/" if self.prefix else ""
        keys, token = [], None
        while True:
            query = {"list-type": "2", "prefix": full}
            if token:
                query["continuation-token"] = token
            target = (f"{self.base_path}/?" + remote_auth.canonical_query(
                urllib.parse.urlencode(query)))
            status, reason, _, body = self._call("GET", target)
            if status != 200:
                raise self._fail("GET", target, status, reason)
            root = ElementTree.fromstring(body)
            found = {el.tag.rsplit("}", 1)[-1]: el for el in root}
            for el in root:
                if el.tag.endswith("Contents"):
                    name = next(c.text for c in el if c.tag.endswith("Key"))
                    keys.append(name[len(self.prefix) + 1:]
                                if self.prefix else name)
            truncated = found.get("IsTruncated")
            token = found.get("NextContinuationToken")
            if truncated is None or truncated.text != "true" or token is None:
                return keys
            token = token.text

    def delete(self, key: str) -> None:
        self._ready()
        target = self._target(key)
        status, reason, _, _ = self._call("DELETE", target)
        if status not in (200, 204, 404):
            raise self._fail("DELETE", target, status, reason)


class _GcsKV(_Remote):
    """The keys of an array in a GCS bucket, each an object
    ``{prefix}/{key}``, through the JSON API as tensorstore's gcs kvstore
    sends it (``TENSORSTORE_GCS_HTTP_URL``, else
    ``https://storage.googleapis.com``), with a bearer token from
    ``remote_auth.gcs_authorization`` where one is found: media ``GET``
    (a 404 a missing key), media upload (``ifGenerationMatch`` where
    conditional, 0 for "none yet"), the object list and ``DELETE``."""

    def __init__(self, bucket: str, prefix: str):
        self.bucket, self.prefix = bucket, prefix.strip("/")
        self.url = f"gs://{bucket}/{self.prefix}".rstrip("/")
        self._connect(os.environ.get("TENSORSTORE_GCS_HTTP_URL")
                      or "https://storage.googleapis.com")
        b = urllib.parse.quote(bucket, safe="")
        self.objects = f"{self.base_path}/storage/v1/b/{b}/o"
        self.upload = f"{self.base_path}/upload/storage/v1/b/{b}/o"

    def _headers(self, method, target, body, headers):
        auth = remote_auth.gcs_authorization()
        if auth is not None:
            headers["Authorization"] = auth
        return headers

    def _name(self, key: str) -> str:
        return urllib.parse.quote(_join(self.prefix, key), safe="")

    def read_versioned(self, key: str):
        """(bytes, generation), or (None, 0) for a missing key."""
        target = f"{self.objects}/{self._name(key)}?alt=media"
        status, reason, headers, body = self._call("GET", target)
        if status == 404:
            return None, 0
        if status != 200:
            raise self._fail("GET", target, status, reason)
        return body, int(headers.get("x-goog-generation") or 0)

    def write_if(self, key: str, data: bytes, version) -> bool:
        """Upload the object; where ``version`` is not ``_ANY``, only if
        its generation is still ``version`` (0 or None: only if there is
        none). False where the condition failed."""
        target = f"{self.upload}?uploadType=media&name={self._name(key)}"
        if version is not _ANY:
            target += f"&ifGenerationMatch={int(version or 0)}"
        status, reason, _, _ = self._call(
            "POST", target, data,
            {"Content-Type": "application/octet-stream"})
        if status == 412 and version is not _ANY:
            return False
        if status != 200:
            raise self._fail("POST", target, status, reason)
        return True

    def list(self):
        """Every key of the store (the object list, each page)."""
        full = f"{self.prefix}/" if self.prefix else ""
        keys, token = [], None
        while True:
            target = (f"{self.objects}?prefix="
                      f"{urllib.parse.quote(full, safe='')}")
            if token:
                target += f"&pageToken={urllib.parse.quote(token, safe='')}"
            status, reason, _, body = self._call("GET", target)
            if status != 200:
                raise self._fail("GET", target, status, reason)
            page = json.loads(body)
            keys += [item["name"][len(self.prefix) + 1:] if self.prefix
                     else item["name"] for item in page.get("items", ())]
            token = page.get("nextPageToken")
            if not token:
                return keys

    def delete(self, key: str) -> None:
        target = f"{self.objects}/{self._name(key)}"
        status, reason, _, _ = self._call("DELETE", target)
        if status not in (200, 204, 404):
            raise self._fail("DELETE", target, status, reason)


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
        return self._decode(name, self.kv.read(name))

    def _decode(self, name: str, data: Optional[bytes]) -> np.ndarray:
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
            name = self._key(key)

            def modify(data):
                chunk = self._decode(name, data)
                if not chunk.flags.writeable:
                    chunk = chunk.copy()
                chunk[in_chunk] = value[in_out]
                return self._encode(chunk)

            self.kv.update(name, modify)

        if not self.kv.writable:
            raise OSError(f"{self.path}: the store is read-only")
        _each(one, list(self._overlaps(ranges)))

    def _replace_chunk(self, key, chunk: np.ndarray) -> None:
        self.kv.write(self._key(key), self._encode(chunk))

    def _encode(self, chunk: np.ndarray) -> bytes:
        return codec.encode_chunk_array(
            self.compressor,
            np.ascontiguousarray(chunk.T if self.fortran else chunk),
            self.dtype.itemsize)


class _ReadyFuture:
    """A finished future, for ``RamVolume``."""

    __slots__ = ("_value",)

    def __init__(self, value=None):
        self._value = value

    def result(self):
        return self._value


@dataclasses.dataclass
class Volume:
    """A zarr array (the JAX package's ``Volume``)."""

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
        return _pool("io").submit(self.store.read, idx)

    def __setitem__(self, idx, value) -> None:
        self.store.write(idx, value)

    def write_async(self, idx, value) -> Future:
        """Begin a write; ``value`` must not change until the future is
        done."""
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


_HTTP = ("http://", "https://")
_BUCKETS = {"s3://": _S3KV, "gs://": _GcsKV}


def _kv(path: str):
    """The key-value store of a path or URL (``memory://`` has none to
    open)."""
    if path.startswith(_HTTP):
        return _HttpKV(path.rstrip("/"))
    for scheme, cls in _BUCKETS.items():
        if path.startswith(scheme):
            bucket, _, prefix = path[len(scheme):].partition("/")
            return cls(bucket, prefix)
    return _FileKV(path)


def _meta(kv) -> Optional[Dict[str, Any]]:
    """The ``.zarray`` of an array in ``kv``, or None."""
    data = kv.read(".zarray")
    return None if data is None else json.loads(data)


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
        raise _unreadable(full, f"order {meta.get('order')}, compressor "
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
    ``.zarray`` is the one tensorstore writes. In an s3 or gs bucket,
    ``delete_existing`` deletes every object under the array's prefix
    first (as tensorstore, which lists them), and the ``.zarray`` is
    written only if there is none yet (``If-None-Match: *`` /
    ``ifGenerationMatch=0``): an existing array raises
    ``FileExistsError``, or opens with ``allow_existing``. An http(s) URL
    is read-only: ``OSError``."""
    dt = np.dtype(dtype)
    metadata = {
        "shape": list(shape),
        "chunks": list(chunks),
        "dtype": _DTYPE_TO_ZARR[dt],
        "compressor": compressor,
        "fill_value": fill_value,
    }
    if path.startswith(_HTTP):
        raise OSError(f"{path}: an http(s) store is read-only")
    if not codec.supported(compressor):
        raise _unreadable(path, f"compressor {compressor}")
    metadata.update(compressor=_normalize_compressor(compressor),
                    fill_value=_fill_value(fill_value, dt), zarr_format=2,
                    order="C", filters=None, dimension_separator=".")
    zarray = json.dumps(metadata, sort_keys=True,
                        separators=(",", ":")).encode()   # tensorstore's bytes
    if path.startswith("memory://"):
        kv = _MemoryKV()
    elif path.startswith(tuple(_BUCKETS)):
        kv = _kv(path)
        if delete_existing:
            keys = kv.list()
            _each(kv.delete, keys)
        elif allow_existing and _meta(kv) is not None:
            return open_zarr(path, writable=True)
        if not kv.write_if(".zarray", zarray, None):
            raise FileExistsError(f"zarr array exists at {path}")
        return Volume(store=_LocalZarr(path, metadata, kv), path=path)
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
    kv.write(".zarray", zarray)
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
