"""Chunk codecs of zarr v2 stores, through the port's own C++ library.

``csrc/zcodec.cpp`` decodes and encodes the chunk formats the JAX package
writes through tensorstore: Blosc 1 frames (zstd, lz4, lz4hc, blosclz,
snappy and zlib streams, byte and bit shuffle) and zstd frames. It links no
codec library. ``g++`` builds it at first use into ``build/zcodec/`` at the
repository root (ignored by git), under a name that carries a hash of the
source and the flags, through a temporary file renamed into place; a failed
build raises ``RuntimeError`` with the compiler's output.

The ``zlib``, ``gzip`` and ``bz2`` compressors go through Python's standard
library. Corrupt data, a chunk of the wrong size, an unknown compressor id
and a codec this module lacks (a zstd dictionary) raise ``ValueError``;
nothing falls back to another codec on its own.

ctypes releases the GIL for the length of a call, so threads decode and
encode chunks in parallel. The numpy versions of the two Blosc shuffles stay
beside the bindings as ``*_plain``, so the tests can hold the C++ against
them bit for bit.
"""

from __future__ import annotations

import bz2
import ctypes
import gzip
import hashlib
import os
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = Path(__file__).resolve().parent / "csrc" / "zcodec.cpp"
BUILD_DIR = _ROOT / "build" / "zcodec"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_ABI_VERSION = 2

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

# Blosc compressor names -> (stream code in the frame header, lz4hc).
BLOSC_CODES = {"blosclz": (0, False), "lz4": (1, False), "lz4hc": (1, True),
               "snappy": (2, False), "zlib": (3, False), "zstd": (4, False)}
COMPRESSOR_IDS = ("blosc", "zstd", "zlib", "gzip", "bz2")
_ERRORS = {-1: "corrupt or truncated data", -2: "data decodes past the chunk",
           -3: "bad magic number", -4: "checksum mismatch",
           -6: "zstd frames with a dictionary are not supported",
           -7: "unsupported format version or codec", -8: "bad arguments",
           -9: "out of memory"}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libzcodec_{tag}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded codec library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        if lib.zc_abi_version() != _ABI_VERSION:
            raise RuntimeError(f"{out}: ABI version {lib.zc_abi_version()}, "
                               f"want {_ABI_VERSION}")
        i64, i32, p = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
        lib.zc_abi_version.argtypes = []
        lib.zc_abi_version.restype = i32
        for name in ("zc_blosc_decode", "zc_zstd_decode", "zc_lz4_decode",
                     "zc_blosclz_decode", "zc_zlib_decode",
                     "zc_snappy_decode", "zc_snappy_encode"):
            getattr(lib, name).argtypes = [p, i64, p, i64]
        lib.zc_blosc_encode.argtypes = [p, i64, p, i64, i32, i32, i32, i32,
                                        i32, i64]
        lib.zc_zstd_encode.argtypes = [p, i64, p, i64, i32, i32]
        lib.zc_zstd_bound.argtypes = [i64]
        lib.zc_snappy_bound.argtypes = [i64]
        lib.zc_shuffle.argtypes = [p, p, i64, i32, i32]
        for name in ("zc_blosc_decode", "zc_zstd_decode", "zc_lz4_decode",
                     "zc_blosclz_decode", "zc_zlib_decode", "zc_blosc_encode",
                     "zc_zstd_encode", "zc_zstd_bound", "zc_shuffle",
                     "zc_snappy_decode", "zc_snappy_encode",
                     "zc_snappy_bound"):
            getattr(lib, name).restype = i64
        _lib = lib
        return lib


def _check(rc: int, what: str) -> int:
    if rc < 0:
        raise ValueError(f"{what}: {_ERRORS.get(rc, f'error {rc}')}")
    return rc


def _flat(arr: np.ndarray) -> np.ndarray:
    """The bytes of a C-contiguous array, as a uint8 view."""
    if not arr.flags.c_contiguous:
        raise ValueError("chunk buffers must be C-contiguous")
    return arr.reshape(-1).view(np.uint8)


def _bytes_of(raw) -> np.ndarray:
    if isinstance(raw, np.ndarray):
        return _flat(raw)
    return np.frombuffer(raw, np.uint8)


# The C calls write into numpy buffers made with np.empty (no zero fill)
# and read from the caller's buffer: no copy of a chunk is made while the
# interpreter lock is held, beside the decode threads' own work.

def _decode_into(fn: str, data, out: np.ndarray, what: str) -> int:
    """Decodes ``data`` into the uint8 array ``out``; returns the bytes."""
    src = _bytes_of(data)
    return _check(getattr(load(), fn)(src.ctypes.data, src.size,
                                      out.ctypes.data, out.size), what)


def _decoded(fn: str, data, cap: int, what: str) -> bytes:
    out = np.empty(max(cap, 1), np.uint8)
    return out[:_decode_into(fn, data, out[:cap], what)].tobytes()


def _encoded(fn: str, raw, cap: int, *args) -> np.ndarray:
    src = _bytes_of(raw)
    out = np.empty(max(cap, 1), np.uint8)
    n = _check(getattr(load(), fn)(src.ctypes.data, src.size,
                                   out.ctypes.data, cap, *args), fn)
    return out[:n]


# ------------------------------------------------------ single formats

def zstd_decompress(data: bytes, nbytes: int) -> bytes:
    """Every frame of ``data`` (at most ``nbytes`` bytes of output)."""
    return _decoded("zc_zstd_decode", data, nbytes, "zstd")


def zstd_compress(raw: bytes, level: int = 1, checksum: bool = False) -> bytes:
    return _zstd_compress(raw, level, checksum).tobytes()


def _zstd_compress(raw, level: int, checksum: bool) -> np.ndarray:
    cap = load().zc_zstd_bound(_bytes_of(raw).size)
    return _encoded("zc_zstd_encode", raw, cap, int(level), int(checksum))


def lz4_decompress(data: bytes, nbytes: int) -> bytes:
    return _decoded("zc_lz4_decode", data, nbytes, "lz4")


def blosclz_decompress(data: bytes, nbytes: int) -> bytes:
    return _decoded("zc_blosclz_decode", data, nbytes, "blosclz")


def snappy_decompress(data: bytes, nbytes: int) -> bytes:
    """A Snappy block (its stated length at most ``nbytes``)."""
    return _decoded("zc_snappy_decode", data, nbytes, "snappy")


def snappy_compress(raw: bytes) -> bytes:
    cap = load().zc_snappy_bound(_bytes_of(raw).size)
    return _encoded("zc_snappy_encode", raw, cap).tobytes()


def zlib_decompress(data: bytes, nbytes: int) -> bytes:
    """The C++ inflate (Blosc's zlib streams); ``decode_chunk`` uses the
    standard library for the ``zlib`` compressor."""
    return _decoded("zc_zlib_decode", data, nbytes, "zlib")


def _blosc_header(data: bytes, nbytes: int) -> None:
    if len(data) < 16:
        raise ValueError("blosc: corrupt or truncated data")
    stored = int.from_bytes(bytes(data[4:8]), "little")
    if stored != nbytes:
        raise ValueError(f"blosc: frame holds {stored} bytes, the chunk "
                         f"{nbytes}")


def blosc_decompress(data: bytes, nbytes: int) -> bytes:
    _blosc_header(data, nbytes)
    return _decoded("zc_blosc_decode", data, nbytes, "blosc")


def blosc_compress(raw: bytes, cname: str = "zstd", clevel: int = 5,
                   shuffle: int = 1, typesize: int = 1,
                   blocksize: int = 0) -> bytes:
    """A Blosc 1 frame. ``shuffle`` -1 is bit shuffle for one-byte types and
    byte shuffle otherwise; blosclz (and ``clevel`` 0) writes the data
    uncompressed in a memcpyed frame."""
    return _blosc_compress(raw, cname, clevel, shuffle, typesize,
                           blocksize).tobytes()


def _blosc_compress(raw, cname, clevel, shuffle, typesize,
                    blocksize) -> np.ndarray:
    if cname not in BLOSC_CODES:
        raise ValueError(f"blosc: cannot write {cname!r} streams")
    code, hc = BLOSC_CODES[cname]
    if shuffle == -1:
        shuffle = 2 if typesize == 1 else 1
    return _encoded("zc_blosc_encode", raw, _bytes_of(raw).size + 16, code,
                    int(hc), int(clevel), int(shuffle), int(typesize),
                    int(blocksize))


# -------------------------------------------------------------- chunks

def _require(compressor: Dict[str, Any]) -> str:
    cid = compressor.get("id")
    if cid not in COMPRESSOR_IDS:
        raise ValueError(f"unsupported zarr compressor {compressor!r}")
    if cid == "blosc":
        cname = compressor.get("cname", "lz4")
        if cname not in BLOSC_CODES:
            raise ValueError(f"unknown blosc compressor name {cname!r}")
    return cid


def supported(compressor: Optional[Dict[str, Any]]) -> bool:
    """Whether ``decode_chunk`` / ``encode_chunk`` take this compressor."""
    if compressor is None:
        return True
    try:
        _require(compressor)
    except ValueError:
        return False
    return True


def decode_chunk_into(compressor: Optional[Dict[str, Any]], data: bytes,
                      out: np.ndarray) -> None:
    """One stored chunk decoded into ``out``, a C-contiguous array of the
    chunk's size (its bytes are the chunk's raw bytes)."""
    flat = _flat(out)
    nbytes = flat.size
    if compressor is None:
        raw = data
    else:
        cid = _require(compressor)
        if cid == "blosc":
            _blosc_header(data, nbytes)
            _decode_into("zc_blosc_decode", data, flat, "blosc")
            return
        if cid == "zstd":
            n = _decode_into("zc_zstd_decode", data, flat, "zstd")
            if n != nbytes:
                raise ValueError(f"chunk decodes to {n} bytes, want {nbytes}")
            return
        lib = {"zlib": zlib, "gzip": gzip, "bz2": bz2}[cid]
        try:
            raw = lib.decompress(data)
        except (OSError, EOFError, zlib.error, ValueError) as exc:
            raise ValueError(f"{cid}: {exc}") from exc
    if len(raw) != nbytes:
        raise ValueError(f"chunk decodes to {len(raw)} bytes, want {nbytes}")
    flat[:] = np.frombuffer(raw, np.uint8)


def decode_chunk(compressor: Optional[Dict[str, Any]], data: bytes,
                 nbytes: int) -> bytes:
    """One stored chunk -> its ``nbytes`` raw bytes."""
    out = np.empty(nbytes, np.uint8)
    decode_chunk_into(compressor, data, out)
    return out.tobytes()


def encode_chunk_array(compressor: Optional[Dict[str, Any]], raw,
                       typesize: int):
    """One chunk's raw bytes (bytes or a C-contiguous array) -> what is
    stored, as a bytes-like object (a uint8 array from the C++ codec)."""
    if compressor is None:
        return _bytes_of(raw)
    cid = _require(compressor)
    if cid == "blosc":
        return _blosc_compress(raw, compressor.get("cname", "lz4"),
                               int(compressor.get("clevel", 5)),
                               int(compressor.get("shuffle", -1)), typesize,
                               int(compressor.get("blocksize", 0) or 0))
    level = int(compressor.get("level", 1))
    if cid == "zstd":
        return _zstd_compress(raw, level,
                              bool(compressor.get("checksum", False)))
    buf = _bytes_of(raw)
    if cid == "zlib":
        return zlib.compress(buf, level)
    if cid == "gzip":
        return gzip.compress(buf, compresslevel=level, mtime=0)
    return bz2.compress(buf, compresslevel=level)


def encode_chunk(compressor: Optional[Dict[str, Any]], raw: bytes,
                 typesize: int) -> bytes:
    """One chunk's raw bytes -> what is stored."""
    return bytes(encode_chunk_array(compressor, raw, typesize))


# ------------------------------------------------------------ shuffles

def _shuffle_lib(block: bytes, typesize: int, mode: int) -> bytes:
    block = bytes(block)
    out = ctypes.create_string_buffer(max(len(block), 1))
    _check(load().zc_shuffle(block, out, len(block), int(typesize), mode),
           "shuffle")
    return out.raw[:len(block)]


def shuffle(block: bytes, typesize: int) -> bytes:
    return _shuffle_lib(block, typesize, 0)


def unshuffle(block: bytes, typesize: int) -> bytes:
    return _shuffle_lib(block, typesize, 1)


def bitshuffle(block: bytes, typesize: int) -> bytes:
    return _shuffle_lib(block, typesize, 2)


def bitunshuffle(block: bytes, typesize: int) -> bytes:
    return _shuffle_lib(block, typesize, 3)


def _split(block: bytes, typesize: int, elems: int):
    a = np.frombuffer(bytes(block), np.uint8)
    return a[:elems * typesize], a[elems * typesize:]


def shuffle_plain(block: bytes, typesize: int) -> bytes:
    """Blosc byte shuffle of one block: byte j of every whole element, for
    j = 0 .. typesize-1 in turn; the leftover bytes stay as they are."""
    head, tail = _split(block, typesize, len(block) // typesize)
    return head.reshape(-1, typesize).T.tobytes() + tail.tobytes()


def unshuffle_plain(block: bytes, typesize: int) -> bytes:
    head, tail = _split(block, typesize, len(block) // typesize)
    return head.reshape(typesize, -1).T.tobytes() + tail.tobytes()


def _bit_elems(block: bytes, typesize: int) -> int:
    elems = len(block) // typesize
    return 0 if elems % 8 else elems


def bitshuffle_plain(block: bytes, typesize: int) -> bytes:
    """Blosc bit shuffle of one block: a block of a multiple of 8 whole
    elements becomes typesize * 8 bit planes (byte b, bit k: plane 8b + k;
    element i at bit i % 8 of byte i // 8); any other block is copied as it
    is, whole, as c-blosc 1.x stores a short last block."""
    elems = _bit_elems(block, typesize)
    head, tail = _split(block, typesize, elems)
    planes = np.unpackbits(head.reshape(elems, typesize).T[:, :, None],
                           axis=2, bitorder="little")     # (ts, elems, 8)
    packed = np.packbits(planes.transpose(0, 2, 1), axis=2,
                         bitorder="little")               # (ts, 8, elems/8)
    return packed.tobytes() + tail.tobytes()


def bitunshuffle_plain(block: bytes, typesize: int) -> bytes:
    elems = _bit_elems(block, typesize)
    head, tail = _split(block, typesize, elems)
    planes = np.unpackbits(head.reshape(typesize, 8, elems // 8), axis=2,
                           bitorder="little")             # (ts, 8, elems)
    data = np.packbits(planes.transpose(0, 2, 1), axis=2,
                       bitorder="little")                 # (ts, elems, 1)
    return data[:, :, 0].T.tobytes() + tail.tobytes()
