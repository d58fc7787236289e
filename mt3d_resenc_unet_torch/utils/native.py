"""ctypes bindings for the native host-ops library (``native/hostops.cpp``).

The port of ``mt3d_resenc_unet_tpu/utils/native.py``: multithreaded C++
loops for the inference engine's host side (patch scatter-add into a RAM
slab, overlap averaging, normals renormalization, quantization). Two
differences:

* ``g++`` builds the library at first use into ``build/hostops/`` at the
  repository root (ignored by git), under a name that carries a hash of
  the source and the flags, so an edited source is rebuilt and a built one
  reused. ``native/libhostops.so`` belongs to the JAX package's loader and
  is never written here;
* a library that cannot be built or loaded raises ``RuntimeError`` with the
  compiler's output, and an array of the wrong dtype, layout or shape
  raises ``ValueError``: no wrapper falls back to numpy on its own. The
  numpy versions stay beside the wrappers as ``*_plain``, with the C++
  arithmetic (a reciprocal, then a product), so the tests can hold the two
  bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "hostops.cpp"
BUILD_DIR = _ROOT / "build" / "hostops"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_ABI_VERSION = 1

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _target() -> Path:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libhostops_{tag}.so"


def _build(out: Path) -> None:
    """Compile ``_SRC`` into ``out`` through a temporary file renamed into
    place, so that concurrent builders never load a half-written library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC}:\n{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded host-ops library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = _target()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        if lib.hostops_abi_version() != _ABI_VERSION:
            raise RuntimeError(f"{out}: ABI version "
                               f"{lib.hostops_abi_version()}, want "
                               f"{_ABI_VERSION}")
        i64 = ctypes.c_int64
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.accumulate_patch.argtypes = [f32p, f32p, f32p, f32p] + [i64] * 10
        lib.finalize_average.argtypes = [f32p, f32p, i64, i64]
        lib.renormalize_vectors.argtypes = [f32p, f32p, i64]
        lib.quantize_u8.argtypes = [f32p, ctypes.POINTER(ctypes.c_uint8), i64]
        lib.encode_normals_u16.argtypes = [f32p,
                                           ctypes.POINTER(ctypes.c_uint16), i64]
        for fn in (lib.accumulate_patch, lib.finalize_average,
                   lib.renormalize_vectors, lib.quantize_u8,
                   lib.encode_normals_u16):
            fn.restype = None
        _lib = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check_f32(**arrays: np.ndarray) -> None:
    for name, a in arrays.items():
        if a.dtype != np.float32 or not a.flags.c_contiguous:
            raise ValueError(f"{name}: want a C-contiguous float32 array, "
                             f"got {a.dtype} (contiguous: "
                             f"{a.flags.c_contiguous})")


def accumulate_patch(sum_arr: np.ndarray, cnt_arr: np.ndarray,
                     pred: np.ndarray, wmap: np.ndarray,
                     z0: int, y0: int, x0: int) -> None:
    """sum (C,SZ,SY,SX) += pred (C,PZ,PY,PX) at offset; cnt += wmap."""
    _check_f32(sum_arr=sum_arr, cnt_arr=cnt_arr, pred=pred, wmap=wmap)
    c, sz, sy, sx = sum_arr.shape
    pz, py, px = pred.shape[1:]
    if (pred.shape[0] != c or cnt_arr.shape != (sz, sy, sx)
            or wmap.shape != (pz, py, px)
            or not (0 <= z0 and z0 + pz <= sz and 0 <= y0 and y0 + py <= sy
                    and 0 <= x0 and x0 + px <= sx)):
        raise ValueError(f"patch {pred.shape} at {(z0, y0, x0)} does not fit "
                         f"the slab {sum_arr.shape} / {cnt_arr.shape} with "
                         f"map {wmap.shape}")
    load().accumulate_patch(
        _ptr(sum_arr, ctypes.c_float), _ptr(cnt_arr, ctypes.c_float),
        _ptr(pred, ctypes.c_float), _ptr(wmap, ctypes.c_float),
        c, sz, sy, sx, pz, py, px, z0, y0, x0)


def finalize_average(sum_block: np.ndarray, cnt_block: np.ndarray) -> None:
    """In place: sum[c][cnt>0] *= 1/cnt. sum_block (C, *spatial)."""
    _check_f32(sum_block=sum_block, cnt_block=cnt_block)
    if sum_block.shape[1:] != cnt_block.shape:
        raise ValueError(f"sums {sum_block.shape} against counts "
                         f"{cnt_block.shape}")
    load().finalize_average(_ptr(sum_block, ctypes.c_float),
                            _ptr(cnt_block, ctypes.c_float),
                            sum_block.shape[0], cnt_block.size)


def renormalize_vectors(sum_block: np.ndarray, cnt_block: np.ndarray) -> None:
    """In place unit-renormalization of (3, *spatial) where cnt > 0."""
    _check_f32(sum_block=sum_block, cnt_block=cnt_block)
    if sum_block.shape != (3,) + cnt_block.shape:
        raise ValueError(f"vectors {sum_block.shape} against counts "
                         f"{cnt_block.shape}")
    load().renormalize_vectors(_ptr(sum_block, ctypes.c_float),
                               _ptr(cnt_block, ctypes.c_float),
                               cnt_block.size)


def quantize_u8(block: np.ndarray) -> np.ndarray:
    """[0, 1] floats -> uint8: clip(v * 255, 0, 255), truncated."""
    _check_f32(block=block)
    out = np.empty(block.shape, np.uint8)
    load().quantize_u8(_ptr(block, ctypes.c_float),
                       _ptr(out, ctypes.c_uint8), block.size)
    return out


def encode_normals_u16(block: np.ndarray) -> np.ndarray:
    """[-1, 1] floats -> uint16: clip((v + 1) * 32767.5, 0, 65535),
    truncated."""
    _check_f32(block=block)
    out = np.empty(block.shape, np.uint16)
    load().encode_normals_u16(_ptr(block, ctypes.c_float),
                              _ptr(out, ctypes.c_uint16), block.size)
    return out


# ---------------------------------------------------------- numpy versions

def accumulate_patch_plain(sum_arr, cnt_arr, pred, wmap, z0, y0, x0) -> None:
    pz, py, px = pred.shape[1:]
    sum_arr[:, z0:z0 + pz, y0:y0 + py, x0:x0 + px] += pred
    cnt_arr[z0:z0 + pz, y0:y0 + py, x0:x0 + px] += wmap


def finalize_average_plain(sum_block, cnt_block) -> None:
    mask = cnt_block > 0
    inv = np.float32(1.0) / cnt_block[mask]
    for ch in range(sum_block.shape[0]):
        sum_block[ch][mask] *= inv


def renormalize_vectors_plain(sum_block, cnt_block) -> None:
    mask = cnt_block > 0
    x, y, z = (sum_block[ch][mask] for ch in range(3))
    mag = np.maximum(np.sqrt(x * x + y * y + z * z), np.float32(1e-30))
    inv = np.float32(1.0) / mag
    for ch, v in enumerate((x, y, z)):
        sum_block[ch][mask] = v * inv


def quantize_u8_plain(block) -> np.ndarray:
    return np.clip(block * np.float32(255.0), 0, 255).astype(np.uint8)


def encode_normals_u16_plain(block) -> np.ndarray:
    q = (block + np.float32(1.0)) * np.float32(32767.5)
    return np.clip(q, 0, 65535).astype(np.uint16)
