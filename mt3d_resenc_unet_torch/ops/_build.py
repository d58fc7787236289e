"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
alone into its own shared library under ``build/torch_kernels/`` at the
repository root (listed in ``.gitignore``); no PyTorch header is compiled,
which keeps a build to seconds. A library's file name carries a hash of its
source and flags, so an edited source is rebuilt and a built one is reused.
``build_all`` starts one ``nvcc`` per source at once.

Every wrapper counts its kernel launches in :data:`LAUNCHES`, so a caller
can show that a run went through the kernels, and calls
:func:`check_no_grad` first: a kernel writes through raw pointers and
records nothing for autograd, so a tensor that needs a gradient reaches it
only through the autograd Functions of ``conv3d.py``, ``upsample.py`` and
``norm_act.py``.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("conv3d_k3_s1", "conv3d_k3_s2", "conv3d_k3_dx_s1",
           "conv3d_k3_dx_s2", "conv3d_k3_dw_s1", "conv3d_k3_dw_s2",
           "upsample2x", "upsample2x_bwd", "norm_act")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

# kernel name -> launches since the last clear(); wrappers add one per launch
LAUNCHES: Dict[str, int] = collections.Counter()
# (kernel name, shape, mode) -> launches since the last clear(), beside
# LAUNCHES, so a run can say which shapes and fusion modes a step launched
LAUNCH_SHAPES: Dict[tuple, int] = collections.Counter()


def mode_name(**modes: bool) -> str:
    """The names of the fusion ``modes`` that are on, joined by "_", or
    "plain": the mode :func:`count` records."""
    return "_".join(m for m, on in modes.items() if on) or "plain"


def count(name: str, shape, **modes: bool) -> None:
    """Count one launch of kernel ``name`` at ``shape`` in ``modes``."""
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[(name, tuple(shape), mode_name(**modes))] += 1


def clear_counts() -> None:
    LAUNCHES.clear()
    LAUNCH_SHAPES.clear()


_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def check_no_grad(name: str, *tensors) -> None:
    """Raise if grad mode is on and a tensor needs a gradient: the kernel's
    output would carry no ``grad_fn`` and the gradient would be lost without
    an error. Inside an autograd Function's forward and backward grad mode
    is off, so the Functions pass."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: a kernel records no gradient; call it through its "
            "autograd Function (or under torch.no_grad()) when an input "
            "requires grad")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: the kernels need nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{tag}.so"


def _start(name: str, nvcc: str):
    """Start nvcc for one source into a temporary file; None if built."""
    out = _target(name)
    if out.exists():
        return None
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Compile every source not built yet, all at once; returns the
    compiler's output (register and spill counts) per newly built source."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with _lock:
        jobs = {name: _start(name, nvcc) for name in SOURCES}
        return {name: _finish(name, job)
                for name, job in jobs.items() if job is not None}


def build_log(name: str) -> str:
    """The ``nvcc -Xptxas -v`` output kept beside ``name``'s library."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lock:
        job = _start(name, _nvcc())
        if job is not None:
            _finish(name, job)
        lib = _libs.setdefault(name, ctypes.CDLL(str(_target(name))))
    return lib
