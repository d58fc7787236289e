"""Fused instance norm + LeakyReLU on (N, *spatial, C), forward and backward.

The counterpart of ``mt3d_resenc_unet_tpu/ops/pallas_norm_act.py``
(``instance_norm_act_pallas`` and its ``custom_vjp``). Four CUDA kernels in
``csrc/norm_act.cu``, each behind a wrapper with a plain PyTorch version of
the same function beside it (the wrapper runs the plain version for CPU
tensors; the tests and ``chip_smoke.py`` hold the kernel against it). A CUDA
tensor always goes to the kernel, or the wrapper raises.

  ``norm_act_stats``      per-(n, c) fp32 [mean; rsqrt(max(E[x^2] - mean^2,
                          0) + eps)], replacing ``_stats_kernel``;
  ``norm_act_norm``       ``(x - mean) * inv`` then LeakyReLU when ``act``,
                          every operation in x's dtype after mean and inv are
                          cast to it, replacing ``_norm_kernel``;
  ``norm_act_bwd_stats``  per-(n, c) fp32 [sum g'; sum g' * xhat], with fp32
                          xhat and g' the cotangent after the LeakyReLU
                          backward, replacing ``_bwd_stats_kernel``;
  ``norm_act_bwd_dx``     ``inv * (g' - mean(g') - xhat * mean(g' xhat))``
                          in x's dtype, replacing ``_bwd_dx_kernel``.

:class:`NormActFn` keeps ``(x, stats)`` as its residuals, as the JAX
``_norm_act_fwd`` does, and runs the two backward kernels. The backward
rebuilds xhat in fp32, so its LeakyReLU mask can differ from the forward's
at 0, as on the TPU. The model does not call this op (the JAX model
normalizes through XLA, and so does the port's fused conv chain): it is the
port of the Pallas op, with the same contract.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

_SOURCE = "norm_act"
_lib_fns = {}
THREADS = 256           # threads per block of every kernel (norm_act.cu)
ROWS_PER_THREAD = 16    # voxels a thread visits per pass, sets the chunking
MAX_CHUNKS = 1024       # bounds the partials and the finalize loop


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(N, *spatial, C) -> (N, S, C)."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


def _leaky(u: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """LeakyReLU with the slope rounded to u's dtype, as JAX multiplies a
    bf16 array by a weakly typed Python float."""
    slope = torch.tensor(negative_slope, dtype=u.dtype, device=u.device)
    return torch.where(u >= 0, u, u * slope)


# ------------------------------------------------------------ plain versions

def norm_act_stats_plain(x2: torch.Tensor, eps: float) -> torch.Tensor:
    """(N, S, C) -> (N, 2, C) fp32 [mean; inv]."""
    xf = x2.float()
    inv_n = 1.0 / x2.shape[1]
    mean = xf.sum(dim=1) * inv_n
    var = (xf * xf).sum(dim=1) * inv_n - mean * mean
    return torch.stack([mean, torch.rsqrt(torch.clamp(var, min=0.0) + eps)], 1)


def norm_act_norm_plain(x2: torch.Tensor, stats: torch.Tensor,
                        negative_slope: float, act: bool) -> torch.Tensor:
    """(x - mean) * inv [then LeakyReLU], in x's dtype."""
    mean = stats[:, None, 0, :].to(x2.dtype)
    inv = stats[:, None, 1, :].to(x2.dtype)
    y = (x2 - mean) * inv
    return _leaky(y, negative_slope) if act else y


def _grad_in(x2, stats, g2, negative_slope, act):
    xhat = (x2.float() - stats[:, None, 0, :]) * stats[:, None, 1, :]
    g = g2.float()
    if act:
        g = torch.where(xhat >= 0, g, g * negative_slope)
    return xhat, g


def norm_act_bwd_stats_plain(x2: torch.Tensor, stats: torch.Tensor,
                             g2: torch.Tensor, negative_slope: float,
                             act: bool) -> torch.Tensor:
    """(N, 2, C) fp32 [sum g'; sum g' * xhat]."""
    xhat, g = _grad_in(x2, stats, g2, negative_slope, act)
    return torch.stack([g.sum(dim=1), (g * xhat).sum(dim=1)], 1)


def norm_act_bwd_dx_plain(x2: torch.Tensor, stats: torch.Tensor,
                          gsums: torch.Tensor, g2: torch.Tensor,
                          negative_slope: float, act: bool) -> torch.Tensor:
    """dx in x's dtype."""
    xhat, g = _grad_in(x2, stats, g2, negative_slope, act)
    inv_n = 1.0 / x2.shape[1]
    mg = gsums[:, None, 0, :] * inv_n
    mgx = gsums[:, None, 1, :] * inv_n
    return (stats[:, None, 1, :] * (g - mg - xhat * mgx)).to(x2.dtype)


# ----------------------------------------------------------------- kernels

def _fn(name: str):
    """The C launcher ``<name>_launch`` of csrc/norm_act.cu, typed."""
    fn = _lib_fns.get(name)
    if fn is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        fn = getattr(_build.load(_SOURCE), f"{name}_launch")
        fn.argtypes = {
            "norm_act_stats": [p, p, p, i, ll, i, i, f, i, p],
            "norm_act_norm": [p, p, p, i, ll, i, i, f, i, i, p],
            "norm_act_bwd_stats": [p, p, p, p, p, i, ll, i, i, f, i, i, p],
            "norm_act_bwd_dx": [p, p, p, p, p, i, ll, i, i, f, i, i, p],
        }[name]
        fn.restype = i
        _lib_fns[name] = fn
    return fn


def _geometry(fn: str, x2: torch.Tensor, *others: torch.Tensor):
    """Checks what the kernels take; returns (N, S, C, nchunk, is_bf16)."""
    if x2.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x2.device}")
    if x2.dim() != 3 or x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{fn}: needs x (N, S, C) in bf16 or fp32; got "
                         f"{tuple(x2.shape)} {x2.dtype}")
    n, s, c = x2.shape
    vec = 8 if x2.dtype == torch.bfloat16 else 4
    if c % vec or c // vec > THREADS or s < 1:
        raise ValueError(f"{fn}: unsupported channels {c} for {x2.dtype}")
    for t in (x2,) + others:
        if t.device != x2.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: tensors must be contiguous, 16-byte "
                             f"aligned and on {x2.device}")
    rows = THREADS // (c // vec)
    nchunk = max(1, min(MAX_CHUNKS, math.ceil(s / (rows * ROWS_PER_THREAD))))
    return n, s, c, nchunk, int(x2.dtype == torch.bfloat16)


def _check_stats(fn: str, t: torch.Tensor, n: int, c: int) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (n, 2, c):
        raise ValueError(f"{fn}: needs (N, 2, C) fp32 vectors; got "
                         f"{tuple(t.shape)} {t.dtype}")


def _launch(fn: str, *args) -> None:
    rc = _fn(fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed, CUDA error {rc}")
    _build.LAUNCHES[fn] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def norm_act_stats(x2: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (N, S, C) -> (N, 2, C) fp32 [mean; inv]."""
    if x2.device.type == "cpu":
        return norm_act_stats_plain(x2, eps)
    fn = "norm_act_stats"
    _build.check_no_grad(fn, x2)
    n, s, c, nchunk, bf16 = _geometry(fn, x2)
    part = torch.empty((n, nchunk, 2, c), dtype=torch.float32,
                       device=x2.device)
    stats = torch.empty((n, 2, c), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        _launch(fn, x2.data_ptr(), part.data_ptr(), stats.data_ptr(), n, s,
                c, nchunk, eps, bf16, _stream(x2))
    return stats


def norm_act_norm(x2: torch.Tensor, stats: torch.Tensor,
                  negative_slope: float = 1e-2,
                  act: bool = True) -> torch.Tensor:
    """y = (x - mean) * inv [then LeakyReLU], (N, S, C) in x's dtype."""
    if x2.device.type == "cpu":
        return norm_act_norm_plain(x2, stats, negative_slope, act)
    fn = "norm_act_norm"
    _build.check_no_grad(fn, x2)
    n, s, c, nchunk, bf16 = _geometry(fn, x2, stats)
    _check_stats(fn, stats, n, c)
    y = torch.empty_like(x2)
    with torch.cuda.device(x2.device):
        _launch(fn, x2.data_ptr(), stats.data_ptr(), y.data_ptr(), n, s, c,
                nchunk, negative_slope, int(act), bf16, _stream(x2))
    return y


def norm_act_bwd_stats(x2: torch.Tensor, stats: torch.Tensor,
                       g2: torch.Tensor, negative_slope: float = 1e-2,
                       act: bool = True) -> torch.Tensor:
    """(N, 2, C) fp32 [sum g'; sum g' * xhat]; g in x's dtype."""
    if x2.device.type == "cpu":
        return norm_act_bwd_stats_plain(x2, stats, g2, negative_slope, act)
    fn = "norm_act_bwd_stats"
    _build.check_no_grad(fn, x2, g2)
    n, s, c, nchunk, bf16 = _geometry(fn, x2, stats, g2)
    _check_stats(fn, stats, n, c)
    if g2.shape != x2.shape or g2.dtype != x2.dtype:
        raise ValueError(f"{fn}: g must match x's shape and dtype")
    part = torch.empty((n, nchunk, 2, c), dtype=torch.float32,
                       device=x2.device)
    gsums = torch.empty((n, 2, c), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        _launch(fn, x2.data_ptr(), stats.data_ptr(), g2.data_ptr(),
                part.data_ptr(), gsums.data_ptr(), n, s, c, nchunk,
                negative_slope, int(act), bf16, _stream(x2))
    return gsums


def norm_act_bwd_dx(x2: torch.Tensor, stats: torch.Tensor,
                    gsums: torch.Tensor, g2: torch.Tensor,
                    negative_slope: float = 1e-2,
                    act: bool = True) -> torch.Tensor:
    """dx (N, S, C) in x's dtype."""
    if x2.device.type == "cpu":
        return norm_act_bwd_dx_plain(x2, stats, gsums, g2, negative_slope,
                                     act)
    fn = "norm_act_bwd_dx"
    _build.check_no_grad(fn, x2, g2)
    n, s, c, nchunk, bf16 = _geometry(fn, x2, stats, gsums, g2)
    _check_stats(fn, stats, n, c)
    _check_stats(fn, gsums, n, c)
    if g2.shape != x2.shape or g2.dtype != x2.dtype:
        raise ValueError(f"{fn}: g must match x's shape and dtype")
    dx = torch.empty_like(x2)
    with torch.cuda.device(x2.device):
        _launch(fn, x2.data_ptr(), stats.data_ptr(), gsums.data_ptr(),
                g2.data_ptr(), dx.data_ptr(), n, s, c, nchunk,
                negative_slope, int(act), bf16, _stream(x2))
    return dx


# ---------------------------------------------------------------- the op

class NormActFn(torch.autograd.Function):
    """``y = norm(x) [then LeakyReLU]`` on (N, S, C), the JAX
    ``_norm_act_2d`` ``custom_vjp``: residuals ``(x, stats)``, backward
    through the two backward kernels (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x2, eps, negative_slope, act):
        x2 = x2.contiguous()
        stats = norm_act_stats(x2, eps)
        y = norm_act_norm(x2, stats, negative_slope, act)
        ctx.save_for_backward(x2, stats)
        ctx.negative_slope, ctx.act = negative_slope, act
        return y

    @staticmethod
    def backward(ctx, gy):
        x2, stats = ctx.saved_tensors
        g2 = gy.to(x2.dtype).contiguous()
        gsums = norm_act_bwd_stats(x2, stats, g2, ctx.negative_slope, ctx.act)
        dx = norm_act_bwd_dx(x2, stats, gsums, g2, ctx.negative_slope,
                             ctx.act)
        return dx, None, None, None


def instance_norm_act_fused(x: torch.Tensor,
                            scale: Optional[torch.Tensor] = None,
                            bias: Optional[torch.Tensor] = None, *,
                            eps: float = 1e-5, negative_slope: float = 1e-2,
                            act: bool = True) -> torch.Tensor:
    """Instance norm (+ LeakyReLU) on (N, *spatial, C), the port of
    ``instance_norm_act_pallas``: the activation is fused into the kernel
    only without an affine; the (C,) scale and bias, and then the
    activation, are plain ops after it (pallas_norm_act.py:236-250)."""
    fuse_act = act and scale is None and bias is None
    y = NormActFn.apply(_flat(x), eps, negative_slope, fuse_act)
    y = y.reshape(x.shape)
    if scale is not None:
        y = y * scale.to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    if act and not fuse_act:
        y = _leaky(y, negative_slope)
    return y
