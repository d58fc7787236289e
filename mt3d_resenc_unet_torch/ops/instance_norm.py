"""Instance norm for NDHWC volumes, split the way the fused conv pipeline
needs it: a conv emits its output's fp32 [sum; sumsq] (ops/conv3d.py),
``stats_to_scale_shift`` turns them into per-(sample, channel) vectors, and
the next conv applies them as its pre-op or ``norm_apply`` does in one
elementwise tail pass.

These are XLA, not Pallas, in the JAX package
(mt3d_resenc_unet_tpu/ops/instance_norm.py:89-145), so they are plain
PyTorch elementwise ops here, computed in fp32 and stored in the input's
dtype. No layout packing: every tensor is plain (N, D, H, W, C).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Vectors = Tuple[torch.Tensor, torch.Tensor]


def instance_stats(x: torch.Tensor) -> torch.Tensor:
    """(N, *spatial, C) -> (N, 2, C) fp32 [sum; sumsq] over all voxels:
    the statistics the conv kernels emit, for producers that do not."""
    xf = x.float().flatten(1, -2)
    return torch.stack([xf.sum(dim=1), (xf * xf).sum(dim=1)], dim=1)


def stats_to_scale_shift(stats: torch.Tensor, count: int, eps: float,
                         scale: Optional[torch.Tensor] = None,
                         bias: Optional[torch.Tensor] = None) -> Vectors:
    """(N, 2, C) fp32 [sum; sumsq] -> (inv, mean * inv), each (N, C) fp32,
    so that ``x * inv - shift`` is the instance-normalized tensor; an
    affine ``scale`` / ``bias`` (C,) folds in as ``inv * scale`` and
    ``shift - bias`` (JAX ``stats_to_scale_shift``)."""
    mean = stats[:, 0] / count
    var = torch.clamp(stats[:, 1] / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    if scale is not None:
        inv = inv * scale.float()
    shift = mean * inv
    if bias is not None:
        shift = shift - bias.float()
    return inv, shift


def pre_vector(vectors: Vectors) -> torch.Tensor:
    """(inv, shift) -> the (N, 2, C) fp32 ``pre`` operand of the conv."""
    return torch.stack(vectors, dim=1).float().contiguous()


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.float().reshape(v.shape[0], *([1] * (ndim - 2)), v.shape[-1])


def _leaky(u: torch.Tensor, negative_slope: float) -> torch.Tensor:
    return torch.where(u >= 0, u, u * negative_slope)


def norm_apply(y: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor,
               negative_slope: float, act: bool = True,
               residual: Optional[torch.Tensor] = None,
               residual_pre: Optional[Vectors] = None) -> torch.Tensor:
    """``leaky((y * inv - shift) [+ residual])``, elementwise, with
    precomputed per-(sample, channel) vectors (N, C).

    ``residual_pre``: (scale, shift) applied to the residual first,
    ``residual = leaky(residual * scale - shift)``: the stem handoff, where
    the block input is the raw stem conv output and the true residual is its
    normalized form (JAX ``norm_apply_packed``)."""
    nd = y.dim()
    u = y.float() * _bcast(inv, nd) - _bcast(shift, nd)
    if residual is not None:
        r = residual.float()
        if residual_pre is not None:
            r = _leaky(r * _bcast(residual_pre[0], nd)
                       - _bcast(residual_pre[1], nd), negative_slope)
        u = u + r
    if act:
        u = _leaky(u, negative_slope)
    return u.to(y.dtype)


def instance_norm_act(x: torch.Tensor, eps: float = 1e-5,
                      negative_slope: float = 1e-2, act: bool = True,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Plain instance norm (+ residual) (+ LeakyReLU) of an unfused
    producer's output."""
    count = x[0, ..., 0].numel()
    inv, shift = stats_to_scale_shift(instance_stats(x), count, eps)
    return norm_apply(x, inv, shift, negative_slope, act, residual)
