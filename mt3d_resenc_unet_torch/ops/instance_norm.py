"""Instance norm for NDHWC volumes, split the way the fused conv pipeline
needs it: a conv emits its output's fp32 [sum; sumsq] (ops/conv3d.py),
``stats_to_scale_shift`` turns them into per-(sample, channel) vectors, and
the next conv applies them as its pre-op or ``norm_apply`` does in one
elementwise tail pass.

These are XLA, not Pallas, in the JAX package
(mt3d_resenc_unet_tpu/ops/instance_norm.py:89-145). No layout packing:
every tensor is plain (N, D, H, W, C). With ``use_kernels`` (a kernel
model's blocks pass theirs) ``norm_apply`` and ``instance_stats`` send the
shapes of ``norm_act.kernel_class`` to the norm-act kernels' tail and
raw-statistics modes (``norm_act.NormTailFn``, ``RawStatsFn``): every
residual block's tail, the skip projections' norms, the decoder stages'
last norm, the stem handoff where a stage applies it, and the statistics
of the producers whose conv does not emit them (the stem, the plain-class
convs, the 1x1 projections, a conv with a bias, dropout). Otherwise they
are plain PyTorch elementwise ops, computed in fp32 and stored in the
input's dtype: the fp32 reference model launches no norm kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import norm_act

Vectors = Tuple[torch.Tensor, torch.Tensor]


def instance_stats(x: torch.Tensor, use_kernels: bool = False
                   ) -> torch.Tensor:
    """(N, *spatial, C) -> (N, 2, C) fp32 [sum; sumsq] over all voxels:
    the statistics the conv kernels emit, for producers that do not; with
    ``use_kernels`` and a shape of the kernels' class, the stats kernel's
    raw mode (``norm_act.RawStatsFn``)."""
    if use_kernels and norm_act.kernel_class(x):
        return norm_act.RawStatsFn.apply(x)
    return norm_act.raw_stats_plain(x)


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


def norm_apply(y: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor,
               negative_slope: float, act: bool = True,
               residual: Optional[torch.Tensor] = None,
               residual_pre: Optional[Vectors] = None,
               use_kernels: bool = False) -> torch.Tensor:
    """``leaky((y * inv - shift) [+ residual])``, elementwise, with
    precomputed per-(sample, channel) vectors (N, C), in fp32, rounded once
    to y's dtype.

    ``residual_pre``: (scale, shift) applied to the residual first,
    ``residual = leaky(residual * scale - shift)``: the stem handoff, where
    the block input is the raw stem conv output and the true residual is its
    normalized form (JAX ``norm_apply_packed``). ``use_kernels``: a shape of
    the kernels' class goes to ``norm_act.NormTailFn`` (the norm kernel's
    tail mode forward, the bwd-stats kernel's backward)."""
    a, b = residual_pre if residual_pre is not None else (None, None)
    if use_kernels and norm_act.kernel_class(y, residual):
        return norm_act.NormTailFn.apply(y, inv, shift, residual, a, b,
                                         negative_slope, act)
    return norm_act.norm_tail_plain(y, inv, shift, negative_slope, act,
                                    residual, a, b)


def instance_norm_act(x: torch.Tensor, eps: float = 1e-5,
                      negative_slope: float = 1e-2, act: bool = True,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Plain instance norm (+ residual) (+ LeakyReLU) of an unfused
    producer's output."""
    count = x[0, ..., 0].numel()
    inv, shift = stats_to_scale_shift(instance_stats(x), count, eps)
    return norm_apply(x, inv, shift, negative_slope, act, residual)
