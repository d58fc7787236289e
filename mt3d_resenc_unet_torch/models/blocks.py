"""Building blocks of the ResEnc U-Net in PyTorch, channels-last.

The port of ``mt3d_resenc_unet_tpu/models/blocks.py`` for inference and
training (the forward is the same in both; there is no dropout, DropPath or
remat in the port, see ``network.check_plan``). Every
tensor is plain NDHWC: the JAX package's x-packing, banded weights and the
branching that picks a packing for the TPU have no counterpart here. What
is kept is its fused pipeline, so the numerics follow the same order:

* every 3x3x3 conv emits its output's fp32 [sum; sumsq] (the instance-norm
  statistics) with the output;
* the next conv applies that norm + LeakyReLU to its input as a pre-op;
* the decoder's skip concat is a split-weight pair whose second conv adds
  the first one's output and takes the statistics of the sum;
* one elementwise tail pass applies the last norm, the residual and the
  LeakyReLU (ops/instance_norm.py ``norm_apply``).

The JAX package runs this pipeline only where its Pallas kernels take the
shape and the unfused conv -> norm -> act order elsewhere; both compute the
same function. Here every block runs the pipeline, and :class:`Conv` sends
the shapes of the JAX package's kernel classes to the CUDA conv through
its autograd Functions (ops/conv3d.py ``Conv3dK3Fn``, ``Conv3dK3PairFn``,
whose backward runs the dx and dW kernels) and the rest (the stem, the
128-channel stage, the deep stride-2 convs, the 1x1 projections) to plain
PyTorch, differentiated by autograd, as the JAX package sends them to XLA.

Parameter names and layouts are the flax ones (``conv1.conv.kernel`` of
shape (kd, kh, kw, ci, co)), so a JAX parameter tree loads by flattening
(tools/from_jax.py). Semantics match the reference blocks
(simple_conv_blocks.py, resblocks.py):
  ConvNormAct  = Conv(same-pad) -> InstanceNorm -> [LeakyReLU]
  BasicBlockD  = conv1(stride) -> conv2, skip = AvgPool(stride) + 1x1
                 Conv + Norm when the shape changes, post-add LeakyReLU.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.conv3d import (Conv3dK3Fn, Conv3dK3PairFn, conv3d_k3_plain,
                          conv_s1_supported, conv_s2_supported)
from ..ops.instance_norm import (Vectors, instance_stats, norm_apply,
                                 pre_vector, stats_to_scale_shift)

Conv3 = Tuple[int, int, int]


def torch_uniform_(param: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """torch's Conv default init, ``kaiming_uniform_(a=sqrt(5))``:
    U(-b, b) with b = 1/sqrt(fan_in) (JAX blocks.py torch_conv_kernel_init;
    the reference never overrides torch's init)."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        param.uniform_(-bound, bound, generator=generator)


def voxel_count(y: torch.Tensor) -> int:
    """Voxels per (sample, channel) of an (N, D, H, W, C) tensor."""
    return y.shape[1] * y.shape[2] * y.shape[3]


def avg_pool(x: torch.Tensor, p: Sequence[int]) -> torch.Tensor:
    """VALID average pooling with window == stride ``p``, in fp32."""
    n, d, h, w, c = x.shape
    d2, h2, w2 = d // p[0], h // p[1], w // p[2]
    xf = x[:, :d2 * p[0], :h2 * p[1], :w2 * p[2]].float()
    return xf.reshape(n, d2, p[0], h2, p[1], w2, p[2], c).mean(dim=(2, 4, 6))


def pointwise(xf: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """1x1x1 conv as a channel matmul in fp32; k is (1, 1, 1, ci, co)."""
    ci, co = k.shape[-2:]
    return (xf.reshape(-1, ci) @ k.float().reshape(ci, co)).reshape(
        *xf.shape[:-1], co)


class Conv(nn.Module):
    """Bias-free same-pad conv with the flax kernel layout (*k, ci, co).

    ``forward`` returns ``(y, stats)``: the raw conv output in the input's
    dtype and its fp32 (N, 2, co) [sum; sumsq]. 3x3x3 convs in the kernel
    shape classes go to the CUDA conv through its autograd Functions when
    ``use_kernels``; everything else runs the same math in plain PyTorch.
    ``pre_pool``: AvgPool(pre_pool) before a 1x1 conv (the ResNet-D skip
    projection, JAX ``_pool_proj``)."""

    def __init__(self, ci: int, co: int, kernel: Conv3, stride: Conv3,
                 use_kernels: bool = False, pre_pool: Tuple[int, ...] = (),
                 negative_slope: float = 1e-2):
        super().__init__()
        self.kernel_size = tuple(kernel)
        self.stride = tuple(stride)
        self.use_kernels = use_kernels
        self.pre_pool = tuple(pre_pool)
        self.negative_slope = negative_slope
        self.kernel = nn.Parameter(torch.empty(*kernel, ci, co))

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = math.prod(self.kernel.shape[:-1])
        torch_uniform_(self.kernel, fan_in, generator)

    def _kernel_class(self, x: torch.Tensor, w: torch.Tensor) -> bool:
        if not self.use_kernels:
            return False
        if self.stride == (1, 1, 1):
            return conv_s1_supported(x.shape, w.shape)
        return self.stride == (2, 2, 2) and conv_s2_supported(x.shape,
                                                              w.shape)

    def forward(self, x: torch.Tensor, x2: Optional[torch.Tensor] = None,
                pre: Optional[Vectors] = None):
        w = self.kernel.to(x.dtype)
        if self.kernel_size == (1, 1, 1):
            xf = avg_pool(x, self.pre_pool) if self.pre_pool else x.float()
            yf = pointwise(xf, w)
            return yf.to(x.dtype), instance_stats(yf)
        stride = self.stride[0]
        slope = self.negative_slope
        if x2 is None:
            pv = pre_vector(pre) if pre is not None else None
            if self._kernel_class(x, w):
                return Conv3dK3Fn.apply(x, w.contiguous(), pv, stride, slope)
            return conv3d_k3_plain(x, w, stride, pre=pv, emit_stats=True,
                                   negative_slope=slope)
        # split-weight concat: conv(concat(x, x2), W) ==
        # conv(x, W[:c1]) + conv(x2, W[c1:]); the second conv adds the
        # first's output and emits the statistics of the sum
        c1 = x.shape[-1]
        w1, w2 = w[..., :c1, :], w[..., c1:, :]
        if self._kernel_class(x, w1) and self._kernel_class(x2, w2):
            return Conv3dK3PairFn.apply(x, x2, w.contiguous(), stride)
        y1 = conv3d_k3_plain(x, w1, stride)
        return conv3d_k3_plain(x2, w2, stride, add_to=y1, emit_stats=True)


class ConvNormAct(nn.Module):
    """Conv -> InstanceNorm -> [LeakyReLU] (reference:
    simple_conv_blocks.py:13-72), in the fused pipeline: ``forward``
    returns the raw conv output and its statistics, and the caller applies
    the norm as the next conv's pre-op or in a tail pass. The norm holds no
    parameters (affine=False), so only ``conv`` appears in the state."""

    def __init__(self, ci: int, co: int, kernel: Conv3, stride: Conv3,
                 use_kernels: bool = False, pre_pool: Tuple[int, ...] = (),
                 negative_slope: float = 1e-2):
        super().__init__()
        self.conv = Conv(ci, co, kernel, stride, use_kernels, pre_pool,
                         negative_slope)

    def forward(self, x, x2=None, pre=None):
        return self.conv(x, x2, pre)


class InstanceNorm(nn.Module):
    """Per-(sample, channel) normalization over the spatial axes with fp32
    statistics, then optional residual add and LeakyReLU (affine=False, the
    reference default)."""

    def __init__(self, eps: float = 1e-5, negative_slope: float = 1e-2,
                 act: bool = True):
        super().__init__()
        self.eps = eps
        self.negative_slope = negative_slope
        self.act = act

    def forward(self, y: torch.Tensor, stats: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                residual_pre: Optional[Vectors] = None) -> torch.Tensor:
        """Normalize ``y`` with its (N, 2, C) [sum; sumsq] ``stats``."""
        inv, shift = stats_to_scale_shift(stats, voxel_count(y), self.eps)
        return norm_apply(y, inv, shift, self.negative_slope, self.act,
                          residual, residual_pre)


class _ResidualSkip(nn.Module):
    """ResNet-D skip path: AvgPool(stride) when strided, then 1x1 Conv +
    Norm when projecting channels (reference: resblocks.py:89-104)."""

    def __init__(self, ci: int, co: int, stride: Conv3, eps: float,
                 negative_slope: float):
        super().__init__()
        self.pool = tuple(stride) if any(s != 1 for s in stride) else ()
        self.proj = (ConvNormAct(ci, co, (1, 1, 1), (1, 1, 1),
                                 pre_pool=self.pool) if ci != co else None)
        self.norm = InstanceNorm(eps, negative_slope, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.proj is None:
            return avg_pool(x, self.pool).to(x.dtype) if self.pool else x
        y, stats = self.proj(x)
        return self.norm(y, stats)


class BasicBlockD(nn.Module):
    """ResNet-D basic block (reference: resblocks.py:15-132) as the JAX
    package's fused chain (blocks.py:546-672): conv1 emits its statistics,
    conv2 applies conv1's norm + LeakyReLU as its pre-op and emits its own,
    and one tail pass applies norm2, the residual and the LeakyReLU."""

    def __init__(self, ci: int, co: int, kernel: Conv3, stride: Conv3,
                 eps: float = 1e-5, negative_slope: float = 1e-2,
                 use_kernels: bool = False):
        super().__init__()
        self.eps = eps
        self.conv1 = ConvNormAct(ci, co, kernel, stride, use_kernels,
                                 negative_slope=negative_slope)
        self.conv2 = ConvNormAct(co, co, kernel, (1, 1, 1), use_kernels,
                                 negative_slope=negative_slope)
        self.skip = (_ResidualSkip(ci, co, stride, eps, negative_slope)
                     if any(s != 1 for s in stride) or ci != co else None)
        self.tail = InstanceNorm(eps, negative_slope, act=True)

    def forward(self, x: torch.Tensor,
                pre: Optional[Vectors] = None) -> torch.Tensor:
        """``pre``: a producer's (scale, shift) not yet applied to ``x``
        (the stem handoff); the block's input is then ``leaky(x * scale -
        shift)``. Only an identity-skip block takes it."""
        residual = x if self.skip is None else self.skip(x)
        y1, s1 = self.conv1(x, pre=pre)
        v1 = stats_to_scale_shift(s1, voxel_count(y1), self.eps)
        y2, s2 = self.conv2(y1, pre=v1)
        return self.tail(y2, s2, residual=residual,
                         residual_pre=pre if self.skip is None else None)


class StackedResidualBlocks(nn.Module):
    """N residual blocks, stride only in the first
    (reference: resblocks.py:262-353)."""

    def __init__(self, n_blocks: int, ci: int, co: int, kernel: Conv3,
                 initial_stride: Conv3, eps: float = 1e-5,
                 negative_slope: float = 1e-2, use_kernels: bool = False):
        super().__init__()
        self.negative_slope = negative_slope
        self.blocks = []
        for i in range(n_blocks):
            block = BasicBlockD(ci if i == 0 else co, co, kernel,
                                initial_stride if i == 0 else (1, 1, 1), eps,
                                negative_slope, use_kernels)
            self.add_module(f"block{i}", block)
            self.blocks.append(block)

    def forward(self, x: torch.Tensor,
                pre: Optional[Vectors] = None) -> torch.Tensor:
        if pre is not None and self.blocks[0].skip is not None:
            # a projecting first block cannot take the handoff: apply the
            # producer's norm here
            x = norm_apply(x, pre[0], pre[1], self.negative_slope, act=True)
            pre = None
        for i, block in enumerate(self.blocks):
            x = block(x, pre if i == 0 else None)
        return x


class StackedConvBlocks(nn.Module):
    """N ConvNormAct blocks, stride only in the first
    (reference: simple_conv_blocks.py:82-148). The first conv takes the
    decoder's (upsampled, skip) pair with split weights; ``ci`` counts both
    halves, as the concat would."""

    def __init__(self, n_convs: int, ci: int, co: int, kernel: Conv3,
                 initial_stride: Conv3, eps: float = 1e-5,
                 negative_slope: float = 1e-2, use_kernels: bool = False):
        super().__init__()
        self.eps = eps
        self.convs = []
        for i in range(n_convs):
            conv = ConvNormAct(ci if i == 0 else co, co, kernel,
                               initial_stride if i == 0 else (1, 1, 1),
                               use_kernels, negative_slope=negative_slope)
            self.add_module(f"conv{i}", conv)
            self.convs.append(conv)
        self.tail = InstanceNorm(eps, negative_slope, act=True)

    def raw(self, x: torch.Tensor, x2: Optional[torch.Tensor] = None):
        """The last conv's raw output and statistics, its norm not applied
        (the stem hands both to stage 0)."""
        y, stats = self.convs[0](x, x2)
        for conv in self.convs[1:]:
            pre = stats_to_scale_shift(stats, voxel_count(y), self.eps)
            y, stats = conv(y, pre=pre)
        return y, stats

    def forward(self, x: torch.Tensor,
                x2: Optional[torch.Tensor] = None) -> torch.Tensor:
        y, stats = self.raw(x, x2)
        return self.tail(y, stats)
