"""Building blocks of the ResEnc U-Net in PyTorch, channels-last.

The port of ``mt3d_resenc_unet_tpu/models/blocks.py`` for inference and
training (there is no remat in the port: ``plan.remat`` changes memory,
not the function). Every tensor is plain (N, *spatial, C): the JAX
package's x-packing, banded weights and the branching that picks a packing
for the TPU have no counterpart here. What is kept is its fused pipeline,
so the numerics follow the same order:

* every 3x3x3 conv emits its output's fp32 [sum; sumsq] (the instance-norm
  statistics) with the output;
* the next conv applies that norm + LeakyReLU to its input as a pre-op;
* the decoder's skip concat is a split-weight pair whose second conv adds
  the first one's output and takes the statistics of the sum;
* one elementwise tail pass applies the last norm, the residual and the
  LeakyReLU (ops/instance_norm.py ``norm_apply``); with ``use_kernels``
  the tail, and the statistics of every producer that does not emit them,
  run on the norm-act kernels (``NormTailFn``, ``RawStatsFn``).

The JAX package runs this pipeline only where its Pallas kernels take the
shape and the unfused conv -> norm -> act order elsewhere; both compute the
same function. Here every block of a plan without conv biases, affine norms
and dropout runs the pipeline; with any of those a block takes the unfused
order (:meth:`ConvNormAct.normed`), as the JAX package does
(blocks.py:559, :601-602). A residual block with squeeze-excitation, or
with DropPath in train mode, splits the tail as JAX does (:594-595): norm
without activation, DropPath, SE, + residual, LeakyReLU. :class:`Conv`
sends bf16, fp16 and fp32 activations of the JAX package's kernel classes
to the CUDA conv through its autograd Functions (ops/conv3d.py ``Conv3dK3Fn``,
``Conv3dK3PairFn``, whose backward runs the dx and dW kernels) and the rest
(the stem, the 128-channel stage, the deep stride-2 convs, the 1x1
projections, other kernels, strides and ranks) to plain PyTorch,
differentiated by autograd, as the JAX package sends them to XLA: in the
model's dtype with fp32 accumulation (ops/lowp.py).
Squeeze-excitation, dropout and DropPath are XLA in the JAX package and
plain PyTorch here.

Dropout and DropPath draw from a ``torch.Generator`` that the caller passes
down (``ResEncUNet.forward(..., generator=...)``), on the activations'
device; they raise without one in train mode, and are the identity in eval
mode. No global RNG is used.

Parameter names and layouts are the flax ones (``conv1.conv.kernel`` of
shape (*k, ci, co), ``conv1.norm.scale``, ``se.reduce.kernel`` of shape
(C, rd)), so a JAX parameter tree loads by flattening (tools/from_jax.py).
Semantics match the reference blocks (simple_conv_blocks.py, resblocks.py):
  ConvNormAct  = Conv(same-pad) -> [Dropout] -> InstanceNorm -> [LeakyReLU]
  BasicBlockD  = conv1(stride) -> conv2, skip = AvgPool(stride) + 1x1
                 Conv + Norm when the shape changes, optional DropPath and
                 SqueezeExcite on the branch, post-add LeakyReLU.
  BottleneckD  = 1x1 reduce -> kxk(stride) -> 1x1 expand, same skip.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import lowp
from ..ops.conv3d import (Conv3dK3Fn, Conv3dK3PairFn, conv3d_k3_plain,
                          conv_s1_supported, conv_s2_supported)
from ..ops.instance_norm import (Vectors, instance_stats, norm_apply,
                                 pre_vector, stats_to_scale_shift)
from ..parallel.distributed import global_rows

Conv3 = Tuple[int, ...]


def torch_uniform_(param: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """torch's Conv default init, ``kaiming_uniform_(a=sqrt(5))``:
    U(-b, b) with b = 1/sqrt(fan_in) (JAX blocks.py torch_conv_kernel_init;
    the reference never overrides torch's init)."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        param.uniform_(-bound, bound, generator=generator)


def voxel_count(y: torch.Tensor) -> int:
    """Voxels per (sample, channel) of an (N, *spatial, C) tensor."""
    return math.prod(y.shape[1:-1])


def avg_pool(x: torch.Tensor, p: Sequence[int]) -> torch.Tensor:
    """VALID average pooling with window == stride ``p``, in fp32."""
    n, c = x.shape[0], x.shape[-1]
    out = [s // q for s, q in zip(x.shape[1:-1], p)]
    xf = x[(slice(None),) + tuple(slice(0, o * q)
                                  for o, q in zip(out, p))].float()
    xf = xf.reshape(n, *(v for o, q in zip(out, p) for v in (o, q)), c)
    return xf.mean(dim=tuple(range(2, 2 * len(p) + 1, 2)))


def pointwise(xf: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """1x1 conv as a channel matmul in fp32; k is (*1, ci, co)."""
    ci, co = k.shape[-2:]
    return (xf.reshape(-1, ci) @ k.float().reshape(ci, co)).reshape(
        *xf.shape[:-1], co)


def _make_divisible(v: float, divisor: int = 8,
                    min_value: Optional[int] = None) -> int:
    """Channel rounding of the squeeze-excitation reduction (timm-style,
    rd_divisor=8; JAX blocks.py:309-317): 32 channels -> 8, 512 -> 32."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _generator(generator: Optional[torch.Generator],
               what: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"{what} in train mode draws from a "
                         "torch.Generator: pass generator= to the model")
    return generator


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: each element kept with probability 1 - p and
    scaled by 1 / (1 - p), the draw from ``generator`` (for the global
    batch in a multi-process step, keeping this rank's rows)."""
    keep = 1.0 - p
    n, rows = global_rows(x.shape[0])
    mask = torch.rand((n,) + tuple(x.shape[1:]),
                      generator=_generator(generator, "dropout"),
                      device=x.device)[rows] < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, p: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Stochastic depth (JAX blocks.py:465-473): the residual branch of
    each sample zeroed with probability p, kept ones scaled by 1 / (1 - p),
    the draw from ``generator`` (for the global batch, as dropout)."""
    keep = 1.0 - p
    n, rows = global_rows(x.shape[0])
    shape = (n,) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=_generator(generator, "DropPath"),
                      device=x.device)[rows] < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Conv(nn.Module):
    """Same-pad conv with the flax kernel layout (*k, ci, co) and an
    optional bias (``bias``, torch's init over the kernel's fan-in).

    ``forward`` returns ``(y, stats)``: the conv output in the input's
    dtype (plus the bias) and its fp32 (N, 2, co) [sum; sumsq], taken after
    the bias. bf16, fp16 and fp32 3x3x3 convs in the kernel shape classes
    go to the CUDA conv through its autograd Functions when
    ``use_kernels`` (the kernels take all three); everything else runs the same math as the JAX
    package runs these shapes in XLA (ops/lowp.py): with operands in the
    input's dtype and fp32 accumulation, and its statistics from the
    norm-act kernels' raw mode where ``use_kernels``. Without
    ``use_kernels`` an fp32 model's 3x3x3 convs run the kernels' plain
    version, ``conv3d_k3_plain`` (the fp32 reference model).
    ``pre_pool``: AvgPool(pre_pool) before a 1x1 conv (the ResNet-D skip
    projection, JAX ``_pool_proj``)."""

    def __init__(self, ci: int, co: int, kernel: Conv3, stride: Conv3,
                 use_kernels: bool = False, pre_pool: Tuple[int, ...] = (),
                 negative_slope: float = 1e-2, bias: bool = False):
        super().__init__()
        self.kernel_size = tuple(kernel)
        self.stride = tuple(stride)
        self.use_kernels = use_kernels
        self.pre_pool = tuple(pre_pool)
        self.negative_slope = negative_slope
        self.kernel = nn.Parameter(torch.empty(*kernel, ci, co))
        self.bias = nn.Parameter(torch.empty(co)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = math.prod(self.kernel.shape[:-1])
        torch_uniform_(self.kernel, fan_in, generator)
        if self.bias is not None:
            torch_uniform_(self.bias, fan_in, generator)

    def _kernel_class(self, x: torch.Tensor, w: torch.Tensor) -> bool:
        """The conv kernels' class: bf16, fp16 or fp32 activations of the
        JAX package's kernel shapes (its dispatch is by shape alone)."""
        if not self.use_kernels or x.dtype not in (torch.bfloat16,
                                                   torch.float16,
                                                   torch.float32):
            return False
        if self.stride == (1, 1, 1):
            return conv_s1_supported(x.shape, w.shape)
        return self.stride == (2, 2, 2) and conv_s2_supported(x.shape,
                                                              w.shape)

    def forward(self, x: torch.Tensor, x2: Optional[torch.Tensor] = None,
                pre: Optional[Vectors] = None):
        y, stats = self._conv(x, x2, pre)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
            stats = instance_stats(y, self.use_kernels)
        return y, stats

    def _pointwise(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32:
            return lowp.pool_proj(x, w, self.pre_pool)
        xf = avg_pool(x, self.pre_pool) if self.pre_pool else x
        return pointwise(xf, w)

    def _conv(self, x, x2, pre):
        w = self.kernel.to(x.dtype)
        slope = self.negative_slope
        if all(k == 1 for k in self.kernel_size + self.stride):
            if pre is not None:
                x = lowp.apply_pre(x, pre_vector(pre), slope)
            if x2 is None:
                y = self._pointwise(x, w)
            else:
                c1 = x.shape[-1]
                y = (self._pointwise(x, w[..., :c1, :]).to(x.dtype)
                     + self._pointwise(x2, w[..., c1:, :]).to(x.dtype))
            return y.to(x.dtype), instance_stats(y, self.use_kernels)
        k3 = (self.kernel_size == (3, 3, 3)
              and self.stride in ((1, 1, 1), (2, 2, 2)))
        stride = self.stride[0] if k3 else self.stride
        if k3 and x.dtype == torch.float32 and not self.use_kernels:
            # the fp32 reference model's 3x3x3 convs: the kernels' plain
            # version, which emits its own statistics
            conv = conv3d_k3_plain
        else:
            conv = functools.partial(lowp.conv, use_kernels=self.use_kernels)
        if x2 is None:
            pv = pre_vector(pre) if pre is not None else None
            if k3 and self._kernel_class(x, w):
                return Conv3dK3Fn.apply(x, w.contiguous(), pv, stride, slope)
            return conv(x, w, stride, pre=pv, emit_stats=True,
                        negative_slope=slope)
        # split-weight concat: conv(concat(x, x2), W) ==
        # conv(x, W[:c1]) + conv(x2, W[c1:]); the second conv adds the
        # first's output and emits the statistics of the sum
        c1 = x.shape[-1]
        w1, w2 = w[..., :c1, :], w[..., c1:, :]
        if k3 and self._kernel_class(x, w1) and self._kernel_class(x2, w2):
            return Conv3dK3PairFn.apply(x, x2, w.contiguous(), stride)
        y1 = conv(x, w1, stride)
        return conv(x2, w2, stride, add_to=y1, emit_stats=True)


class InstanceNorm(nn.Module):
    """Per-(sample, channel) normalization over the spatial axes with fp32
    statistics, then optional residual add and LeakyReLU. ``affine``: the
    parameters ``scale`` (ones) and ``bias`` (zeros) of shape (C,), folded
    into the normalization vectors as JAX folds them; the reference default
    is affine=False, which holds no parameters. ``use_kernels``: the
    kernels' class of shapes goes to the norm-act kernels' tail mode
    (ops/instance_norm.py ``norm_apply``), as ``Conv`` sends its class to
    the conv kernels."""

    def __init__(self, c: int, eps: float = 1e-5,
                 negative_slope: float = 1e-2, affine: bool = False,
                 use_kernels: bool = False):
        super().__init__()
        self.eps = eps
        self.negative_slope = negative_slope
        self.use_kernels = use_kernels
        self.scale = nn.Parameter(torch.ones(c)) if affine else None
        self.bias = nn.Parameter(torch.zeros(c)) if affine else None

    def vectors(self, stats: torch.Tensor, count: int) -> Vectors:
        """(N, 2, C) [sum; sumsq] of ``count`` voxels -> (inv, shift)."""
        return stats_to_scale_shift(stats, count, self.eps, self.scale,
                                    self.bias)

    def forward(self, y: torch.Tensor, stats: torch.Tensor, act: bool = True,
                residual: Optional[torch.Tensor] = None,
                residual_pre: Optional[Vectors] = None) -> torch.Tensor:
        """Normalize ``y`` with its (N, 2, C) [sum; sumsq] ``stats``."""
        inv, shift = self.vectors(stats, voxel_count(y))
        return norm_apply(y, inv, shift, self.negative_slope, act,
                          residual, residual_pre, self.use_kernels)


class ConvNormAct(nn.Module):
    """Conv -> [Dropout] -> InstanceNorm -> [LeakyReLU] (reference:
    simple_conv_blocks.py:13-72). ``forward`` is the fused pipeline's half:
    the raw conv output and its statistics, the norm applied by the caller
    as the next conv's pre-op or in a tail pass (only without a bias, an
    affine norm and dropout). :meth:`normed` is the unfused order."""

    def __init__(self, ci: int, co: int, kernel: Conv3, stride: Conv3,
                 use_kernels: bool = False, pre_pool: Tuple[int, ...] = (),
                 eps: float = 1e-5, negative_slope: float = 1e-2,
                 conv_bias: bool = False, norm_affine: bool = False,
                 dropout_p: float = 0.0):
        super().__init__()
        self.conv = Conv(ci, co, kernel, stride, use_kernels, pre_pool,
                         negative_slope, conv_bias)
        self.norm = InstanceNorm(co, eps, negative_slope, norm_affine,
                                 use_kernels)
        self.dropout_p = dropout_p

    def forward(self, x, x2=None, pre=None):
        return self.conv(x, x2, pre)

    def normed(self, x: torch.Tensor, x2: Optional[torch.Tensor] = None,
               act: bool = True, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """The unfused order: conv (+ bias), dropout in train mode (the
        statistics are then the dropped tensor's), norm, LeakyReLU."""
        y, stats = self.conv(x, x2)
        if self.training and self.dropout_p > 0.0:
            y = dropout(y, self.dropout_p, generator)
            stats = instance_stats(y, self.conv.use_kernels)
        return self.norm(y, stats, act)


def _fused(conv_bias: bool, norm_affine: bool, dropout_p: float) -> bool:
    """Whether a block can run the fused pipeline: its convs' statistics
    are those of their raw outputs and its norms hold no parameters."""
    return not (conv_bias or norm_affine or dropout_p > 0.0)


class _ResidualSkip(nn.Module):
    """ResNet-D skip path: AvgPool(stride) when strided, then 1x1 Conv +
    Norm when projecting channels (reference: resblocks.py:89-104). The
    decoder's residual first block hands it the (upsampled, skip) pair at
    stride 1, whose concat width 2C always differs from C: the projection
    then takes the pair with split weights (JAX blocks.py:515-521)."""

    def __init__(self, ci: int, co: int, stride: Conv3, eps: float,
                 negative_slope: float, norm_affine: bool = False,
                 use_kernels: bool = False):
        super().__init__()
        self.pool = tuple(stride) if any(s != 1 for s in stride) else ()
        ones = (1,) * len(stride)
        self.proj = (ConvNormAct(ci, co, ones, ones, use_kernels,
                                 pre_pool=self.pool, eps=eps,
                                 negative_slope=negative_slope,
                                 norm_affine=norm_affine)
                     if ci != co else None)

    def forward(self, x: torch.Tensor,
                x2: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.proj is None:
            return avg_pool(x, self.pool).to(x.dtype) if self.pool else x
        y, stats = self.proj(x, x2)
        return self.proj.norm(y, stats, act=False)


class SqueezeExcite(nn.Module):
    """Channel squeeze-excitation (JAX blocks.py:433-462; the reference
    imports dynamic_network_architectures' SqueezeExcite, rd_divisor=8):
    the fp32 spatial mean, cast to the activations' dtype; ``reduce``
    (C -> rd), ReLU, ``expand`` (rd -> C) in that dtype; the sigmoid gate
    in fp32, cast back; ``x * gate`` in the activations' dtype."""

    def __init__(self, c: int, rd_ratio: float = 1.0 / 16):
        super().__init__()
        rd = _make_divisible(c * rd_ratio, 8)
        self.reduce = Dense(c, rd)
        self.expand = Dense(rd, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.mean(x, dim=tuple(range(1, x.dim() - 1)),
                       dtype=torch.float32).to(x.dtype)
        s = self.expand(torch.relu(self.reduce(s)))
        gate = torch.sigmoid(s.float()).to(x.dtype)
        return x * gate.reshape(x.shape[0], *(1,) * (x.dim() - 2),
                                x.shape[-1])


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with kernel (ci, co), in
    x's dtype with fp32 accumulation (ops/lowp.py ``matmul``); torch
    Linear's init, bound 1/sqrt(ci) for both."""

    def __init__(self, ci: int, co: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(ci, co))
        self.bias = nn.Parameter(torch.empty(co))

    def reset_parameters(self, generator: torch.Generator) -> None:
        ci = self.kernel.shape[0]
        torch_uniform_(self.kernel, ci, generator)
        torch_uniform_(self.bias, ci, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lowp.matmul(x, self.kernel) + self.bias.to(x.dtype)


class _Residual(nn.Module):
    """The part of BasicBlockD and BottleneckD after the branch's last
    norm: [DropPath] -> [SqueezeExcite] -> + residual -> LeakyReLU."""

    def __init__(self, co: int, negative_slope: float,
                 squeeze_excitation: bool, se_ratio: float,
                 stochastic_depth_p: float):
        super().__init__()
        self.negative_slope = negative_slope
        self.se = SqueezeExcite(co, se_ratio) if squeeze_excitation else None
        self.stochastic_depth_p = stochastic_depth_p

    def _fuses_tail(self) -> bool:
        """JAX's ``fuse_tail`` (blocks.py:594-595): no SE, no DropPath in
        train mode, so norm, residual and LeakyReLU run as one pass."""
        return self.se is None and not (self.training
                                        and self.stochastic_depth_p > 0.0)

    def _finish(self, out: torch.Tensor, residual: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.training and self.stochastic_depth_p > 0.0:
            out = drop_path(out, self.stochastic_depth_p, generator)
        if self.se is not None:
            out = self.se(out)
        return F.leaky_relu(out + residual, self.negative_slope)


class BasicBlockD(_Residual):
    """ResNet-D basic block (reference: resblocks.py:15-132) as the JAX
    package's fused chain (blocks.py:546-672): conv1 emits its statistics,
    conv2 applies conv1's norm + LeakyReLU as its pre-op and emits its own,
    and one tail pass applies norm2, the residual and the LeakyReLU. With
    squeeze-excitation, or DropPath in train mode, the tail is split:
    norm2 without activation, DropPath, SE, + residual, LeakyReLU. With a
    conv bias, an affine norm or dropout (on conv1) the convs run the
    unfused order."""

    def __init__(self, ci: int, co: int, kernel: Conv3, stride: Conv3,
                 eps: float = 1e-5, negative_slope: float = 1e-2,
                 use_kernels: bool = False, conv_bias: bool = False,
                 norm_affine: bool = False, dropout_p: float = 0.0,
                 squeeze_excitation: bool = False,
                 se_ratio: float = 1.0 / 16,
                 stochastic_depth_p: float = 0.0):
        super().__init__(co, negative_slope, squeeze_excitation, se_ratio,
                         stochastic_depth_p)
        opts = dict(eps=eps, negative_slope=negative_slope,
                    conv_bias=conv_bias, norm_affine=norm_affine)
        self.conv1 = ConvNormAct(ci, co, kernel, stride, use_kernels,
                                 dropout_p=dropout_p, **opts)
        self.conv2 = ConvNormAct(co, co, kernel, (1,) * len(stride),
                                 use_kernels, **opts)
        self.skip = (_ResidualSkip(ci, co, stride, eps, negative_slope,
                                   norm_affine, use_kernels)
                     if any(s != 1 for s in stride) or ci != co else None)
        self.fused = _fused(conv_bias, norm_affine, dropout_p)

    def takes_pre(self) -> bool:
        """Whether the block can apply a producer's norm as conv1's pre-op
        (the stem handoff): the fused chain with an identity skip and a
        fused tail in either mode (JAX blocks.py:775-786)."""
        return (self.fused and self.skip is None and self.se is None
                and self.stochastic_depth_p == 0.0)

    def forward(self, x: torch.Tensor, pre: Optional[Vectors] = None,
                x2: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``pre``: a producer's (scale, shift) not yet applied to ``x``
        (the stem handoff; only where :meth:`takes_pre`); the block's input
        is then ``leaky(x * scale - shift)``. ``x2``: the decoder's skip,
        the second half of the first block's concatenated input."""
        residual = x if self.skip is None else self.skip(x, x2)
        if self.fused:
            y1, s1 = self.conv1(x, x2, pre)
            v1 = self.conv1.norm.vectors(s1, voxel_count(y1))
            y2, s2 = self.conv2(y1, pre=v1)
        else:
            y2, s2 = self.conv2(self.conv1.normed(x, x2,
                                                  generator=generator))
        if self._fuses_tail():
            return self.conv2.norm(y2, s2, True, residual, pre)
        out = self.conv2.norm(y2, s2, act=False)
        return self._finish(out, residual, generator)


class BottleneckD(_Residual):
    """ResNet-D bottleneck (reference: resblocks.py:135-259; JAX
    blocks.py:675-733): 1x1 -> kxk(stride) -> 1x1 in the unfused order,
    dropout on the middle conv, the same skip, DropPath and SE as
    :class:`BasicBlockD`."""

    def __init__(self, ci: int, co: int, bottleneck: int, kernel: Conv3,
                 stride: Conv3, eps: float = 1e-5,
                 negative_slope: float = 1e-2, use_kernels: bool = False,
                 conv_bias: bool = False, norm_affine: bool = False,
                 dropout_p: float = 0.0, squeeze_excitation: bool = False,
                 se_ratio: float = 1.0 / 16,
                 stochastic_depth_p: float = 0.0):
        super().__init__(co, negative_slope, squeeze_excitation, se_ratio,
                         stochastic_depth_p)
        ones = (1,) * len(stride)
        opts = dict(eps=eps, negative_slope=negative_slope,
                    conv_bias=conv_bias, norm_affine=norm_affine)
        self.skip = (_ResidualSkip(ci, co, stride, eps, negative_slope,
                                   norm_affine, use_kernels)
                     if any(s != 1 for s in stride) or ci != co else None)
        self.conv1 = ConvNormAct(ci, bottleneck, ones, ones, use_kernels,
                                 **opts)
        self.conv2 = ConvNormAct(bottleneck, bottleneck, kernel, stride,
                                 use_kernels, dropout_p=dropout_p, **opts)
        self.conv3 = ConvNormAct(bottleneck, co, ones, ones, use_kernels,
                                 **opts)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        residual = x if self.skip is None else self.skip(x)
        out = self.conv1.normed(x)
        out = self.conv2.normed(out, generator=generator)
        out = self.conv3.normed(out, act=False)
        return self._finish(out, residual, generator)


class StackedResidualBlocks(nn.Module):
    """N residual blocks, stride only in the first
    (reference: resblocks.py:262-353): ``BasicBlockD``, or ``BottleneckD``
    with ``block_type="BottleneckBlockD"`` (``bottleneck_features``
    defaults to features // 4). The first block takes the decoder's
    (upsampled, skip) pair with split weights; ``ci`` counts both halves,
    as the concat would."""

    def __init__(self, n_blocks: int, ci: int, co: int, kernel: Conv3,
                 initial_stride: Conv3, eps: float = 1e-5,
                 negative_slope: float = 1e-2, use_kernels: bool = False,
                 block_type: str = "BasicBlockD",
                 bottleneck_features: Optional[int] = None, **opts):
        super().__init__()
        self.negative_slope = negative_slope
        self.use_kernels = use_kernels
        ones = (1,) * len(initial_stride)
        self.blocks = []
        for i in range(n_blocks):
            args = (ci if i == 0 else co, co)
            if block_type == "BottleneckBlockD":
                args += (bottleneck_features or co // 4,)
            block = (BottleneckD if block_type == "BottleneckBlockD"
                     else BasicBlockD)(
                *args, kernel, initial_stride if i == 0 else ones, eps,
                negative_slope, use_kernels, **opts)
            self.add_module(f"block{i}", block)
            self.blocks.append(block)

    def forward(self, x: torch.Tensor, pre: Optional[Vectors] = None,
                x2: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        first = self.blocks[0]
        if pre is not None and not (isinstance(first, BasicBlockD)
                                    and first.takes_pre()):
            # the first block cannot take the handoff (JAX blocks.py:771-794):
            # apply the producer's norm here
            x = norm_apply(x, pre[0], pre[1], self.negative_slope, act=True,
                           use_kernels=self.use_kernels)
            pre = None
        for i, block in enumerate(self.blocks):
            if isinstance(block, BottleneckD):
                x = block(x, generator)
            else:
                x = block(x, pre if i == 0 else None,
                          x2 if i == 0 else None, generator)
        return x


class StackedConvBlocks(nn.Module):
    """N ConvNormAct blocks, stride only in the first
    (reference: simple_conv_blocks.py:82-148). The first conv takes the
    decoder's (upsampled, skip) pair with split weights; ``ci`` counts both
    halves, as the concat would."""

    def __init__(self, n_convs: int, ci: int, co: int, kernel: Conv3,
                 initial_stride: Conv3, eps: float = 1e-5,
                 negative_slope: float = 1e-2, use_kernels: bool = False,
                 conv_bias: bool = False, norm_affine: bool = False,
                 dropout_p: float = 0.0):
        super().__init__()
        self.convs = []
        for i in range(n_convs):
            conv = ConvNormAct(
                ci if i == 0 else co, co, kernel,
                initial_stride if i == 0 else (1,) * len(initial_stride),
                use_kernels, eps=eps, negative_slope=negative_slope,
                conv_bias=conv_bias, norm_affine=norm_affine,
                dropout_p=dropout_p)
            self.add_module(f"conv{i}", conv)
            self.convs.append(conv)
        self.fused = _fused(conv_bias, norm_affine, dropout_p)

    def raw(self, x: torch.Tensor, x2: Optional[torch.Tensor] = None):
        """The fused chain's last raw output and statistics, its norm not
        applied (the stem hands both to stage 0)."""
        y, stats = self.convs[0](x, x2)
        for prev, conv in zip(self.convs, self.convs[1:]):
            y, stats = conv(y, pre=prev.norm.vectors(stats, voxel_count(y)))
        return y, stats

    def forward(self, x: torch.Tensor, x2: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.fused:
            y, stats = self.raw(x, x2)
            return self.convs[-1].norm(y, stats)
        for i, conv in enumerate(self.convs):
            x = conv.normed(x, x2 if i == 0 else None, generator=generator)
        return x
