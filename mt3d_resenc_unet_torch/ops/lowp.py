"""The model's plain classes in the working precision (bf16), as the JAX
package runs them.

The shapes outside the kernel classes (the Ci=1 stem, the 128-channel
stage and its decoder pair, the deep stride-2 convs, the pool+projection
skips, the deep-stage upsamples and the seg layers) are XLA in the JAX
package, not Pallas. There ``Conv.__call__`` / ``_dispatch``
(models/blocks.py:130-135, 192-207), ``_pool_proj`` (:214-255), the stem
GEMM (ops/gemm_conv.py:221-276), ``UpsampleConv`` and ``SegLayer`` cast
their operands to the compute dtype and ask for its output
(``preferred_element_type=self.dtype``): bf16 operands, fp32 accumulation,
a bf16 result; and its unfused conv -> norm -> act order hands the next
conv a bf16 activation. The functions here do the same for an input in a
16-bit dtype:

* on the card, one cuDNN conv or cuBLAS matmul in the input's dtype (both
  accumulate in fp32; ``core.config.set_precision`` keeps cuBLAS's split-K
  reductions in fp32 as well);
* on the CPU, the fp32 conv or matmul of the same rounded operands, then
  rounded to the input's dtype: the same products, summed in another order.

A pre-op's normalized input is rounded to the input's dtype before the
conv; statistics are fp32 sums of the rounded output (in a kernel model the
stats kernel's raw mode takes them, ``instance_stats``). Everything else is
plain PyTorch differentiated by autograd, except the stem's weight gradient
(:class:`StemConvFn`). ``conv3d.conv3d_k3_plain`` and
``upsample.upsample_plain`` stay the fp32 path of the kernels' shape
classes (the fp32 reference model, and the kernels' yardsticks); an fp32
input comes here only for what no kernel class covers (:func:`conv` of
another kernel, stride or rank; the pointwise and matmul functions), and is
computed in fp32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .instance_norm import instance_stats
from .upsample import upsample_gemm


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with both operands in a's dtype, fp32 accumulation, the
    result in a's dtype."""
    b = b.to(a.dtype)
    if a.device.type == "cuda":
        return a @ b
    return (a.float() @ b.float()).to(a.dtype)


def _conv(x: torch.Tensor, w: torch.Tensor, stride) -> torch.Tensor:
    """Same-padded ((k - 1) // 2 on both sides, JAX ``_pad_same``) conv of
    channels-last x (N, *spatial, Ci) with w (*k, Ci, Co) in x's dtype, of
    any rank, kernel and stride (an int or one per axis); on the card cuDNN
    on the channels-first views."""
    nd = x.dim() - 2
    k = w.shape[:nd]
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    pad = tuple((kk - 1) // 2 for kk in k)
    xl = x.permute(0, nd + 1, *range(1, nd + 1))
    wl = w.to(x.dtype).permute(nd + 1, nd, *range(nd))
    if x.device.type == "cuda":
        fmt = (torch.channels_last_3d if nd == 3
               else torch.contiguous_format)
        y = conv(xl, wl.contiguous(memory_format=fmt), stride=stride,
                 padding=pad)
    else:
        y = conv(xl.float(), wl.float(), stride=stride,
                 padding=pad).to(x.dtype)
    return y.permute(0, *range(2, nd + 2), 1).contiguous()


def stem_class(x: torch.Tensor, w: torch.Tensor, stride: int) -> bool:
    """The JAX stem GEMM's class (gemm_conv.py ``stem_supported``): one
    input channel, 3x3x3, stride 1, for an input that needs no gradient
    (the image; :class:`StemConvFn` has no dx)."""
    return (x.dim() == 5 and x.shape[-1] == 1
            and tuple(w.shape[:4]) == (3, 3, 3, 1)
            and stride in (1, (1, 1, 1)) and not x.requires_grad)


def _stem_patches(x: torch.Tensor) -> torch.Tensor:
    """(N, D, H, W, 1) -> (32, N*D*H*W): the 27 taps' shifted views of the
    zero-padded volume, then 5 rows of zeros (K = 32 keeps the GEMMs on
    the tensor cores' tiles)."""
    n, d, h, w, _ = x.shape
    xp = F.pad(x[..., 0], (1, 1, 1, 1, 1, 1))
    taps = [xp[:, a:a + d, b:b + h, c:c + w]
            for a in range(3) for b in range(3) for c in range(3)]
    taps += [torch.zeros_like(taps[0])] * 5
    return torch.stack(taps).reshape(32, -1)


class StemConvFn(torch.autograd.Function):
    """The Ci=1 stem conv ``y = conv(x, w)`` as the JAX package computes it
    (``conv3d_stem_cf`` / ``_stem_cf_bwd``, gemm_conv.py:221-276): one GEMM
    over the tap-patch matrix P (27 taps x voxels), y = P^T W forward and
    dW = P gy backward with fp32 accumulation (:263), rounded to W's dtype.
    With Ci = 1 a conv library's implicit GEMM has a K of 27; here the
    weight gradient is one (32 x M) x (M x Co) product. x needs no
    gradient (the image): the Function returns none for it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x)
        co = w.shape[-1]
        w32 = F.pad(w.reshape(27, co), (0, 0, 0, 5))
        y = matmul(_stem_patches(x).t(), w32)
        return y.reshape(*x.shape[:4], co)

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        co = gy.shape[-1]
        dw = matmul(_stem_patches(x), gy.reshape(-1, co).to(x.dtype))
        return None, dw[:27].reshape(3, 3, 3, 1, co)


def apply_pre(x: torch.Tensor, pre: torch.Tensor,
              negative_slope: float) -> torch.Tensor:
    """A producer's norm + LeakyReLU ``leaky(x * pre[:, 0] - pre[:, 1])``
    in fp32, rounded to x's dtype; ``pre`` is (N, 2, C)."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    u = x.float() * pre[:, 0].reshape(shape) - pre[:, 1].reshape(shape)
    return torch.where(u >= 0, u, u * negative_slope).to(x.dtype)


def conv(x: torch.Tensor, w: torch.Tensor, stride=1,
         pre: Optional[torch.Tensor] = None,
         add_to: Optional[torch.Tensor] = None,
         emit_stats: bool = False, negative_slope: float = 1e-2,
         use_kernels: bool = False):
    """The function of ``conv3d.conv3d_k3_plain`` in x's dtype, for any
    rank, kernel and stride: the pre-op (:func:`apply_pre`); the conv
    (:class:`StemConvFn` in the stem's class); ``add_to`` added in x's
    dtype (JAX adds the two halves' outputs so); ``emit_stats``: fp32
    [sum; sumsq] of the result (``instance_stats``: with ``use_kernels``
    the stats kernel's raw mode where the shape is in its class). Returns
    ``y`` or ``(y, stats)``. An fp32 input computes the same in fp32: the
    fp32 model's convs outside the 3x3x3 class (other kernels, anisotropic
    strides, 2-D plans)."""
    if pre is not None:
        x = apply_pre(x, pre, negative_slope)
    w = w.to(x.dtype)
    if stem_class(x, w, stride):
        y = StemConvFn.apply(x, w)
    else:
        y = _conv(x, w, stride)
    if add_to is not None:
        y = y + add_to
    return (y, instance_stats(y, use_kernels)) if emit_stats else y


def pool_proj(x: torch.Tensor, k: torch.Tensor,
              p: Sequence[int] = ()) -> torch.Tensor:
    """AvgPool(p) (window == stride, VALID) then the 1x1 projection k
    (*1, Ci, Co), as JAX ``_pool_proj``: for p = (2, 2, 2) at Ci <= 64
    the D and H pair sums in x's dtype and one matmul whose K takes the W
    pair; otherwise one matmul over the whole window (JAX's fallback conv
    with k / prod(p) over the window). No ``p``: the plain 1x1 conv."""
    n, ci = x.shape[0], x.shape[-1]
    co = k.shape[-1]
    w2 = k.to(x.dtype).reshape(ci, co) / math.prod(p)
    if not p:
        a = x
    elif (x.dim() == 5 and tuple(p) == (2, 2, 2) and ci <= 64
          and 128 % ci == 0 and x.shape[3] % (128 // ci) == 0
          and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
        _, d, h, wd, _ = x.shape
        t = x[:, 0::2] + x[:, 1::2]
        t = t[:, :, 0::2] + t[:, :, 1::2]
        a = t.reshape(n, d // 2, h // 2, wd // 2, 2 * ci)
        w2 = torch.cat([w2, w2])
    else:
        nd = len(p)
        out = [s // q for s, q in zip(x.shape[1:-1], p)]
        a = x[(slice(None),) + tuple(slice(0, o * q)
                                     for o, q in zip(out, p))]
        a = a.reshape(n, *(v for o, q in zip(out, p) for v in (o, q)), ci)
        a = a.permute(0, *range(1, 2 * nd, 2), *range(2, 2 * nd + 1, 2),
                      2 * nd + 1)
        a = a.reshape(n, *out, math.prod(p) * ci)
        w2 = w2.repeat(math.prod(p), 1)
    return matmul(a.reshape(-1, a.shape[-1]), w2).reshape(*a.shape[:-1], co)


def upsample(x: torch.Tensor, wf: torch.Tensor) -> torch.Tensor:
    """``upsample.upsample_plain`` in x's dtype (JAX ``UpsampleConv``'s
    generic GEMM)."""
    return upsample_gemm(x, wf.to(x.dtype), matmul).contiguous()


def seg(x: torch.Tensor, k: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The 1x1 seg head as JAX ``SegLayer``: the matmul and the bias add in
    x's dtype, then fp32 (the logits)."""
    ci, co = k.shape[-2:]
    y = matmul(x.reshape(-1, ci), k.reshape(ci, co)) + bias.to(x.dtype)
    return y.float().reshape(*x.shape[:-1], co)
