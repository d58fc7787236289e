"""3x3x3 pad-1 conv on NDHWC, stride 1 or 2, with the fused instance-norm
hooks of the JAX package's Pallas convs, and its backward.

Three CUDA kernels, each behind a wrapper with a plain PyTorch version of
the same function beside it (the wrapper runs the plain version for CPU
tensors; the tests and ``chip_smoke.py`` hold the kernel against it). A
CUDA tensor always goes to the kernel, or the wrapper raises.

  ``conv3d_k3``     the forward: at stride 1 csrc/conv3d_k3_s1.cu (an
                    implicit GEMM on the tensor cores), replacing
                    ``mt3d_resenc_unet_tpu/ops/pallas_conv.py::_conv_kernel``;
                    at stride 2 csrc/conv3d_k3.cu, replacing
                    ``::_s2_fwd_kernel``;
  ``conv3d_k3_dx``  csrc/conv3d_k3_dx.cu: the input gradient, replacing
                    ``_conv_kernel`` in its corr/post mode
                    (``_conv3d_dx_fused_f``) and ``_s2_dx_kernel``;
  ``conv3d_k3_dw``  the weight gradient: at stride 1 csrc/conv3d_k3_dw_s1.cu
                    (27 GEMMs over voxels on the tensor cores), replacing
                    ``_dw_kernel``; at stride 2 csrc/conv3d_k3_dw.cu,
                    replacing ``_s2_dw_kernel``.

The two tensor-core kernels take their tiling from the planners
:func:`_s1_plan` and :func:`_dw_s1_plan` here; the kernels decode their
block indices as the planners' docstrings say.

The kernels write through raw pointers and record nothing for autograd, so
training reaches them through :class:`Conv3dK3Fn` and
:class:`Conv3dK3PairFn`, the counterparts of the JAX ``custom_vjp``s
``conv3d_packed_stats`` / ``conv3d_packed_ns`` / ``conv3d_s2_packed`` and
``conv3d_packed_dual_stats``. A wrapper called outside them on a CUDA tensor
that needs a gradient raises (``_build.check_no_grad``).

Layouts are the JAX package's: x (N, D, H, W, Ci), w (3, 3, 3, Ci, Co).
Forward modes, each optional:
  pre       (N, 2, Ci) fp32 [scale; shift]: the input is
            ``leaky(x * scale - shift)``, with the zero padding applied
            after it;
  add_to    (N, Do, Ho, Wo, Co): added to the conv output;
  emit_stats returns ``(y, stats)`` with stats (N, 2, Co) fp32
            [sum; sumsq] of the output (after add_to) over all voxels.
Backward modes: ``y`` and ``gs`` (the stats' cotangent) fold the stats
into the output cotangent, ``gy + gs[0] + 2 * y * gs[1]`` (the correction),
without writing the corrected tensor to memory; ``pre`` recomputes the
pre-op's input so dx is taken with respect to the raw input.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_KERNEL = "conv3d_k3"
_lib_fns = {}


def conv_s1_supported(x_shape, w_shape) -> bool:
    """The stride-1 shape class of the JAX package's banded kernel
    (pallas_conv.py ``is_supported``), cut to the channel counts this
    kernel takes (multiples of 32)."""
    if len(x_shape) != 5 or len(w_shape) != 5:
        return False
    kd, kh, kw, ci, co = w_shape
    n, d, h, w, c = x_shape
    if (kd, kh, kw) != (3, 3, 3) or c != ci or ci % 32 or co % 32:
        return False
    if d < 2 or h < 2:
        return False
    if co in (256, 512):
        return ci % 128 == 0 and ci <= 512 and w >= 2
    if co not in (32, 64) or ci > 128:
        return False
    g = 128 // co
    return (g * ci) % 128 == 0 and w % g == 0 and w // g >= 2


def conv_s2_supported(x_shape, w_shape) -> bool:
    """The stride-2 shape class of the JAX package's banded stride-2 kernel
    (pallas_conv.py ``s2_supported``): 32->64 and 64->128."""
    if len(x_shape) != 5 or len(w_shape) != 5:
        return False
    kd, kh, kw, ci, co = w_shape
    if (kd, kh, kw) != (3, 3, 3) or 128 % co or ci % 32:
        return False
    g_out = 128 // co
    g_in = 2 * g_out
    if g_in * ci != 128:
        return False
    n, d, h, w, c = x_shape
    return (c == ci and d % 2 == 0 and h % 2 == 0 and w % g_in == 0
            and d >= 4 and h >= 4)


def conv3d_k3_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                    pre: Optional[torch.Tensor] = None,
                    add_to: Optional[torch.Tensor] = None,
                    emit_stats: bool = False,
                    negative_slope: float = 1e-2):
    """Plain PyTorch version of :func:`conv3d_k3`: the same math in fp32,
    output in ``x.dtype``."""
    xf = x.float()
    if pre is not None:
        u = xf * pre[:, 0, None, None, None, :] - pre[:, 1, None, None, None, :]
        xf = torch.where(u >= 0, u, u * negative_slope)
    y = F.conv3d(xf.permute(0, 4, 1, 2, 3), w.float().permute(4, 3, 0, 1, 2),
                 stride=stride, padding=1).permute(0, 2, 3, 4, 1)
    if add_to is not None:
        y = y + add_to.float()
    out = y.to(x.dtype).contiguous()
    if not emit_stats:
        return out
    stats = torch.stack([y.sum(dim=(1, 2, 3)), (y * y).sum(dim=(1, 2, 3))],
                        dim=1)
    return out, stats


def _fn(source: str = _KERNEL):
    """The C launcher of ``csrc/<source>.cu``, its argument types set."""
    fn = _lib_fns.get(source)
    if fn is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = getattr(_build.load(source), f"{source}_ndhwc_launch")
        fn.argtypes = {
            "conv3d_k3": [p, p, p, p, p, p] + [i] * 7 + [f, p],
            "conv3d_k3_dx": [p] * 8 + [i] * 7 + [f, p],
            "conv3d_k3_dw": [p] * 6 + [i] * 7 + [f, p],
            "conv3d_k3_s1": [p] * 7 + [i] * 8 + [f, p],
            "conv3d_k3_dw_s1": [p] * 6 + [i] * 7 + [f, p],
        }[source]
        fn.restype = i
        _lib_fns[source] = fn
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, device,
           fn: str = "conv3d_k3") -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def conv3d_k3(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              pre: Optional[torch.Tensor] = None,
              add_to: Optional[torch.Tensor] = None,
              emit_stats: bool = False, negative_slope: float = 1e-2):
    """y = conv3d(x, w) (3x3x3, pad 1, ``stride`` 1 or 2), with the
    optional pre-op, add-in and stats described in the module docstring.
    Returns ``y`` or ``(y, stats)``."""
    if x.device.type == "cpu":
        return conv3d_k3_plain(x, w, stride, pre, add_to, emit_stats,
                               negative_slope)
    _build.check_no_grad("conv3d_k3", x, w, pre, add_to)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_k3: unsupported device {x.device}")
    if stride not in (1, 2) or x.dim() != 5 or w.dim() != 5:
        raise ValueError("conv3d_k3: needs 5-D x and w and stride 1 or 2")
    n, d, h, wd, ci = x.shape
    co = w.shape[-1]
    if ci % 32 or co % 32:
        raise ValueError(f"conv3d_k3: channels {ci}->{co} not multiples of 32")
    dev = x.device
    bf16 = torch.bfloat16
    _check(x, "x", bf16, (n, d, h, wd, ci), dev)
    _check(w, "w", bf16, (3, 3, 3, ci, co), dev)
    _aligned("conv3d_k3", x=x, w=w, add_to=add_to)
    do, ho, wo = ((s - 1) // stride + 1 for s in (d, h, wd))
    if pre is not None:
        _check(pre, "pre", torch.float32, (n, 2, ci), dev)
    if add_to is not None:
        _check(add_to, "add_to", bf16, (n, do, ho, wo, co), dev)
    y = torch.empty((n, do, ho, wo, co), dtype=bf16, device=dev)
    stats = (torch.zeros((n, 2, co), dtype=torch.float32, device=dev)
             if emit_stats else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if stride == 1:
            plan = _s1_plan(n, (d, h, wd), ci, co, _sm_count(dev))
            part = (torch.zeros((n, d, h, wd, co), dtype=torch.float32,
                                device=dev) if plan["splits"] > 1 else None)
            rc = _fn("conv3d_k3_s1")(
                x.data_ptr(), w.data_ptr(), _ptr(pre), _ptr(add_to),
                y.data_ptr(), _ptr(stats), _ptr(part), n, d, h, wd, ci, co,
                plan["splits"], plan["grid"], negative_slope, stream)
        else:
            rc = _fn()(x.data_ptr(), w.data_ptr(), _ptr(pre), _ptr(add_to),
                       y.data_ptr(), _ptr(stats), n, d, h, wd, ci, co, stride,
                       negative_slope, stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_k3: kernel launch failed, CUDA error {rc}")
    _build.count(f"{_KERNEL}_s{stride}", (ci, co, d, h, wd),
                 pre=pre is not None, addin=add_to is not None,
                 stats=emit_stats)
    return (y, stats) if emit_stats else y


def _nc(t: torch.Tensor) -> torch.Tensor:
    """NDHWC -> NCDHW view."""
    return t.permute(0, 4, 1, 2, 3)


def _bc(v: torch.Tensor) -> torch.Tensor:
    """(N, C) -> broadcastable over (N, D, H, W, C)."""
    return v[:, None, None, None, :]


def _leaky(u: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(u >= 0, u, u * slope)


def _corrected(gy: torch.Tensor, y: Optional[torch.Tensor],
               gs: Optional[torch.Tensor]) -> torch.Tensor:
    """``gy + gs[0] + 2 * y * gs[1]`` in fp32: d(sum)/dy = 1 and
    d(sumsq)/dy = 2y fold the stats' cotangent into the output's (JAX
    ``_stats_grad_correction``)."""
    g = gy.float()
    if gs is not None:
        g = g + _bc(gs[:, 0]) + 2.0 * y.float() * _bc(gs[:, 1])
    return g


def _dx_size(gy: torch.Tensor, stride: int, x: Optional[torch.Tensor],
             size) -> tuple:
    """Spatial extent of dx: ``size``, else x's, else ``stride`` times
    gy's (a stride-2 conv of an even extent)."""
    if size is not None:
        return tuple(size)
    if x is not None:
        return tuple(x.shape[1:4])
    return tuple(stride * s for s in gy.shape[1:4])


def _check_corr(y, gs, x, pre, fn: str) -> None:
    if (y is None) != (gs is None):
        raise ValueError(f"{fn}: y and gs come together (the correction)")
    if pre is not None and x is None:
        raise ValueError(f"{fn}: pre needs x, the forward's raw input")


def conv3d_k3_dx_plain(gy: torch.Tensor, w: torch.Tensor, stride: int = 1,
                       y: Optional[torch.Tensor] = None,
                       gs: Optional[torch.Tensor] = None,
                       x: Optional[torch.Tensor] = None,
                       pre: Optional[torch.Tensor] = None, size=None,
                       negative_slope: float = 1e-2):
    """Plain PyTorch version of :func:`conv3d_k3_dx` in fp32: the
    transposed conv of the (corrected) cotangent, then the pre-op's
    backward."""
    _check_corr(y, gs, x, pre, "conv3d_k3_dx")
    n, ci = gy.shape[0], w.shape[3]
    g = _corrected(gy, y, gs)
    gxn = torch.nn.grad.conv3d_input(
        (n, ci) + _dx_size(gy, stride, x, size),
        w.float().permute(4, 3, 0, 1, 2), _nc(g), stride=stride,
        padding=1).permute(0, 2, 3, 4, 1)
    if pre is None:
        return gxn.to(gy.dtype).contiguous()
    xf = x.float()
    scale = _bc(pre[:, 0])
    u = xf * scale - _bc(pre[:, 1])
    du = gxn * torch.where(u >= 0, 1.0, negative_slope)
    dst = torch.stack([(du * xf).sum(dim=(1, 2, 3)), du.sum(dim=(1, 2, 3))],
                      dim=1)
    return (du * scale).to(gy.dtype).contiguous(), dst


def conv3d_k3_dw_plain(x: torch.Tensor, gy: torch.Tensor, stride: int = 1,
                       pre: Optional[torch.Tensor] = None,
                       y: Optional[torch.Tensor] = None,
                       gs: Optional[torch.Tensor] = None,
                       negative_slope: float = 1e-2) -> torch.Tensor:
    """Plain PyTorch version of :func:`conv3d_k3_dw` in fp32."""
    _check_corr(y, gs, x, pre, "conv3d_k3_dw")
    xin = x.float()
    if pre is not None:
        xin = _leaky(xin * _bc(pre[:, 0]) - _bc(pre[:, 1]), negative_slope)
    ci, co = x.shape[-1], gy.shape[-1]
    dw = torch.nn.grad.conv3d_weight(_nc(xin), (co, ci, 3, 3, 3),
                                     _nc(_corrected(gy, y, gs)),
                                     stride=stride, padding=1)
    return dw.permute(2, 3, 4, 1, 0).contiguous()


def _aligned(fn: str, **tensors) -> None:
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be 16-byte aligned")


def _bwd_args(fn, gy, stride, y, gs, x, pre, d, h, wd, ci):
    """Check the operands of a backward kernel; returns (n, co)."""
    if gy.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {gy.device}")
    if stride not in (1, 2) or gy.dim() != 5:
        raise ValueError(f"{fn}: needs a 5-D gy and stride 1 or 2")
    n, co = gy.shape[0], gy.shape[-1]
    if ci % 32 or co % 32:
        raise ValueError(f"{fn}: channels {ci}->{co} not multiples of 32")
    dev, bf16 = gy.device, torch.bfloat16
    out = (n,) + tuple((s - 1) // stride + 1 for s in (d, h, wd)) + (co,)
    _check(gy, "gy", bf16, out, dev, fn)
    if y is not None:
        _check(y, "y", bf16, out, dev, fn)
        _check(gs, "gs", torch.float32, (n, 2, co), dev, fn)
    if x is not None:
        _check(x, "x", bf16, (n, d, h, wd, ci), dev, fn)
    if pre is not None:
        _check(pre, "pre", torch.float32, (n, 2, ci), dev, fn)
    _aligned(fn, gy=gy, y=y, x=x)
    return n, co


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


# tiles of the stride-1 tensor-core kernels (csrc/conv3d_k3_s1.cu and
# csrc/conv3d_k3_dw_s1.cu): a forward unit is a brick of S1_BRICK output
# voxels x 32 output channels x a range of 16-channel Ci chunks; a dW block
# is all 27 taps of a 32 x 32 (ci, co) tile over a range of DW_BRICK voxel
# bricks
S1_BRICK, S1_CT, S1_KC = (4, 8, 8), 32, 16
DW_BRICK, DW_CT = (2, 8, 8), 32
_SMS: Dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _bricks(size, brick) -> Tuple[int, ...]:
    return tuple(-(-s // b) for s, b in zip(size, brick))


def _s1_plan(n: int, size, ci: int, co: int, sms: int) -> dict:
    """The launch of the stride-1 forward kernel: ``units`` = splits x
    output channel tiles x samples x bricks, walked by ``grid`` persistent
    blocks (about two per SM). Where the units of an unsplit K (bricks x
    tiles) are fewer than two per SM, K is split: each of ``splits`` units
    of a brick and tile takes an equal range of ``chunks`` of the Ci / 16
    chunks (``splits`` a divisor of it), with all 27 taps. The kernel
    decodes unit u = ((split * tiles + tile) * n + sample) * bricks +
    brick, brick = (bd * nbh + bh) * nbw + bw, and block b takes units
    [b * units / grid, (b + 1) * units / grid)."""
    base = math.prod(_bricks(size, S1_BRICK)) * n * (co // S1_CT)
    nc = ci // S1_KC
    splits = 1
    if base < 2 * sms:
        splits = next((s for s in range(1, nc + 1)
                       if nc % s == 0 and base * s >= 2 * sms), nc)
    units = base * splits
    return dict(splits=splits, units=units, grid=min(units, 2 * sms),
                chunks=nc // splits)


def _dw_s1_plan(n: int, size, ci: int, co: int, sms: int) -> dict:
    """The launch of the stride-1 dW kernel: ``tiles`` (ci, co) tiles of
    32 x 32, each over ``splits`` ranges of the voxel bricks, so that
    tiles x splits blocks (one per SM at a time) fill the SMs once where
    the tiles alone do not. The kernel decodes block = split * tiles +
    tile, tile = (ci / 32) * (co / 32 tiles) + co / 32; split s takes
    bricks [s * bricks / splits, (s + 1) * bricks / splits), brick =
    ((sample * nbd + bd) * nbh + bh) * nbw + bw."""
    tiles = (ci // DW_CT) * (co // DW_CT)
    bricks = n * math.prod(_bricks(size, DW_BRICK))
    splits = max(1, min(bricks, sms // tiles))
    return dict(tiles=tiles, splits=splits, blocks=tiles * splits,
                bricks=bricks)


def conv3d_k3_dx(gy: torch.Tensor, w: torch.Tensor, stride: int = 1,
                 y: Optional[torch.Tensor] = None,
                 gs: Optional[torch.Tensor] = None,
                 x: Optional[torch.Tensor] = None,
                 pre: Optional[torch.Tensor] = None, size=None,
                 negative_slope: float = 1e-2):
    """dx of ``conv3d_k3`` from the output cotangent gy (N, Do, Ho, Wo, Co):
    the transposed conv with the flipped, transposed weights. ``y`` and
    ``gs`` (N, 2, Co) apply the correction; ``x`` and ``pre`` (N, 2, Ci)
    take dx through the pre-op. ``size``: dx's spatial extent when neither
    x nor ``stride * gy`` gives it. Returns dx (N, D, H, W, Ci) in gy's
    dtype, or with ``pre`` ``(dx, dst)``, dst (N, 2, Ci) fp32
    [sum du * x; sum du] with du the cotangent of the pre-op's output
    before its activation (so d scale = dst[0], d shift = -dst[1])."""
    if gy.device.type == "cpu":
        return conv3d_k3_dx_plain(gy, w, stride, y, gs, x, pre, size,
                                  negative_slope)
    fn = "conv3d_k3_dx"
    _check_corr(y, gs, x, pre, fn)
    _build.check_no_grad(fn, gy, w, y, gs, x, pre)
    d, h, wd = _dx_size(gy, stride, x, size)
    if w.dim() != 5:
        raise ValueError(f"{fn}: needs a 5-D w")
    ci = w.shape[3]
    n, co = _bwd_args(fn, gy, stride, y, gs, x if pre is not None else None,
                      pre, d, h, wd, ci)
    dev = gy.device
    _check(w, "w", torch.bfloat16, (3, 3, 3, ci, co), dev, fn)
    dx = torch.empty((n, d, h, wd, ci), dtype=torch.bfloat16, device=dev)
    dst = (torch.zeros((n, 2, ci), dtype=torch.float32, device=dev)
           if pre is not None else None)
    with torch.cuda.device(dev):
        rc = _fn(fn)(gy.data_ptr(), w.data_ptr(), _ptr(y), _ptr(gs),
                     _ptr(x if pre is not None else None), _ptr(pre),
                     dx.data_ptr(), _ptr(dst), n, d, h, wd, ci, co, stride,
                     negative_slope, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed, CUDA error {rc}")
    _build.count(f"{fn}_s{stride}", (ci, co, d, h, wd), corr=y is not None,
                 post=pre is not None)
    return (dx, dst) if pre is not None else dx


def conv3d_k3_dw(x: torch.Tensor, gy: torch.Tensor, stride: int = 1,
                 pre: Optional[torch.Tensor] = None,
                 y: Optional[torch.Tensor] = None,
                 gs: Optional[torch.Tensor] = None,
                 negative_slope: float = 1e-2) -> torch.Tensor:
    """dW of ``conv3d_k3``: (3, 3, 3, Ci, Co) fp32, the correlation of the
    (pre-op'd, zero-padded) input x (N, D, H, W, Ci) with the (corrected)
    cotangent gy (N, Do, Ho, Wo, Co), summed over all samples and voxels."""
    if x.device.type == "cpu":
        return conv3d_k3_dw_plain(x, gy, stride, pre, y, gs, negative_slope)
    fn = "conv3d_k3_dw"
    _check_corr(y, gs, x, pre, fn)
    _build.check_no_grad(fn, x, gy, pre, y, gs)
    if x.dim() != 5:
        raise ValueError(f"{fn}: needs a 5-D x")
    d, h, wd, ci = x.shape[1:]
    n, co = _bwd_args(fn, gy, stride, y, gs, x, pre, d, h, wd, ci)
    dev = gy.device
    dw = torch.zeros((3, 3, 3, ci, co), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if stride == 1:
            plan = _dw_s1_plan(n, (d, h, wd), ci, co, _sm_count(dev))
            rc = _fn("conv3d_k3_dw_s1")(
                x.data_ptr(), gy.data_ptr(), _ptr(pre), _ptr(y), _ptr(gs),
                dw.data_ptr(), n, d, h, wd, ci, co, plan["splits"],
                negative_slope, stream)
        else:
            rc = _fn(fn)(x.data_ptr(), gy.data_ptr(), _ptr(pre), _ptr(y),
                         _ptr(gs), dw.data_ptr(), n, d, h, wd, ci, co, stride,
                         negative_slope, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed, CUDA error {rc}")
    _build.count(f"{fn}_s{stride}", (ci, co, d, h, wd), pre=pre is not None,
                 corr=y is not None)
    return dw


class Conv3dK3Fn(torch.autograd.Function):
    """``(y, stats) = conv3d_k3(x, w, stride, pre, emit_stats=True)`` with
    the backward of the JAX ``custom_vjp``s ``conv3d_packed_stats`` (no
    pre), ``conv3d_packed_ns`` (pre) and ``conv3d_s2_packed`` (stride 2):
    dx and dW through the kernels, each building the corrected cotangent
    ``gy + gs[0] + 2 * y * gs[1]`` as it stages it, and for ``pre`` the
    vector ``[sum du * x; -sum du]`` (``_ns_bwd``, pallas_conv.py:1304).
    Gradients go on from ``pre`` and ``stats`` through
    ``stats_to_scale_shift`` by plain autograd, as in JAX.

    On the CPU the wrappers run their plain versions, so this runs (and is
    tested) there too."""

    @staticmethod
    def forward(ctx, x, w, pre, stride, negative_slope):
        y, stats = conv3d_k3(x, w, stride, pre=pre, emit_stats=True,
                             negative_slope=negative_slope)
        ctx.save_for_backward(x, w, pre, y)
        ctx.stride, ctx.slope = stride, negative_slope
        return y, stats

    @staticmethod
    def backward(ctx, gy, gs):
        x, w, pre, y = ctx.saved_tensors
        gy = gy.to(y.dtype).contiguous()
        gs = gs.float().contiguous()
        s, slope = ctx.stride, ctx.slope
        dx = dw = dpre = None
        if pre is not None:
            dx, dst = conv3d_k3_dx(gy, w, s, y, gs, x, pre,
                                   negative_slope=slope)
            dpre = torch.stack([dst[:, 0], -dst[:, 1]], dim=1)
        elif ctx.needs_input_grad[0]:
            dx = conv3d_k3_dx(gy, w, s, y, gs, size=x.shape[1:4])
        if ctx.needs_input_grad[1]:
            dw = conv3d_k3_dw(x, gy, s, pre, y, gs, slope).to(w.dtype)
        return dx, dw, dpre, None, None


class Conv3dK3PairFn(torch.autograd.Function):
    """The decoder's split-weight pair ``conv(x1, w[..., :c1, :]) +
    conv(x2, w[..., c1:, :])`` returning ``(y, stats)``: the second half's
    kernel adds the first half's output and takes the statistics of the
    sum. Backward of the JAX ``conv3d_packed_dual_stats`` (``_dual_bwd``,
    pallas_conv.py:1365): dx twice and dW twice from one corrected
    cotangent that each kernel builds as it stages it, never written to
    memory."""

    @staticmethod
    def forward(ctx, x1, x2, w, stride):
        c1 = x1.shape[-1]
        y1 = conv3d_k3(x1, w[..., :c1, :].contiguous(), stride)
        y, stats = conv3d_k3(x2, w[..., c1:, :].contiguous(), stride,
                             add_to=y1, emit_stats=True)
        ctx.save_for_backward(x1, x2, w, y)
        ctx.stride = stride
        return y, stats

    @staticmethod
    def backward(ctx, gy, gs):
        x1, x2, w, y = ctx.saved_tensors
        gy = gy.to(y.dtype).contiguous()
        gs = gs.float().contiguous()
        s, c1 = ctx.stride, x1.shape[-1]
        halves = ((x1, w[..., :c1, :].contiguous()),
                  (x2, w[..., c1:, :].contiguous()))
        dx1, dx2 = (conv3d_k3_dx(gy, wh, s, y, gs, size=xh.shape[1:4])
                    for xh, wh in halves)
        dw = None
        if ctx.needs_input_grad[2]:
            dw = torch.cat([conv3d_k3_dw(xh, gy, s, y=y, gs=gs)
                            for xh, _ in halves], dim=-2).to(w.dtype)
        return dx1, dx2, dw, None
