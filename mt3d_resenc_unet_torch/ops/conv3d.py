"""3x3x3 pad-1 conv on NDHWC, stride 1 or 2, with the fused instance-norm
hooks of the JAX package's Pallas convs, and its backward.

Three CUDA kernels, each behind a wrapper with a plain PyTorch version of
the same function beside it (the wrapper runs the plain version for CPU
tensors; the tests and ``chip_smoke.py`` hold the kernel against it). A
CUDA tensor always goes to the kernel, or the wrapper raises.

  ``conv3d_k3``     the forward: at stride 1 csrc/conv3d_k3_s1.cu,
                    replacing ``mt3d_resenc_unet_tpu/ops/pallas_conv.py::
                    _conv_kernel``; at stride 2 csrc/conv3d_k3_s2.cu,
                    replacing ``::_s2_fwd_kernel``;
  ``conv3d_k3_dx``  the input gradient: at stride 1 csrc/conv3d_k3_dx_s1.cu,
                    replacing ``_conv_kernel`` in its corr/post mode
                    (``_conv3d_dx_fused_f``); at stride 2
                    csrc/conv3d_k3_dx_s2.cu, replacing ``_s2_dx_kernel``;
  ``conv3d_k3_dw``  the weight gradient: at stride 1 csrc/conv3d_k3_dw_s1.cu,
                    replacing ``_dw_kernel``; at stride 2
                    csrc/conv3d_k3_dw_s2.cu, replacing ``_s2_dw_kernel``.

At compute dtype float32 the same three wrappers launch the kernels of
csrc/conv3d_k3_f32_fwd.cu (the forward), csrc/conv3d_k3_f32_dx.cu (dx) and
csrc/conv3d_k3_f32_dw.cu (dW), which replace the same Pallas kernels as the
JAX package runs them in fp32: implicit GEMMs on the FP64 tensor cores at
fp32 accuracy, with every fusion of the bf16 kernels. The forward and dx
stage halo'd input (cotangent) bricks once a channel chunk, as the bf16
kernels do, tiled by :func:`_f32_fwd_plan` and :func:`_f32_dx_plan`; dW
stages each output brick's input footprint and cotangent once for all 27
taps of a channel tile, tiled by :func:`_f32_dw_plan`. Their
launches count under the bf16 kernel's name with ``_f32`` after it, the
name of their entry (``conv3d_k3_s1_f32``, ``conv3d_k3_dx_s2_f32``, ...).

At compute dtype float16 the six tensor-core kernels below run as they run
bf16, instantiated on ``__half`` (csrc/b16.cuh: the fp16 MMA and
conversions, the same tiles and plans); their launches count under the
bf16 name with ``_f16`` after it (``conv3d_k3_s1_f16``, ...).

The six bf16 kernels are implicit GEMMs on the tensor cores and take their
tiling from the planners :func:`_s1_plan`, :func:`_s2_plan`,
:func:`_dx_s1_plan`, :func:`_dx_s2_plan`, :func:`_dw_s1_plan` and
:func:`_dw_s2_plan` here; the kernels decode their block indices as the
planners' docstrings say. The stride-2 forward and dW stage their input by
parity as :func:`s2_row` lays it out; the stride-2 dx stages its cotangent
footprint as :func:`dx_s2_row` does and runs each parity class's taps
(:func:`dx_s2_taps`). Every kernel sums
across blocks and warps in a fixed order (no atomics), through scratch the
wrapper allocates: two runs on the same inputs give bit-equal outputs,
statistics, dW and [sum du*x; sum du].

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


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' working precision: fp32, or fp64 for
    an fp64 tensor (so a caller can evaluate them exactly as a
    yardstick)."""
    return t if t.dtype == torch.float64 else t.float()


def conv3d_k3_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                    pre: Optional[torch.Tensor] = None,
                    add_to: Optional[torch.Tensor] = None,
                    emit_stats: bool = False,
                    negative_slope: float = 1e-2):
    """Plain PyTorch version of :func:`conv3d_k3`: the same math in fp32
    (fp64 for an fp64 x), output in ``x.dtype``."""
    xf = _wide(x)
    if pre is not None:
        pre = pre.to(xf.dtype)
        u = xf * pre[:, 0, None, None, None, :] - pre[:, 1, None, None, None, :]
        xf = torch.where(u >= 0, u, u * negative_slope)
    y = F.conv3d(xf.permute(0, 4, 1, 2, 3),
                 w.to(xf.dtype).permute(4, 3, 0, 1, 2),
                 stride=stride, padding=1).permute(0, 2, 3, 4, 1)
    if add_to is not None:
        y = y + add_to.to(xf.dtype)
    out = y.to(x.dtype).contiguous()
    if not emit_stats:
        return out
    stats = torch.stack([y.sum(dim=(1, 2, 3)), (y * y).sum(dim=(1, 2, 3))],
                        dim=1)
    return out, stats


def _fn(source: str):
    """The C launcher of ``csrc/<source>.cu``, its argument types set."""
    fn = _lib_fns.get(source)
    if fn is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = getattr(_build.load(source), f"{source}_ndhwc_launch")
        fn.argtypes = {
            "conv3d_k3_dx_s1": [p] * 9 + [i] * 8 + [f, i, p],
            "conv3d_k3_dx_s2": [p] * 9 + [i] * 7 + [f, i, p],
            "conv3d_k3_s1": [p] * 7 + [i] * 8 + [f, i, p],
            "conv3d_k3_s2": [p] * 7 + [i] * 7 + [f, i, p],
            "conv3d_k3_dw_s1": [p] * 7 + [i] * 7 + [f, i, p],
            "conv3d_k3_dw_s2": [p] * 7 + [i] * 7 + [f, i, p],
        }[source]
        fn.restype = i
        _lib_fns[source] = fn
    return fn


def _kernel_dtype(fn: str, t: torch.Tensor) -> torch.dtype:
    """The dtype of ``t`` if a kernel takes it (bf16, fp16 or fp32), else
    raise: a CUDA tensor never falls back to the plain version."""
    if t.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{fn}: the kernels take bf16, fp16 or fp32, not "
                         f"{t.dtype}")
    return t.dtype


def _f32_fn(kind: str):
    """The C launcher ``conv3d_k3_f32_<kind>_launch``, its argument types
    set: the forward's of csrc/conv3d_k3_f32_fwd.cu, dx's of
    csrc/conv3d_k3_f32_dx.cu, dW's of csrc/conv3d_k3_f32_dw.cu."""
    key = f"f32_{kind}"
    fn = _lib_fns.get(key)
    if fn is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib = _build.load({"fwd": F32_FWD_SOURCE, "dx": F32_DX_SOURCE,
                           "dw": F32_DW_SOURCE}[kind])
        fn = getattr(lib, f"conv3d_k3_f32_{kind}_launch")
        fn.argtypes = {"fwd": [p] * 8 + [i] * 10 + [f, p],
                       "dx": [p] * 10 + [i] * 11 + [f, p],
                       "dw": [p] * 7 + [i] * 11
                       + [ctypes.c_longlong, i, f, p]}[kind]
        fn.restype = i
        _lib_fns[key] = fn
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
    dt = _kernel_dtype("conv3d_k3", x)
    _check(x, "x", dt, (n, d, h, wd, ci), dev)
    _check(w, "w", dt, (3, 3, 3, ci, co), dev)
    _aligned("conv3d_k3", x=x, w=w, add_to=add_to)
    do, ho, wo = ((s - 1) // stride + 1 for s in (d, h, wd))
    if pre is not None:
        _check(pre, "pre", torch.float32, (n, 2, ci), dev)
    if add_to is not None:
        _check(add_to, "add_to", dt, (n, do, ho, wo, co), dev)
    if dt == torch.float32:
        with torch.cuda.device(dev):
            out = _conv3d_k3_f32(x, w, stride, pre, add_to, emit_stats,
                                 negative_slope, _sm_count(dev),
                                 torch.cuda.current_stream(dev).cuda_stream)
        _build.count(f"{_KERNEL}_s{stride}_f32", (ci, co, d, h, wd),
                     pre=pre is not None, addin=add_to is not None,
                     stats=emit_stats)
        return out if emit_stats else out[0]
    y = torch.empty((n, do, ho, wo, co), dtype=dt, device=dev)
    stats = (torch.empty((n, 2, co), dtype=torch.float32, device=dev)
             if emit_stats else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if stride == 1:
            plan = _s1_plan(n, (d, h, wd), ci, co, _sm_count(dev),
                            emit_stats)
            part = (torch.empty(plan["scratch"], dtype=torch.float32,
                                device=dev) if plan["scratch"] else None)
            rc = _fn("conv3d_k3_s1")(
                x.data_ptr(), w.data_ptr(), _ptr(pre), _ptr(add_to),
                y.data_ptr(), _ptr(stats), _ptr(part), n, d, h, wd, ci, co,
                plan["splits"], plan["grid"], negative_slope,
                _build.DTYPE_CODES[dt], stream)
        else:
            plan = _s2_plan(n, (d, h, wd), ci, co, _sm_count(dev),
                            pre is not None)
            part = (torch.empty(plan["slots"], dtype=torch.float32,
                                device=dev) if emit_stats else None)
            rc = _fn("conv3d_k3_s2")(
                x.data_ptr(), w.data_ptr(), _ptr(pre), _ptr(add_to),
                y.data_ptr(), _ptr(stats), _ptr(part), n, d, h, wd, ci, co,
                plan["grid"], negative_slope, _build.DTYPE_CODES[dt], stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_k3: kernel launch failed, CUDA error {rc}")
    _build.count(f"{_KERNEL}_s{stride}{_build.SUFFIX[dt]}", (ci, co, d, h, wd),
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
    """``gy + gs[0] + 2 * y * gs[1]`` in fp32 (fp64 for an fp64 gy):
    d(sum)/dy = 1 and d(sumsq)/dy = 2y fold the stats' cotangent into the
    output's (JAX ``_stats_grad_correction``)."""
    g = _wide(gy)
    if gs is not None:
        gs = gs.to(g.dtype)
        g = g + _bc(gs[:, 0]) + 2.0 * y.to(g.dtype) * _bc(gs[:, 1])
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
    """Plain PyTorch version of :func:`conv3d_k3_dx` in fp32 (fp64 for an
    fp64 gy): the transposed conv of the (corrected) cotangent, then the
    pre-op's backward. The corrected cotangent is rounded to gy's dtype
    first, as the JAX kernel rounds it before its matrix unit
    (``_tile_corr_flat``, ``u.astype(gy_val.dtype)``): a no-op in fp32."""
    _check_corr(y, gs, x, pre, "conv3d_k3_dx")
    n, ci = gy.shape[0], w.shape[3]
    g = _wide(_corrected(gy, y, gs).to(gy.dtype))
    gxn = torch.nn.grad.conv3d_input(
        (n, ci) + _dx_size(gy, stride, x, size),
        w.to(g.dtype).permute(4, 3, 0, 1, 2), _nc(g), stride=stride,
        padding=1).permute(0, 2, 3, 4, 1)
    if pre is None:
        return gxn.to(gy.dtype).contiguous()
    xf = x.to(g.dtype)
    pre = pre.to(g.dtype)
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
    """Plain PyTorch version of :func:`conv3d_k3_dw` in fp32 (fp64 for an
    fp64 x). The corrected cotangent is rounded to gy's dtype first, as
    the JAX kernel rounds it before its matrix unit (``_dw_kernel``,
    ``.astype(gy_ref.dtype)``) and as :func:`conv3d_k3_dx_plain` does. At
    fp16 the flagship's ~2e-7 cotangents are subnormals, where that
    rounding moves dW by up to a quarter of its max abs (H100, the card
    tests' cases at cotangents of 2e-7)."""
    _check_corr(y, gs, x, pre, "conv3d_k3_dw")
    xin = _wide(x)
    if pre is not None:
        pre = pre.to(xin.dtype)
        xin = _leaky(xin * _bc(pre[:, 0]) - _bc(pre[:, 1]), negative_slope)
    ci, co = x.shape[-1], gy.shape[-1]
    g = _wide(_corrected(gy, y, gs).to(gy.dtype))
    dw = torch.nn.grad.conv3d_weight(_nc(xin), (co, ci, 3, 3, 3), _nc(g),
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
    dev, dt = gy.device, _kernel_dtype(fn, gy)
    out = (n,) + tuple((s - 1) // stride + 1 for s in (d, h, wd)) + (co,)
    _check(gy, "gy", dt, out, dev, fn)
    if y is not None:
        _check(y, "y", dt, out, dev, fn)
        _check(gs, "gs", torch.float32, (n, 2, co), dev, fn)
    if x is not None:
        _check(x, "x", dt, (n, d, h, wd, ci), dev, fn)
    if pre is not None:
        _check(pre, "pre", torch.float32, (n, 2, ci), dev, fn)
    _aligned(fn, gy=gy, y=y, x=x)
    return n, co


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


# tiles of the tensor-core kernels (csrc/conv3d_k3_s{1,2}.cu,
# csrc/conv3d_k3_dx_s{1,2}.cu and csrc/conv3d_k3_dw_s{1,2}.cu): a forward
# unit is a brick of S1_BRICK output voxels (S2_BRICK at stride 2,
# S2_PRE_BRICK with a pre-op) x 32 output channels x a range of 16-channel
# Ci chunks; a stride-1 dx unit a brick of DX1_BRICK dx voxels x 32 dx
# channels x a range of 16-channel Co chunks; a stride-2 dx unit a brick of
# DX2_BRICK cotangent voxels q (the 8 x as many dx voxels 2q + p) x 32 dx
# channels, all Co chunks; both dx kernels run one block of DX1_WARPS /
# DX2_WARPS warps per SM. A dW block is all 27 taps of a 32 x 32 (ci, co)
# tile over a range of DW_BRICK (output) voxel bricks
S1_BRICK, S1_CT, S1_KC = (4, 8, 8), 32, 16
S2_BRICK, S2_PRE_BRICK = (4, 8, 8), (2, 8, 8)
DX1_BRICK, DX1_WARPS = (8, 8, 8), 16
DX2_BRICK, DX2_WARPS = (2, 8, 8), 16
# the parity classes c = 4 p_d + 2 p_h + p_w whose tile the even and the odd
# warps of the stride-2 dx kernel own: 13 and 14 taps
DX2_CLASSES = ((0, 1, 2, 7), (3, 4, 5, 6))
DW_BRICK, DW_CT = (2, 8, 8), 32
S2_WARPS, S2_SLOT = 8, 64      # stats scratch: fp32 per unit and warp
S1_FIN_VOX = 64                # voxels per block of the split finish
_SMS: Dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _bricks(size, brick) -> Tuple[int, ...]:
    return tuple(-(-s // b) for s, b in zip(size, brick))


def _s1_plan(n: int, size, ci: int, co: int, sms: int,
             stats: bool = False) -> dict:
    """The launch of the stride-1 forward kernel: ``units`` = splits x
    output channel tiles x samples x bricks, walked by ``grid`` persistent
    blocks (about two per SM). Where the units of an unsplit K (bricks x
    tiles) are fewer than two per SM, K is split: each of ``splits`` units
    of a brick and tile takes an equal range of ``chunks`` of the Ci / 16
    chunks (``splits`` a divisor of it), with all 27 taps. The kernel
    decodes unit u = ((split * tiles + tile) * n + sample) * bricks +
    brick, brick = (bd * nbh + bh) * nbw + bw, and block b takes units
    [b * units / grid, (b + 1) * units / grid).

    ``scratch``: the fp32 floats of the kernel's scratch (0: none). Unsplit
    with ``stats``, the ``slots`` of [sum; sumsq]: one per group (tile,
    sample), written at the group's last unit, and one per block, written
    at its last unit where that is inside a group (:func:`s1_stat_slots`),
    S2_WARPS x S2_SLOT floats each. Split, one slice of n x voxels x co per
    split, then with ``stats`` the finish blocks' [sum; sumsq] slots, n x
    ceil(voxels / S1_FIN_VOX) x 2 x co."""
    return _split_k_plan(n, size, co // S1_CT, ci // S1_KC, S1_BRICK,
                         2 * sms, S2_WARPS, stats)


def _split_k_plan(n: int, size, tiles: int, nc: int, brick, blocks: int,
                  warps: int, sums: bool) -> dict:
    """The stride-1 forward's and dx's launch: units of a ``brick`` of
    voxels x one of ``tiles`` 32-wide output channel tiles x a sample, over
    the ``nc`` 16-channel chunks of K, split into ``splits`` (a divisor of
    ``nc``) where the unsplit units are fewer than ``blocks`` (the
    persistent blocks the card holds at once), walked by ``grid`` <=
    ``blocks`` blocks; ``scratch`` as :func:`_s1_plan` says, with ``warps``
    warps a block and, with ``sums``, the output's per-channel sums."""
    base = math.prod(_bricks(size, brick)) * n * tiles
    splits = 1
    if base < blocks:
        splits = next((s for s in range(1, nc + 1)
                       if nc % s == 0 and base * s >= blocks), nc)
    units = base * splits
    grid = min(units, blocks)
    vox, cout = math.prod(size), tiles * S1_CT
    if splits > 1:
        scratch = splits * n * vox * cout + (
            n * -(-vox // S1_FIN_VOX) * 2 * cout if sums else 0)
    else:
        scratch = (tiles * n + grid) * warps * S2_SLOT if sums else 0
    return dict(splits=splits, units=units, grid=grid, chunks=nc // splits,
                scratch=scratch)


def s1_stat_slots(units: int, grid: int, bricks: int) -> list:
    """The statistics slots the unsplit stride-1 forward writes, as (slot,
    group, first unit, last unit) in the order its stats kernel adds them
    per group: block b's flush at its last unit u inside group g = u //
    bricks goes to slot groups + b and covers its units of g; the flush at
    a group's last unit to slot g, covering the group's units from the
    start of the block that holds it."""
    groups = units // bricks
    starts = [b * units // grid for b in range(grid)]
    out = []
    for g in range(groups):
        for b in range(grid):
            last = (b + 1) * units // grid - 1
            if last // bricks == g and (last + 1) % bricks:
                out.append((groups + b, g, max(starts[b], g * bricks), last))
        end = (g + 1) * bricks - 1
        b = max(i for i in range(grid) if starts[i] <= end)
        out.append((g, g, max(starts[b], g * bricks), end))
    return out


def _s2_out(size) -> Tuple[int, ...]:
    return tuple((s - 1) // 2 + 1 for s in size)


def _s2_plan(n: int, size, ci: int, co: int, sms: int,
             pre: bool = False) -> dict:
    """The launch of the stride-2 forward kernel: ``units`` = output
    channel tiles x samples x bricks of ``brick`` output voxels (S2_BRICK,
    or S2_PRE_BRICK with a pre-op, whose second footprint needs the room),
    walked by ``grid`` persistent blocks, one per SM (a block's ring takes
    most of an SM's shared memory). The kernel decodes unit u = (tile * n
    + sample) * bricks + brick, brick = (bd * nbh + bh) * nbw + bw, and
    block b takes units [b * units / grid, (b + 1) * units / grid). With
    statistics, warp k of unit u writes its [sum; sumsq] to the ``slots``
    fp32 scratch at (u * S2_WARPS + k) * S2_SLOT."""
    brick = S2_PRE_BRICK if pre else S2_BRICK
    units = math.prod(_bricks(_s2_out(size), brick)) * n * (co // S1_CT)
    return dict(brick=brick, units=units, grid=min(units, sms),
                slots=units * S2_WARPS * S2_SLOT)


def s2_row(bd: int, parity, m) -> int:
    """The staged row of the stride-2 kernels' input footprint position
    (2 m_d + p_d, 2 m_h + p_h, 2 m_w + p_w), relative to 2 * (brick origin)
    - 1, for output bricks of bd x 8 x 8 (csrc/conv3d_k3_s2.cu ``frow``):
    8 sub-bricks, one per ``parity`` (p_d, p_h, p_w), in that order, each
    (d, h, w) row-major with b + 1 rows along an axis of b outputs at
    parity 0 and b at parity 1. Tap k reads parity (k == 1) at m = o - o0
    + (k == 2), so a tap's 8 consecutive output w are 8 consecutive
    rows."""
    bh, bw = S2_BRICK[1:]
    fh, fw = 2 * bh + 1, 2 * bw + 1
    pd, ph, pw = parity
    md, mh, mw = m
    eh, ew = bh + 1 - ph, bw + 1 - pw
    off = pd * (bd + 1) * fh * fw + (bd + 1 - pd) * (
        ph * (bh + 1) * fw + eh * pw * (bw + 1))
    return off + (md * eh + mh) * ew + mw


def _dw_s2_plan(n: int, size, ci: int, co: int, sms: int) -> dict:
    """The launch of the stride-2 dW kernel: :func:`_dw_s1_plan` over the
    output voxels (bricks of DW_BRICK output voxels, each staging its
    (2 * 2 + 1) x 17 x 17 input footprint). Every block stores its partial
    sums to its slice of a (splits, 27, Ci, Co) fp32 scratch, added in
    split order after."""
    return _dw_s1_plan(n, _s2_out(size), ci, co, sms)


def _dw_s1_plan(n: int, size, ci: int, co: int, sms: int) -> dict:
    """The launch of the stride-1 dW kernel: ``tiles`` (ci, co) tiles of
    32 x 32, each over ``splits`` ranges of the voxel bricks, so that
    tiles x splits blocks (one per SM at a time) fill the SMs once where
    the tiles alone do not. The kernel decodes block = split * tiles +
    tile, tile = (ci / 32) * (co / 32 tiles) + co / 32; split s takes
    bricks [s * bricks / splits, (s + 1) * bricks / splits), brick =
    ((sample * nbd + bd) * nbh + bh) * nbw + bw. Every block stores its
    partial sums to its slice of a (splits, 27, Ci, Co) fp32 scratch,
    added in split order after."""
    tiles = (ci // DW_CT) * (co // DW_CT)
    bricks = n * math.prod(_bricks(size, DW_BRICK))
    splits = max(1, min(bricks, sms // tiles))
    return dict(tiles=tiles, splits=splits, blocks=tiles * splits,
                bricks=bricks)


def _dx_s1_plan(n: int, size, ci: int, co: int, sms: int,
                post: bool = False) -> dict:
    """The launch of the stride-1 dx kernel: :func:`_s1_plan`'s scheme with
    the GEMM's N and K swapped (N = the Ci / 32 dx channel tiles, K = 27
    taps x the Co / 16 cotangent chunks), over bricks of DX1_BRICK dx
    voxels and one persistent block per SM, so K is split where the units
    of an unsplit K are fewer than the SMs. The kernel decodes unit u =
    ((split * tiles + tile) * n + sample) * bricks + brick, brick = (bd *
    nbh + bh) * nbw + bw, and block b takes units [b * units / grid, (b +
    1) * units / grid). ``scratch``: with ``post`` unsplit, the [sum du*x;
    sum du] slots of :func:`s1_stat_slots` (groups = tiles x samples),
    DX1_WARPS x S2_SLOT floats each; split, one slice of n x voxels x ci
    per split, then with ``post`` the finish blocks' slots, n x
    ceil(voxels / S1_FIN_VOX) x 2 x ci."""
    return _split_k_plan(n, size, ci // S1_CT, co // S1_KC, DX1_BRICK, sms,
                         DX1_WARPS, post)


def _dx_s2_plan(n: int, size, ci: int, co: int, sms: int,
                post: bool = False) -> dict:
    """The launch of the stride-2 dx kernel for a dx of extent ``size``:
    ``units`` = dx channel tiles x samples x bricks of DX2_BRICK cotangent
    voxels (over gy's extent, ``_s2_out(size)``), walked by ``grid``
    persistent blocks of DX2_WARPS warps (one per SM). The kernel decodes
    unit u = (tile * n + sample) * bricks + brick, brick = (bd * nbh + bh)
    * nbw + bw, and block b takes units [b * units / grid, (b + 1) * units
    / grid). With ``post``, warp k of unit u writes its [sum du*x; sum du]
    to the ``slots`` fp32 scratch at (u * DX2_WARPS + k) * S2_SLOT (0
    without)."""
    units = math.prod(_bricks(_s2_out(size), DX2_BRICK)) * n * (ci // S1_CT)
    return dict(units=units, grid=min(units, sms),
                slots=units * DX2_WARPS * S2_SLOT if post else 0)


def dx_s2_taps(parity) -> list:
    """The taps of the stride-2 dx kernel's parity class ``parity`` (p_d,
    p_h, p_w), in its order (csrc/conv3d_k3_dx_s2.cu ``class_tap``), as
    (tap (k_d, k_h, k_w), footprint shift (s_d, s_h, s_w)): dx voxel 2q + p
    takes tap k from cotangent q + s. Along an axis of parity 0 the one tap
    k = 1 at s = 0; of parity 1, by that axis's bit of the tap number (d,
    h, w from the lowest bit), k = 0 at s = 1 or k = 2 at s = 0."""
    out = []
    for t in range(1 << sum(parity)):
        k, s = [], []
        for p in parity:
            if not p:
                k.append(1)
                s.append(0)
                continue
            b, t = t & 1, t >> 1
            k.append(2 if b else 0)
            s.append(0 if b else 1)
        out.append((tuple(k), tuple(s)))
    return out


def dx_s2_row(m) -> int:
    """The staged row of cotangent footprint position (m_d, m_h, m_w),
    relative to the brick origin, 0 <= m <= DX2_BRICK per axis, in the
    stride-2 dx kernel (csrc/conv3d_k3_dx_s2.cu ``foot_inside``): row-major
    over the (b + 1)-wide footprint, so a tap's 8 consecutive q_w are 8
    consecutive rows at any shift."""
    _, fh, fw = (b + 1 for b in DX2_BRICK)
    md, mh, mw = m
    return (md * fh + mh) * fw + mw


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
    _check(w, "w", gy.dtype, (3, 3, 3, ci, co), dev, fn)
    post = pre is not None
    if gy.dtype == torch.float32:
        with torch.cuda.device(dev):
            out = _conv3d_k3_dx_f32(gy, w, stride, y, gs, x, pre,
                                    (d, h, wd), negative_slope, _sm_count(dev),
                                    torch.cuda.current_stream(dev).cuda_stream)
        _build.count(f"{fn}_s{stride}_f32", (ci, co, d, h, wd),
                     corr=y is not None, post=post)
        return out if post else out[0]
    dx = torch.empty((n, d, h, wd, ci), dtype=gy.dtype, device=dev)
    dst = (torch.empty((n, 2, ci), dtype=torch.float32, device=dev)
           if post else None)
    if stride == 1:
        plan = _dx_s1_plan(n, (d, h, wd), ci, co, _sm_count(dev), post)
        floats, tail = plan["scratch"], (plan["splits"], plan["grid"])
    else:
        plan = _dx_s2_plan(n, (d, h, wd), ci, co, _sm_count(dev), post)
        floats, tail = plan["slots"], (plan["grid"],)
    part = (torch.empty(floats, dtype=torch.float32, device=dev)
            if floats else None)
    with torch.cuda.device(dev):
        rc = _fn(f"{fn}_s{stride}")(
            gy.data_ptr(), w.data_ptr(), _ptr(y), _ptr(gs),
            _ptr(x if post else None), _ptr(pre), dx.data_ptr(), _ptr(dst),
            _ptr(part), n, d, h, wd, ci, co, *tail, negative_slope,
            _build.DTYPE_CODES[gy.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed, CUDA error {rc}")
    _build.count(f"{fn}_s{stride}{_build.SUFFIX[gy.dtype]}",
                 (ci, co, d, h, wd), corr=y is not None, post=post)
    return (dx, dst) if post else dx


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
    if gy.dtype == torch.float32:
        with torch.cuda.device(dev):
            dw = _conv3d_k3_dw_f32(x, gy, stride, pre, y, gs, negative_slope,
                                   _sm_count(dev),
                                   torch.cuda.current_stream(dev).cuda_stream)
        _build.count(f"{fn}_s{stride}_f32", (ci, co, d, h, wd),
                     pre=pre is not None, corr=y is not None)
        return dw
    dw = torch.empty((3, 3, 3, ci, co), dtype=torch.float32, device=dev)
    plan = (_dw_s1_plan if stride == 1 else _dw_s2_plan)(
        n, (d, h, wd), ci, co, _sm_count(dev))
    part = torch.empty((plan["splits"], 27, ci, co), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        rc = _fn(f"conv3d_k3_dw_s{stride}")(
            x.data_ptr(), gy.data_ptr(), _ptr(pre), _ptr(y), _ptr(gs),
            dw.data_ptr(), part.data_ptr(), n, d, h, wd, ci, co,
            plan["splits"], negative_slope, _build.DTYPE_CODES[gy.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed, CUDA error {rc}")
    _build.count(f"{fn}_s{stride}{_build.SUFFIX[gy.dtype]}",
                 (ci, co, d, h, wd), pre=pre is not None, corr=y is not None)
    return dw


# the fp32 forward (csrc/conv3d_k3_f32_fwd.cu): a unit is a brick of output
# voxels x bn output channels x a range of the Ci / F32_FWD_KC channel
# chunks; tile 0 ("big") everywhere, tile 1 ("small") at stride 1 where every
# output extent is at most 4 and Co % 64 == 0. One block an SM, 8 MMA warps
# and 4 producer warps; a step copies a halo brick (stride 1: once a chunk,
# (b + 2)^3 rows; stride 2: a parity class's sub-brick, at most (b + 1)^3
# rows) and its taps' weights (9, or at most 8) into 3-stage fp32 rings,
# which the producers convert once to the fp64 brick and weights the MMAs
# read. A split K's finish block takes F32_FIN_VOX voxels of a sample
F32_FWD_SOURCE = "conv3d_k3_f32_fwd"
F32_FWD_KC = 8
F32_FWD_TILES = {0: dict(brick=(4, 8, 8), bn=32, wgm=8),
                 1: dict(brick=(4, 4, 4), bn=64, wgm=4)}
F32_FWD_STAGES = 3
F32_FWD_PRODUCERS = 128
F32_FIN_VOX = 64


def f32_fwd_smem(tile: int, stride: int) -> int:
    """The dynamic shared memory (bytes) of an fp32 forward block: two
    (stride 2: three) fp64 halo bricks and weight steps (the MMA warps read
    one while the producer warps convert the next into another), the fp32
    rings the copies land in (weight rows padded by 4 floats), a word of
    inside bits a producer thread and ring stage, and the fp64 column sums
    of the MMA warps along M."""
    t = F32_FWD_TILES[tile]
    grow = 2 if stride == 1 else 1
    rows = math.prod(b + grow for b in t["brick"])
    taps = 9 if stride == 1 else 8
    kc, stages = F32_FWD_KC, F32_FWD_STAGES
    fp64 = (2 if stride == 1 else 3) * (rows * kc + taps * t["bn"] * kc)
    fp32 = stages * (rows * kc + taps * kc * (t["bn"] + 4))
    return (fp64 * 8 + fp32 * 4 + stages * F32_FWD_PRODUCERS * 4
            + t["wgm"] * 2 * t["bn"] * 8)


def _f32_fwd_plan(n: int, size, ci: int, co: int, stride: int,
                  sms: int) -> dict:
    """The launch of the fp32 forward: ``units`` = splits x ``ntiles``
    channel tiles x n samples x ``bricks`` (``nb`` per axis) output bricks,
    walked by ``grid`` persistent blocks, block b taking units [b * units /
    grid, (b + 1) * units / grid) (:func:`f32_fwd_unit` decodes one). Where
    the unsplit units are fewer than the SMs, K is split into ``splits``
    (a divisor of the ci / 8 chunks, ``cps`` a split) that least the
    chunks the busiest block walks, the fewest on a tie. Scratch: unsplit
    with statistics, ``slots`` fp64 = n x ``groups`` (the bricks) x 2 x co;
    split, ``part`` fp64 = splits x n x voxels x co, and with statistics
    the finish blocks' slots (``groups`` = ceil(voxels / F32_FIN_VOX))."""
    out = tuple((s - 1) // stride + 1 for s in size)
    tile = int(stride == 1 and co % 64 == 0 and max(out) <= 4)
    return dict(_f32_unit_plan(n, out, ci // F32_FWD_KC, co,
                               F32_FWD_TILES[tile], sms),
                tile=tile, smem=f32_fwd_smem(tile, stride))


def _f32_unit_plan(n: int, out, nch: int, co: int, t: dict,
                   sms: int) -> dict:
    """The units of the fp32 brick kernels (the forward and dx): tile ``t``
    over the ``out`` voxels of n samples and ``co`` output channels, K in
    ``nch`` chunks, split as :func:`_f32_fwd_plan` says."""
    nb = _bricks(out, t["brick"])
    bricks, ntiles = math.prod(nb), co // t["bn"]
    base = bricks * n * ntiles
    splits, best = 1, None
    for s in range(1, nch + 1):
        if nch % s or (s > 1 and base >= sms):
            continue
        units = base * s
        walk = -(-units // min(units, sms)) * (nch // s)
        if best is None or walk < best:
            splits, best = s, walk
    units = base * splits
    vox = math.prod(out)
    groups = -(-vox // F32_FIN_VOX) if splits > 1 else bricks
    return dict(brick=t["brick"], bn=t["bn"], nb=nb,
                bricks=bricks, ntiles=ntiles, splits=splits,
                cps=nch // splits, units=units, grid=min(units, sms),
                groups=groups, slots=n * groups * 2 * co,
                part=splits * n * vox * co if splits > 1 else 0)


def f32_fwd_unit(plan: dict, n: int, u: int) -> dict:
    """Unit u of an fp32 forward plan for n samples, as the kernel decodes
    it: u = ((split * ntiles + tile) * n + sample) * bricks + brick, brick
    = (bd * nbh + bh) * nbw + bw; its chunks [split * cps, (split + 1) *
    cps) and output brick origin."""
    b, r = u % plan["bricks"], u // plan["bricks"]
    sample, r = r % n, r // n
    tile, split = r % plan["ntiles"], r // plan["ntiles"]
    _, nbh, nbw = plan["nb"]
    bd, bh, bw = b // (nbh * nbw), b // nbw % nbh, b % nbw
    origin = tuple(i * e for i, e in zip((bd, bh, bw), plan["brick"]))
    return dict(split=split, tile=tile, sample=sample, brick=b,
                origin=origin, chunks=(split * plan["cps"],
                                       (split + 1) * plan["cps"]))


# the fp32 dx (csrc/conv3d_k3_f32_dx.cu): the forward's units transposed,
# a brick of dx voxels x bn dx channels x a range of the co / F32_FWD_KC
# cotangent chunks. Tiles: at stride 1 the forward's (0 "big", 1 "small"
# where ci % 64 == 0 and every dx extent is at most 4); at stride 2 tile 2,
# an 8^3 dx brick x 16 channels, twice the big tile's voxels for half its
# channels, so that each staged weight serves twice the rows. A stride-1
# chunk is 3 steps (one per kd) under one staged halo'd cotangent brick,
# (b + 2)^3 rows, in one fp32 slot (two under CORR, y's beside it); a
# stride-2 chunk one step, the (b / 2 + 1)^3 cotangent brick that serves
# all 8 parity classes and the 27 taps' weights. At stride 2 the 8 MMA warps
# take the classes of F32_DX_S2_CLASSES: pair p (warps 2p, 2p + 1, the two
# halves of each class's b / 2 planes q_d) multiplies its first m-tiles by
# class [p][0]'s taps and the others by class [p][1]'s (a class c = 4 p_d +
# 2 p_h + p_w)
F32_DX_SOURCE = "conv3d_k3_f32_dx"
F32_DX_TILES = {**F32_FWD_TILES, 2: dict(brick=(8, 8, 8), bn=16, wgm=8)}
F32_DX_S2_CLASSES = ((7, 0), (3, 1), (5, 2), (6, 4))


def f32_dx_smem(tile: int, corr: bool) -> int:
    """The dynamic shared memory (bytes) of an fp32 dx block of ``tile``
    (2: stride 2's): two fp64 cotangent bricks and weight steps (the MMA
    warps read one while the producer warps convert the next into the
    other), the fp32 slots the copies land in (the brick's: one at stride
    1, three at stride 2, twice that under CORR; the weights' three), a
    word of inside bits a producer thread and brick slot, and the fp64
    column sums of the MMA warps along M."""
    t = F32_DX_TILES[tile]
    if tile < 2:
        rows, taps, slots = math.prod(b + 2 for b in t["brick"]), 9, 1
    else:
        rows = math.prod(b // 2 + 1 for b in t["brick"])
        taps, slots = 27, F32_FWD_STAGES
    kc, bn = F32_FWD_KC, t["bn"]
    fp64 = 2 * (rows * kc + taps * bn * kc)
    fp32 = slots * rows * kc * (2 if corr else 1) + (
        F32_FWD_STAGES * taps * bn * kc)
    return (fp64 * 8 + fp32 * 4 + slots * F32_FWD_PRODUCERS * 4
            + t["wgm"] * 2 * bn * 8)


def _f32_dx_plan(n: int, size, ci: int, co: int, stride: int, sms: int,
                 corr: bool = False) -> dict:
    """The launch of the fp32 dx for a dx of extent ``size``: the forward's
    plan (:func:`_f32_fwd_plan`) over dx's voxels and its ci channels, K
    the co / 8 cotangent chunks: ``units`` = splits x ``ntiles`` x n x
    ``bricks`` dx bricks (:func:`f32_dx_unit` decodes one). Scratch: unsplit
    with the pre-op backward, ``slots`` fp64 = n x ``groups`` x 2 x ci of
    [sum du*x; sum du]; split, ``part`` fp64 = splits x n x voxels x ci,
    the slots then per finish block. ``smem``: :func:`f32_dx_smem` in the
    launch's mode (``corr``: with the correction)."""
    tile = 2 if stride == 2 else int(ci % 64 == 0 and max(size) <= 4)
    return dict(_f32_unit_plan(n, tuple(size), co // F32_FWD_KC, ci,
                               F32_DX_TILES[tile], sms),
                tile=tile, smem=f32_dx_smem(tile, corr))


def f32_dx_unit(plan: dict, n: int, u: int, stride: int) -> dict:
    """Unit u of an fp32 dx plan, decoded as :func:`f32_fwd_unit` decodes a
    forward unit (``origin``: the dx brick's), with ``gy_origin`` the
    cotangent voxel of its staged brick's first row: origin - 1 at stride
    1, origin / 2 at stride 2."""
    t = f32_fwd_unit(plan, n, u)
    t["gy_origin"] = tuple(o - 1 if stride == 1 else o // 2
                           for o in t["origin"])
    return t


# the fp32 dW (csrc/conv3d_k3_f32_dw.cu): a unit is all 27 taps of a ci x co
# tile (``ci`` x ``co`` channels of a tile) x a range of the batch's output
# bricks. One block an SM: 12 MMA warps, one per (kd, m-tile, n-tile) with
# its 9 (kh, kw) taps, and 4 producer warps; a step is one brick, its input
# footprint (stride 1 the halo'd (b + 2)^3 brick, stride 2 the (2b + 1)^3
# footprint by parity class) and cotangent rows (y's under CORR) copied
# into one of ``stages`` fp32 slots and converted once to one of two fp64
# buffers (the input's rows along w padded to a multiple of 4). Tiles: 0 at
# stride 1, 1 at stride 1 where every output extent is at most 4, 2 at
# stride 2 where co % 64 == 0 (64 co x 8 ci: a staged input element serves
# twice the MMAs of 32 x 16), 3 at stride 2 otherwise. A split K's finish
# block takes F32_DW_FIN_THREADS elements of dW; the planner counts a
# unit's epilogue (its 27 x ci x co sums stored) as F32_DW_EPILOGUE bricks
F32_DW_SOURCE = "conv3d_k3_f32_dw"
F32_DW_TILES = {0: dict(stride=1, brick=(2, 4, 8), co=32, ci=16, stages=3),
                1: dict(stride=1, brick=(4, 4, 4), co=32, ci=16, stages=3),
                2: dict(stride=2, brick=(2, 2, 8), co=64, ci=8, stages=3),
                3: dict(stride=2, brick=(2, 2, 8), co=32, ci=16, stages=2)}
F32_DW_FIN_THREADS = 256
F32_DW_EPILOGUE = 2
F32_DW_PRODUCERS = 128


def f32_dw_regions(tile: int) -> list:
    """The input regions an fp32 dW step stages, as
    csrc/conv3d_k3_f32_dw.cu lays them out (``Cfg::ext``, ``Cfg::base``):
    (first fp64 row, extent (e_d, e_h, e_w), padded row length along w,
    offset o of the input voxel S * (o0 + r) + o of row r along each axis).
    Stride 1: the halo'd brick; stride 2: the parity classes c = 4 p_d + 2
    p_h + p_w in order, an odd axis (p = 1) one row longer, from 2 o0 - 1.
    Rows along w are padded to a multiple of 4 in the fp64 buffers."""
    t = F32_DW_TILES[tile]
    out, base = [], 0
    for c in range(1 if t["stride"] == 1 else 8):
        if t["stride"] == 1:
            ext, off = tuple(b + 2 for b in t["brick"]), (-1, -1, -1)
        else:
            par = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
            ext = tuple(b + p for b, p in zip(t["brick"], par))
            off = tuple(-p for p in par)
        pad = -(-ext[2] // 4) * 4
        out.append((base, ext, pad, off))
        base += ext[0] * ext[1] * pad
    return out


def f32_dw_smem(tile: int, corr: bool) -> int:
    """The dynamic shared memory (bytes) of an fp32 dW block of ``tile``:
    two fp64 input bricks (padded rows) and cotangent bricks (the MMA warps
    read one while the producer warps convert the next into the other),
    the ``stages`` fp32 slots the copies land in (the input's real rows,
    the cotangent's, PRE's [scale; shift] and CORR's [gs0; gs1] of the
    tile's channels), a word of inside bits a producer thread and slot, and
    under CORR the stages' y slots."""
    t = F32_DW_TILES[tile]
    regions = f32_dw_regions(tile)
    padded = sum(e[0] * e[1] * p for _, e, p, _ in regions)
    real = sum(math.prod(e) for _, e, _, _ in regions)
    gf = math.prod(t["brick"]) * t["co"]
    slot = real * t["ci"] + gf + 2 * (t["ci"] + t["co"])
    return (2 * (padded * t["ci"] + gf) * 8
            + t["stages"] * (slot + F32_DW_PRODUCERS) * 4
            + (t["stages"] * gf * 4 if corr else 0))


def _f32_dw_plan(n: int, size, ci: int, co: int, stride: int, sms: int,
                 corr: bool = False) -> dict:
    """The launch of the fp32 dW for an input of extent ``size``: ``units``
    = splits x ``ntiles`` (ci / tile ci x co / tile co) tiles, each unit a
    tile's 27 taps over one split's range of the batch's ``bricks`` output
    bricks (``nb`` per axis of a sample; :func:`f32_dw_unit` decodes a
    unit), walked by ``grid`` persistent blocks, block b taking units [b *
    units / grid, (b + 1) * units / grid). ``splits`` (at most ``sms``)
    least the busiest block's walk, counting a unit's epilogue as
    F32_DW_EPILOGUE bricks (the fewest splits on a tie). Split, each
    unit stores its fp64 sums to its split's slice of ``part`` = splits x
    27 x ci x co doubles, added by ``fin_grid`` finish blocks. ``smem``:
    :func:`f32_dw_smem` in the launch's mode (``corr``)."""
    out = tuple((s - 1) // stride + 1 for s in size)
    if stride == 1:
        tile = int(max(out) <= 4)
    else:
        tile = 2 if co % 64 == 0 else 3
    t = F32_DW_TILES[tile]
    nb = _bricks(out, t["brick"])
    bricks = n * math.prod(nb)
    ntci, ntco = ci // t["ci"], co // t["co"]
    ntiles = ntci * ntco
    splits, best = 1, None
    for s in range(1, min(bricks, sms) + 1):
        units = ntiles * s
        walk = -(-units // min(units, sms)) * (-(-bricks // s)
                                                + F32_DW_EPILOGUE)
        if best is None or walk < best:
            splits, best = s, walk
    units = ntiles * splits
    length = 27 * ci * co
    return dict(tile=tile, brick=t["brick"], ci=t["ci"], co=t["co"], nb=nb,
                bricks=bricks, ntci=ntci, ntco=ntco, ntiles=ntiles,
                splits=splits, units=units, grid=min(units, sms),
                part=splits * length if splits > 1 else 0,
                fin_grid=(-(-length // F32_DW_FIN_THREADS) if splits > 1
                          else 0),
                smem=f32_dw_smem(tile, corr))


def f32_dw_unit(plan: dict, u: int) -> dict:
    """Unit u of an fp32 dW plan, as the kernel decodes it: u = (split *
    ntco + co tile) * ntci + ci tile, its first ci and co channels and its
    bricks [split * bricks / splits, (split + 1) * bricks / splits) of the
    batch's (brick b: sample b // per-sample bricks, then (bd * nbh + bh) *
    nbw + bw)."""
    tile, split = u % plan["ntiles"], u // plan["ntiles"]
    b, s = plan["bricks"], plan["splits"]
    return dict(split=split, ci0=tile % plan["ntci"] * plan["ci"],
                co0=tile // plan["ntci"] * plan["co"],
                bricks=(split * b // s, (split + 1) * b // s))


def f32_dw_swz(rw: int, row: int, pos: int) -> int:
    """Where csrc/conv3d_k3_f32_dw.cu's ``swz`` keeps logical double
    ``pos`` of staged fp64 row ``row`` in a buffer of ``rw``-double rows:
    its 16-byte pair XORed with a mask of the row's low bits."""
    m = {8: ((row >> 1) & 1) << 1, 16: (row & 3) << 1,
         32: (row & 1) | ((row & 2) << 1), 64: row & 3}[rw]
    return row * rw + (pos ^ (m << 1))


def f32_dw_brick(plan: dict, b: int) -> Tuple[int, tuple]:
    """Brick b of the batch's in an fp32 dW plan: (sample, output origin)."""
    per = math.prod(plan["nb"])
    _, nbh, nbw = plan["nb"]
    r = b % per
    idx = (r // (nbh * nbw), r // nbw % nbh, r % nbw)
    return b // per, tuple(i * e for i, e in zip(idx, plan["brick"]))


def _conv3d_k3_f32(x, w, stride, pre, add_to, emit_stats, slope, sms,
                   stream):
    """The fp32 forward kernel on checked operands: (y, stats or None)."""
    n, d, h, wd, ci = x.shape
    co = w.shape[-1]
    out = tuple((s - 1) // stride + 1 for s in (d, h, wd))
    y = torch.empty((n, *out, co), dtype=torch.float32, device=x.device)
    plan = _f32_fwd_plan(n, (d, h, wd), ci, co, stride, sms)
    stats = slots = part = None
    if emit_stats:
        stats = torch.empty((n, 2, co), dtype=torch.float32, device=x.device)
        slots = torch.empty(plan["slots"], dtype=torch.float64,
                            device=x.device)
    if plan["splits"] > 1:
        part = torch.empty(plan["part"], dtype=torch.float64, device=x.device)
    rc = _f32_fn("fwd")(
        x.data_ptr(), w.data_ptr(), _ptr(pre), _ptr(add_to), y.data_ptr(),
        _ptr(stats), _ptr(slots), _ptr(part), n, d, h, wd, ci, co, stride,
        plan["tile"], plan["splits"], plan["grid"], slope, stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_k3: fp32 kernel launch failed, CUDA error "
                           f"{rc}")
    return y, stats


def _conv3d_k3_dx_f32(gy, w, stride, y, gs, x, pre, size, slope, sms,
                      stream):
    """The fp32 dx kernel on checked operands: (dx, dst or None)."""
    n, co = gy.shape[0], gy.shape[-1]
    ci = w.shape[3]
    dev = gy.device
    _aligned("conv3d_k3_dx", w=w)
    dx = torch.empty((n, *size, ci), dtype=torch.float32, device=dev)
    plan = _f32_dx_plan(n, size, ci, co, stride, sms, corr=y is not None)
    dst = slots = part = None
    if pre is not None:
        dst = torch.empty((n, 2, ci), dtype=torch.float32, device=dev)
        slots = torch.empty(plan["slots"], dtype=torch.float64, device=dev)
    if plan["splits"] > 1:
        part = torch.empty(plan["part"], dtype=torch.float64, device=dev)
    rc = _f32_fn("dx")(
        gy.data_ptr(), w.data_ptr(), _ptr(y), _ptr(gs),
        _ptr(x if pre is not None else None), _ptr(pre), dx.data_ptr(),
        _ptr(dst), _ptr(slots), _ptr(part), n, *size, ci, co, stride,
        plan["tile"], plan["splits"], plan["grid"], plan["smem"], slope,
        stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_k3_dx: fp32 kernel launch failed, CUDA "
                           f"error {rc}")
    return dx, dst


def _conv3d_k3_dw_f32(x, gy, stride, pre, y, gs, slope, sms, stream):
    """The fp32 dW kernel on checked operands. Its producers copy PRE's
    [scale; shift] and CORR's gs in 16-byte pieces: a view that starts
    elsewhere is copied to a fresh (aligned) tensor first."""
    n, d, h, wd, ci = x.shape
    co = gy.shape[-1]
    pre, gs = (t.clone() if t is not None and t.data_ptr() % 16 else t
               for t in (pre, gs))
    plan = _f32_dw_plan(n, (d, h, wd), ci, co, stride, sms, y is not None)
    dw = torch.empty((3, 3, 3, ci, co), dtype=torch.float32, device=x.device)
    part = (torch.empty(plan["part"], dtype=torch.float64, device=x.device)
            if plan["splits"] > 1 else None)
    rc = _f32_fn("dw")(
        x.data_ptr(), gy.data_ptr(), _ptr(pre), _ptr(y), _ptr(gs),
        dw.data_ptr(), _ptr(part), n, d, h, wd, ci, co, stride, plan["tile"],
        plan["splits"], plan["grid"], plan["smem"], plan["part"],
        plan["fin_grid"], slope, stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_k3_dw: fp32 kernel launch failed, CUDA "
                           f"error {rc}")
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
