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

All six kernels are implicit GEMMs on the tensor cores and take their
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


def _fn(source: str):
    """The C launcher of ``csrc/<source>.cu``, its argument types set."""
    fn = _lib_fns.get(source)
    if fn is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = getattr(_build.load(source), f"{source}_ndhwc_launch")
        fn.argtypes = {
            "conv3d_k3_dx_s1": [p] * 9 + [i] * 8 + [f, p],
            "conv3d_k3_dx_s2": [p] * 9 + [i] * 7 + [f, p],
            "conv3d_k3_s1": [p] * 7 + [i] * 8 + [f, p],
            "conv3d_k3_s2": [p] * 7 + [i] * 7 + [f, p],
            "conv3d_k3_dw_s1": [p] * 7 + [i] * 7 + [f, p],
            "conv3d_k3_dw_s2": [p] * 7 + [i] * 7 + [f, p],
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
                plan["splits"], plan["grid"], negative_slope, stream)
        else:
            plan = _s2_plan(n, (d, h, wd), ci, co, _sm_count(dev),
                            pre is not None)
            part = (torch.empty(plan["slots"], dtype=torch.float32,
                                device=dev) if emit_stats else None)
            rc = _fn("conv3d_k3_s2")(
                x.data_ptr(), w.data_ptr(), _ptr(pre), _ptr(add_to),
                y.data_ptr(), _ptr(stats), _ptr(part), n, d, h, wd, ci, co,
                plan["grid"], negative_slope, stream)
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
    backward. The corrected cotangent is rounded to gy's dtype first, as
    the JAX kernel rounds it before its matrix unit (``_tile_corr_flat``,
    ``u.astype(gy_val.dtype)``): a no-op in fp32."""
    _check_corr(y, gs, x, pre, "conv3d_k3_dx")
    n, ci = gy.shape[0], w.shape[3]
    g = _corrected(gy, y, gs).to(gy.dtype).float()
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
    _check(w, "w", torch.bfloat16, (3, 3, 3, ci, co), dev, fn)
    post = pre is not None
    dx = torch.empty((n, d, h, wd, ci), dtype=torch.bfloat16, device=dev)
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
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed, CUDA error {rc}")
    _build.count(f"{fn}_s{stride}", (ci, co, d, h, wd), corr=y is not None,
                 post=post)
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
    dw = torch.empty((3, 3, 3, ci, co), dtype=torch.float32, device=dev)
    plan = (_dw_s1_plan if stride == 1 else _dw_s2_plan)(
        n, (d, h, wd), ci, co, _sm_count(dev))
    part = torch.empty((plan["splits"], 27, ci, co), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        rc = _fn(f"conv3d_k3_dw_s{stride}")(
            x.data_ptr(), gy.data_ptr(), _ptr(pre), _ptr(y), _ptr(gs),
            dw.data_ptr(), part.data_ptr(), n, d, h, wd, ci, co,
            plan["splits"], negative_slope,
            torch.cuda.current_stream(dev).cuda_stream)
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
