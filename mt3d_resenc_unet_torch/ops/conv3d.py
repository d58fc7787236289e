"""3x3x3 pad-1 conv on NDHWC, stride 1 or 2, with the fused instance-norm
hooks of the JAX package's Pallas convs.

``conv3d_k3`` is the wrapper of the CUDA kernel ``csrc/conv3d_k3.cu``, which
replaces ``mt3d_resenc_unet_tpu/ops/pallas_conv.py::_conv_kernel`` (stride
1) and ``::_s2_fwd_kernel`` (stride 2). It is bound by the fp32 FMA pipes on
the H100 (see the source's note). ``conv3d_k3_plain`` is the same function
in plain PyTorch: the wrapper runs it for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernel against it. A CUDA tensor always goes to
the kernel, or the wrapper raises.

Layouts are the JAX package's: x (N, D, H, W, Ci), w (3, 3, 3, Ci, Co).
Modes, each optional:
  pre       (N, 2, Ci) fp32 [scale; shift]: the input is
            ``leaky(x * scale - shift)``, with the zero padding applied
            after it;
  add_to    (N, Do, Ho, Wo, Co): added to the conv output;
  emit_stats returns ``(y, stats)`` with stats (N, 2, Co) fp32
            [sum; sumsq] of the output (after add_to) over all voxels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_KERNEL = "conv3d_k3"
_lib_fn = None


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


def _fn():
    global _lib_fn
    if _lib_fn is None:
        fn = _build.load(_KERNEL).conv3d_k3_ndhwc_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = i
        _lib_fn = fn
    return _lib_fn


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"conv3d_k3: {name} must be a contiguous {dtype} tensor of shape "
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
    if x.data_ptr() % 16:
        raise ValueError("conv3d_k3: x must be 16-byte aligned")
    do, ho, wo = ((s - 1) // stride + 1 for s in (d, h, wd))
    if pre is not None:
        _check(pre, "pre", torch.float32, (n, 2, ci), dev)
    if add_to is not None:
        _check(add_to, "add_to", bf16, (n, do, ho, wo, co), dev)
    y = torch.empty((n, do, ho, wo, co), dtype=bf16, device=dev)
    stats = (torch.zeros((n, 2, co), dtype=torch.float32, device=dev)
             if emit_stats else None)
    with torch.cuda.device(dev):
        rc = _fn()(x.data_ptr(), w.data_ptr(),
                   pre.data_ptr() if pre is not None else None,
                   add_to.data_ptr() if add_to is not None else None,
                   y.data_ptr(), stats.data_ptr() if emit_stats else None,
                   n, d, h, wd, ci, co, stride, negative_slope,
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_k3: kernel launch failed, CUDA error {rc}")
    _build.LAUNCHES[f"{_KERNEL}_s{stride}"] += 1
    return (y, stats) if emit_stats else y
