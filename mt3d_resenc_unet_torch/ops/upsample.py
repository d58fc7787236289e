"""Transposed conv with kernel == stride on NDHWC: one pointwise GEMM whose
columns are the output parities, written depth-to-space.

``upsample2x`` is the wrapper of the CUDA kernel ``csrc/upsample2x.cu``,
which replaces ``mt3d_resenc_unet_tpu/ops/pallas_upsample.py::_fwd_kernel``
(the 2x2x2 case). It is bound by the fp32 FMA pipes on the H100 (see the
source's note). ``upsample_plain`` is the same function in plain PyTorch, for
any kernel == stride: the wrapper runs it for CPU tensors, the model runs it
for the upsample shapes that have no kernel, and the tests and
``chip_smoke.py`` hold the kernel against it. A CUDA tensor given to the
wrapper always goes to the kernel, or the wrapper raises.

``wf`` is the transposed-conv kernel in the JAX layout (*k, Ci, Co) with
its spatial flip already applied: y[.., k*i + a, ..] = x[.., i, ..] @ wf[a].
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_KERNEL = "upsample2x"
_lib_fn = None


def upsample2x_supported(x_shape, ci: int, co: int) -> bool:
    """The shape class where the JAX package takes its Pallas upsample
    (models/network.py UpsampleConv: qn * ci == 128), cut to the channel
    counts this kernel takes (multiples of 32): 128->64 and 64->32."""
    g_o = 128 // co if co <= 64 and 128 % co == 0 else 0
    qn = g_o // 2
    return (len(x_shape) == 5 and g_o >= 2 and qn * ci == 128
            and x_shape[-1] == ci and x_shape[3] % qn == 0
            and ci % 32 == 0 and co % 32 == 0)


def upsample_plain(x: torch.Tensor, wf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: fp32 GEMM plus interleave, output in
    ``x.dtype``."""
    k = tuple(wf.shape[:-2])
    ci, co = wf.shape[-2:]
    n, *spatial, _ = x.shape
    nd = len(k)
    w2 = wf.float().permute(nd, *range(nd), nd + 1).reshape(ci, -1)
    y = (x.float().reshape(-1, ci) @ w2).reshape(n, *spatial, *k, co)
    perm = [0]
    for i in range(nd):
        perm += [1 + i, 1 + nd + i]
    perm.append(1 + 2 * nd)
    y = y.permute(perm).reshape(n, *(s * kk for s, kk in zip(spatial, k)), co)
    return y.to(x.dtype).contiguous()


def _fn():
    global _lib_fn
    if _lib_fn is None:
        fn = _build.load(_KERNEL).upsample2x_ndhwc_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
        _lib_fn = fn
    return _lib_fn


def upsample2x(x: torch.Tensor, wf: torch.Tensor) -> torch.Tensor:
    """x (N, D, H, W, Ci), wf (2, 2, 2, Ci, Co) flipped ->
    y (N, 2D, 2H, 2W, Co)."""
    if x.device.type == "cpu":
        return upsample_plain(x, wf)
    if x.device.type != "cuda":
        raise ValueError(f"upsample2x: unsupported device {x.device}")
    if x.dim() != 5 or tuple(wf.shape[:3]) != (2, 2, 2) or wf.dim() != 5:
        raise ValueError("upsample2x: needs x (N,D,H,W,Ci), wf (2,2,2,Ci,Co)")
    n, d, h, w, ci = x.shape
    co = wf.shape[-1]
    if wf.shape[3] != ci or ci % 32 or co % 32:
        raise ValueError(f"upsample2x: unsupported channels {ci}->{co}")
    for t, name in ((x, "x"), (wf, "wf")):
        if (t.dtype != torch.bfloat16 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"upsample2x: {name} must be contiguous bf16 on "
                             f"{x.device}; got {t.dtype} on {t.device}")
    if x.data_ptr() % 16:
        raise ValueError("upsample2x: x must be 16-byte aligned")
    y = torch.empty((n, 2 * d, 2 * h, 2 * w, co), dtype=torch.bfloat16,
                    device=x.device)
    with torch.cuda.device(x.device):
        rc = _fn()(x.data_ptr(), wf.data_ptr(), y.data_ptr(), n, d, h, w, ci,
                   co, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"upsample2x: kernel launch failed, CUDA error {rc}")
    _build.LAUNCHES[_KERNEL] += 1
    return y
