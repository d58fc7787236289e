"""Transposed conv with kernel == stride on NDHWC: one pointwise GEMM whose
columns are the output parities, written depth-to-space, and its backward.

``upsample2x`` is the wrapper of the CUDA kernel ``csrc/upsample2x.cu``,
which replaces ``mt3d_resenc_unet_tpu/ops/pallas_upsample.py::_fwd_kernel``
(the 2x2x2 case); ``upsample2x_dx`` and ``upsample2x_dw`` wrap the kernels
of ``csrc/upsample2x_bwd.cu``, which replace ``::_dx_kernel`` and
``::_dw_kernel``. All are bound by the fp32 FMA pipes on the H100 (see the
sources' notes). ``upsample_plain`` is the same function in plain PyTorch,
for any kernel == stride, and ``upsample2x_dx_plain`` /
``upsample2x_dw_plain`` are the backward's: the wrappers run them for CPU
tensors, the model runs ``upsample_plain`` for the upsample shapes that have
no kernel, and the tests and ``chip_smoke.py`` hold the kernels against
them. A CUDA tensor given to a wrapper always goes to the kernel, or the
wrapper raises; one that needs a gradient reaches the kernels only through
:class:`Upsample2xFn`, the counterpart of the JAX ``custom_vjp``
``upsample2x_packed``.

``wf`` is the transposed-conv kernel in the JAX layout (*k, Ci, Co) with
its spatial flip already applied: y[.., k*i + a, ..] = x[.., i, ..] @ wf[a].
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_KERNEL = "upsample2x"
_lib_fns = {}


def upsample2x_supported(x_shape, ci: int, co: int) -> bool:
    """The shape class where the JAX package takes its Pallas upsample
    (models/network.py UpsampleConv: qn * ci == 128), cut to the channel
    counts this kernel takes (multiples of 32): 128->64 and 64->32."""
    g_o = 128 // co if co <= 64 and 128 % co == 0 else 0
    qn = g_o // 2
    return (len(x_shape) == 5 and g_o >= 2 and qn * ci == 128
            and x_shape[-1] == ci and x_shape[3] % qn == 0
            and ci % 32 == 0 and co % 32 == 0)


def upsample_gemm(x: torch.Tensor, wf: torch.Tensor, matmul) -> torch.Tensor:
    """The transposed conv as ``matmul(x rows, wf as (Ci, prod(k) * Co))``
    written depth-to-space; ``matmul`` sets the precision."""
    k = tuple(wf.shape[:-2])
    ci, co = wf.shape[-2:]
    n, *spatial, _ = x.shape
    nd = len(k)
    w2 = wf.permute(nd, *range(nd), nd + 1).reshape(ci, -1)
    y = matmul(x.reshape(-1, ci), w2).reshape(n, *spatial, *k, co)
    perm = [0]
    for i in range(nd):
        perm += [1 + i, 1 + nd + i]
    perm.append(1 + 2 * nd)
    return y.permute(perm).reshape(
        n, *(s * kk for s, kk in zip(spatial, k)), co)


def upsample_plain(x: torch.Tensor, wf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: fp32 GEMM plus interleave, output in
    ``x.dtype``."""
    y = upsample_gemm(x, wf, lambda a, b: a.float() @ b.float())
    return y.to(x.dtype).contiguous()


def _fn(name: str = _KERNEL):
    """The C launcher ``<name>_ndhwc_launch``, its argument types set; all
    three take (in, in, out, N, Di, Hi, Wi, Ci, Co, stream)."""
    fn = _lib_fns.get(name)
    if fn is None:
        source = _KERNEL if name == _KERNEL else "upsample2x_bwd"
        fn = getattr(_build.load(source), f"{name}_ndhwc_launch")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
        _lib_fns[name] = fn
    return fn


def _check(fn: str, **tensors: torch.Tensor) -> None:
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if (t.dtype != torch.bfloat16 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be contiguous bf16 on "
                             f"{dev}; got {t.dtype} on {t.device}")


def upsample2x(x: torch.Tensor, wf: torch.Tensor) -> torch.Tensor:
    """x (N, D, H, W, Ci), wf (2, 2, 2, Ci, Co) flipped ->
    y (N, 2D, 2H, 2W, Co)."""
    if x.device.type == "cpu":
        return upsample_plain(x, wf)
    _build.check_no_grad("upsample2x", x, wf)
    if x.device.type != "cuda":
        raise ValueError(f"upsample2x: unsupported device {x.device}")
    if x.dim() != 5 or tuple(wf.shape[:3]) != (2, 2, 2) or wf.dim() != 5:
        raise ValueError("upsample2x: needs x (N,D,H,W,Ci), wf (2,2,2,Ci,Co)")
    n, d, h, w, ci = x.shape
    co = wf.shape[-1]
    if wf.shape[3] != ci or ci % 32 or co % 32:
        raise ValueError(f"upsample2x: unsupported channels {ci}->{co}")
    _check("upsample2x", x=x, wf=wf)
    if x.data_ptr() % 16:
        raise ValueError("upsample2x: x must be 16-byte aligned")
    y = torch.empty((n, 2 * d, 2 * h, 2 * w, co), dtype=torch.bfloat16,
                    device=x.device)
    with torch.cuda.device(x.device):
        rc = _fn()(x.data_ptr(), wf.data_ptr(), y.data_ptr(), n, d, h, w, ci,
                   co, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"upsample2x: kernel launch failed, CUDA error {rc}")
    _build.count(_KERNEL, (ci, co, d, h, w))
    return y


def _fine_rows(gy: torch.Tensor) -> torch.Tensor:
    """(N, 2D, 2H, 2W, Co) -> (N*D*H*W, 8*Co) with column p*Co + co,
    p = (a, b, c) the output parity, in fp32."""
    n, d2, h2, w2, co = gy.shape
    g = gy.float().reshape(n, d2 // 2, 2, h2 // 2, 2, w2 // 2, 2, co)
    return g.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, 8 * co)


def upsample2x_dx_plain(gy: torch.Tensor, wf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`upsample2x_dx`, fp32 GEMM, output in
    ``gy.dtype``."""
    n, d2, h2, w2, co = gy.shape
    ci = wf.shape[3]
    w2t = wf.float().reshape(8, ci, co).permute(0, 2, 1).reshape(8 * co, ci)
    dx = _fine_rows(gy) @ w2t
    return dx.reshape(n, d2 // 2, h2 // 2, w2 // 2, ci).to(gy.dtype)


def upsample2x_dw_plain(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`upsample2x_dw`: (2, 2, 2, Ci, Co)
    fp32."""
    ci, co = x.shape[-1], gy.shape[-1]
    dw = x.float().reshape(-1, ci).t() @ _fine_rows(gy)      # (ci, 8*co)
    return dw.reshape(ci, 8, co).permute(1, 0, 2).reshape(2, 2, 2, ci, co)


def _bwd_shapes(fn: str, x_shape, gy: torch.Tensor, ci: int):
    if gy.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {gy.device}")
    if gy.dim() != 5 or any(s % 2 for s in gy.shape[1:4]):
        raise ValueError(f"{fn}: gy must be (N, 2D, 2H, 2W, Co)")
    n, d2, h2, w2, co = gy.shape
    if ci % 32 or co % 32:
        raise ValueError(f"{fn}: unsupported channels {ci}->{co}")
    if x_shape is not None and tuple(x_shape) != (n, d2 // 2, h2 // 2,
                                                  w2 // 2, ci):
        raise ValueError(f"{fn}: x {tuple(x_shape)} does not match gy "
                         f"{tuple(gy.shape)}")
    if gy.data_ptr() % 16:
        raise ValueError(f"{fn}: gy must be 16-byte aligned")
    return n, d2 // 2, h2 // 2, w2 // 2, co


def upsample2x_dx(gy: torch.Tensor, wf: torch.Tensor) -> torch.Tensor:
    """gy (N, 2D, 2H, 2W, Co), wf (2, 2, 2, Ci, Co) flipped ->
    dx (N, D, H, W, Ci) in gy's dtype: ``dx[i] = sum_p gy[2i + p] @
    wf[p]^T``."""
    if gy.device.type == "cpu":
        return upsample2x_dx_plain(gy, wf)
    fn = "upsample2x_dx"
    _build.check_no_grad(fn, gy, wf)
    if wf.dim() != 5 or tuple(wf.shape[:3]) != (2, 2, 2):
        raise ValueError(f"{fn}: needs wf (2, 2, 2, Ci, Co)")
    ci = wf.shape[3]
    n, d, h, w, co = _bwd_shapes(fn, None, gy, ci)
    _check(fn, gy=gy, wf=wf)
    if wf.shape[4] != co:
        raise ValueError(f"{fn}: wf {tuple(wf.shape)} vs gy channels {co}")
    dx = torch.empty((n, d, h, w, ci), dtype=torch.bfloat16, device=gy.device)
    with torch.cuda.device(gy.device):
        rc = _fn(fn)(gy.data_ptr(), wf.data_ptr(), dx.data_ptr(), n, d, h, w,
                     ci, co, torch.cuda.current_stream(gy.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed, CUDA error {rc}")
    _build.count(fn, (ci, co, d, h, w))
    return dx


def upsample2x_dw(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """x (N, D, H, W, Ci), gy (N, 2D, 2H, 2W, Co) -> the gradient of the
    flipped wf, (2, 2, 2, Ci, Co) fp32: ``dwf[p] = sum_i x[i]^T gy[2i + p]``."""
    if x.device.type == "cpu":
        return upsample2x_dw_plain(x, gy)
    fn = "upsample2x_dw"
    _build.check_no_grad(fn, x, gy)
    ci = x.shape[-1]
    n, d, h, w, co = _bwd_shapes(fn, x.shape, gy, ci)
    _check(fn, x=x, gy=gy)
    if x.data_ptr() % 16:
        raise ValueError(f"{fn}: x must be 16-byte aligned")
    dw = torch.zeros((2, 2, 2, ci, co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _fn(fn)(x.data_ptr(), gy.data_ptr(), dw.data_ptr(), n, d, h, w,
                     ci, co, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed, CUDA error {rc}")
    _build.count(fn, (ci, co, d, h, w))
    return dw


class Upsample2xFn(torch.autograd.Function):
    """``y = upsample2x(x, wf)`` with the backward of the JAX ``custom_vjp``
    ``upsample2x_packed`` (``_upsample_bwd``, pallas_upsample.py:134): dx
    and dW through the kernels, dW rounded to wf's dtype as in JAX. The
    caller's flip of the parameter stays outside, so its gradient comes
    from autograd. Runs on the CPU too, through the plain versions."""

    @staticmethod
    def forward(ctx, x, wf):
        ctx.save_for_backward(x, wf)
        return upsample2x(x, wf)

    @staticmethod
    def backward(ctx, gy):
        x, wf = ctx.saved_tensors
        gy = gy.to(x.dtype).contiguous()
        dx = upsample2x_dx(gy, wf) if ctx.needs_input_grad[0] else None
        dw = (upsample2x_dw(x, gy).to(wf.dtype)
              if ctx.needs_input_grad[1] else None)
        return dx, dw
