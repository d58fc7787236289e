"""Instance norm + LeakyReLU on (N, *spatial, C), forward and backward, and
the model's norm tail and unfused statistics on the same kernels.

The counterpart of ``mt3d_resenc_unet_tpu/ops/pallas_norm_act.py``
(``instance_norm_act_pallas`` and its ``custom_vjp``) and, in further
modes of the same kernels, of the JAX package's XLA norm tail
(``ops/instance_norm.py`` ``norm_apply_packed``) and statistics
(``packed_stats_xla``). CUDA kernels in ``csrc/norm_act.cu``, each behind a
wrapper with a plain PyTorch version of the same function beside it (the
wrapper runs the plain version for CPU tensors; the tests and
``chip_smoke.py`` hold the kernel against it). A CUDA tensor always goes to
the kernel, or the wrapper raises. Each counts its launches under its own
name in ``_build.LAUNCHES`` (and by (N, S, C) and mode in
``_build.LAUNCH_SHAPES``).

  ``norm_act_stats``      per-(n, c) fp32 [mean; rsqrt(max(E[x^2] - mean^2,
                          0) + eps)], replacing ``_stats_kernel``;
  ``raw_stats``           the same kernel's [sum x; sum x^2] (counter
                          ``norm_act_raw_stats``): ``packed_stats_xla``;
  ``norm_act_norm``       ``(x - mean) * inv`` then LeakyReLU when ``act``,
                          every operation in x's dtype after mean and inv are
                          cast to it, replacing ``_norm_kernel``;
  ``norm_tail``           ``leaky((y * inv - shift) [+ residual])`` with
                          (N, C) vectors, the residual optionally through
                          ``leaky(r * a - b)`` (``residual_pre``), fp32
                          inside and one rounding at the store (counter
                          ``norm_act_tail``): ``norm_apply_packed``;
  ``norm_act_bwd_stats``  per-(n, c) fp32 [sum g'; sum g' * xhat], with fp32
                          xhat and g' the cotangent after the LeakyReLU
                          backward, replacing ``_bwd_stats_kernel``;
  ``norm_tail_bwd``       the tail's backward in one pass (counter
                          ``norm_act_tail_bwd``): dy, the residual's
                          cotangent and the vectors' fp32 sums;
  ``norm_act_bwd_dx``     ``inv * (g' - mean(g') - xhat * mean(g' xhat))``
                          in x's dtype, replacing ``_bwd_dx_kernel``.

:class:`NormActFn` keeps ``(x, stats)`` as its residuals, as the JAX
``_norm_act_fwd`` does, and runs the two backward kernels. The backward
rebuilds xhat in fp32, so its LeakyReLU mask can differ from the forward's
at 0, as on the TPU. No model path calls this op (the JAX model normalizes
through XLA): it is the port of the Pallas op, with the same contract.

:class:`NormTailFn` and :class:`RawStatsFn` are what the model calls
(``ops/instance_norm.py`` ``norm_apply`` and ``instance_stats`` with
``use_kernels``, for the shapes of :func:`kernel_class`): every residual
block's tail, the skip projections' norms, the decoder stages' last norm,
the stem handoff where it is applied, and the statistics of every producer
whose conv does not emit them.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional

import torch

from . import _build

_SOURCE = "norm_act"
_lib_fns = {}
THREADS = 256           # threads per block of every kernel (norm_act.cu)
ROWS_PER_THREAD = 16    # norm / bwd_dx: voxels a thread visits per pass
MAX_CHUNKS = 1024       # norm / bwd_dx: bounds the chunks of a sample
UNROLL = 4              # rows a thread loads per trip (norm_act.cu UNROLL)
SMS = 132               # the H100's SMs: the grids are sized to them
BLOCK_BYTES = 1 << 17   # a block reads at least 128 KB of the tensor


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(N, *spatial, C) -> (N, S, C)."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


def _leaky(u: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """LeakyReLU with the slope rounded to u's dtype, as JAX multiplies a
    bf16 array by a weakly typed Python float."""
    slope = torch.tensor(negative_slope, dtype=u.dtype, device=u.device)
    return torch.where(u >= 0, u, u * slope)


def _vec(dtype: torch.dtype) -> int:
    """Channels of one 16-byte vector."""
    return 4 if dtype == torch.float32 else 8


def kernel_class(x: torch.Tensor,
                 residual: Optional[torch.Tensor] = None) -> bool:
    """The shapes the kernels take: (N, *spatial, C) of any rank in bf16,
    fp16 or fp32 with C a multiple of the 16-byte vector and C / vec <=
    THREADS, and a residual of the same shape and dtype. The model sends these to
    :class:`NormTailFn` and :class:`RawStatsFn` and the rest to the plain
    ops, by shape, as it dispatches the convs."""
    if x.dim() < 3 or x.dtype not in _build.DTYPE_CODES:
        return False
    c, vec = x.shape[-1], _vec(x.dtype)
    return (c % vec == 0 and 0 < c // vec <= THREADS and x.numel() > 0
            and (residual is None or (residual.shape == x.shape
                                      and residual.dtype == x.dtype)))


# ------------------------------------------------------------ plain versions

def norm_act_stats_plain(x2: torch.Tensor, eps: float) -> torch.Tensor:
    """(N, S, C) -> (N, 2, C) fp32 [mean; inv]."""
    xf = x2.float()
    inv_n = 1.0 / x2.shape[1]
    mean = xf.sum(dim=1) * inv_n
    var = (xf * xf).sum(dim=1) * inv_n - mean * mean
    return torch.stack([mean, torch.rsqrt(torch.clamp(var, min=0.0) + eps)], 1)


def raw_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """(N, *spatial, C) -> (N, 2, C) fp32 [sum; sumsq] over all voxels."""
    xf = x.float().flatten(1, -2)
    return torch.stack([xf.sum(dim=1), (xf * xf).sum(dim=1)], dim=1)


def norm_act_norm_plain(x2: torch.Tensor, stats: torch.Tensor,
                        negative_slope: float, act: bool) -> torch.Tensor:
    """(x - mean) * inv [then LeakyReLU], in x's dtype."""
    mean = stats[:, None, 0, :].to(x2.dtype)
    inv = stats[:, None, 1, :].to(x2.dtype)
    y = (x2 - mean) * inv
    return _leaky(y, negative_slope) if act else y


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.float().reshape(v.shape[0], *([1] * (ndim - 2)), v.shape[-1])


def _leaky32(u: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """LeakyReLU of an fp32 u, the slope an fp32 scalar."""
    return torch.where(u >= 0, u, u * negative_slope)


def norm_tail_plain(y: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor,
                    negative_slope: float, act: bool = True,
                    residual: Optional[torch.Tensor] = None,
                    a: Optional[torch.Tensor] = None,
                    b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``leaky((y * inv - shift) [+ residual])`` on (N, *spatial, C) with
    (N, C) vectors, in fp32, rounded to y's dtype; the residual first
    through ``leaky(residual * a - b)`` where ``a`` is given."""
    nd = y.dim()
    u = y.float() * _bcast(inv, nd) - _bcast(shift, nd)
    if residual is not None:
        r = residual.float()
        if a is not None:
            r = _leaky32(r * _bcast(a, nd) - _bcast(b, nd), negative_slope)
        u = u + r
    if act:
        u = _leaky32(u, negative_slope)
    return u.to(y.dtype)


def norm_tail_bwd_plain(y2, r2, inv, shift, a, b, g2, negative_slope, act):
    """The tail's backward on (N, S, C): (dy, dr, sums) with dy and dr in
    their tensors' dtypes (dr None without a residual) and sums (N, K, C)
    fp32 [sum g' y; -sum g'] (K = 2), then [sum g_r r; -sum g_r] (K = 4)
    with ``a``: g' is the cotangent through the LeakyReLU's mask, g_r g'
    through the residual's."""
    inv3, shift3 = inv[:, None].float(), shift[:, None].float()
    yf = y2.float()
    u = yf * inv3 - shift3
    if r2 is not None:
        rf = r2.float()
        if a is not None:
            t = rf * a[:, None].float() - b[:, None].float()
            u = u + _leaky32(t, negative_slope)
        else:
            u = u + rf
    g = g2.float()
    if act:
        g = torch.where(u >= 0, g, g * negative_slope)
    sums = [(g * yf).sum(dim=1), -g.sum(dim=1)]
    dr = None
    if r2 is not None:
        if a is not None:
            gr = torch.where(t >= 0, g, g * negative_slope)
            sums += [(gr * rf).sum(dim=1), -gr.sum(dim=1)]
            dr = (gr * a[:, None].float()).to(r2.dtype)
        else:
            dr = g.to(r2.dtype)
    return (g * inv3).to(y2.dtype), dr, torch.stack(sums, 1)


def _grad_in(x2, stats, g2, negative_slope, act):
    xhat = (x2.float() - stats[:, None, 0, :]) * stats[:, None, 1, :]
    g = g2.float()
    if act:
        g = torch.where(xhat >= 0, g, g * negative_slope)
    return xhat, g


def norm_act_bwd_stats_plain(x2: torch.Tensor, stats: torch.Tensor,
                             g2: torch.Tensor, negative_slope: float,
                             act: bool) -> torch.Tensor:
    """(N, 2, C) fp32 [sum g'; sum g' * xhat]."""
    xhat, g = _grad_in(x2, stats, g2, negative_slope, act)
    return torch.stack([g.sum(dim=1), (g * xhat).sum(dim=1)], 1)


def norm_act_bwd_dx_plain(x2: torch.Tensor, stats: torch.Tensor,
                          gsums: torch.Tensor, g2: torch.Tensor,
                          negative_slope: float, act: bool) -> torch.Tensor:
    """dx in x's dtype."""
    xhat, g = _grad_in(x2, stats, g2, negative_slope, act)
    inv_n = 1.0 / x2.shape[1]
    mg = gsums[:, None, 0, :] * inv_n
    mgx = gsums[:, None, 1, :] * inv_n
    return (stats[:, None, 1, :] * (g - mg - xhat * mgx)).to(x2.dtype)


# ----------------------------------------------------------------- kernels

def _fn(name: str):
    """The C launcher ``<name>_launch`` of csrc/norm_act.cu, typed."""
    fn = _lib_fns.get(name)
    if fn is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        tail = [i, ll, i, i, f, i, i, p]    # N, S, C, nchunk, f, int, dtype
        fn = getattr(_build.load(_SOURCE), f"{name}_launch")
        fn.argtypes = {
            "norm_act_stats": [p, p, p, p] + tail,
            "norm_act_norm": [p, p, p] + tail,
            "norm_act_tail": [p] * 7 + tail,
            "norm_act_tail_bwd": [p] * 12 + tail,
            "norm_act_bwd_stats": [p] * 6 + tail,
            "norm_act_bwd_dx": [p] * 5 + tail,
        }[name]
        fn.restype = i
        _lib_fns[name] = fn
    return fn


def _geometry(fn: str, x2: torch.Tensor, *others: Optional[torch.Tensor]):
    """Checks what the kernels take; returns (N, S, C, dtype code)."""
    if x2.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x2.device}")
    if x2.dim() != 3 or not kernel_class(x2):
        raise ValueError(f"{fn}: needs x (N, S, C) in bf16, fp16 or fp32 with "
                         "C a "
                         f"multiple of the vector and C / vec <= {THREADS}; "
                         f"got {tuple(x2.shape)} {x2.dtype}")
    for t in (x2,) + others:
        if t is None:
            continue
        if t.device != x2.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: tensors must be contiguous, 16-byte "
                             f"aligned and on {x2.device}")
    n, s, c = x2.shape
    return n, s, c, _build.DTYPE_CODES[x2.dtype]


def _op_chunks(s: int, c: int, vec: int) -> int:
    """Chunks a sample of ``norm_act_norm`` / ``norm_act_bwd_dx`` (their
    first design): ROWS_PER_THREAD rows a thread, at most MAX_CHUNKS."""
    rows = THREADS // (c // vec)
    return max(1, min(MAX_CHUNKS, math.ceil(s / (rows * ROWS_PER_THREAD))))


def _chunks(n: int, s: int, c: int, vec: int, per_sm: int = 2) -> int:
    """Chunks a sample of the reductions and the tail: about ``per_sm``
    blocks an SM over the N samples (4 for the statistics, which read one
    tensor and so need more blocks for as many bytes in flight; 2 for the
    passes over two or three), each of at least BLOCK_BYTES of the tensor
    and a trip of UNROLL rows a thread; a reduction's finalize then adds
    at most ~per_sm * SMS / N partials a sample."""
    rows = THREADS // (c // vec)
    most = min(math.ceil(s / (rows * UNROLL)),
               math.ceil(s * c * (16 // vec) / BLOCK_BYTES))
    return max(1, min(most, math.ceil(per_sm * SMS / n), 65535))


def _check_stats(fn: str, t: torch.Tensor, n: int, c: int) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (n, 2, c):
        raise ValueError(f"{fn}: needs (N, 2, C) fp32 vectors; got "
                         f"{tuple(t.shape)} {t.dtype}")


def _check_vectors(fn: str, like: torch.Tensor, *vs: Optional[torch.Tensor]):
    n, c = like.shape[0], like.shape[-1]
    for v in vs:
        if v is not None and (v.dtype != torch.float32
                              or tuple(v.shape) != (n, c)
                              or v.device != like.device
                              or not v.is_contiguous()):
            raise ValueError(f"{fn}: needs contiguous (N, C) fp32 vectors on "
                             f"{like.device}; got {tuple(v.shape)} {v.dtype}")


def _launch(fn: str, name: str, shape, modes, *args) -> None:
    """Launch ``fn``'s C launcher and count one launch of kernel ``name``
    at ``shape`` in ``modes``."""
    rc = _fn(fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error {rc}")
    _build.count(name, shape, **modes)


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on t's card (the call PyTorch's
    generated kernels make: cheaper than a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _on(t: torch.Tensor):
    """The device context a launch on t's card needs (none when it is the
    current one: entering one costs the host microseconds a launch)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


# per (device, stream): N ints that are 0 between launches (each reducing
# launch's last block of a sample resets its counter); launches on one
# stream run in order, so they share them
_counters = {}


def _counter(t: torch.Tensor, n: int, stream: int) -> torch.Tensor:
    key = (t.device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=t.device)
        _counters[key] = buf
    return buf


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stats_launch(fn: str, name: str, x2: torch.Tensor, eps: float,
                  raw: bool) -> torch.Tensor:
    _build.check_no_grad(name, x2)
    n, s, c, code = _geometry(name, x2)
    nchunk = _chunks(n, s, c, _vec(x2.dtype), per_sm=4)
    # the partials, then the (N, 2, C) result: one allocation
    part = torch.empty(n * (nchunk + 1) * 2 * c, dtype=torch.float32,
                       device=x2.device)
    out = part[n * nchunk * 2 * c:].view(n, 2, c)
    with _on(x2):
        st = _stream(x2)
        _launch(fn, name, (n, s, c), {}, x2.data_ptr(), part.data_ptr(),
                _counter(x2, n, st).data_ptr(), out.data_ptr(), n, s, c,
                nchunk, eps, int(raw), code, st)
    return out


def norm_act_stats(x2: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (N, S, C) -> (N, 2, C) fp32 [mean; inv]."""
    if x2.device.type == "cpu":
        return norm_act_stats_plain(x2, eps)
    return _stats_launch("norm_act_stats", "norm_act_stats", x2, eps, False)


def raw_stats(x2: torch.Tensor) -> torch.Tensor:
    """x (N, S, C) -> (N, 2, C) fp32 [sum x; sum x^2] (mode (a) of the
    stats kernel)."""
    if x2.device.type == "cpu":
        return raw_stats_plain(x2)
    return _stats_launch("norm_act_stats", "norm_act_raw_stats", x2, 0.0,
                         True)


def norm_act_norm(x2: torch.Tensor, stats: torch.Tensor,
                  negative_slope: float = 1e-2,
                  act: bool = True) -> torch.Tensor:
    """y = (x - mean) * inv [then LeakyReLU], (N, S, C) in x's dtype."""
    if x2.device.type == "cpu":
        return norm_act_norm_plain(x2, stats, negative_slope, act)
    fn = "norm_act_norm"
    _build.check_no_grad(fn, x2)
    n, s, c, code = _geometry(fn, x2, stats)
    _check_stats(fn, stats, n, c)
    nchunk = _op_chunks(s, c, _vec(x2.dtype))
    y = torch.empty_like(x2)
    with _on(x2):
        _launch(fn, fn, (n, s, c), {"act": act}, x2.data_ptr(),
                stats.data_ptr(), y.data_ptr(), n, s, c, nchunk,
                negative_slope, int(act), code, _stream(x2))
    return y


def _tail_args(fn, y2, r2, inv, shift, a, b, g2=None):
    """Checks the tail's operands (and the cotangent ``g2``); returns (N,
    S, C, dtype code, chunks, modes)."""
    if (a is None) != (b is None) or (a is not None and r2 is None):
        raise ValueError(f"{fn}: residual_pre (a, b) needs both vectors and "
                         "a residual")
    n, s, c, code = _geometry(fn, y2, r2, g2)
    for t in (r2, g2):
        if t is not None and (t.shape != y2.shape or t.dtype != y2.dtype):
            raise ValueError(f"{fn}: the residual and the cotangent must "
                             "match y's shape and dtype")
    _check_vectors(fn, y2, inv, shift, a, b)
    modes = {"residual": r2 is not None, "pre": a is not None}
    return n, s, c, code, _chunks(n, s, c, _vec(y2.dtype)), modes


def norm_tail(y2: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor,
              r2: Optional[torch.Tensor] = None,
              a: Optional[torch.Tensor] = None,
              b: Optional[torch.Tensor] = None,
              negative_slope: float = 1e-2, act: bool = True
              ) -> torch.Tensor:
    """The tail forward (mode (b) of the norm kernel) on (N, S, C):
    ``leaky((y * inv - shift) [+ residual])``, the residual through
    ``leaky(r * a - b)`` with (a, b); vectors (N, C) fp32."""
    if y2.device.type == "cpu":
        return norm_tail_plain(y2, inv, shift, negative_slope, act, r2, a, b)
    fn = "norm_act_tail"
    _build.check_no_grad(fn, y2, r2, inv, shift, a, b)
    n, s, c, code, nchunk, modes = _tail_args(fn, y2, r2, inv, shift, a, b)
    out = torch.empty_like(y2)
    with _on(y2):
        _launch(fn, fn, (n, s, c), {**modes, "act": act}, y2.data_ptr(),
                _ptr(r2), inv.data_ptr(), shift.data_ptr(), _ptr(a), _ptr(b),
                out.data_ptr(), n, s, c, nchunk, negative_slope, int(act),
                code, _stream(y2))
    return out


def norm_tail_bwd(y2, r2, inv, shift, a, b, g2, negative_slope=1e-2,
                  act=True):
    """The tail backward (mode (c) of the bwd-stats kernel), one pass over
    y, the residual and the cotangent g: (dy, dr, sums) as
    :func:`norm_tail_bwd_plain`."""
    if y2.device.type == "cpu":
        return norm_tail_bwd_plain(y2, r2, inv, shift, a, b, g2,
                                   negative_slope, act)
    fn = "norm_act_tail_bwd"
    _build.check_no_grad(fn, y2, r2, g2)
    n, s, c, code, nchunk, modes = _tail_args(fn, y2, r2, inv, shift, a, b,
                                              g2)
    k = 4 if a is not None else 2
    dy = torch.empty_like(y2)
    dr = None if r2 is None else torch.empty_like(r2)
    part = torch.empty(n * (nchunk + 1) * k * c, dtype=torch.float32,
                       device=y2.device)
    sums = part[n * nchunk * k * c:].view(n, k, c)
    with _on(y2):
        st = _stream(y2)
        _launch(fn, fn, (n, s, c), {**modes, "act": act}, y2.data_ptr(),
                _ptr(r2), inv.data_ptr(), shift.data_ptr(), _ptr(a), _ptr(b),
                g2.data_ptr(), dy.data_ptr(), _ptr(dr), part.data_ptr(),
                _counter(y2, n, st).data_ptr(), sums.data_ptr(), n, s, c,
                nchunk, negative_slope, int(act), code, st)
    return dy, dr, sums


def norm_act_bwd_stats(x2: torch.Tensor, stats: torch.Tensor,
                       g2: torch.Tensor, negative_slope: float = 1e-2,
                       act: bool = True) -> torch.Tensor:
    """(N, 2, C) fp32 [sum g'; sum g' * xhat]; g in x's dtype."""
    if x2.device.type == "cpu":
        return norm_act_bwd_stats_plain(x2, stats, g2, negative_slope, act)
    fn = "norm_act_bwd_stats"
    _build.check_no_grad(fn, x2, g2)
    n, s, c, code = _geometry(fn, x2, stats, g2)
    _check_stats(fn, stats, n, c)
    if g2.shape != x2.shape or g2.dtype != x2.dtype:
        raise ValueError(f"{fn}: g must match x's shape and dtype")
    nchunk = _chunks(n, s, c, _vec(x2.dtype))
    part = torch.empty(n * (nchunk + 1) * 2 * c, dtype=torch.float32,
                       device=x2.device)
    gsums = part[n * nchunk * 2 * c:].view(n, 2, c)
    with _on(x2):
        st = _stream(x2)
        _launch(fn, fn, (n, s, c), {"act": act}, x2.data_ptr(),
                stats.data_ptr(), g2.data_ptr(), part.data_ptr(),
                _counter(x2, n, st).data_ptr(), gsums.data_ptr(), n, s, c,
                nchunk, negative_slope, int(act), code, st)
    return gsums


def norm_act_bwd_dx(x2: torch.Tensor, stats: torch.Tensor,
                    gsums: torch.Tensor, g2: torch.Tensor,
                    negative_slope: float = 1e-2,
                    act: bool = True) -> torch.Tensor:
    """dx (N, S, C) in x's dtype."""
    if x2.device.type == "cpu":
        return norm_act_bwd_dx_plain(x2, stats, gsums, g2, negative_slope,
                                     act)
    fn = "norm_act_bwd_dx"
    _build.check_no_grad(fn, x2, g2)
    n, s, c, code = _geometry(fn, x2, stats, gsums, g2)
    _check_stats(fn, stats, n, c)
    _check_stats(fn, gsums, n, c)
    if g2.shape != x2.shape or g2.dtype != x2.dtype:
        raise ValueError(f"{fn}: g must match x's shape and dtype")
    nchunk = _op_chunks(s, c, _vec(x2.dtype))
    dx = torch.empty_like(x2)
    with _on(x2):
        _launch(fn, fn, (n, s, c), {"act": act}, x2.data_ptr(),
                stats.data_ptr(), gsums.data_ptr(), g2.data_ptr(),
                dx.data_ptr(), n, s, c, nchunk, negative_slope, int(act),
                code, _stream(x2))
    return dx


# ------------------------------------------------------- the model's Functions

class NormTailFn(torch.autograd.Function):
    """``leaky((y * inv - shift) [+ residual])`` on (N, *spatial, C), the
    residual first through ``leaky(residual * a - b)`` where (a, b) are
    given: the model's norm tail (``norm_tail`` forward, ``norm_tail_bwd``
    backward; their plain versions on the CPU). Saves y and the residual in
    their own dtype and the (N, C) vectors; returns the gradients of y, inv,
    shift, the residual, a and b."""

    @staticmethod
    def forward(ctx, y, inv, shift, residual, a, b, negative_slope, act):
        y2 = _flat(y).contiguous()
        r2 = None if residual is None else _flat(residual).contiguous()
        vecs = [None if v is None else v.float().contiguous()
                for v in (inv, shift, a, b)]
        out = norm_tail(y2, vecs[0], vecs[1], r2, vecs[2], vecs[3],
                        negative_slope, act)
        ctx.save_for_backward(y2, r2, *vecs)
        ctx.negative_slope, ctx.act, ctx.shape = negative_slope, act, y.shape
        return out.reshape(y.shape)

    @staticmethod
    def backward(ctx, gout):
        y2, r2, inv, shift, a, b = ctx.saved_tensors
        g2 = _flat(gout).to(y2.dtype).contiguous()
        dy, dr, sums = norm_tail_bwd(y2, r2, inv, shift, a, b, g2,
                                     ctx.negative_slope, ctx.act)
        shape = ctx.shape
        da, db = (sums[:, 2], sums[:, 3]) if a is not None else (None, None)
        return (dy.reshape(shape), sums[:, 0], sums[:, 1],
                None if dr is None else dr.reshape(shape), da, db, None,
                None)


class RawStatsFn(torch.autograd.Function):
    """(N, *spatial, C) -> (N, 2, C) fp32 [sum x; sum x^2] (``raw_stats``;
    its plain version on the CPU). The backward ``g_s + 2 x g_q``, rounded
    to x's dtype, is plain PyTorch; x is saved in its own dtype."""

    @staticmethod
    def forward(ctx, x):
        x2 = _flat(x).contiguous()
        ctx.save_for_backward(x2)
        ctx.shape = x.shape
        return raw_stats(x2)

    @staticmethod
    def backward(ctx, g):
        (x2,) = ctx.saved_tensors
        g = g.float()
        dx = torch.addcmul(g[:, None, 0], x2, g[:, None, 1], value=2.0)
        return dx.to(x2.dtype).reshape(ctx.shape)


# ---------------------------------------------------------------- the op

class NormActFn(torch.autograd.Function):
    """``y = norm(x) [then LeakyReLU]`` on (N, S, C), the JAX
    ``_norm_act_2d`` ``custom_vjp``: residuals ``(x, stats)``, backward
    through the two backward kernels (their plain versions on the CPU).
    The model does not call this op, as the JAX model does not call
    ``instance_norm_act_pallas``; it runs the same stats, norm and
    bwd-stats kernels in their raw-statistics and tail modes, through
    :class:`RawStatsFn` and :class:`NormTailFn`."""

    @staticmethod
    def forward(ctx, x2, eps, negative_slope, act):
        x2 = x2.contiguous()
        stats = norm_act_stats(x2, eps)
        y = norm_act_norm(x2, stats, negative_slope, act)
        ctx.save_for_backward(x2, stats)
        ctx.negative_slope, ctx.act = negative_slope, act
        return y

    @staticmethod
    def backward(ctx, gy):
        x2, stats = ctx.saved_tensors
        g2 = gy.to(x2.dtype).contiguous()
        gsums = norm_act_bwd_stats(x2, stats, g2, ctx.negative_slope, ctx.act)
        dx = norm_act_bwd_dx(x2, stats, gsums, g2, ctx.negative_slope,
                             ctx.act)
        return dx, None, None, None


def instance_norm_act_fused(x: torch.Tensor,
                            scale: Optional[torch.Tensor] = None,
                            bias: Optional[torch.Tensor] = None, *,
                            eps: float = 1e-5, negative_slope: float = 1e-2,
                            act: bool = True) -> torch.Tensor:
    """Instance norm (+ LeakyReLU) on (N, *spatial, C), the port of
    ``instance_norm_act_pallas``: the activation is fused into the kernel
    only without an affine; the (C,) scale and bias, and then the
    activation, are plain ops after it (pallas_norm_act.py:236-250)."""
    fuse_act = act and scale is None and bias is None
    y = NormActFn.apply(_flat(x), eps, negative_slope, fuse_act)
    y = y.reshape(x.shape)
    if scale is not None:
        y = y * scale.to(y.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    if act and not fuse_act:
        y = _leaky(y, negative_slope)
    return y
