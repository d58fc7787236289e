"""Transposed conv with kernel == stride on NDHWC: one pointwise GEMM whose
columns are the output parities, written depth-to-space, and its backward.

``upsample2x`` is the wrapper of the CUDA kernel ``csrc/upsample2x.cu``,
which replaces ``mt3d_resenc_unet_tpu/ops/pallas_upsample.py::_fwd_kernel``
(the 2x2x2 case); ``upsample2x_dx`` and ``upsample2x_dw`` wrap the kernels
of ``csrc/upsample2x_bwd.cu``, which replace ``::_dx_kernel`` and
``::_dw_kernel``. All three are GEMMs on the tensor cores, bound by bytes on
the H100 (see the sources' notes): the forward tiled by :func:`_up_fwd_plan`
and staging its output by parity as :func:`up2_row` lays it out before the
fine rows leave, the backward tiled by :func:`_up_bwd_plan` and staging the
cotangent the same way. Their dW sums across blocks in a
fixed order (no atomics). ``upsample_plain`` is the same function in plain
PyTorch, for any kernel == stride, and ``upsample2x_dx_plain`` /
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
from .conv3d import _sm_count

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
    """The C launcher ``<name>_ndhwc_launch``, its argument types set: (in,
    in, out, [scratch,] N, Di, Hi, Wi, Ci, Co, [plan ints,] stream)."""
    fn = _lib_fns.get(name)
    if fn is None:
        source = _KERNEL if name == _KERNEL else "upsample2x_bwd"
        fn = getattr(_build.load(source), f"{name}_ndhwc_launch")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            _KERNEL: [p] * 3 + [i] * 11 + [p],
            "upsample2x_dx": [p] * 3 + [i] * 8 + [p],
            "upsample2x_dw": [p] * 4 + [i] * 9 + [p],
        }[name]
        fn.restype = i
        _lib_fns[name] = fn
    return fn


# tiles of the forward kernel (csrc/upsample2x.cu): (tm, tco) of the
# flagship's two shapes, where a block keeps all eight parities' weights
# resident; elsewhere tiles of UP_FWD_TM voxels x 32 co, with x and the
# weights streamed in chunks of UP_FWD_KC input channels
UP_FWD_RESIDENT = {(128, 64): (128, 64), (64, 32): (256, 32)}
UP_FWD_TM, UP_FWD_KC = 64, 32


def _up_fwd_plan(n: int, size, ci: int, co: int, sms: int) -> dict:
    """The launch of the upsample forward kernel for coarse extents
    ``size`` = (D, H, W).

    A block owns tiles of ``tm`` coarse voxels (``tm / 16`` rows of h x 16
    w of one (n, d); tile t = ((n * D + d) * nhg + hg) * nwg + wg, as the
    backward's) x ``tco`` output channels, all eight parities: the four
    (a, b) pairs in turn, both c of each. At 128->64 and 64->32 (tiles of
    128 x 64 and 256 x 32) the weights stay ``resident`` in shared memory
    and a ring stage holds a whole tile's x (``kc`` = Ci), so every x byte
    is read once; elsewhere (64 x 32) a ring stage holds ``kc`` = 32
    channels of the tile's x and of the current pair's weights, so any Ci
    fits. ``grid`` = (blocks, Co / tco): the blocks of a co tile walk
    contiguous ranges of the ``tiles``, block b taking [b * T / G, (b + 1)
    * T / G). ``smem`` is the resident weights, a 2-stage ring and one
    pair's staged outputs."""
    d, h, w = size
    resident = (ci, co) in UP_FWD_RESIDENT
    tm, tco = UP_FWD_RESIDENT.get((ci, co), (UP_FWD_TM, 32))
    kc = ci if resident else UP_FWD_KC
    stage = tm * kc * 2 + (0 if resident else 2 * kc * tco * 2)
    smem = 8 * ci * tco * 2 * resident + 2 * stage + 2 * tm * tco * 2
    tiles = n * d * -(-h // (tm // UP_VW)) * -(-w // UP_VW)
    groups = co // tco
    return dict(tm=tm, tco=tco, kc=kc, resident=resident, tiles=tiles,
                grid=(min(tiles, max(1, sms // groups)), groups), smem=smem)


# tiles of the backward kernels (csrc/upsample2x_bwd.cu): coarse-voxel tiles
# of vh x UP_VW voxels of one (n, d); dW's K chunks are UP_DW_VH x UP_VW
UP_VW, UP_DW_VH, UP_DW_STAGES = 16, 4, 4
UP_DX_MAX_CO = 256     # dx with 32-ci tiles: its resident weights


def _up_bwd_plan(n: int, size, ci: int, co: int, sms: int) -> dict:
    """The launches of the upsample backward kernels for coarse extents
    ``size`` = (D, H, W).

    ``dx``: a block owns tiles of ``tm`` coarse voxels (``tm / 16`` rows of
    h x 16 w of one (n, d); tile t = ((n * D + d) * nhg + hg) * nwg + wg)
    x ``tci`` input channels, all 8 parities and all Co in its K: 128 x 128
    at 128->64 and 256 x 64 at 64->32 (so every gy byte is read once),
    128 x 32 otherwise; gy streams through a ring of ``stages`` of one
    (a, b) x ``kc`` channels beside the resident weights (``smem`` bytes in
    all). ``grid`` = (blocks, Ci / tci): the blocks of a ci
    tile walk contiguous ranges of the ``tiles``, block b taking [b * T /
    G, (b + 1) * T / G).

    ``dw``: a block owns the output tile of ``pb`` parities x ``tci`` x
    ``tco`` (8 x 64 x 32 at 64->32, all of it; 2 x 128 x 64 at 128->64, the
    parities (a, b, 0..1) of one (a, b): gy read once, x 4 times; 8 x 32 x
    32 otherwise) over a range of the ``chunks`` of 4 x 16 coarse voxels
    (numbered as dx's tiles): ``splits`` ranges per tile, so that tiles x
    splits blocks fill the SMs once. Block = split * tiles + tile, tile =
    (parity group * (Ci / tci) + ci tile) * (Co / tco) + co tile; split s
    takes chunks [s * C / splits, (s + 1) * C / splits) and stores its
    partial tile to slice s of the fp32 ``scratch``, which a second kernel
    adds in split order."""
    d, h, w = size
    nwg = -(-w // UP_VW)
    if co == 64 and ci % 128 == 0:
        xt = (128, 128, 64, 3)
    elif co == 32 and ci % 64 == 0:
        xt = (256, 64, 32, 6)
    else:
        xt = (128, 32, 32, 6)
    tm, xci, kc, stages = xt
    dx_tiles = n * d * -(-h // (tm // UP_VW)) * nwg
    ci_tiles = ci // xci
    dx = dict(tm=tm, tci=xci, kc=kc, stages=stages, tiles=dx_tiles,
              grid=(min(dx_tiles, max(1, sms // ci_tiles)), ci_tiles),
              smem=16 * xci * co + stages * 4 * tm * kc)
    if co == 32 and ci % 64 == 0:
        wt = (64, 32, 8)
    elif co == 64 and ci % 128 == 0:
        wt = (128, 64, 2)
    else:
        wt = (32, 32, 8)
    wci, wco, pb = wt
    tiles = (8 // pb) * (ci // wci) * (co // wco)
    chunks = n * d * -(-h // UP_DW_VH) * nwg
    splits = max(1, min(chunks, sms // tiles))
    vox = UP_DW_VH * UP_VW
    dw = dict(tci=wci, tco=wco, pb=pb, tiles=tiles, chunks=chunks,
              splits=splits, blocks=tiles * splits,
              scratch=(splits, 8, ci, co),
              smem=UP_DW_STAGES * 2 * vox * (wci + pb * wco))
    return dict(dx=dx, dw=dw)


def up2_row(ab: int, c: int, vox: int, vw: int, hh: int, k: int) -> int:
    """The staged row of the backward kernels' gy tile (csrc/upsample2x_bwd.cu
    ``gy_slots``), and of the forward kernel's output tile of one pair
    (csrc/upsample2x.cu, ``ab`` = 0), that holds fine voxel (2 * hh + b, 2 *
    k + c) of the tile's (a, b) = ``ab`` (0..3, in the order staged), for
    coarse row ``hh`` and
    coarse w ``k`` of a tile of ``vox`` voxels, ``vw`` along w: the parity
    blocks (ab, c) of ``vox`` rows each, in that order, and in each the
    tile's voxels row-major, so coarse voxel v = hh * vw + k of parity
    (a, b, c) is row (2 * ab + c) * vox + v."""
    return (2 * ab + c) * vox + hh * vw + k


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
    if x.data_ptr() % 16 or wf.data_ptr() % 16:
        raise ValueError("upsample2x: x and wf must be 16-byte aligned")
    plan = _up_fwd_plan(n, (d, h, w), ci, co, _sm_count(x.device))
    y = torch.empty((n, 2 * d, 2 * h, 2 * w, co), dtype=torch.bfloat16,
                    device=x.device)
    with torch.cuda.device(x.device):
        rc = _fn()(x.data_ptr(), wf.data_ptr(), y.data_ptr(), n, d, h, w, ci,
                   co, plan["tm"], plan["tco"], plan["smem"], plan["tiles"],
                   plan["grid"][0],
                   torch.cuda.current_stream(x.device).cuda_stream)
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
    if wf.data_ptr() % 16:
        raise ValueError(f"{fn}: wf must be 16-byte aligned")
    plan = _up_bwd_plan(n, (d, h, w), ci, co, _sm_count(gy.device))["dx"]
    if plan["tci"] == 32 and co > UP_DX_MAX_CO:
        raise ValueError(f"{fn}: unsupported channels {ci}->{co} (Co > "
                         f"{UP_DX_MAX_CO} outside 128->64 and 64->32)")
    dx = torch.empty((n, d, h, w, ci), dtype=torch.bfloat16, device=gy.device)
    with torch.cuda.device(gy.device):
        rc = _fn(fn)(gy.data_ptr(), wf.data_ptr(), dx.data_ptr(), n, d, h, w,
                     ci, co, plan["tci"], plan["grid"][0],
                     torch.cuda.current_stream(gy.device).cuda_stream)
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
    plan = _up_bwd_plan(n, (d, h, w), ci, co, _sm_count(x.device))["dw"]
    dw = torch.empty((2, 2, 2, ci, co), dtype=torch.float32, device=x.device)
    part = torch.empty(plan["scratch"], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _fn(fn)(x.data_ptr(), gy.data_ptr(), dw.data_ptr(),
                     part.data_ptr(), n, d, h, w, ci, co, plan["tci"],
                     plan["tco"], plan["splits"],
                     torch.cuda.current_stream(x.device).cuda_stream)
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
