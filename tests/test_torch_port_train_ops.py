"""The torch port's autograd Functions against the JAX ``custom_vjp``s they
mirror, on the CPU, and the two faults of the port repaired for training.

Each Function's backward runs its wrappers' plain versions here (the CPU
path), so what is tested is the Function's own logic: which cotangent goes
to which dx/dW call, the correction ``gy + gs[0] + 2*y*gs[1]``, the pre-op
backward ``[sum du*x; -sum du]``, the split pair and the dtypes. The JAX
side runs the Pallas kernels in interpret mode
(``pltpu.force_tpu_interpret_mode``, as tests/test_pallas_conv.py does) at
tiny shapes in fp32. Packed operands are a reshape of the port's NDHWC
tensors; the port's (N, 2, C) stats are the packed (N, 2, g*C) stats summed
over the g groups, so the cotangent fed to JAX is the port's ``gs`` tiled g
times, and a packed per-lane gradient (scale, shift) is summed over groups.

Tolerance: rtol 2e-3 / atol 2e-4 after dividing both sides by the JAX
side's max abs (as tests/test_pallas_conv.py compares the fused backward
paths): both sides are fp32, but the interpret-mode kernels and oneDNN sum
in other orders, and the stats' cotangent enters as ``2*y*gs[1]`` summed
over every voxel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mt3d_resenc_unet_tpu.ops.pallas_conv import (conv3d_packed_dual_stats,
                                                  conv3d_packed_ns,
                                                  conv3d_packed_stats,
                                                  conv3d_s2)
from mt3d_resenc_unet_tpu.ops.pallas_upsample import upsample2x_packed
from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
from mt3d_resenc_unet_torch.models.network import ResEncUNet
from mt3d_resenc_unet_torch.ops import _build
from mt3d_resenc_unet_torch.ops.conv3d import (Conv3dK3Fn, Conv3dK3PairFn,
                                               conv3d_k3, conv3d_k3_dw,
                                               conv3d_k3_dx,
                                               conv3d_k3_dx_plain)
from mt3d_resenc_unet_torch.ops.upsample import (Upsample2xFn, upsample2x,
                                                 upsample2x_dw, upsample2x_dx)

RTOL, ATOL = 2e-3, 2e-4
SLOPE = 1e-2
G = 4               # packing factor of a 32-channel conv (128 lanes)
X = (1, 4, 4, 32, 32)   # packed (1, 4, 4, 8, 128): the flat in-kernel path


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _close(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    sc = float(np.abs(want).max()) + 1e-8
    np.testing.assert_allclose(got / sc, want / sc, RTOL, ATOL, err_msg=name)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _pack(a, g=G):
    n, d, h, w, c = a.shape
    return jnp.asarray(a).reshape(n, d, h, w // g, g * c)


def _groups(a, g=G):
    """Packed per-lane (..., g*c) -> the port's (..., c): sum of groups."""
    a = np.asarray(a)
    return a.reshape(a.shape[:-1] + (g, a.shape[-1] // g)).sum(-2)


def _inputs(seed, x_shape=X, ci=32, co=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, ci, co)) * 0.1).astype(np.float32)
    return rng, x, w


def _cotangents(rng, y_shape):
    gy = rng.standard_normal(y_shape).astype(np.float32)
    gs = (rng.standard_normal((y_shape[0], 2, y_shape[-1])) * 0.1).astype(
        np.float32)
    return gy, gs


def test_conv_fn_matches_conv3d_packed_stats():
    rng, x, w = _inputs(0)
    gy, gs = _cotangents(rng, X)
    (yp, st), vjp = jax.vjp(lambda a, b: conv3d_packed_stats(a, b, G),
                            _pack(x), jnp.asarray(w))
    dxp, dw = vjp((_pack(gy), jnp.tile(jnp.asarray(gs), (1, 1, G))))

    xt, wt = _t(x, True), _t(w, True)
    y, stats = Conv3dK3Fn.apply(xt, wt, None, 1, SLOPE)
    torch.autograd.backward([y, stats], [_t(gy), _t(gs)])
    _close(y.detach(), np.asarray(yp).reshape(X), "y")
    _close(stats.detach(), _groups(st), "stats")
    _close(xt.grad, np.asarray(dxp).reshape(X), "dx")
    _close(wt.grad, dw, "dw")


def test_conv_fn_with_pre_matches_conv3d_packed_ns():
    rng, x, w = _inputs(1)
    gy, gs = _cotangents(rng, X)
    scale = rng.uniform(0.5, 2.0, (1, 32)).astype(np.float32)
    shift = rng.standard_normal((1, 32)).astype(np.float32)
    (yp, st), vjp = jax.vjp(
        lambda a, b, s, t: conv3d_packed_ns(a, b, s, t, G, SLOPE),
        _pack(x), jnp.asarray(w), jnp.tile(scale, (1, G)),
        jnp.tile(shift, (1, G)))
    dxp, dw, dscale, dshift = vjp((_pack(gy),
                                   jnp.tile(jnp.asarray(gs), (1, 1, G))))

    xt, wt = _t(x, True), _t(w, True)
    pre = _t(np.stack([scale, shift], 1), True)
    y, stats = Conv3dK3Fn.apply(xt, wt, pre, 1, SLOPE)
    torch.autograd.backward([y, stats], [_t(gy), _t(gs)])
    _close(y.detach(), np.asarray(yp).reshape(X), "y")
    _close(stats.detach(), _groups(st), "stats")
    _close(xt.grad, np.asarray(dxp).reshape(X), "dx")
    _close(wt.grad, dw, "dw")
    _close(pre.grad[:, 0], _groups(dscale), "dscale")
    _close(pre.grad[:, 1], _groups(dshift), "dshift")


def test_pair_fn_matches_conv3d_packed_dual_stats():
    rng, x1, w = _inputs(2, ci=64)
    x2 = rng.standard_normal(X).astype(np.float32)
    gy, gs = _cotangents(rng, X)
    (yp, st), vjp = jax.vjp(
        lambda a, b, c: conv3d_packed_dual_stats(a, b, c, G),
        _pack(x1), _pack(x2), jnp.asarray(w))
    dx1p, dx2p, dw = vjp((_pack(gy), jnp.tile(jnp.asarray(gs), (1, 1, G))))

    t1, t2, wt = _t(x1, True), _t(x2, True), _t(w, True)
    y, stats = Conv3dK3PairFn.apply(t1, t2, wt, 1)
    torch.autograd.backward([y, stats], [_t(gy), _t(gs)])
    _close(y.detach(), np.asarray(yp).reshape(X), "y")
    _close(stats.detach(), _groups(st), "stats")
    _close(t1.grad, np.asarray(dx1p).reshape(X), "dx1")
    _close(t2.grad, np.asarray(dx2p).reshape(X), "dx2")
    _close(wt.grad, dw, "dw")


@pytest.mark.parametrize("with_stats", [False, True])
def test_conv_fn_stride2_matches_conv3d_s2(with_stats):
    """JAX's stride-2 kernel emits no stats (their correction runs in XLA);
    the port's stride-2 conv does, so the JAX side takes its stats from
    XLA reductions of ``conv3d_s2``'s output and differentiates them."""
    x_shape, y_shape = (1, 8, 8, 16, 32), (1, 4, 4, 8, 64)
    rng, x, w = _inputs(3, x_shape, 32, 64)
    gy, gs = _cotangents(rng, y_shape)
    if not with_stats:
        gs = np.zeros_like(gs)

    def f(a, b):
        yv = conv3d_s2(a, b)
        return yv, jnp.stack([jnp.sum(yv, (1, 2, 3)),
                              jnp.sum(yv * yv, (1, 2, 3))], axis=1)

    (yj, sj), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp((jnp.asarray(gy), jnp.asarray(gs)))

    xt, wt = _t(x, True), _t(w, True)
    y, stats = Conv3dK3Fn.apply(xt, wt, None, 2, SLOPE)
    torch.autograd.backward([y, stats], [_t(gy), _t(gs)])
    _close(y.detach(), yj, "y")
    _close(stats.detach(), sj, "stats")
    _close(xt.grad, dx, "dx")
    _close(wt.grad, dw, "dw")


def _jax_upsample(x, kernel):
    """JAX ``UpsampleConv``'s packed path: the band matrix wb built in XLA
    from the flipped kernel (models/network.py), then ``upsample2x_packed``;
    gradients reach the kernel through wb's construction."""
    n, d, h, w, ci = x.shape
    co = kernel.shape[-1]
    g_o = 128 // co
    qn = g_o // 2
    wflip = jnp.flip(kernel, axis=(0, 1, 2))
    wb = jnp.zeros((2, 2, qn, ci, 2 * qn, co), kernel.dtype)
    for q in range(qn):
        for dk in range(2):
            wb = wb.at[:, :, q, :, 2 * q + dk, :].set(wflip[:, :, dk])
    wb = wb.reshape(2, 2, qn * ci, g_o * co)
    y = upsample2x_packed(x.reshape(n, d, h, w // qn, qn * ci), wb)
    return y.reshape(n, 2 * d, 2 * h, 2 * w, co)


@pytest.mark.parametrize("ci,co", [(128, 64), (64, 32)])
def test_upsample_fn_matches_upsample2x_packed(ci, co):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 2, 3, 4, ci)).astype(np.float32)
    kernel = (rng.standard_normal((2, 2, 2, ci, co)) * 0.1).astype(np.float32)
    gy = rng.standard_normal((1, 4, 6, 8, co)).astype(np.float32)
    yj, vjp = jax.vjp(_jax_upsample, jnp.asarray(x), jnp.asarray(kernel))
    dx, dk = vjp(jnp.asarray(gy))

    xt, kt = _t(x, True), _t(kernel, True)
    y = Upsample2xFn.apply(xt, torch.flip(kt, dims=(0, 1, 2)).contiguous())
    y.backward(_t(gy))
    _close(y.detach(), yj, "y")
    _close(xt.grad, dx, "dx")
    _close(kt.grad, dk, "dkernel")


# --- the two faults repaired for training ---------------------------------

def test_check_no_grad_raises_only_for_grad_requiring_inputs():
    a = torch.zeros(2, requires_grad=True)
    b = torch.zeros(2)
    _build.check_no_grad("k", b, None)
    with torch.no_grad():
        _build.check_no_grad("k", a, b)
    with pytest.raises(RuntimeError, match="records no gradient"):
        _build.check_no_grad("k", b, a)


def _meta(*shape, grad=False):
    return torch.empty(*shape, device="meta", requires_grad=grad)


@pytest.mark.parametrize("call", [
    lambda t: conv3d_k3(t((1, 4, 4, 4, 32), True), t((3, 3, 3, 32, 32))),
    lambda t: conv3d_k3_dx(t((1, 4, 4, 4, 32)), t((3, 3, 3, 32, 32), True)),
    lambda t: conv3d_k3_dw(t((1, 4, 4, 4, 32), True), t((1, 4, 4, 4, 32))),
    lambda t: upsample2x(t((1, 2, 2, 2, 64), True), t((2, 2, 2, 64, 32))),
    lambda t: upsample2x_dx(t((1, 4, 4, 4, 32)), t((2, 2, 2, 64, 32), True)),
    lambda t: upsample2x_dw(t((1, 2, 2, 2, 64), True), t((1, 4, 4, 4, 32))),
], ids=["conv3d_k3", "conv3d_k3_dx", "conv3d_k3_dw", "upsample2x",
        "upsample2x_dx", "upsample2x_dw"])
def test_kernel_wrappers_refuse_grad_requiring_device_tensors(call):
    """Off the CPU a wrapper goes to its kernel, which records no gradient:
    it raises rather than return an output without ``grad_fn``. (Meta
    tensors stand in for the card; without the grad they reach the device
    check instead.)"""
    with pytest.raises(RuntimeError, match="records no gradient"):
        call(lambda shape, grad=False: _meta(*shape, grad=grad))
    with pytest.raises(ValueError, match="unsupported device"):
        call(lambda shape, grad=False: _meta(*shape))


def test_model_returns_logits_in_train_mode():
    plan = plan_from_autoconfig((16, 16, 16), 1,
                                [TaskHead("sheet", 1, "sigmoid"),
                                 TaskHead("normals", 3, "softmax")],
                                max_features=64, use_pallas_conv=True)
    model = ResEncUNet(plan, seed=1)
    assert not model.training      # starts in eval mode
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 16, 16, 16, 1)).astype(np.float32))
    with torch.no_grad():
        probs = model(x)
        logits_eval = model(x, apply_activations=False)
        model.train()
        logits = model(x)
    for name, act in (("sheet", torch.sigmoid),
                      ("normals", lambda v: torch.softmax(v, -1))):
        torch.testing.assert_close(logits[name], logits_eval[name])
        torch.testing.assert_close(act(logits[name]), probs[name])
        assert not torch.allclose(logits[name], probs[name])


def _bf16(a):
    """float32 -> the nearest bf16 value (ties to even), as float32: the
    rounding written out on the bits."""
    b = np.asarray(a, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return b.view(np.float32)


@pytest.mark.parametrize("stride,post", [(1, False), (1, True), (2, False),
                                         (2, True)])
def test_plain_dx_rounds_the_corrected_cotangent_as_jax(stride, post):
    # bf16 gy: the corrected cotangent is rounded to bf16 before the
    # transposed conv (JAX _tile_corr_flat: u = gy + gs0 + 2*y*gs1 in fp32,
    # then u.astype(gy.dtype)), so the plain dx equals the plain dx of that
    # rounded cotangent without the correction, bit for bit
    rng = np.random.default_rng(11)
    n, ci, co, size = 2, 32, 32, (6, 5, 7)
    out = tuple((s - 1) // stride + 1 for s in size)
    gy, y = (_bf16(rng.standard_normal((n,) + out + (co,))) for _ in range(2))
    gs = (rng.standard_normal((n, 2, co)) * 0.3).astype(np.float32)
    w = _bf16(rng.standard_normal((3, 3, 3, ci, co)) * 0.1)
    u = (gy + gs[:, 0, None, None, None]) + \
        (np.float32(2) * y) * gs[:, 1, None, None, None]
    bf = torch.bfloat16
    kw = {}
    if post:
        kw = dict(x=torch.from_numpy(_bf16(rng.standard_normal(
            (n,) + size + (ci,)))).to(bf), pre=torch.from_numpy(np.stack(
                [rng.random((n, ci)) + 0.5, rng.standard_normal((n, ci))],
                1).astype(np.float32)))
    wt = torch.from_numpy(w).to(bf)
    got = conv3d_k3_dx_plain(torch.from_numpy(gy).to(bf), wt, stride,
                             y=torch.from_numpy(y).to(bf),
                             gs=torch.from_numpy(gs), size=size, **kw)
    want = conv3d_k3_dx_plain(torch.from_numpy(_bf16(u)).to(bf), wt, stride,
                              size=size, **kw)
    unrounded = conv3d_k3_dx_plain(torch.from_numpy(u), wt.float(), stride,
                                   size=size, **kw)
    got, want, unrounded = ((r if post else (r,)) for r in (got, want,
                                                           unrounded))
    assert got[0].dtype == bf
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # and the rounding shows: the fp32 cotangent gives another dx
    assert not torch.equal(got[0], unrounded[0].to(bf))
