"""The torch port's fused instance norm + LeakyReLU against the JAX package,
on the CPU.

``instance_norm_act_fused`` here runs the plain versions of its four CUDA
kernels (the path a CPU tensor takes through the wrappers). It is held
against the JAX Pallas op ``instance_norm_act_pallas`` in TPU interpret
mode (as tests/test_pallas_norm.py runs it) and against the XLA
``instance_norm_act``, on the same seeded numpy inputs at (2, 4, 4, 8, 16):

* forward, fp32: rtol 1e-4, atol 1e-5 (the JAX test's own limits); both
  sides compute in fp32 and differ only by summation order;
* gradients of ``sum(y * g)``: ``NormActFn``'s backward against
  ``jax.grad`` of the Pallas op, 1e-4 relative and absolute (same fp32
  formulas, summed in another order);
* bf16 forward against the XLA path: both round every elementwise
  operation to bf16 after the same fp32 statistics, so they may differ by
  one bf16 step where the fp32 statistics differ in their last bit: 1/128
  of the output's max abs.

Interpret mode is slow, so it runs three cases only.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.ops.instance_norm import instance_norm_act
from mt3d_resenc_unet_tpu.ops.pallas_norm_act import instance_norm_act_pallas
from mt3d_resenc_unet_torch.ops import _build
from mt3d_resenc_unet_torch.ops import norm_act as tna

SHAPE = (2, 4, 4, 8, 16)


def _inputs(seed, affine=False):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(SHAPE) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal(SHAPE).astype(np.float32)
    sb = (rng.standard_normal((2, SHAPE[-1])).astype(np.float32)
          if affine else (None, None))
    return x, g, sb[0], sb[1]


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _t(a, **kw):
    return None if a is None else torch.tensor(a, **kw)


@pytest.fixture
def interpret():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("act,affine", [(True, False), (False, False),
                                        (True, True)])
def test_forward_and_grad_match_pallas_interpret(interpret, act, affine):
    x, g, scale, bias = _inputs(1, affine)

    def f(xj):
        return jnp.sum(instance_norm_act_pallas(xj, _jnp(scale), _jnp(bias),
                                                act=act) * g)

    want = instance_norm_act_pallas(jnp.asarray(x), _jnp(scale), _jnp(bias),
                                    act=act)
    want_dx = jax.grad(f)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = tna.instance_norm_act_fused(xt, _t(scale), _t(bias), act=act)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("act,affine", [(True, False), (False, False),
                                        (True, True)])
def test_forward_matches_xla(act, affine):
    x, _, scale, bias = _inputs(2, affine)
    want = instance_norm_act(jnp.asarray(x), _jnp(scale), _jnp(bias),
                             act=act)
    got = tna.instance_norm_act_fused(torch.from_numpy(x), _t(scale),
                                      _t(bias), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_grad_matches_xla_autodiff():
    """The hand-written backward against JAX's autodiff of the XLA op,
    which shares no code with it: the JAX test's 1e-3 / 1e-4 limits."""
    x, g, _, _ = _inputs(3)
    want = jax.grad(lambda xj: jnp.sum(instance_norm_act(xj) * g))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (tna.instance_norm_act_fused(xt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-4)


def test_bf16_forward_matches_xla():
    x, _, _, _ = _inputs(4)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(instance_norm_act(xb).astype(jnp.float32))
    got = tna.instance_norm_act_fused(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 1 / 128, err


def test_backward_mask_uses_fp32_xhat():
    """The backward rebuilds fp32 xhat and masks on it, as the TPU kernel:
    a voxel whose bf16 output rounds to 0 still takes the slope its fp32
    xhat says."""
    x2 = torch.tensor([[[0.0], [1.0], [2.0], [3.0]]]).repeat(1, 1, 8)
    x2 = (x2 + torch.tensor([1e-3] + [0.0] * 7)).bfloat16()
    stats = tna.norm_act_stats(x2, 1e-5)
    g = torch.ones_like(x2)
    gs = tna.norm_act_bwd_stats(x2, stats, g, 1e-2, True)
    xhat = (x2.float() - stats[:, None, 0]) * stats[:, None, 1]
    gp = torch.where(xhat >= 0, 1.0, 1e-2)
    torch.testing.assert_close(gs[:, 0], gp.sum(1))
    torch.testing.assert_close(gs[:, 1], (gp * xhat).sum(1))


def test_wrappers_run_plain_on_cpu_and_count_no_launch():
    _build.LAUNCHES.clear()
    x = torch.randn(2, 64, 32)
    stats = tna.norm_act_stats(x)
    y = tna.norm_act_norm(x, stats)
    gs = tna.norm_act_bwd_stats(x, stats, y)
    tna.norm_act_bwd_dx(x, stats, gs, y)
    assert not any(_build.LAUNCHES.values())
    torch.testing.assert_close(stats, tna.norm_act_stats_plain(x, 1e-5))
    assert "norm_act" in _build.SOURCES
