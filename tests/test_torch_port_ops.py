"""The torch port's ops against the JAX package, on the CPU.

Each kernel's plain PyTorch version (the path a CPU tensor takes through
the wrapper) is held against ``lax.conv_general_dilated`` or the JAX
package's own ops on the same numpy inputs, in fp32. Tolerance: 1e-4
relative and absolute, because both sides compute in fp32 but sum in
another order (oneDNN vs XLA); the measured differences are ~1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from mt3d_resenc_unet_tpu.ops import instance_norm as jnorm
from mt3d_resenc_unet_tpu.ops.pallas_conv import is_supported, s2_supported
from mt3d_resenc_unet_torch.ops import _build
from mt3d_resenc_unet_torch.ops import instance_norm as tnorm
from mt3d_resenc_unet_torch.ops.conv3d import (conv3d_k3, conv3d_k3_plain,
                                               conv_s1_supported,
                                               conv_s2_supported)
from mt3d_resenc_unet_torch.ops.upsample import (upsample2x,
                                                 upsample2x_supported,
                                                 upsample_plain)

RTOL = ATOL = 1e-4
SLOPE = 1e-2


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _jax_conv(x, w, stride):
    return lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride,) * 3, ((1, 1),) * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=lax.Precision.HIGHEST)


def _leaky(u):
    return jnp.where(u >= 0, u, u * SLOPE)


def _case(stride, seed=0):
    rng = np.random.default_rng(seed)
    ci, co = (32, 32) if stride == 1 else (32, 64)
    x = rng.standard_normal((2, 8, 6, 8, ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, ci, co)) * 0.05).astype(np.float32)
    return rng, x, w


@pytest.mark.parametrize("mode", ["plain", "stats", "pre_stats",
                                  "addin_stats"])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv3d_plain_matches_xla(stride, mode):
    rng, x, w = _case(stride)
    n, ci, co = x.shape[0], x.shape[-1], w.shape[-1]
    pre = add = None
    xin = jnp.asarray(x)
    if mode == "pre_stats":
        pre = np.stack([rng.uniform(0.5, 2.0, (n, ci)),
                        rng.standard_normal((n, ci))], 1).astype(np.float32)
        xin = _leaky(xin * pre[:, 0, None, None, None, :]
                     - pre[:, 1, None, None, None, :])
    ref = _jax_conv(xin, w, stride)
    if mode == "addin_stats":
        x1 = rng.standard_normal(x.shape).astype(np.float32)
        w1 = (rng.standard_normal(w.shape) * 0.05).astype(np.float32)
        add_j = _jax_conv(x1, w1, stride)
        add = np.asarray(add_j)
        ref = ref + add_j
    out = conv3d_k3_plain(_t(x), _t(w), stride,
                          pre=_t(pre) if pre is not None else None,
                          add_to=_t(add) if add is not None else None,
                          emit_stats=mode != "plain", negative_slope=SLOPE)
    y, stats = out if mode != "plain" else (out, None)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), RTOL, ATOL)
    if stats is not None:
        want = np.stack([np.asarray(jnp.sum(ref, axis=(1, 2, 3))),
                         np.asarray(jnp.sum(ref * ref, axis=(1, 2, 3)))], 1)
        # sums over ~400 voxels reach ~1e3: atol 1e-2 is ~1e-5 relative
        np.testing.assert_allclose(stats.numpy(), want, 1e-4, 1e-2)
        assert stats.shape == (n, 2, co) and stats.dtype == torch.float32


@pytest.mark.parametrize("stride", [1, 2])
def test_conv3d_pre_op_pads_with_zeros_after_norm(stride):
    """A zero input with shift -1 normalizes to 1 inside the volume; the
    padding must stay 0, so a corner output sees 8 taps, not 27."""
    ci = co = 32
    x = torch.zeros(1, 4, 4, 4, ci)
    w = torch.ones(3, 3, 3, ci, co)
    pre = torch.stack([torch.ones(1, ci), -torch.ones(1, ci)], 1)
    y = conv3d_k3_plain(x, w, stride, pre=pre)
    assert float(y[0, 0, 0, 0, 0]) == pytest.approx(8 * ci)
    if stride == 1:
        assert float(y[0, 1, 1, 1, 0]) == pytest.approx(27 * ci)


def test_conv3d_wrapper_on_cpu_is_the_plain_version():
    _, x, w = _case(1)
    _build.LAUNCHES.clear()
    y, st = conv3d_k3(_t(x), _t(w), 1, emit_stats=True)
    y0, st0 = conv3d_k3_plain(_t(x), _t(w), 1, emit_stats=True)
    assert torch.equal(y, y0) and torch.equal(st, st0)
    assert sum(_build.LAUNCHES.values()) == 0  # no kernel launched


def test_wrappers_raise_off_cpu_without_a_kernel():
    """No fallback: a tensor that is not on the CPU goes to the kernel or
    the wrapper raises."""
    x = torch.empty(1, 4, 4, 4, 32, device="meta")
    w = torch.empty(3, 3, 3, 32, 32, device="meta")
    with pytest.raises(ValueError):
        conv3d_k3(x, w)
    with pytest.raises(ValueError):
        upsample2x(x, torch.empty(2, 2, 2, 32, 32, device="meta"))


def _jax_upsample(x, kernel):
    from mt3d_resenc_unet_tpu.models.network import UpsampleConv
    mod = UpsampleConv(features=kernel.shape[-1], kernel_size=(2, 2, 2),
                       dtype=jnp.float32)
    return np.asarray(mod.apply({"params": {"kernel": jnp.asarray(kernel)}},
                                jnp.asarray(x)))


@pytest.mark.parametrize("ci,co", [(128, 64), (64, 32), (64, 128)])
def test_upsample_plain_matches_jax_upsampleconv(ci, co):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 4, ci)).astype(np.float32)
    kernel = (rng.standard_normal((2, 2, 2, ci, co)) * 0.1).astype(np.float32)
    ref = _jax_upsample(x, kernel)
    wf = torch.flip(_t(kernel), dims=(0, 1, 2)).contiguous()
    np.testing.assert_allclose(upsample_plain(_t(x), wf).numpy(), ref,
                               RTOL, ATOL)
    np.testing.assert_allclose(upsample2x(_t(x), wf).numpy(), ref,
                               RTOL, ATOL)


# flagship shapes (N=2, 128^3 patch): (x_shape, w_shape)
_S1 = [((2, 128, 128, 128, 32), (3, 3, 3, 32, 32)),
       ((2, 64, 64, 64, 64), (3, 3, 3, 64, 64)),
       ((2, 32, 32, 32, 128), (3, 3, 3, 128, 128)),
       ((2, 16, 16, 16, 256), (3, 3, 3, 256, 256)),
       ((2, 8, 8, 8, 512), (3, 3, 3, 512, 512)),
       ((2, 4, 4, 4, 512), (3, 3, 3, 512, 512)),
       ((2, 128, 128, 128, 1), (3, 3, 3, 1, 32))]
_S2 = [((2, 128, 128, 128, 32), (3, 3, 3, 32, 64)),
       ((2, 64, 64, 64, 64), (3, 3, 3, 64, 128)),
       ((2, 32, 32, 32, 128), (3, 3, 3, 128, 256)),
       ((2, 16, 16, 16, 256), (3, 3, 3, 256, 512))]


@pytest.mark.parametrize("xs,ws", _S1)
def test_stride1_kernel_class_is_the_jax_banded_class(xs, ws):
    assert conv_s1_supported(xs, ws) == is_supported(xs, ws)


@pytest.mark.parametrize("xs,ws", _S2)
def test_stride2_kernel_class_is_the_jax_s2_class(xs, ws):
    assert conv_s2_supported(xs, ws) == s2_supported(xs, ws)


@pytest.mark.parametrize("xs,ci,co,want", [
    ((2, 32, 32, 32, 128), 128, 64, True),
    ((2, 64, 64, 64, 64), 64, 32, True),
    ((2, 4, 4, 4, 512), 512, 512, False),
    ((2, 8, 8, 8, 512), 512, 256, False),
    ((2, 16, 16, 16, 256), 256, 128, False)])
def test_upsample_kernel_class_is_the_jax_packed_class(xs, ci, co, want):
    assert upsample2x_supported(xs, ci, co) == want


def test_stats_to_scale_shift_matches_jax():
    rng = np.random.default_rng(2)
    y = rng.standard_normal((2, 5, 6, 7, 16)).astype(np.float32) * 3 + 1
    stats = np.stack([y.sum((1, 2, 3)), (y * y).sum((1, 2, 3))], 1)
    count = 5 * 6 * 7
    ja, jb = jnorm.stats_to_scale_shift(jnp.asarray(stats), 1, count, 1e-5)
    ta, tb = tnorm.stats_to_scale_shift(_t(stats), count, 1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), RTOL, ATOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), RTOL, ATOL)
    np.testing.assert_allclose(tnorm.instance_stats(_t(y)).numpy(),
                               np.asarray(jnorm.packed_stats_xla(
                                   jnp.asarray(y))), 1e-5, 1e-3)


@pytest.mark.parametrize("variant", ["act", "noact", "residual",
                                     "residual_pre"])
def test_norm_apply_matches_jax(variant):
    rng = np.random.default_rng(3)
    y = rng.standard_normal((2, 4, 5, 6, 8)).astype(np.float32)
    inv = rng.uniform(0.5, 2, (2, 8)).astype(np.float32)
    shift = rng.standard_normal((2, 8)).astype(np.float32)
    res = rng.standard_normal(y.shape).astype(np.float32)
    rpre = (rng.uniform(0.5, 2, (2, 8)).astype(np.float32),
            rng.standard_normal((2, 8)).astype(np.float32))
    act = variant != "noact"
    r = res if variant.startswith("residual") else None
    rp = rpre if variant == "residual_pre" else None
    want = jnorm.norm_apply_packed(
        jnp.asarray(y), jnp.asarray(inv), jnp.asarray(shift), SLOPE, act,
        residual=None if r is None else jnp.asarray(r),
        residual_pre=None if rp is None else tuple(map(jnp.asarray, rp)))
    got = tnorm.norm_apply(
        _t(y), _t(inv), _t(shift), SLOPE, act,
        residual=None if r is None else _t(r),
        residual_pre=None if rp is None else tuple(map(_t, rp)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)


@pytest.mark.parametrize("residual", [False, True])
def test_instance_norm_act_matches_jax(residual):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 6, 6, 8, 32)) * 2 + 0.5).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32) if residual else None
    want = jnorm.instance_norm_act_packed(
        jnp.asarray(x), None, None, 1e-5, SLOPE, True,
        residual=None if r is None else jnp.asarray(r))
    got = tnorm.instance_norm_act(_t(x), 1e-5, SLOPE, True,
                                  residual=None if r is None else _t(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)


def test_port_package_imports_no_jax():
    """The port's modules import torch and never jax."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    for path in (root / "mt3d_resenc_unet_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "mt3d_resenc_unet_tpu import" not in text, path
        assert "from mt3d_resenc_unet_tpu" not in text, path
    assert jax is not None  # the reference side of these tests
