"""The torch port's sliding-window inference against the JAX package, on
the CPU.

``predict_volume`` is held against a numpy blend of the JAX model's eval
forward over the same grid, normalization and Gaussian map, with the same
parameters carried over by ``params_from_jax``; the normals are renormalized
to unit length on both sides. Tolerance: 1e-4 relative
and absolute (fp32 on both sides, sums in another order; see
test_torch_port_model.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.core.plan import TaskHead as JTaskHead
from mt3d_resenc_unet_tpu.core.plan import plan_from_autoconfig as jax_plan
from mt3d_resenc_unet_tpu.data.positions import \
    sliding_window_grid as jax_grid
from mt3d_resenc_unet_tpu.data.zio import normalize_to_unit as jax_unit
from mt3d_resenc_unet_tpu.infer.engine import standardize as jax_standardize
from mt3d_resenc_unet_tpu.infer.gaussian import gaussian_map as jax_gaussian
from mt3d_resenc_unet_tpu.models.network import ResEncUNet as JaxUNet
from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
from mt3d_resenc_unet_torch.data.positions import sliding_window_grid
from mt3d_resenc_unet_torch.infer.engine import (normalize_to_unit,
                                                 predict_volume, standardize)
from mt3d_resenc_unet_torch.infer.gaussian import gaussian_map
from mt3d_resenc_unet_torch.models.network import ResEncUNet
from mt3d_resenc_unet_torch.tools.from_jax import params_from_jax

PATCH = (16, 16, 16)
SHAPE = (48, 40, 40)
OVERLAP = 0.25


def _tasks(cls):
    return [cls("sheet", 1, "sigmoid"), cls("normals", 3, "none")]


def _jax_blend(model, params, vol):
    """Reference: the JAX engine's read path (normalize_to_unit then
    standardize), its eval forward, and a numpy Gaussian-weighted blend:
    the weighted mean, or for the normals the weighted sum renormalized to
    unit length as the JAX engine finalizes them (engine.py:579-584)."""
    positions = sorted(jax_grid(vol.shape, PATCH, OVERLAP))
    wmap = jax_gaussian(PATCH, 1.0 / 8)
    batch = np.stack([
        jax_standardize(jax_unit(vol[z:z + PATCH[0], y:y + PATCH[1],
                                     x:x + PATCH[2]], vol.dtype))
        for z, y, x in positions])[..., None]
    outs = jax.jit(lambda p, b: model.apply({"params": p}, b,
                                            train=False))(params, batch)
    result = {}
    weight = np.zeros(vol.shape, np.float32)
    for z, y, x in positions:
        weight[z:z + PATCH[0], y:y + PATCH[1], x:x + PATCH[2]] += wmap
    for name, pred in outs.items():
        pred = np.asarray(pred)
        acc = np.zeros(vol.shape + (pred.shape[-1],), np.float32)
        for i, (z, y, x) in enumerate(positions):
            acc[z:z + PATCH[0], y:y + PATCH[1], x:x + PATCH[2]] += \
                pred[i] * wmap[..., None]
        if name == "normals":
            # the engine's finalize: the weighted sum over its magnitude
            mag = np.sqrt(np.sum(acc * acc, axis=-1, keepdims=True))
            result[name] = acc / np.maximum(mag, 1e-30)
        else:
            result[name] = acc / weight[..., None]
    return result


@pytest.fixture(scope="module")
def blended():
    vol = np.random.default_rng(0).integers(0, 256, SHAPE, dtype=np.uint8)
    plan = jax_plan(PATCH, 1, _tasks(JTaskHead), max_features=64)
    model = JaxUNet(plan=plan, dtype=jnp.float32)
    params = jax.jit(lambda k: model.init(
        {"params": k}, jnp.zeros((1,) + PATCH + (1,)), train=False))(
        jax.random.key(1))["params"]
    want = _jax_blend(model, params, vol)
    port = ResEncUNet(plan_from_autoconfig(PATCH, 1, _tasks(TaskHead),
                                           max_features=64,
                                           use_pallas_conv=True))
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    got = predict_volume(port, vol, PATCH, OVERLAP, batch_size=3,
                         device=torch.device("cpu"))
    return got, want


@pytest.mark.parametrize("task,channels", [("sheet", 1), ("normals", 3)])
def test_predict_volume_matches_jax_blend(blended, task, channels):
    got, want = blended
    assert got[task].shape == SHAPE + (channels,)
    assert got[task].dtype == np.float32
    assert np.isfinite(got[task]).all()
    np.testing.assert_allclose(got[task], want[task], 1e-4, 1e-4)


def test_sheet_blend_is_a_probability(blended):
    sheet = blended[0]["sheet"]
    assert sheet.min() >= 0.0 and sheet.max() <= 1.0


def test_served_normals_have_unit_length(blended):
    normals = blended[0]["normals"]
    np.testing.assert_allclose(np.linalg.norm(normals, axis=-1), 1.0,
                               atol=1e-5)


def test_predict_volume_rejects_unknown_normalization():
    port = ResEncUNet(plan_from_autoconfig(PATCH, 1, _tasks(TaskHead),
                                           max_features=64))
    with pytest.raises(ValueError):
        predict_volume(port, np.zeros(PATCH, np.uint8), PATCH,
                       normalization="zscore")


@pytest.mark.parametrize("shape,patch,overlap", [
    ((48, 40, 40), (16, 16, 16), 0.25), ((160, 256, 256), (128,) * 3, 0.25),
    ((130, 64, 200), (64, 64, 64), 0.5)])
def test_grid_copy_matches_jax(shape, patch, overlap):
    assert sliding_window_grid(shape, patch, overlap) == \
        jax_grid(shape, patch, overlap)


@pytest.mark.parametrize("patch", [(16, 16, 16), (128, 128, 128)])
def test_gaussian_copy_matches_jax(patch):
    np.testing.assert_array_equal(gaussian_map(patch, 1.0 / 8),
                                  jax_gaussian(patch, 1.0 / 8))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_normalization_copies_match_jax(dtype):
    rng = np.random.default_rng(5)
    hi = np.iinfo(dtype).max if np.issubdtype(dtype, np.integer) else 1.0
    raw = (rng.random((6, 7, 8)) * hi).astype(dtype)
    unit = normalize_to_unit(raw, raw.dtype)
    np.testing.assert_array_equal(unit, jax_unit(raw, raw.dtype))
    np.testing.assert_array_equal(standardize(unit), jax_standardize(unit))
