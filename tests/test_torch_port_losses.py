"""The torch port's losses and wire decode against the JAX package's, on
the CPU.

Every loss of ``LOSS_FN_MAP``, the wrappers and ``build_task_losses`` get
the same numpy inputs (NDHWC, seeded) on both sides; values and the
gradient with respect to the prediction must agree to rtol/atol 1e-6
(gradients: after dividing by the JAX gradient's max abs). Both sides are
fp32 and use the same formulas and epsilons; they differ only in the order
of the sums, ~1e-7 relative at these sizes. ``decode_wire`` must be
bit-identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.train import losses as jl
from mt3d_resenc_unet_tpu.train.step import decode_wire as jax_decode
from mt3d_resenc_unet_torch.train import losses as tl
from mt3d_resenc_unet_torch.train.step import decode_wire

TOL = 1e-6
SHAPE = (2, 4, 5, 6)


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    c = {"MaskedCosineLoss": 3, "CrossEntropyLoss": 4,
         "GeneralizedDiceLoss": 1}.get(name, 2)
    pred = (rng.standard_normal(SHAPE + (c,)) * 2).astype(np.float32)
    if name == "MaskedCosineLoss":
        target = rng.standard_normal(SHAPE + (3,)).astype(np.float32)
        target[0, 0] = 0.0        # voxels without a normal are masked out
    elif name == "CrossEntropyLoss":
        target = rng.dirichlet(np.ones(c), SHAPE).astype(np.float32)
    elif name == "BCELoss":
        pred = rng.uniform(0.0, 1.0, pred.shape).astype(np.float32)
        target = (rng.random(pred.shape) > 0.5).astype(np.float32)
    else:
        target = (rng.random(pred.shape) > 0.5).astype(np.float32)
    return pred, target


def _compare(jfn, tfn, pred, target):
    jv, jg = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(target)))(
        jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    tv = tfn(p, torch.from_numpy(target))
    tv.backward()
    assert tv.dtype == torch.float32 and tv.dim() == 0
    np.testing.assert_allclose(float(tv.detach()), float(jv), TOL, TOL)
    sc = float(np.abs(np.asarray(jg)).max()) + 1e-12
    np.testing.assert_allclose(p.grad.numpy() / sc, np.asarray(jg) / sc,
                               TOL, TOL)


@pytest.mark.parametrize("name", sorted(tl.LOSS_FN_MAP))
def test_loss_matches_jax(name):
    assert sorted(tl.LOSS_FN_MAP) == sorted(jl.LOSS_FN_MAP)
    pred, target = _inputs(name)
    _compare(jl.LOSS_FN_MAP[name](), tl.LOSS_FN_MAP[name](), pred, target)


@pytest.mark.parametrize("name,kwargs", [
    ("DiceLoss", {"normalization": "softmax", "smooth_factor": 0.1}),
    ("DiceLoss", {"normalization": "none", "weight": (0.3, 0.7)}),
    ("GeneralizedDiceLoss", {"normalization": "softmax"}),
    ("BCEWithLogitsLoss", {"reduction": "sum"}),
    ("BCEDiceLoss", {"alpha": 0.3, "beta": 0.9}),
    ("BCEWithLogitsLossZSmooth", {"center_smoothing": 0.05,
                                  "edge_smoothing": 0.3}),
    ("MSELoss", {"reduction": "sum"}),
])
def test_loss_options_match_jax(name, kwargs):
    pred, target = _inputs(name, seed=1)
    _compare(jl.LOSS_FN_MAP[name](**kwargs), tl.LOSS_FN_MAP[name](**kwargs),
             pred, target)


def test_cross_entropy_index_targets_match_jax():
    rng = np.random.default_rng(2)
    pred = rng.standard_normal(SHAPE + (4,)).astype(np.float32)
    idx = rng.integers(0, 4, SHAPE + (1,)).astype(np.int32)
    jv = jl.CrossEntropyLoss()(jnp.asarray(pred), jnp.asarray(idx))
    tv = tl.CrossEntropyLoss()(torch.from_numpy(pred), torch.from_numpy(idx))
    np.testing.assert_allclose(float(tv), float(jv), TOL, TOL)


@pytest.mark.parametrize("wrapper", ["ignore", "on_label", "skip_last"])
def test_loss_wrappers_match_jax(wrapper):
    pred, target = _inputs("BCEDiceLoss", seed=3)
    if wrapper == "ignore":
        target[0, 1] = 2.0
        jw = jl.MaskingLossWrapper(jl.BCEDiceLoss(), 2.0)
        tw = tl.MaskingLossWrapper(tl.BCEDiceLoss(), 2.0)
    elif wrapper == "on_label":
        target[1, 2] = 0.0
        jw = jl.LossOnLabelWrapper(jl.BCEWithLogitsLoss())
        tw = tl.LossOnLabelWrapper(tl.BCEWithLogitsLoss())
    else:
        pred = pred[..., :1]
        jw = jl.SkipLastTargetChannelWrapper(jl.DiceLoss())
        tw = tl.SkipLastTargetChannelWrapper(tl.DiceLoss())
    _compare(jw, tw, np.ascontiguousarray(pred), target)


def test_build_task_losses_matches_jax():
    cfg = {"sheet": {"loss_fn": "BCEDiceLoss",
                     "loss_kwargs": {"alpha": 0.5, "beta": 0.5}},
           "normals": {"loss_fn": "MaskedCosineLoss"},
           "other": {}}
    jls = jl.build_task_losses(cfg, ignore_label=2.0,
                               loss_only_on_label=True)
    tls = tl.build_task_losses(cfg, ignore_label=2.0,
                               loss_only_on_label=True)
    assert list(tls) == list(jls)
    for name in cfg:
        pred, target = _inputs("MaskedCosineLoss" if name == "normals"
                               else "BCEDiceLoss", seed=4)
        _compare(jls[name], tls[name], pred, target)
    with pytest.raises(ValueError):
        tl.build_task_losses({"x": {"loss_fn": "NoSuchLoss"}})


def test_decode_wire_is_bit_identical_to_jax():
    rng = np.random.default_rng(5)
    batch = {
        "image": rng.integers(0, 256, (2, 3, 4, 5, 1)).astype(np.uint8),
        "sheet": rng.integers(0, 256, (2, 3, 4, 5, 1)).astype(np.uint8),
        "normals": np.concatenate([
            np.array([0, 1, 32767, 32768, 65534, 65535], np.uint16),
            rng.integers(0, 65536, 2 * 3 * 4 * 5 * 3 - 6).astype(np.uint16),
        ]).reshape(2, 3, 4, 5, 3),
        "depth": rng.integers(0, 65536, (2, 3)).astype(np.uint16),
        "mask": rng.random((2, 3)).astype(np.float32),
    }
    want = jax_decode({k: jnp.asarray(v) for k, v in batch.items()})
    got = decode_wire({k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for k in batch:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    bf = decode_wire({"image": torch.ones(2, dtype=torch.bfloat16)},
                     upcast_bf16=True)
    assert bf["image"].dtype == torch.float32
