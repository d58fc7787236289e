"""Squeeze-excitation in the torch port against the JAX package, on the CPU.

The plan is ``tests/test_torch_port_model.py``'s 32^3 4-stage cut of the
flagship (``max_features=256``; 32, 64, 128, 256 channels, blocks 1, 3, 4,
6) with ``squeeze_excitation=True``, as ``tasks/sheet_normals.yaml`` sets
it. JAX runs its XLA path in fp32, the port fp32 with
``use_pallas_conv=True`` (the kernel wrappers run their plain versions
here), from the same parameters (``params_from_jax``, ``strict=True``) and
a seeded numpy batch:

* ``count_params`` and the state dict's names and shapes equal JAX's;
* the eval forward within 1e-4 (rtol and atol; measured ~3e-6);
* the train-mode multi-task loss within 1e-5 relative (measured 3.1e-7);
* every gradient to JAX_TOL in relative L2 norm with cosine >= JAX_MIN_COS,
  the limits of tests/test_torch_port_train.py (measured 0.0086 and
  0.99996). Elementwise the two differ by up to 5.5% of a tensor's max abs
  (72 of the 76 tensors by more than 2e-3): at random init an fp32
  LeakyReLU input within rounding of 0 takes either slope in the two
  frameworks (the hazard that file documents), so no elementwise limit
  holds across frameworks; the Functions against plain autograd of the
  port (same roundings) are held elementwise to FN_TOL of each tensor's max
  (measured 4.8e-6);
* the exceptions of the reference's degenerate squeeze: an SE's input is
  instance-normalized without affine, so its spatial mean is 0 up to
  rounding, every gate is close to a per-channel constant and
  ``se.reduce.kernel``'s gradient is rounding noise (measured |g| <=
  2.3e-10 on both sides, cosine ~0). The gates are held by an absolute
  limit (GATE_ATOL) and that gradient by REDUCE_ATOL on the difference.

The module alone: ``_make_divisible`` (32 -> 8, 512 -> 32), the flax Dense
layout and torch Linear's init, and the fp32 and bf16 forward against JAX
``SqueezeExcite`` on an input with a non-zero mean (bf16: the roundings JAX
makes, within 1e-2 of the output's max, as the other bf16 ops).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.core.plan import TaskHead as JTaskHead
from mt3d_resenc_unet_tpu.core.plan import plan_from_autoconfig as jax_plan
from mt3d_resenc_unet_tpu.models import blocks as jblocks
from mt3d_resenc_unet_tpu.models.network import ResEncUNet as JaxUNet
from mt3d_resenc_unet_tpu.models.network import count_params as jax_count
from mt3d_resenc_unet_tpu.train import losses as jl
from mt3d_resenc_unet_tpu.train import step as js
from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
from mt3d_resenc_unet_torch.models import blocks
from mt3d_resenc_unet_torch.models.network import ResEncUNet, count_params
from mt3d_resenc_unet_torch.tools.from_jax import params_from_jax
from mt3d_resenc_unet_torch.train import losses as tl
from mt3d_resenc_unet_torch.train import step as ts

PATCH = (32, 32, 32)
RTOL = ATOL = 1e-4
LOSS_RTOL = 1e-5
FN_TOL = 1e-4
JAX_TOL = 0.1
JAX_MIN_COS = 0.995
GATE_ATOL = 1e-5
REDUCE_ATOL = 1e-8
LOSS_CFG = {"sheet": {"loss_fn": "BCEDiceLoss",
                      "loss_kwargs": {"alpha": 0.5, "beta": 0.5}},
            "normals": {"loss_fn": "MaskedCosineLoss"}}
WEIGHTS = {"sheet": 1.0, "normals": 1.0}


def _tasks(cls):
    return [cls("sheet", 1, "sigmoid"), cls("normals", 3, "none")]


def _batch():
    rng = np.random.default_rng(0)
    return {"image": rng.random((2,) + PATCH + (1,), np.float32),
            "sheet": (rng.random((2,) + PATCH + (1,)) > 0.5).astype(
                np.float32),
            "normals": rng.standard_normal((2,) + PATCH + (3,)).astype(
                np.float32)}


def _gate_name(path) -> str:
    return ".".join(k.key for k in path[:-2])


@pytest.fixture(scope="module")
def jax_se():
    plan = jax_plan(PATCH, 1, _tasks(JTaskHead), max_features=256,
                    squeeze_excitation=True)
    model = JaxUNet(plan=plan, dtype=jnp.float32)
    params = jax.jit(lambda k: model.init(
        {"params": k}, jnp.zeros((1,) + PATCH + (1,)), train=False))(
        jax.random.key(0))["params"]
    batch = _batch()
    targets = {k: v for k, v in batch.items() if k != "image"}

    def forward(p, x):
        # each SE's gate: the sigmoid of its "expand" Dense output
        return model.apply({"params": p}, x, train=False,
                           capture_intermediates=lambda m, _: m.name
                           == "expand", mutable=["intermediates"])

    out, state = jax.jit(forward)(params, batch["image"])
    gates = {_gate_name(path): np.asarray(jax.nn.sigmoid(v))
             for path, v in jax.tree_util.tree_flatten_with_path(
                 state["intermediates"])[0]}

    def loss(p):
        o = model.apply({"params": p}, batch["image"], train=True)
        return js.multitask_loss(o, targets, jl.build_task_losses(LOSS_CFG),
                                 WEIGHTS)

    (total, per), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return {"params": jax.tree.map(np.asarray, params), "batch": batch,
            "out": {k: np.asarray(v) for k, v in out.items()},
            "gates": gates, "loss": (float(total),
                                     {k: float(v) for k, v in per.items()}),
            "grads": params_from_jax(jax.tree.map(np.asarray, grads))}


def _port_plan(**kw):
    return plan_from_autoconfig(PATCH, 1, _tasks(TaskHead), max_features=256,
                                squeeze_excitation=True, **kw)


def _loss_and_grads(model, batch):
    model.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = model(tb["image"])
    total, per = ts.multitask_loss(
        out, {k: v for k, v in tb.items() if k != "image"},
        tl.build_task_losses(LOSS_CFG), WEIGHTS)
    total.backward()
    return (float(total.detach()),
            {k: float(v.detach()) for k, v in per.items()},
            {n: p.grad for n, p in model.named_parameters()})


@pytest.fixture(scope="module")
def port_se(jax_se):
    model = ResEncUNet(_port_plan(use_pallas_conv=True))
    model.load_state_dict(params_from_jax(jax_se["params"]), strict=True)
    gates = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: gates.__setitem__(
            name, torch.sigmoid(out).numpy()))
        for name, m in model.named_modules() if name.endswith("se.expand")]
    with torch.no_grad():
        out = model(torch.from_numpy(jax_se["batch"]["image"]))
    for h in hooks:
        h.remove()
    plain = ResEncUNet(dataclasses.replace(model.plan, use_pallas_conv=False))
    plain.load_state_dict(model.state_dict())
    return {"model": model, "out": out, "gates": gates,
            "kernels": _loss_and_grads(model, jax_se["batch"]),
            "plain": _loss_and_grads(plain, jax_se["batch"])}


def test_se_state_dict_and_count_match_jax(jax_se, port_se):
    sd = params_from_jax(jax_se["params"])
    own = ResEncUNet(_port_plan()).state_dict()
    assert sorted(own) == sorted(sd)
    assert all(own[k].shape == sd[k].shape for k in own)
    assert tuple(own["encoder.stage0.block0.se.reduce.kernel"].shape) == (
        32, 8)
    assert count_params(port_se["model"]) == jax_count(jax_se["params"])


@pytest.mark.parametrize("task,channels", [("sheet", 1), ("normals", 3)])
def test_se_forward_matches_jax(jax_se, port_se, task, channels):
    got = port_se["out"][task]
    assert tuple(got.shape) == (2,) + PATCH + (channels,)
    np.testing.assert_allclose(got.numpy(), jax_se["out"][task], RTOL, ATOL)


def test_se_gates_match_jax_absolutely(jax_se, port_se):
    want, got = jax_se["gates"], port_se["gates"]
    assert sorted(got) == sorted(want) and len(got) == 14
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], 0, GATE_ATOL,
                                   err_msg=name)


def test_se_train_loss_matches_jax(jax_se, port_se):
    jt, jper = jax_se["loss"]
    tt, tper, _ = port_se["kernels"]
    np.testing.assert_allclose(tt, jt, LOSS_RTOL)
    for k in jper:
        np.testing.assert_allclose(tper[k], jper[k], LOSS_RTOL, err_msg=k)


def test_se_gradients_match_jax(jax_se, port_se):
    got, want = port_se["kernels"][2], jax_se["grads"]
    assert sorted(got) == sorted(want)
    reduce_kernels = 0
    for name, g in got.items():
        w = want[name].numpy()
        if g is None:       # the seg layers of the coarse decoder stages
            assert not w.any(), name
            continue
        g = g.numpy()
        if name.endswith("se.reduce.kernel"):
            reduce_kernels += 1
            np.testing.assert_allclose(g, w, 0, REDUCE_ATOL, err_msg=name)
            continue
        dist = np.linalg.norm(g - w) / np.linalg.norm(w)
        cos = float((g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w)))
        assert dist <= JAX_TOL and cos >= JAX_MIN_COS, (name, dist, cos)
    assert reduce_kernels == 14


def test_se_gradients_match_plain_autograd(port_se):
    """The conv and upsample Functions' backward against autograd of the
    plain forward, SE blocks included."""
    got, want = port_se["kernels"][2], port_se["plain"][2]
    for name, g in got.items():
        w = want[name]
        assert (g is None) == (w is None), name
        if g is None:
            continue
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= FN_TOL * scale, name


@pytest.mark.parametrize("c,rd", [(32, 8), (64, 8), (128, 8), (256, 16),
                                  (512, 32)])
def test_make_divisible_matches_jax(c, rd):
    assert blocks._make_divisible(c / 16, 8) == rd
    assert jblocks._make_divisible(c / 16, 8) == rd


def test_squeeze_excite_layout_and_init():
    se = blocks.SqueezeExcite(64)
    gen = torch.Generator().manual_seed(0)
    for m in se.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    shapes = {k: tuple(v.shape) for k, v in se.state_dict().items()}
    assert shapes == {"reduce.kernel": (64, 8), "reduce.bias": (8,),
                      "expand.kernel": (8, 64), "expand.bias": (64,)}
    for name, fan_in in (("reduce", 64), ("expand", 8)):
        dense = getattr(se, name)
        bound = 1.0 / math.sqrt(fan_in)
        assert float(dense.bias.detach().abs().max()) <= bound
        assert 0.9 * bound < float(dense.kernel.detach().abs().max()) <= bound


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_squeeze_excite_matches_jax(dtype):
    rng = np.random.default_rng(2)
    c = 64
    x = (rng.standard_normal((2, 6, 6, 6, c)) + rng.standard_normal(c)
         ).astype(np.float32)
    jse = jblocks.SqueezeExcite(dtype=getattr(jnp, dtype))
    variables = jse.init(jax.random.key(0), jnp.asarray(x))
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jse.apply(variables, xj).astype(jnp.float32))
    se = blocks.SqueezeExcite(c)
    se.load_state_dict(params_from_jax(variables), strict=True)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    with torch.no_grad():
        got = se(xt)
    assert got.dtype == xt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, 1e-5, 1e-6)
    else:
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-2
