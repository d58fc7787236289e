"""Every network plan the JAX package builds, built by the torch port and
held against the JAX model on the CPU.

Each plan is built in both packages, the JAX parameters are carried over by
``params_from_jax`` with ``strict=True`` (so the state-dict names and
shapes and ``count_params`` agree), and both run the same seeded numpy
input in fp32, JAX on its XLA path (``use_pallas_conv=False``), the port
with ``use_pallas_conv=True`` (its kernel wrappers run their plain versions
here). An affine norm's scale and bias start at ones and zeros, so they
are perturbed first, or the check could not see them.

* The nine plan options the port refused before it built them (conv bias,
  affine norm, dropout, squeeze-excitation, DropPath, deep supervision,
  ResidualBlock decoder, BottleneckBlockD encoder, no stem) at the
  autoconfigured 16^3 plan with ``max_features=64`` (3 stages, 32, 64, 64
  channels), and the other plans of the JAX tests (a BottleneckD encoder, a
  ConvBlock encoder, a 2-D plan, kernels other than 3^3, anisotropic
  strides, 1x1x1 kernels, the options together, another ``nonlin``) from
  manual configs: the eval forward within RTOL / ATOL (fp32 on both sides,
  convs summed in another order; measured <= 1.1e-5).
* Deep supervision: the list of outputs, full resolution first, and its
  multi-task loss in train mode against JAX ``multitask_loss`` (1e-5
  relative); a deep-supervision model and a plain one share a state dict
  (JAX tests/test_model.py:125-135).
* Dropout and DropPath in train mode: they draw from the caller's
  ``torch.Generator`` (two seeds differ, one seed repeats), raise without
  one, keep a share 1 - p scaled by 1 / (1 - p), and are the identity at
  p = 0; a training step through ``make_train_step`` takes the generator.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.core.plan import TaskHead as JTaskHead
from mt3d_resenc_unet_tpu.core.plan import plan_from_autoconfig as jax_auto
from mt3d_resenc_unet_tpu.core.plan import plan_from_manual_config as jax_manual
from mt3d_resenc_unet_tpu.models.network import ResEncUNet as JaxUNet
from mt3d_resenc_unet_tpu.models.network import count_params as jax_count
from mt3d_resenc_unet_tpu.train import losses as jl
from mt3d_resenc_unet_tpu.train import step as js
from mt3d_resenc_unet_torch.core.plan import (TaskHead, plan_from_autoconfig,
                                              plan_from_manual_config)
from mt3d_resenc_unet_torch.models import blocks
from mt3d_resenc_unet_torch.models.network import ResEncUNet, count_params
from mt3d_resenc_unet_torch.tools.from_jax import params_from_jax
from mt3d_resenc_unet_torch.train import losses as tl
from mt3d_resenc_unet_torch.train import step as ts

RTOL = ATOL = 1e-4
PATCH = (16, 16, 16)
LOSS_CFG = {"sheet": {"loss_fn": "BCEDiceLoss",
                      "loss_kwargs": {"alpha": 0.5, "beta": 0.5}},
            "normals": {"loss_fn": "MaskedCosineLoss"}}
WEIGHTS = {"sheet": 1.0, "normals": 1.0}

# the options test_torch_port_model.py held as refused before the port
# built them
OPTIONS = [
    {"conv_bias": True}, {"norm_affine": True}, {"dropout_p": 0.1},
    {"squeeze_excitation": True}, {"stochastic_depth_p": 0.1},
    {"deep_supervision": True}, {"basic_decoder_block": "ResidualBlock"},
    {"basic_encoder_block": "BottleneckBlockD"}, {"do_stem": False}]

_MANUAL = dict(
    basic_encoder_block="BasicBlockD", basic_decoder_block="ConvBlock",
    bottleneck_block="BasicBlockD", features_per_stage=[32, 64, 64],
    num_stages=3, n_blocks_per_stage=[1, 2, 2],
    n_conv_per_stage_decoder=[1, 1], kernel_sizes=3, strides=[1, 2, 2])
# (name, manual-config overrides, patch)
PLANS = [
    ("bottleneck_encoder", dict(basic_encoder_block="BottleneckBlockD",
                                bottleneck_block="BottleneckBlockD"), PATCH),
    ("conv_block_encoder", dict(basic_encoder_block="ConvBlock"), PATCH),
    ("2d_se_deep_supervision", dict(
        kernel_sizes=[[3, 3], [3, 3], [5, 5]], strides=[[1, 1], [2, 2], [2, 1]],
        squeeze_excitation=True, deep_supervision=True), (16, 16)),
    ("kernels_and_anisotropic_strides", dict(
        kernel_sizes=[[1, 3, 3], [3, 3, 3], [5, 5, 5]],
        strides=[[1, 1, 1], [1, 2, 2], [2, 2, 2]]), (8, 16, 16)),
    ("1x1x1_kernels", dict(kernel_sizes=1), PATCH),
    ("options_together", dict(
        dropout_op_kwargs={"p": 0.2}, conv_bias=True, norm_affine=True,
        basic_decoder_block="ResidualBlock", stochastic_depth_p=0.3,
        squeeze_excitation=True, do_stem=False), PATCH),
]


def _tasks(cls):
    return [cls("sheet", 1, "sigmoid"), cls("normals", 3, "none")]


def _plans(manual=None, patch=PATCH, **override):
    """(JAX plan, port plan) from the autoconfig with ``override`` or from
    a manual config with ``manual``."""
    if manual is None:
        return (jax_auto(patch, 1, _tasks(JTaskHead), max_features=64,
                         **override),
                plan_from_autoconfig(patch, 1, _tasks(TaskHead),
                                     max_features=64, use_pallas_conv=True,
                                     **override))
    cfg = {**_MANUAL, **manual}
    return (jax_manual(cfg, patch, 1, _tasks(JTaskHead)),
            dataclasses.replace(plan_from_manual_config(
                cfg, patch, 1, _tasks(TaskHead)), use_pallas_conv=True))


def _jax_params(model, patch):
    # eager: the JAX ops compile once per shape across the plans, where a
    # jitted init compiles each plan's whole graph (5-9 s each)
    params = model.init({"params": jax.random.key(0)},
                        jnp.zeros((1,) + patch + (1,)), train=False)["params"]
    rng = np.random.default_rng(1)

    def perturb(path, v):
        name = jax.tree_util.keystr(path)
        v = np.asarray(v)
        if "'norm'" in name:          # an affine norm's scale / bias
            return (v + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(perturb, params)


def _input(patch, n=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n,) + patch + (1,)).astype(np.float32)


def _flat(out):
    """{task: tensor or list} -> [(name, array)] in a fixed order."""
    items = []
    for task in sorted(out):
        v = out[task]
        for i, a in enumerate(v if isinstance(v, list) else [v]):
            items.append((f"{task}[{i}]", np.asarray(a)))
    return items


def _check_against_jax(jplan, tplan, patch):
    jmodel = JaxUNet(plan=jplan, dtype=jnp.float32)
    params = _jax_params(jmodel, patch)
    x = _input(patch)
    want = jax.jit(lambda p, v: jmodel.apply({"params": p}, v,
                                             train=False))(params, x)
    model = ResEncUNet(tplan)
    sd = params_from_jax(params)
    own = model.state_dict()
    assert sorted(own) == sorted(sd)
    assert all(own[k].shape == sd[k].shape for k in own)
    model.load_state_dict(sd, strict=True)
    assert count_params(model) == jax_count(params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    got, want = _flat(got), _flat(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, RTOL, ATOL, err_msg=name)


@pytest.mark.parametrize("override", OPTIONS,
                         ids=[next(iter(o)) for o in OPTIONS])
def test_plan_option_matches_jax(override):
    _check_against_jax(*_plans(**override), PATCH)


@pytest.mark.parametrize("name,manual,patch", PLANS,
                         ids=[p[0] for p in PLANS])
def test_plan_matches_jax(name, manual, patch):
    _check_against_jax(*_plans(manual, patch), patch)


def test_nonlin_is_not_read():
    """The JAX package never reads ``plan.nonlin``; neither does the port:
    a plan naming another nonlinearity builds the same LeakyReLU net."""
    base = ResEncUNet(_plans()[1])
    other = ResEncUNet(_plans(nonlin="relu")[1])
    x = torch.from_numpy(_input(PATCH))
    with torch.no_grad():
        a, b = base(x), other(x)
    for k in a:
        assert torch.equal(a[k], b[k])


# -- deep supervision -------------------------------------------------------

def test_deep_supervision_outputs_full_resolution_first():
    model = ResEncUNet(_plans(deep_supervision=True)[1])
    with torch.no_grad():
        out = model(torch.from_numpy(_input(PATCH)))
        logits = model(torch.from_numpy(_input(PATCH)),
                       apply_activations=False)
    for task, c in (("sheet", 1), ("normals", 3)):
        assert [tuple(v.shape) for v in out[task]] == [
            (2, 16, 16, 16, c), (2, 8, 8, 8, c)]
    # eval mode applies each task's activation to every output
    for a, b in zip(out["sheet"], logits["sheet"]):
        torch.testing.assert_close(a, torch.sigmoid(b))
    for a, b in zip(out["normals"], logits["normals"]):
        assert torch.equal(a, b)


def test_deep_supervision_loss_matches_jax():
    jplan, tplan = _plans(deep_supervision=True)
    jmodel = JaxUNet(plan=jplan, dtype=jnp.float32)
    params = _jax_params(jmodel, PATCH)
    rng = np.random.default_rng(3)
    batch = {"image": _input(PATCH, seed=4),
             "sheet": (rng.random((2,) + PATCH + (1,)) > 0.5).astype(
                 np.float32),
             "normals": rng.standard_normal((2,) + PATCH + (3,)).astype(
                 np.float32)}
    targets = {k: v for k, v in batch.items() if k != "image"}

    def jloss(p):
        out = jmodel.apply({"params": p}, batch["image"], train=True)
        return js.multitask_loss(out, targets,
                                 jl.build_task_losses(LOSS_CFG), WEIGHTS)

    jtotal, jper = jax.jit(jloss)(params)
    model = ResEncUNet(tplan)
    model.load_state_dict(params_from_jax(params), strict=True)
    model.train()
    with torch.no_grad():
        out = model(torch.from_numpy(batch["image"]))
        assert isinstance(out["sheet"], list) and len(out["sheet"]) == 2
        total, per = ts.multitask_loss(
            out, {k: torch.from_numpy(v) for k, v in targets.items()},
            tl.build_task_losses(LOSS_CFG), WEIGHTS)
    np.testing.assert_allclose(float(total), float(jtotal), 1e-5)
    for k in per:
        np.testing.assert_allclose(float(per[k]), float(jper[k]), 1e-5,
                                   err_msg=k)


def test_deep_supervision_and_plain_models_share_a_state_dict():
    plain = ResEncUNet(_plans()[1], seed=5)
    ds = ResEncUNet(_plans(deep_supervision=True)[1])
    ds.load_state_dict(plain.state_dict(), strict=True)
    x = torch.from_numpy(_input(PATCH))
    with torch.no_grad():
        a, b = plain(x), ds(x)
    for k in a:
        assert torch.equal(a[k], b[k][0])


# -- dropout and DropPath ---------------------------------------------------

STOCHASTIC = [{"dropout_p": 0.3}, {"stochastic_depth_p": 0.5}]


def _train_out(model, x, seed):
    model.train()
    with torch.no_grad():
        return model(x, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("override", STOCHASTIC,
                         ids=[next(iter(o)) for o in STOCHASTIC])
def test_train_mode_draws_from_the_generator(override):
    model = ResEncUNet(_plans(**override)[1])
    x = torch.from_numpy(_input(PATCH))
    a, b, c = (_train_out(model, x, s)["sheet"] for s in (1, 1, 2))
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    model.train()
    with pytest.raises(ValueError, match="torch.Generator"):
        model(x)
    model.eval()
    with torch.no_grad():
        ev = model(x, apply_activations=False)["sheet"]
    assert not torch.allclose(a, ev)


@pytest.mark.parametrize("fn", [blocks.dropout, blocks.drop_path],
                         ids=["dropout", "drop_path"])
def test_zero_rate_is_the_identity(fn):
    x = torch.randn(4, 3, 5, 6, 2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(fn(x, 0.0, torch.Generator().manual_seed(1)), x)


def test_dropout_and_drop_path_keep_one_minus_p_scaled():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(64, 8, 8, 8, 4)
    y = blocks.dropout(x, 0.25, gen)
    assert set(torch.unique(y).tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert abs(float((y == 0).float().mean()) - 0.25) < 0.01
    z = blocks.drop_path(x, 0.5, gen)
    per_sample = z.flatten(1)
    assert all(len(torch.unique(r)) == 1 for r in per_sample)
    assert set(torch.unique(z).tolist()) == {0.0, 2.0}


def test_train_step_takes_the_generator():
    model = ResEncUNet(_plans(dropout_p=0.2, stochastic_depth_p=0.2)[1])
    state = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(6)
    batch = {"image": torch.from_numpy(_input(PATCH, seed=6)),
             "sheet": torch.from_numpy((rng.random((2,) + PATCH + (1,))
                                        > 0.5).astype(np.float32)),
             "normals": torch.from_numpy(rng.standard_normal(
                 (2,) + PATCH + (3,)).astype(np.float32))}

    def first_step(seed):
        model.load_state_dict(state)
        opt = ts.build_optimizer(model.parameters(), "AdamW",
                                 ts.cosine_epoch_schedule(1e-3, 10, 1))
        step = ts.make_train_step(
            model, tl.build_task_losses(LOSS_CFG), WEIGHTS,
            generator=torch.Generator().manual_seed(seed))
        return {k: float(v) for k, v in step(opt, batch).items()}

    a, b, c = first_step(1), first_step(1), first_step(2)
    assert a == b and a != c
    assert all(np.isfinite(v) for v in a.values())
