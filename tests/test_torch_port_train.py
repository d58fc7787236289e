"""The torch port's training step against the JAX package's, on the CPU.

* The loss and every parameter's gradient at the 32^3 4-stage plan of
  tests/test_torch_port_model.py, from the same parameters and a seeded
  numpy batch, with the flagship's BCEDice + MaskedCosine losses:
  - the port with ``use_pallas_conv=True`` (the conv and upsample autograd
    Functions, whose backward runs the plain versions of the dx/dW kernels
    here) against the port with ``use_pallas_conv=False`` (plain autograd
    through the same forward): each gradient to FN_TOL of its own max abs.
    Same fp32 forward, same roundings; measured 5.4e-6 at worst.
  - the port against JAX ``value_and_grad`` on its XLA path, both fp32:
    the loss to 1e-5 relative and each gradient to JAX_TOL in relative L2
    norm, with cosine >= JAX_MIN_COS. Elementwise the two differ by up to
    27% of a gradient's max abs in the 4^3 stage, and JAX's own fp32
    gradients differ from its float64 ones by up to 1.8%: at random init a
    1e-7 relative change of the parameters (float64, both frameworks) moves
    deep gradients by up to 4%, because a LeakyReLU input that lies within
    fp32 rounding of 0 takes the other slope, and at 4^3 voxels one voxel
    weighs ~1% of a weight gradient. Measured worst relative L2 0.023,
    cosine 0.9997; the limits keep >4x headroom on the distance.
* The clip + AdamW (and SGD-nesterov) update against optax on identical
  numpy gradients, to 1e-6: the same formulas in fp32 in another order.
* Two steps of ``make_train_step`` with ``grad_accum_steps=2`` (interleaved
  microbatches) against the JAX step from the same parameters, at a 16^3
  3-stage plan (its XLA compile takes seconds, the 32^3 step's a minute):
  per-task losses and total to 1e-4 relative at both steps, ``grad_norm``
  to 1e-4 at the first step and 2e-3 at the second, after one AdamW update
  has turned fp32 noise into parameter differences (measured 3.9e-4).
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.core.plan import TaskHead as JTaskHead
from mt3d_resenc_unet_tpu.core.plan import plan_from_autoconfig as jax_plan
from mt3d_resenc_unet_tpu.models.network import ResEncUNet as JaxUNet
from mt3d_resenc_unet_tpu.train import losses as jl
from mt3d_resenc_unet_tpu.train import step as js
from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
from mt3d_resenc_unet_torch.models.network import ResEncUNet
from mt3d_resenc_unet_torch.tools.from_jax import params_from_jax
from mt3d_resenc_unet_torch.train import losses as tl
from mt3d_resenc_unet_torch.train import step as ts
from mt3d_resenc_unet_torch.train.optimizers import NAMES, create_optimizer

FN_TOL = 1e-4
JAX_TOL = 0.1
JAX_MIN_COS = 0.995
LOSS_CFG = {"sheet": {"loss_fn": "BCEDiceLoss",
                      "loss_kwargs": {"alpha": 0.5, "beta": 0.5}},
            "normals": {"loss_fn": "MaskedCosineLoss"}}
WEIGHTS = {"sheet": 1.0, "normals": 1.0}


def _tasks(cls):
    return [cls("sheet", 1, "sigmoid"), cls("normals", 3, "none")]


def _batch(patch, n, seed=0):
    """bench.py's float batch, made with numpy from the seed."""
    rng = np.random.default_rng(seed)
    return {"image": rng.random((n,) + patch + (1,), np.float32),
            "sheet": (rng.random((n,) + patch + (1,)) > 0.5).astype(
                np.float32),
            "normals": rng.standard_normal((n,) + patch + (3,)).astype(
                np.float32)}


def _jax_setup(patch, max_features):
    plan = jax_plan(patch, 1, _tasks(JTaskHead), max_features=max_features)
    model = JaxUNet(plan=plan, dtype=jnp.float32)
    params = jax.jit(lambda k: model.init(
        {"params": k}, jnp.zeros((1,) + patch + (1,)), train=False))(
        jax.random.key(0))["params"]
    return model, params


def _port_model(patch, max_features, params):
    model = ResEncUNet(plan_from_autoconfig(
        patch, 1, _tasks(TaskHead), max_features=max_features,
        use_pallas_conv=True))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return model


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(model, batch):
    model.train()
    out = model(batch["image"])
    total, per = ts.multitask_loss(
        out, {k: v for k, v in batch.items() if k != "image"},
        tl.build_task_losses(LOSS_CFG), WEIGHTS)
    total.backward()
    return (float(total.detach()), {k: float(v.detach()) for k, v in per.items()},
            {n: p.grad for n, p in model.named_parameters()})


@pytest.fixture(scope="module")
def grads32():
    patch = (32, 32, 32)
    jmodel, params = _jax_setup(patch, 256)
    batch = _batch(patch, 2)
    loss_fns = jl.build_task_losses(LOSS_CFG)

    def loss(p):
        out = jmodel.apply({"params": p}, batch["image"], train=True)
        return js.multitask_loss(
            out, {k: v for k, v in batch.items() if k != "image"}, loss_fns,
            WEIGHTS)

    (jtotal, jper), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    model = _port_model(patch, 256, params)
    plain = ResEncUNet(dataclasses.replace(model.plan, use_pallas_conv=False))
    plain.load_state_dict(model.state_dict())
    tb = _torch_batch(batch)
    return {"jax": (float(jtotal), {k: float(v) for k, v in jper.items()},
                    params_from_jax(jax.tree.map(np.asarray, jgrads))),
            "port": _port_grads(model, tb), "plain": _port_grads(plain, tb)}


def test_train_mode_loss_matches_jax(grads32):
    jt, jper, _ = grads32["jax"]
    tt, tper, _ = grads32["port"]
    np.testing.assert_allclose(tt, jt, 1e-5)
    for k in jper:
        np.testing.assert_allclose(tper[k], jper[k], 1e-5, err_msg=k)


def test_every_parameter_gradient_matches_plain_autograd(grads32):
    """The Functions' backward against autograd of the plain forward."""
    got, want = grads32["port"][2], grads32["plain"][2]
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = want[name]
        assert (g is None) == (w is None), name
        if g is None:       # the seg layers of the coarse decoder stages
            continue
        assert g.dtype == torch.float32, name
        sc = float(w.abs().max())
        assert sc > 0, name
        assert float((g - w).abs().max()) / sc <= FN_TOL, name


def test_every_parameter_gradient_matches_jax(grads32):
    want, got = grads32["jax"][2], grads32["port"][2]
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = want[name].numpy().ravel()
        if g is None:
            # unused in the forward: JAX applies them to a 1-voxel slice
            # only to create them, so their gradient is exactly zero
            assert not w.any(), name
            continue
        g = g.numpy().ravel()
        dist = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
        assert dist <= JAX_TOL and cos >= JAX_MIN_COS, (name, dist, cos)


def _optax_tx(name):
    sched = js.cosine_epoch_schedule(1e-3, 4, 1)
    return js.build_optimizer(name, sched, weight_decay=1e-4,
                              grad_clip_norm=3.0), sched


@pytest.mark.parametrize("name", ["AdamW", "SGD"])
def test_clip_and_update_match_optax(name):
    rng = np.random.default_rng(7)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    tx, sched = _optax_tx(name)
    state = tx.init(params)
    jp = params
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = ts.build_optimizer(tparams.values(), name,
                             ts.cosine_epoch_schedule(1e-3, 4, 1),
                             weight_decay=1e-4, grad_clip_norm=3.0)
    for step, scale in enumerate((5.0, 0.1, 2.0)):  # above and below the clip
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32)
                 for k, s in shapes.items()}
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k].copy())
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            grads)), 1e-6)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jp[k]), 1e-6, 1e-6,
                                       err_msg=f"{name} step {step} {k}")
    assert opt.count == 3


@pytest.mark.parametrize("name", NAMES)
def test_create_optimizer_builds_the_torch_optimizers(name):
    p = [torch.nn.Parameter(torch.ones(3))]
    sched = ts.cosine_epoch_schedule(1e-2, 10, 1)
    opt = create_optimizer(p, name.upper(), 1e-2 if name == "sm3" else sched,
                           weight_decay=1e-4, grad_clip_norm=3.0)
    if name == "sgd":
        assert isinstance(opt.opt, torch.optim.SGD)
        assert opt.opt.defaults["nesterov"]
        assert opt.opt.defaults["momentum"] == 0.9
    if name == "adamw":
        assert isinstance(opt.opt, torch.optim.AdamW)
    p[0].grad = torch.full((3,), 4.0)
    norm = opt.step()                      # clipped to 3, then the update
    np.testing.assert_allclose(float(norm), float(np.sqrt(48.0)), 1e-6)
    assert opt.count == 1 and float(p[0].detach()[0]) < 1.0
    with pytest.raises(ValueError):
        create_optimizer(p, "no-such-optimizer", sched)


def test_cosine_schedule_matches_jax():
    j = js.cosine_epoch_schedule(1e-3, 500, 250)
    t = ts.cosine_epoch_schedule(1e-3, 500, 250)
    for step in (0, 1, 249, 250, 251, 60000, 125000, 200000):
        np.testing.assert_allclose(t(step), float(j(step)), 1e-6)


def test_train_steps_with_accumulation_match_jax():
    patch = (16, 16, 16)
    jmodel, params = _jax_setup(patch, 128)
    batch = _batch(patch, 2, seed=1)
    loss_fns = jl.build_task_losses(LOSS_CFG)
    tx = js.build_optimizer("AdamW", js.cosine_epoch_schedule(1e-3, 500, 250),
                            weight_decay=1e-4, grad_clip_norm=3.0)
    state = js.TrainState.create(apply_fn=jmodel.apply, params=params,
                                 tx=tx, rng=jax.random.key(1))
    jstep = js.make_train_step(jmodel, loss_fns, WEIGHTS, grad_accum_steps=2,
                               donate=False)

    model = _port_model(patch, 128, params)
    opt = ts.build_optimizer(model.parameters(), "AdamW",
                             ts.cosine_epoch_schedule(1e-3, 500, 250),
                             weight_decay=1e-4, grad_clip_norm=3.0)
    tstep = ts.make_train_step(model, tl.build_task_losses(LOSS_CFG),
                               WEIGHTS, grad_accum_steps=2)
    tb = _torch_batch(batch)
    for step in range(2):
        state, jm = jstep(state, batch)
        tm = tstep(opt, tb)
        assert model.training
        for k in ("sheet", "normals", "total_loss", "grad_norm"):
            tol = 2e-3 if (step, k) == (1, "grad_norm") else 1e-4
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), tol,
                                       err_msg=f"step {step} {k}")


def test_eval_step_reports_logit_losses_and_metrics():
    patch = (16, 16, 16)
    model = ResEncUNet(plan_from_autoconfig(patch, 1, _tasks(TaskHead),
                                            max_features=64))
    model.train()
    batch = _torch_batch(_batch(patch, 1, seed=2))
    loss_fns = tl.build_task_losses(LOSS_CFG)
    m = ts.make_eval_step(model, loss_fns)(batch)
    assert not model.training
    with torch.no_grad():
        logits = model(batch["image"], apply_activations=False)
    for k in ("sheet", "normals"):
        np.testing.assert_allclose(float(m[k]),
                                   float(loss_fns[k](logits[k], batch[k])),
                                   1e-6)
    np.testing.assert_allclose(float(m["total_loss"]),
                               float(m["sheet"] + m["normals"]), 1e-6)
    assert 0.0 <= float(m["sheet_dice"]) <= 1.0
    np.testing.assert_allclose(float(m["normals_cosine"]),
                               1.0 - float(m["normals"]), 1e-6)
