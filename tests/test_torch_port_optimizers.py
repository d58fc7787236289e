"""The port's optimizer factory against the JAX package's, on the CPU.

Every name ``mt3d_resenc_unet_tpu/train/optimizers.py::create_optimizer``
builds runs 5 updates in both packages (JAX's jitted, as its step runs
them) from the same parameters and the same seeded numpy gradients, on
tensors shaped as the port's parameters (kernels ``(kd, kh, kw, ci, co)``,
a (256, 256) and a (512, 512) one for adafactor's factoring and its tie, a
bias and a norm vector), with the learning rate on a cosine schedule that
changes at every update (sm3 takes a float, as optax.sm3 does). Three
cases: neither decay nor clip, ``weight_decay`` alone and
``grad_clip_norm`` alone (CLIP, below the gradients' norm at some updates
and above it at others). The limit: the largest parameter difference is at
most MOVE_TOL of the largest move the JAX updates made. Each case also
shows that its decay or clip moves the JAX result by over 10x that limit
(or, where the rule cannot see it, not at all).

Both packages run the same fp32 formulas in another order. The data keep
the limit a measure of the rules and not of fp32 rounding that a rule
amplifies:

* where an elementwise rule divides by sqrt(v) + eps (eps 1e-8 to 1e-3),
  an element whose gradient nearly cancels turns a one-ulp difference of
  its inputs into up to 6e-4 of the move. So the clip case uses quantized
  gradients (+-1..4 times a power of two), whose global norm is exact in
  any summation order, and the names that add the decay to the gradient
  before such a rule (ELEMENTWISE_AFTER_DECAY) take SMALL_DECAY: its term
  still changes their moves by over 10x the limit, and the rounding of
  ``wd * p`` stays far below eps; the others take LARGE_DECAY;
* lars scales its step by trust_coefficient 1e-3, so at LR its move is a
  few hundred ulps of the parameters and one ulp of rounding in ``p + u``
  is 2e-4 of it: lars runs at LARS_LR.
"""

import io

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.train import optimizers as jo
from mt3d_resenc_unet_tpu.train import step as js
from mt3d_resenc_unet_torch.train import optimizers as to
from mt3d_resenc_unet_torch.train import step as ts

MOVE_TOL = 1e-4
NORM_TOL = 1e-5    # the pre-clip global norm, relative
SHAPES = {"conv": (3, 3, 3, 32, 64), "square": (256, 256),
          "tie": (512, 512), "bias": (64,), "norm": (32,)}
GRAD_SCALES = (3e-3, 1e-2, 2e-3, 5e-3, 1e-3)   # global norms ~1.6-16
LR = 0.1
LARS_LR = 1.0
CLIP = 1.0
LARGE_DECAY = 0.1
SMALL_DECAY = 1e-4
# the names whose decay enters the gradient before an elementwise
# normalization by an eps of 1e-8 to 1e-3 (see the module docstring)
ELEMENTWISE_AFTER_DECAY = ("adam", "adamax", "nadam", "radam", "rmsprop",
                           "adagrad", "yogi", "sm3")


def _schedules(name):
    if name == "sm3":
        return LR, LR
    lr = LARS_LR if name == "lars" else LR
    return (js.cosine_epoch_schedule(lr, 10, 1),
            ts.cosine_epoch_schedule(lr, 10, 1))


def _data(seed=0, quantized=False):
    """Parameters and one gradient set per GRAD_SCALES entry.
    ``quantized``: each gradient entry is +-1..4 times a power of two, so
    that every partial sum of the squares is exact and the global norm the
    same in any order."""
    rng = np.random.default_rng(seed)
    params = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = []
    for scale in GRAD_SCALES:
        if quantized:
            scale = 2.0 ** np.round(np.log2(scale))
            grads.append({k: (rng.integers(1, 5, s) * rng.choice([-1, 1], s)
                              * scale / 2).astype(np.float32)
                          for k, s in SHAPES.items()})
        else:
            grads.append({k: (rng.standard_normal(s) * scale).astype(
                np.float32) for k, s in SHAPES.items()})
    return params, grads


def _run_port(name, params, grads, weight_decay, clip):
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = to.create_optimizer(tparams.values(), name, _schedules(name)[1],
                              weight_decay=weight_decay,
                              grad_clip_norm=clip)
    norms = []
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        norms.append(float(opt.step()))
    return {k: p.detach().numpy() for k, p in tparams.items()}, norms


def _run_jax(name, params, grads, weight_decay, clip):
    tx = jo.create_optimizer(name, _schedules(name)[0],
                             weight_decay=weight_decay, grad_clip_norm=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    update = jax.jit(tx.update)     # as the JAX step runs it
    for g in grads:
        updates, state = update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, updates)
    return {k: np.asarray(v) for k, v in jp.items()}


def _case(name, case):
    """(weight_decay, grad_clip_norm) of a case."""
    if case == "decay":
        return (SMALL_DECAY if name in ELEMENTWISE_AFTER_DECAY
                else LARGE_DECAY), None
    return 0.0, (CLIP if case == "clip" else None)


@pytest.mark.parametrize("case", ["plain", "decay", "clip"])
@pytest.mark.parametrize("name", to.NAMES)
def test_every_name_matches_the_jax_factory(name, case):
    weight_decay, clip = _case(name, case)
    params, grads = _data(quantized=case == "clip")
    want = _run_jax(name, params, grads, weight_decay, clip)
    got, norms = _run_port(name, params, grads, weight_decay, clip)
    for g, n in zip(grads, norms):    # fp32 sums of 0.67M squares
        np.testing.assert_allclose(n, float(optax.global_norm(g)), NORM_TOL)
    move = max(float(np.abs(want[k] - params[k]).max()) for k in SHAPES)
    assert move > 0
    if case != "plain":
        # the decay or clip changes the JAX result well above the limit,
        # except where the rule cannot see it: adafactor ignores the
        # factory's decay, and a per-tensor trust ratio with no decay
        # (fromage, lars) undoes a uniform scale of the gradients
        base = _run_jax(name, params, grads, 0.0, None)
        effect = max(float(np.abs(want[k] - base[k]).max()) for k in SHAPES)
        if (name, case) in (("adafactor", "decay"), ("fromage", "clip"),
                            ("lars", "clip")):
            assert effect <= MOVE_TOL * move, (name, effect / move)
        else:
            assert effect > 10 * MOVE_TOL * move, (name, effect / move)
    if clip:    # the clip is active at some updates and idle at others
        assert min(norms) < clip < max(norms)
    for k in SHAPES:
        diff = float(np.abs(got[k] - want[k]).max())
        assert diff <= MOVE_TOL * move, (name, k, diff / move)


@pytest.mark.parametrize("name", to.NAMES)
def test_state_survives_a_checkpoint_round_trip(name):
    """Two updates, the optimizer's state_dict through torch.save and
    ``torch.load(weights_only=True)`` (train/checkpoint.py) into a fresh
    optimizer on copies of the parameters, then three more updates in each:
    the parameters stay bit-equal."""
    params, grads = _data(seed=1)
    sched = _schedules(name)[1]

    def build(values):
        ps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]
        return ps, to.create_optimizer(ps, name, sched, weight_decay=0.1,
                                       grad_clip_norm=1.0)

    def step(ps, opt, g):
        for p, k in zip(ps, SHAPES):
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()

    ps_a, opt_a = build(params.values())
    for g in grads[:2]:
        step(ps_a, opt_a, g)
    buf = io.BytesIO()
    torch.save(opt_a.opt.state_dict(), buf)
    buf.seek(0)
    ps_b, opt_b = build([p.detach().numpy() for p in ps_a])
    opt_b.opt.load_state_dict(torch.load(buf, weights_only=True))
    opt_b.count = opt_a.count
    for g in grads[2:]:
        step(ps_a, opt_a, g)
        step(ps_b, opt_b, g)
    for a, b in zip(ps_a, ps_b):
        assert torch.equal(a, b), name


def test_adafactor_factors_as_optax():
    """The factored dims follow np.argsort of the shape, ties included; a
    dim below 128 leaves the tensor unfactored."""
    h = dict(to._RULES["adafactor"][0])
    assert to.factored_dims((512, 512), h) == (0, 1)
    assert to.factored_dims((3, 3, 3, 512, 512), h) == (3, 4)
    assert to.factored_dims((3, 3, 3, 32, 64), h) is None
    assert to.factored_dims((64,), h) is None
    ps = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES.values()]
    opt = to.create_optimizer(ps, "adafactor", 1e-2)
    for p in ps:
        p.grad = torch.ones_like(p)
    opt.step()
    state = [opt.opt.state[p] for p in ps]
    assert [sorted(k for k in s if k != "step") for s in state] == [
        ["v"], ["v_col", "v_row"], ["v_col", "v_row"], ["v"], ["v"]]


def test_sm3_refuses_a_schedule_as_jax_does():
    p = [torch.nn.Parameter(torch.ones(3))]
    sched = ts.cosine_epoch_schedule(LR, 10, 1)
    with pytest.raises(TypeError):
        jo.create_optimizer("sm3", js.cosine_epoch_schedule(LR, 10, 1))
    with pytest.raises(TypeError, match="sm3"):
        to.create_optimizer(p, "sm3", sched)
