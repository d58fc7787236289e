"""The rest of the port's ``create_optimizer``: optax 0.2.6's keywords of
each of the 16 names, and the state bridge of every name, against the JAX
factory on the CPU.

* Every keyword the JAX factory passes through for each name (rmsprop's
  ``eps_in_sqrt`` / ``centered`` / ``momentum`` / ``nesterov`` /
  ``bias_correction``; adafactor's ``factored`` / ``momentum`` /
  ``dtype_momentum`` / ``multiply_by_parameter_scale`` /
  ``weight_decay_rate`` / ``weight_decay_mask``; ``mu_dtype`` of adam /
  adamw / nadam / lion; ``nesterov`` of adam / adamw / radam / lars;
  radam's ``threshold``; the masks of adamw / lamb / lion / lars, by name
  and as a callable; ``b1`` / ``b2`` / ``eps`` / ``eps_root`` of the names
  torch computes; sgd's momentum and nesterov): three updates (five for
  radam's threshold, which only the fifth reaches) from the same
  parameters and seeded numpy gradients as
  ``tests/test_torch_port_optimizers.py``, the learning rate on a cosine
  schedule. The limit is that file's: the largest parameter difference at
  most MOVE_TOL of the largest move the JAX updates made, and each case
  shows that its keyword changes the JAX result by more than 10x that.
  Where a moment is kept in bf16 (``mu_dtype``, ``dtype_momentum``) a few
  elements' moments land one bf16 ulp apart (XLA fuses the moment update
  into one fp32 expression, and rounds it from another fp32 value): there
  the largest difference is held to BF16_MOVE_TOL and the share of
  elements more than MOVE_TOL of the move apart to BF16_FAR_SHARE, and the
  keyword changes over 10x as many elements.
* The state bridge (``tools/from_jax.py::state_from_jax``): for each of
  the 16 names, and for the structural switches whose state optax keeps
  apart (rmsprop centered with momentum and bias correction, adafactor with
  momentum, adam with nesterov, adamw with a mask), JAX runs two updates,
  the bridge carries its state into the port's optimizer, and the port's
  third update lands within MOVE_TOL of that update's move from JAX's.
  The same with a moment in its own dtype (adam's ``mu_dtype`` bf16 on
  fp32 parameters, adafactor's fp32 momentum on bf16 ones), which
  ``load_state_dict`` must keep, and on bf16 and fp16 parameters for
  adam, adamw, adamax, radam and sgd (the names torch computes in fp32,
  an ``OptaxRule`` in 16 bits): there the share of elements more than one
  ulp apart, or NaN in one package only, is held to FAR16_SHARE.
* What the JAX factory refuses is refused (an unknown keyword:
  ``TypeError``) and what it drops is dropped (sgd's other keywords,
  every keyword of fromage).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.train import optimizers as jo
from mt3d_resenc_unet_torch.tools.from_jax import leaf_from_jax, state_from_jax
from mt3d_resenc_unet_torch.train import optimizers as to
from mt3d_resenc_unet_torch.train.checkpoint import opt_state_by_index

from test_torch_port_optimizers import MOVE_TOL, SHAPES, _data, _schedules

# a bf16 moment (mu_dtype, dtype_momentum): the largest difference over the
# largest move, and the share of elements more than MOVE_TOL of the move
# apart; measured at most 9.2e-4 and 7.3e-5 (adafactor's momentum), limits
# 5x that
BF16_MOVE_TOL = 5e-3
BF16_FAR_SHARE = 4e-4
DECAY = 0.1         # the own decay of adamw / lamb / lion / lars
MASK = {"conv": True, "square": False, "tie": True, "bias": False,
        "norm": True}


def _matrices(p):
    """A callable mask: the parameters of two dims or more."""
    return {k: v.ndim > 1 for k, v in p.items()}


# (name, optax keywords; the port's where they differ, updates)
CASES = [
    ("rmsprop", dict(eps_in_sqrt=False)),
    ("rmsprop", dict(centered=True)),
    ("rmsprop", dict(momentum=0.9)),
    ("rmsprop", dict(momentum=0.9, nesterov=True)),
    ("rmsprop", dict(bias_correction=True)),
    ("rmsprop", dict(centered=True, momentum=0.5)),
    ("adafactor", dict(factored=False)),
    ("adafactor", dict(momentum=0.9)),
    ("adafactor", dict(momentum=0.9, dtype_momentum=jnp.bfloat16),
     dict(momentum=0.9, dtype_momentum=torch.bfloat16)),
    ("adafactor", dict(multiply_by_parameter_scale=False)),
    ("adafactor", dict(weight_decay_rate=1e-2)),
    ("adafactor", dict(weight_decay_rate=1e-2, weight_decay_mask=MASK)),
    ("adam", dict(mu_dtype=jnp.bfloat16), dict(mu_dtype=torch.bfloat16)),
    ("adamw", dict(mu_dtype=jnp.bfloat16), dict(mu_dtype="bfloat16")),
    ("nadam", dict(mu_dtype=jnp.bfloat16), dict(mu_dtype=torch.bfloat16)),
    ("lion", dict(mu_dtype=jnp.bfloat16), dict(mu_dtype=torch.bfloat16)),
    ("adam", dict(nesterov=True)),
    ("adamw", dict(nesterov=True)),
    ("radam", dict(nesterov=True)),
    ("lars", dict(nesterov=True)),
    ("radam", dict(b2=0.9, threshold=4.5), None, 5),
    ("adamw", dict(mask=MASK)),
    ("adamw", dict(mask=_matrices)),
    ("lamb", dict(mask=MASK)),
    ("lion", dict(mask=_matrices)),
    ("lars", dict(weight_decay_mask=MASK)),
    ("lars", dict(trust_ratio_mask=_matrices)),
    ("adam", dict(b1=0.8, b2=0.99, eps=1e-6)),
    ("adam", dict(eps_root=1e-8)),
    ("adamax", dict(b1=0.8, b2=0.99, eps=1e-3)),
    ("radam", dict(b2=0.9, threshold=4.5, eps_root=1e-3), None, 5),
    ("nadam", dict(nesterov=False)),
    ("sgd", dict(momentum=0.5, nesterov=False)),
    ("sgd", dict(momentum=None)),
]


def _case_id(case):
    return case[0] + "-" + "-".join(
        f"{k}={getattr(v, '__name__', v) if not isinstance(v, dict) else 'dict'}"
        for k, v in case[1].items())


def _decay(name):
    return DECAY if name in ("adamw", "lamb", "lion", "lars") else 0.0


def _jax_updates(name, params, grads, kwargs, n, sched=None):
    tx = jo.create_optimizer(name, sched or _schedules(name)[0],
                             weight_decay=_decay(name), **kwargs)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    update = jax.jit(tx.update)
    for g in grads[:n]:
        u, state = update({k: jnp.asarray(v) for k, v in g.items()}, state,
                          jp)
        jp = optax.apply_updates(jp, u)
    return ({k: np.asarray(v) for k, v in jp.items()},
            jax.tree.map(np.asarray, state))


def _port_params(params):
    return {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in params.items()}


def _step(opt, tparams, g):
    for k, p in tparams.items():
        p.grad = torch.from_numpy(g[k].copy())
    opt.step()


def _diff_over_move(got, want, before):
    move = max(float(np.abs(want[k] - before[k]).max()) for k in SHAPES)
    assert move > 0
    diff = max(float(np.abs(got[k] - want[k]).max()) for k in SHAPES)
    return diff / move, move


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_keyword_matches_optax(case):
    name, jkw = case[0], case[1]
    pkw = case[2] if len(case) > 2 and case[2] is not None else jkw
    n = case[3] if len(case) > 3 else 3
    params, grads = _data()
    want, _ = _jax_updates(name, params, grads, jkw, n)
    base, _ = _jax_updates(name, params, grads, {}, n)
    tparams = _port_params(params)
    opt = to.create_optimizer(list(tparams.items()), name,
                              _schedules(name)[1], weight_decay=_decay(name),
                              **pkw)
    for g in grads[:n]:
        _step(opt, tparams, g)
    got = {k: p.detach().numpy() for k, p in tparams.items()}
    err, move = _diff_over_move(got, want, params)
    if not any("dtype" in k for k in pkw):
        assert err <= MOVE_TOL, err
        effect = max(float(np.abs(want[k] - base[k]).max()) for k in SHAPES)
        assert effect > 10 * MOVE_TOL * move, effect / move
        return
    # a bf16 moment: the elements more than MOVE_TOL of the move apart
    thr = MOVE_TOL * move
    total = sum(want[k].size for k in SHAPES)
    far = sum(int((np.abs(got[k] - want[k]) > thr).sum())
              for k in SHAPES) / total
    changed = sum(int((np.abs(want[k] - base[k]) > thr).sum())
                  for k in SHAPES) / total
    assert err <= BF16_MOVE_TOL and far <= BF16_FAR_SHARE, (err, far)
    assert changed > 10 * max(far, 1 / total), changed
    for p in tparams.values():
        moments = [v for k, v in opt.opt.state[p].items()
                   if k in ("mu", "ema")]
        assert moments and all(m.dtype == torch.bfloat16 for m in moments)


def test_routing_and_refusals():
    p = [torch.nn.Parameter(torch.ones(3))]
    named = [("w", p[0])]
    assert isinstance(to.create_optimizer(p, "adam", 1e-3).opt,
                      torch.optim.Adam)
    assert isinstance(to.create_optimizer(p, "adam", 1e-3, b1=0.8).opt,
                      torch.optim.Adam)
    assert isinstance(to.create_optimizer(p, "adam", 1e-3,
                                          nesterov=True).opt, to.OptaxRule)
    assert isinstance(to.create_optimizer(named, "adamw", 1e-3,
                                          mask={"w": False}).opt,
                      to.OptaxRule)
    assert isinstance(to.create_optimizer(p, "radam", 1e-3,
                                          threshold=4.0).opt, to.OptaxRule)
    for name in to.NAMES:
        if name in ("sgd", "fromage"):
            continue
        with pytest.raises(TypeError):
            jo.create_optimizer(name, 1e-3, no_such_keyword=1)
        with pytest.raises(TypeError, match="no_such_keyword"):
            to.create_optimizer(p, name, 1e-3, no_such_keyword=1)
    # what the JAX factory drops: sgd's other keywords, all of fromage's
    jo.create_optimizer("sgd", 1e-3, accumulator_dtype=jnp.bfloat16, x=1)
    jo.create_optimizer("fromage", 1e-3, min_norm=1.0)
    sgd = to.create_optimizer(p, "sgd", 1e-3, accumulator_dtype="bfloat16",
                              x=1).opt
    assert sgd.defaults["momentum"] == 0.9 and sgd.defaults["nesterov"]
    frm = to.create_optimizer(p, "fromage", 1e-3, min_norm=1.0).opt
    assert frm.defaults["min_norm"] == 1e-6
    with pytest.raises(TypeError, match="named parameters"):
        to.create_optimizer(p, "lamb", 1e-3, mask={"w": True})
    with pytest.raises(KeyError):
        to.create_optimizer(named, "lion", 1e-3, mask={"v": True})


# 16-bit parameters in the state bridge: the gradients are GRAD16_SCALE
# times _data's (at _data's scale fp16 Adam's second moments underflow
# to 0 for most elements, and with optax's eps rounding to 0 in fp16 the
# update is inf / NaN in both packages). Limit: the share of elements more
# than one ulp apart, or NaN in one package only, after the third update.
# Measured: bf16 0 for adam, adamw, adamax, radam and sgd (bit-equal),
# 5.0e-4 for adafactor with momentum (its ema in fp32); fp16 3.1e-2,
# 3.2e-2, 3.3e-2, 1.5e-3 and 1.7e-2 for adam, adamw, adamax, radam and
# sgd (the cause of the fp16 differences is not traced: the bf16 updates
# are bit-equal). Limits 2x the measured shares, as
# test_torch_port_dtypes.py's, and bf16 0 as its ADAMW_ULP_SHARE's 1e-3.
GRAD16_SCALE = 10.0
FAR16_SHARE = {
    ("bfloat16", "adam"): 1e-3, ("bfloat16", "adamw"): 1e-3,
    ("bfloat16", "adamax"): 1e-3, ("bfloat16", "radam"): 1e-3,
    ("bfloat16", "sgd"): 1e-3, ("bfloat16", "adafactor"): 1e-3,
    ("float16", "adam"): 6.2e-2, ("float16", "adamw"): 6.4e-2,
    ("float16", "adamax"): 6.5e-2, ("float16", "radam"): 3.1e-3,
    ("float16", "sgd"): 3.3e-2,
}
# (name, optax keywords, the port's, the parameters' dtype)
BRIDGED = [(name, {}, {}, "float32") for name in to.NAMES] + [
    ("rmsprop", dict(centered=True, momentum=0.5, bias_correction=True), None,
     "float32"),
    ("adafactor", dict(momentum=0.9), None, "float32"),
    ("adam", dict(nesterov=True), None, "float32"),
    ("adamw", dict(mask=MASK), None, "float32"),
    # a moment in its own dtype survives load_state_dict
    ("adam", dict(mu_dtype=jnp.bfloat16), dict(mu_dtype=torch.bfloat16),
     "float32"),
    ("adafactor", dict(momentum=0.9), None, "bfloat16"),
] + [(name, {}, {}, dt) for dt in ("bfloat16", "float16")
     for name in ("adam", "adamw", "adamax", "radam", "sgd")]


def _far_share(got, want):
    """The share of elements more than one ulp of ``want``'s dtype apart,
    or NaN in one of the two only."""
    from test_torch_port_dtypes import _ulps_apart
    far = total = 0
    for k in SHAPES:
        g, w = got[k], want[k]
        far += int((_ulps_apart(g, w) > 1).sum())
        far += int((torch.isnan(g) != torch.isnan(w)).sum())
        total += w.numel()
    return far / total


@pytest.mark.parametrize(
    "name,jkw,pkw,dtype", BRIDGED,
    ids=[f"{c[0]}-{'-'.join(c[1])}-{c[3]}" for c in BRIDGED])
def test_state_bridge_resumes_every_name(name, jkw, pkw, dtype):
    pkw = jkw if pkw is None else pkw
    params, grads = _data(seed=2)
    if dtype != "float32":
        jd = jnp.dtype(dtype)
        params = {k: np.asarray(jnp.asarray(v, jd)) for k, v in params.items()}
        grads = [{k: np.asarray(jnp.asarray(v * GRAD16_SCALE, jd))
                  for k, v in g.items()} for g in grads]
    sched = (0.1 if name == "sm3" else None)
    mid, state = _jax_updates(name, params, grads, jkw, 2, sched)
    end, _ = _jax_updates(name, params, grads, jkw, 3, sched)
    carried = state_from_jax(mid, state, 2, name, **pkw)
    assert carried["step"] == 2

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in carried["params"].items():
                self.register_parameter(k, torch.nn.Parameter(v.clone()))

    net = Net()
    tparams = dict(net.named_parameters())
    opt = to.create_optimizer(list(tparams.items()), name,
                              sched or _schedules(name)[1],
                              weight_decay=_decay(name), **pkw)
    opt.opt.load_state_dict(opt_state_by_index(carried["opt_state"], net,
                                               opt.opt))
    opt.count = carried["step"]
    for k, p in tparams.items():
        p.grad = leaf_from_jax(grads[2][k])
    opt.step()
    # the moments stay in optax's dtypes of them
    moments = {"mu": pkw.get("mu_dtype") or getattr(torch, dtype),
               "ema": torch.float32}
    for p in tparams.values():
        assert p.dtype == getattr(torch, dtype)
        for k, v in opt.opt.state[p].items():
            if k in moments and isinstance(v, torch.Tensor):
                assert v.dtype == moments[k], k
    if dtype != "float32":
        got = {k: p.detach() for k, p in tparams.items()}
        far = _far_share(got, {k: leaf_from_jax(v) for k, v in end.items()})
        assert far <= FAR16_SHARE[dtype, name], far
        return
    got = {k: p.detach().numpy() for k, p in tparams.items()}
    err, _ = _diff_over_move(got, end, mid)
    assert err <= MOVE_TOL, err
    if name != "fromage":     # the only stateless rule
        assert all(opt.opt.state[p] for p in tparams.values())
