"""The torch port's norm tail and raw statistics (``ops/norm_act.py``
``NormTailFn``, ``RawStatsFn``) against the JAX package, on the CPU.

On the CPU the Functions run their kernels' plain versions (the path a CPU
tensor takes through the wrappers). Inputs are seeded numpy arrays at
(2, 8, 8, 8, C), C in {16, 32}:

* ``NormTailFn`` against JAX ``norm_apply_packed`` at g = 1 (the unpacked
  tensor, per-channel vectors): the forward, and the gradients of y, inv,
  shift, the residual and ``residual_pre``'s (a, b) against ``jax.vjp``,
  with a residual, with ``residual_pre`` and with neither, act on and off;
  ``RawStatsFn`` against ``packed_stats_xla`` and its vjp. Tolerance fp32
  rtol 1e-5 / atol 1e-6: both sides compute in fp32 with the same
  operations and differ only in the summation order of the reductions.
  For a sum over the voxels (the vectors' gradients, the statistics) rtol
  applies to the sum of its terms' magnitudes, the scale of a
  floating-point sum's rounding error, as a near-cancelling sum's own
  magnitude is not (|got - want| <= atol + rtol * sum |term|);
* ``NormTailFn``'s backward against autograd of the port's eager tail
  (``norm_apply`` without kernels), in fp32 and in bf16: the bf16
  cotangents dy and dr within one bf16 ulp of the eager ones (the same
  fp32 products rounded once), the fp32 vector gradients within the fp32
  tolerance above (sums in another order); ``RawStatsFn``'s backward
  against autograd of the eager statistics, the same way;
* routing: a kernel model (``use_pallas_conv``, bf16) sends every tail and
  every unfused producer's statistics to the Functions, as many as
  ``models/network.py::norm_launches`` derives from its plan, and the fp32
  reference model sends none.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.ops.instance_norm import (norm_apply_packed,
                                                    packed_stats_xla)
from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
from mt3d_resenc_unet_torch.models.network import ResEncUNet, norm_launches
from mt3d_resenc_unet_torch.ops import _build
from mt3d_resenc_unet_torch.ops import instance_norm, norm_act

RTOL, ATOL = 1e-5, 1e-6
SLOPE = 1e-2
SPATIAL = (8, 8, 8)
MODES = ("none", "residual", "residual_pre")


def _inputs(seed, c):
    rng = np.random.default_rng(seed)
    shape = (2,) + SPATIAL + (c,)
    f = np.float32
    return {
        "y": (rng.standard_normal(shape) * 1.5 + 0.3).astype(f),
        "inv": (rng.random((2, c)) + 0.5).astype(f),
        "shift": rng.standard_normal((2, c)).astype(f),
        "r": rng.standard_normal(shape).astype(f),
        "a": (rng.random((2, c)) + 0.5).astype(f),
        "b": rng.standard_normal((2, c)).astype(f),
        "g": rng.standard_normal(shape).astype(f),
    }


def _names(mode):
    return {"none": ("y", "inv", "shift"),
            "residual": ("y", "inv", "shift", "r"),
            "residual_pre": ("y", "inv", "shift", "r", "a", "b")}[mode]


def _masses(d, dtype=torch.float32):
    """The sums of the terms' magnitudes of each reduction, per (n, c):
    |g y|, |g|, |g r|, |g| over the voxels bound those of the vectors'
    gradients (|g'| <= |g|); |x| and x^2 those of the statistics."""
    t = {k: torch.from_numpy(d[k]).to(dtype).float().flatten(1, -2)
         for k in ("y", "r", "g")}
    g = t["g"].abs()
    return {"inv": (g * t["y"].abs()).sum(1), "shift": g.sum(1),
            "a": (g * t["r"].abs()).sum(1), "b": g.sum(1),
            "stats": torch.stack([t["y"].abs().sum(1),
                                  t["y"].square().sum(1)], 1)}


def _close(got, want, mass=None, err_msg=""):
    """rtol / atol elementwise, or (``mass``) against the terms' sum."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if mass is None:
        np.testing.assert_allclose(got, want, RTOL, ATOL, err_msg=err_msg)
        return
    err = np.abs(got - want)
    bound = ATOL + RTOL * np.asarray(mass)
    assert (err <= bound).all(), (err_msg, float((err / bound).max()))


def _port(d, mode, act, dtype=torch.float32, eager=False):
    """The tail's output and the gradients of sum(out * g) by input name,
    through NormTailFn or (``eager``) autograd of the eager tail."""
    t = {k: torch.tensor(d[k], requires_grad=True) for k in _names(mode)}
    y = t["y"].detach().to(dtype).requires_grad_()
    r = t["r"].detach().to(dtype).requires_grad_() if "r" in t else None
    pre = (t["a"], t["b"]) if "a" in t else None
    out = instance_norm.norm_apply(y, t["inv"], t["shift"], SLOPE, act, r,
                                   pre, use_kernels=not eager)
    out.backward(torch.tensor(d["g"]).to(dtype))
    grads = {k: v.grad for k, v in t.items() if k not in ("y", "r")}
    grads["y"] = y.grad
    if r is not None:
        grads["r"] = r.grad
    return out.detach(), grads


@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_tail_matches_jax_norm_apply_packed(c, act, mode):
    d = _inputs(c + 3 * act, c)
    names = _names(mode)

    def f(*args):
        v = dict(zip(names, args))
        pre = (v["a"], v["b"]) if "a" in v else None
        return norm_apply_packed(v["y"], v["inv"], v["shift"], SLOPE, act,
                                 v.get("r"), pre)

    want, vjp = jax.vjp(f, *(jnp.asarray(d[k]) for k in names))
    want_grads = dict(zip(names, vjp(jnp.asarray(d["g"]))))
    calls = _build.LAUNCHES.copy()
    got, grads = _port(d, mode, act)
    assert _build.LAUNCHES == calls            # plain versions on the CPU
    _close(got.numpy(), want)
    assert sorted(grads) == sorted(names)
    mass = _masses(d)
    for k in names:
        _close(grads[k].numpy(), want_grads[k], mass.get(k), k)


@pytest.mark.parametrize("c", [16, 32])
def test_raw_stats_match_packed_stats_xla(c):
    d = _inputs(7, c)
    gs = np.random.default_rng(8).standard_normal((2, 2, c)).astype(np.float32)
    want, vjp = jax.vjp(packed_stats_xla, jnp.asarray(d["y"]))
    (want_dx,) = vjp(jnp.asarray(gs))
    x = torch.tensor(d["y"], requires_grad=True)
    got = instance_norm.instance_stats(x, use_kernels=True)
    got.backward(torch.from_numpy(gs))
    _close(got.detach().numpy(), want, _masses(d)["stats"])
    _close(x.grad.numpy(), want_dx)


def _bf16_ulp(t):
    """One bf16 ulp of each element's magnitude (of the smallest normal
    at 0)."""
    m = t.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_tail_backward_matches_eager_autograd(dtype, act, mode):
    d = _inputs(11 + act, 32)
    got, grads = _port(d, mode, act, dtype)
    want, want_grads = _port(d, mode, act, dtype, eager=True)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    mass = _masses(d, dtype)
    for k, w in want_grads.items():
        g = grads[k]
        assert g.dtype == w.dtype, k
        if k in ("y", "r") and dtype == torch.bfloat16:
            assert bool(((g.float() - w.float()).abs()
                         <= _bf16_ulp(w)).all()), k
        else:
            _close(g.float().numpy(), w.float().numpy(), mass.get(k), k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_raw_stats_backward_matches_eager_autograd(dtype):
    d = _inputs(13, 16)
    gs = torch.from_numpy(
        np.random.default_rng(14).standard_normal((2, 2, 16)).astype(
            np.float32))
    out = {}
    for kernels in (True, False):
        x = torch.tensor(d["y"]).to(dtype).requires_grad_()
        s = instance_norm.instance_stats(x, use_kernels=kernels)
        s.backward(gs)
        out[kernels] = (s.detach(), x.grad)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    got, want = out[True][1], out[False][1]
    assert got.dtype == dtype
    if dtype == torch.bfloat16:
        assert bool(((got.float() - want.float()).abs()
                     <= _bf16_ulp(want)).all())
    else:
        _close(got.numpy(), want.numpy())


def test_kernel_class_is_by_shape():
    bf, f32 = torch.bfloat16, torch.float32
    assert norm_act.kernel_class(torch.empty(2, 4, 4, 4, 32, dtype=bf))
    assert norm_act.kernel_class(torch.empty(2, 4, 4, 4, 2048, dtype=bf))
    assert not norm_act.kernel_class(torch.empty(2, 4, 4, 4, 2056, dtype=bf))
    assert not norm_act.kernel_class(torch.empty(2, 4, 4, 4, 12, dtype=bf))
    assert norm_act.kernel_class(torch.empty(2, 4, 4, 4, 12, dtype=f32))
    assert not norm_act.kernel_class(torch.empty(2, 4, 4, 4, 1, dtype=f32))
    assert not norm_act.kernel_class(
        torch.empty(2, 4, 4, 4, 16, dtype=torch.float16))
    y = torch.empty(2, 4, 4, 4, 16)
    assert not norm_act.kernel_class(y, torch.empty(2, 4, 4, 4, 16,
                                                    dtype=bf))
    assert norm_act.kernel_class(y, torch.empty_like(y))


def _count_calls(monkeypatch):
    """Counts the Functions' wrapper calls (``norm_tail``, ``norm_tail_bwd``,
    ``raw_stats``: what launches on the card) and the plain versions'
    calls made outside them."""
    calls = dict.fromkeys(("norm_act_tail", "norm_act_tail_bwd",
                           "norm_act_raw_stats", "plain_tail",
                           "plain_stats"), 0)
    inside = [False]

    def spy(name, fn, plain=False):
        def wrapped(*args, **kw):
            if plain:
                calls[name] += not inside[0]
                return fn(*args, **kw)
            calls[name] += 1
            inside[0] = True
            try:
                return fn(*args, **kw)
            finally:
                inside[0] = False
        return wrapped

    monkeypatch.setattr(norm_act, "norm_tail",
                        spy("norm_act_tail", norm_act.norm_tail))
    monkeypatch.setattr(norm_act, "norm_tail_bwd",
                        spy("norm_act_tail_bwd", norm_act.norm_tail_bwd))
    monkeypatch.setattr(norm_act, "raw_stats",
                        spy("norm_act_raw_stats", norm_act.raw_stats))
    monkeypatch.setattr(norm_act, "norm_tail_plain",
                        spy("plain_tail", norm_act.norm_tail_plain, True))
    monkeypatch.setattr(norm_act, "raw_stats_plain",
                        spy("plain_stats", norm_act.raw_stats_plain, True))
    return calls


def _train_pass(model, patch):
    model.train()
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2,) + patch + (1,), np.float32))
    out = model(x)
    sum(v.float().square().mean() for v in out.values()).backward()


@pytest.mark.parametrize("squeeze_excitation", [False, True])
def test_kernel_model_routes_tails_and_stats(monkeypatch, squeeze_excitation):
    """A bf16 kernel model's forward and backward at a 16^3 three-stage
    plan reach the Functions as often as its plan implies (the stem, the
    plain-class convs and the projections' statistics; every block's and
    decoder stage's tail, the projections' norms, with SE the handoff and
    the split tails), and nothing of the kernels' class takes the plain
    ops; the fp32 reference model reaches none."""
    patch = (16, 16, 16)
    plan = plan_from_autoconfig(
        patch, 1, [TaskHead("sheet", 1, "sigmoid"),
                   TaskHead("normals", 3, "none")], max_features=64,
        use_pallas_conv=True, squeeze_excitation=squeeze_excitation)
    want = norm_launches(plan, patch, 2)
    assert want["norm_act_tail"] > 0 and want["norm_act_raw_stats"] > 0
    calls = _count_calls(monkeypatch)
    _train_pass(ResEncUNet(plan, dtype=torch.bfloat16), patch)
    assert {k: calls[k] for k in want} == want
    assert calls["plain_tail"] == calls["plain_stats"] == 0
    ref_plan = dataclasses.replace(plan, use_pallas_conv=False)
    assert set(norm_launches(ref_plan, patch, 2).values()) == {0}
    calls.update(dict.fromkeys(calls, 0))
    _train_pass(ResEncUNet(ref_plan), patch)
    assert {k: calls[k] for k in want} == dict.fromkeys(want, 0)
    assert calls["plain_tail"] > 0 and calls["plain_stats"] > 0


def test_wrappers_run_plain_on_cpu_and_count_no_launch():
    _build.clear_counts()
    d = _inputs(5, 16)
    y2 = torch.from_numpy(d["y"]).reshape(2, -1, 16)
    r2 = torch.from_numpy(d["r"]).reshape(2, -1, 16)
    g2 = torch.from_numpy(d["g"]).reshape(2, -1, 16)
    v = {k: torch.from_numpy(d[k]) for k in ("inv", "shift", "a", "b")}
    out = norm_act.norm_tail(y2, v["inv"], v["shift"], r2, v["a"], v["b"])
    dy, dr, sums = norm_act.norm_tail_bwd(y2, r2, v["inv"], v["shift"],
                                          v["a"], v["b"], g2)
    stats = norm_act.raw_stats(y2)
    assert not any(_build.LAUNCHES.values())
    assert out.shape == dy.shape == dr.shape == y2.shape
    assert sums.shape == (2, 4, 16) and stats.shape == (2, 2, 16)
    _, dr0, sums0 = norm_act.norm_tail_bwd(y2, r2, v["inv"], v["shift"],
                                           None, None, g2)
    assert sums0.shape == (2, 2, 16) and dr0.dtype == r2.dtype
    with pytest.raises(ValueError):
        norm_act._tail_args("norm_act_tail", y2, None, v["inv"],
                            v["shift"], v["a"], v["b"])
