"""Compute dtype float16 on the port's kernel path, against the JAX package
on the CPU.

The JAX package picks its Pallas kernels by shape alone and runs them at
fp16 as at bf16 and fp32; the port sends an fp16 tensor of the kernels'
shape classes to the same Functions and kernels as bf16 (here, on the CPU,
their plain versions).

* The three Functions at fp16 (``Conv3dK3Fn`` with stats, pre-op, stride
  1 and 2, ``Conv3dK3PairFn`` with its add-in at stride 1 and 2,
  ``Upsample2xFn``) against autograd of the plain functions on the same
  fp16 leaves: outputs and statistics to FN_F16_TOL, every input's
  gradient to FN_F16_GRAD_TOL, relative L2. Both compute in fp32 from the
  same fp16 operands; the Functions' backward rounds the corrected
  cotangent to fp16 before the transposed conv, as the JAX kernel does
  (``pallas_conv.py`` ``_tile_corr_flat``), and rounds dx to fp16 where
  autograd keeps fp32 until the leaf.
* An fp16 kernel model (``use_pallas_conv=True``, the 16^3 three-stage plan
  of ``test_torch_port_dtypes.py``) against the JAX model at fp16 with
  ``use_pallas_conv=True``, its Pallas kernels in interpret mode, from the
  same numpy weights and batch (one module fixture for both): outputs to
  JAX_FWD_TOL of their max abs, every gradient by relative L2
  (JAX_GRAD_TOL) and cosine (JAX_MIN_COS). The forward's limit is under
  the bf16 model's against JAX (``test_torch_port_plain_bf16.py``: 3e-2),
  the gradients' the bf16 trainer's grad_norm limit. The same pass counts
  the norm-act wrappers' calls against ``norm_launches(...,
  torch.float16)``.
* The norm-act op at fp16 (``instance_norm_act_fused``, its four kernels'
  plain versions) against ``instance_norm_act_pallas`` at fp16 in interpret
  mode: forward and the gradient of ``sum(y * g)``, NORM_F16_TOL of the
  max abs.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.core.plan import TaskHead as JTaskHead
from mt3d_resenc_unet_tpu.core.plan import plan_from_autoconfig as jplan
from mt3d_resenc_unet_tpu.models.network import ResEncUNet as JaxUNet
from mt3d_resenc_unet_tpu.ops.pallas_norm_act import instance_norm_act_pallas
from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
from mt3d_resenc_unet_torch.models import blocks, network
from mt3d_resenc_unet_torch.models.network import ResEncUNet, norm_launches
from mt3d_resenc_unet_torch.ops import conv3d as c3
from mt3d_resenc_unet_torch.ops import norm_act
from mt3d_resenc_unet_torch.ops import upsample as up
from mt3d_resenc_unet_torch.tools.from_jax import params_from_jax

PATCH = (16, 16, 16)
SLOPE = 1e-2
MODES = ("stats", "pre_stats", "s2_stats", "s2_pre_stats", "pair",
         "pair_s2", "upsample")
# limits, each beside what this file measured on the CPU (seeds as below)
FN_F16_TOL = 1e-5        # measured 0: the same fp32 products, one rounding
FN_F16_GRAD_TOL = 1.5e-3  # measured 3.1e-4 at worst (x of "stats")
# forward measured 1.7e-3 (normals); gradients 0.093 and cosine 0.9957 at
# worst (the 4^3 stage), as far apart as each package's fp16 gradients are
# from its fp32 ones (test_torch_port_dtypes.py); the gradient limit is the
# bf16 trainer's grad_norm limit against JAX (P16_LIMITS there)
JAX_FWD_TOL, JAX_GRAD_TOL, JAX_MIN_COS = 8e-3, 0.2, 0.98
NORM_F16_TOL = 1e-4      # measured 0 (y) and 1.7e-5 (dx)
KERNEL_FNS = ("Conv3dK3Fn", "Conv3dK3PairFn", "Upsample2xFn")


def _rel_l2(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / want.norm())


# ------------------------------------------------------------ the Functions

def _case(mode: str, seed: int = 0):
    """fp16 leaves of one Function case, from numpy at ``seed``; the pre
    vectors stay fp32, as the model hands them over."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float16)
        return torch.tensor(a, requires_grad=True)

    n, ci, co = 2, 32, 64
    if mode == "upsample":
        return dict(x=t(n, 3, 4, 4, 64), wf=t(2, 2, 2, 64, 32, scale=0.1))
    stride = 2 if "s2" in mode else 1
    ext = (6, 4, 8) if stride == 2 else (5, 4, 6)
    case = dict(stride=stride, x=t(n, *ext, ci),
                w=t(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5))
    if "pre" in mode:
        pre = np.stack([rng.random((n, ci)) + 0.5,
                        rng.standard_normal((n, ci))], 1)
        case["pre"] = torch.tensor(pre.astype(np.float32), requires_grad=True)
    if mode.startswith("pair"):
        case["x2"] = t(n, *ext, co)
        case["w"] = t(3, 3, 3, ci + co, co, scale=(27 * (ci + co)) ** -0.5)
    return case


def _apply(mode, case, fn):
    """The outputs of one case through the Functions (``fn`` True) or the
    plain functions under autograd, and a scalar loss of them that weighs
    y and both statistics."""
    if mode == "upsample":
        y = (up.Upsample2xFn.apply(case["x"], case["wf"]) if fn
             else up.upsample_plain(case["x"], case["wf"]))
        return (y,), (y * torch.linspace(-1, 1, y.numel()).reshape(
            y.shape)).sum()
    s = case["stride"]
    if mode.startswith("pair"):
        x1, x2, w = case["x"], case["x2"], case["w"]
        if fn:
            y, st = c3.Conv3dK3PairFn.apply(x1, x2, w, s)
        else:
            c1 = x1.shape[-1]
            y1 = c3.conv3d_k3_plain(x1, w[..., :c1, :], s)
            y, st = c3.conv3d_k3_plain(x2, w[..., c1:, :], s, add_to=y1,
                                       emit_stats=True)
    else:
        pre = case.get("pre")
        if fn:
            y, st = c3.Conv3dK3Fn.apply(case["x"], case["w"], pre, s, SLOPE)
        else:
            y, st = c3.conv3d_k3_plain(case["x"], case["w"], s, pre=pre,
                                       emit_stats=True, negative_slope=SLOPE)
    weights = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
    loss = (y * weights).sum() + 1e-3 * st[:, 0].sum() + 1e-4 * st[:, 1].sum()
    return (y, st), loss


@pytest.mark.parametrize("mode", MODES)
def test_fp16_functions_match_autograd_of_plain(mode):
    case = _case(mode)
    tensors = {k: v for k, v in case.items() if isinstance(v, torch.Tensor)}
    got_out, got_loss = _apply(mode, case, True)
    got_loss.backward()
    got = {k: v.grad.clone() for k, v in tensors.items()}
    for v in tensors.values():
        v.grad = None
    want_out, want_loss = _apply(mode, case, False)
    want_loss.backward()
    assert got_out[0].dtype == torch.float16
    for g, w in zip(got_out, want_out):
        assert _rel_l2(g, w) <= FN_F16_TOL, _rel_l2(g, w)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.isfinite(got[k]).all(), k
        assert _rel_l2(got[k], v.grad) <= FN_F16_GRAD_TOL, (
            k, _rel_l2(got[k], v.grad))


def test_fp16_functions_take_subnormal_cotangents():
    """The flagship's per-voxel cotangents are ~2e-7, fp16 subnormals (the
    smallest normal is 6.1e-5): the Functions' dx and dW from such a
    cotangent against autograd of the plain functions from the same one,
    as the test above (nothing flushed to zero on the way)."""
    case = _case("pre_stats", seed=5)
    tensors = {k: v for k, v in case.items() if isinstance(v, torch.Tensor)}
    got = {}
    for fn in (True, False):
        for v in tensors.values():
            v.grad = None
        (y, _), _ = _apply("pre_stats", case, fn)
        gy = (torch.linspace(-1, 1, y.numel()).reshape(y.shape)
              * 2e-7).half()
        assert float(gy.abs().max()) < torch.finfo(torch.float16).tiny
        (y.float() * gy.float()).sum().backward()
        got[fn] = {k: v.grad.clone() for k, v in tensors.items()}
    for k in tensors:
        assert float(got[True][k].abs().max()) > 0, k
        assert _rel_l2(got[True][k], got[False][k]) <= FN_F16_GRAD_TOL, (
            k, _rel_l2(got[True][k], got[False][k]))


@pytest.mark.parametrize("stride", [1, 2])
def test_fp16_plain_dw_rounds_the_corrected_cotangent_as_jax(stride):
    """The plain dW (the kernels' yardstick and their CPU route) rounds the
    corrected cotangent gy + gs0 + 2*y*gs1 to gy's dtype before the
    correlation, as the JAX kernel does (``pallas_conv.py`` ``_dw_kernel``,
    ``.astype(gy_ref.dtype)``): equal, bit for bit, to the plain dW of that
    rounded cotangent; at the flagship's subnormal scale the rounding
    shows."""
    rng = np.random.default_rng(12)
    n, ci, co, size = 2, 32, 32, (6, 4, 6)
    out = tuple((s - 1) // stride + 1 for s in size)
    x = torch.from_numpy(rng.standard_normal((n,) + size + (ci,))).half()
    gy, y = (torch.from_numpy(rng.standard_normal((n,) + out + (co,))
                              * sc).half() for sc in (2e-7, 1.0))
    gs = torch.from_numpy(rng.standard_normal((n, 2, co)) * 2e-7).float()
    got = c3.conv3d_k3_dw_plain(x, gy, stride, y=y, gs=gs)
    u = (gy.float() + gs[:, None, None, None, 0]) + (
        2.0 * y.float()) * gs[:, None, None, None, 1]
    assert torch.equal(got, c3.conv3d_k3_dw_plain(x, u.half(), stride))
    assert not torch.equal(got, c3.conv3d_k3_dw_plain(x.float(), u, stride))


# ------------------------------------------------- the model against JAX

def _plan():
    return plan_from_autoconfig(
        PATCH, 1, [TaskHead("sheet", 1, "sigmoid"),
                   TaskHead("normals", 3, "none")], max_features=64,
        use_pallas_conv=True)


def _spy(monkeypatch):
    """Counts the applies of the conv and upsample Functions and the calls
    of the norm-act wrappers the model launches on the card."""
    calls = collections.Counter()

    def fn(module, name):
        f = getattr(module, name)

        class Spy:
            @staticmethod
            def apply(*args):
                calls[name] += 1
                return f.apply(*args)

        monkeypatch.setattr(module, name, Spy)

    def wrapper(name, attr):
        f = getattr(norm_act, attr)

        def wrapped(*args, **kw):
            calls[name] += 1
            return f(*args, **kw)

        monkeypatch.setattr(norm_act, attr, wrapped)

    fn(blocks, "Conv3dK3Fn")
    fn(blocks, "Conv3dK3PairFn")
    fn(network, "Upsample2xFn")
    wrapper("norm_act_tail", "norm_tail")
    wrapper("norm_act_tail_bwd", "norm_tail_bwd")
    wrapper("norm_act_raw_stats", "raw_stats")
    return calls


@pytest.fixture(scope="module")
def jax_fp16_kernels():
    """The 16^3 plan at fp16 with the kernels on in both packages, the JAX
    model's Pallas kernels in interpret mode; the same numpy weights (fp32
    parameters) and batch: (JAX outputs and gradients, the port's, the
    port's calls)."""
    from jax.experimental.pallas import tpu as pltpu
    jp = jplan(PATCH, 1, [JTaskHead("sheet", 1, "sigmoid"),
                          JTaskHead("normals", 3, "none")], max_features=64,
               use_pallas_conv=True)
    jmodel = JaxUNet(plan=jp, dtype=jnp.float16)
    x = np.random.default_rng(1).random((2,) + PATCH + (1,), np.float32)
    xla = JaxUNet(plan=dataclasses.replace(jp, use_pallas_conv=False),
                  dtype=jnp.float32)
    params = jax.jit(lambda k: xla.init({"params": k}, jnp.asarray(x),
                                        train=False))(
        jax.random.key(0))["params"]

    def loss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), train=True)
        return sum(jnp.mean(jnp.square(v.astype(jnp.float32)))
                   for v in out.values()), out

    with pltpu.force_tpu_interpret_mode():
        (_, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params)
    model = ResEncUNet(_plan(), dtype=torch.float16)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    model.train()
    with pytest.MonkeyPatch.context() as mp:
        calls = _spy(mp)
        out = model(torch.from_numpy(x))
        sum(v.float().square().mean() for v in out.values()).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return ({k: np.asarray(v.astype(jnp.float32)) for k, v in jout.items()},
            params_from_jax(jax.tree.map(np.asarray, jgrads)),
            {k: v.detach().float().numpy() for k, v in out.items()}, grads,
            calls)


def test_fp16_kernel_model_matches_jax_pallas_forward(jax_fp16_kernels):
    jout, _, out, _, calls = jax_fp16_kernels
    assert all(calls[n] > 0 for n in KERNEL_FNS), calls
    assert sorted(out) == sorted(jout)
    for k in jout:
        assert np.isfinite(out[k]).all(), k
        sc = float(np.abs(jout[k]).max())
        assert float(np.abs(out[k] - jout[k]).max()) <= JAX_FWD_TOL * sc, k


def test_fp16_kernel_model_matches_jax_pallas_gradients(jax_fp16_kernels):
    _, jgrads, _, grads, _ = jax_fp16_kernels
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        w = jgrads[name].float().numpy().ravel().astype(np.float64)
        if g is None:   # unused in the forward; JAX's gradient is 0
            assert not w.any(), name
            continue
        g = g.double().numpy().ravel()
        dist = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
        assert dist <= JAX_GRAD_TOL and cos >= JAX_MIN_COS, (name, dist, cos)


def test_norm_launches_at_fp16_count_the_fp16_pass(jax_fp16_kernels):
    calls = jax_fp16_kernels[4]
    want = norm_launches(_plan(), PATCH, 2, torch.float16)
    assert want["norm_act_tail"] > 0 and want["norm_act_raw_stats"] > 0
    assert {k: calls[k] for k in want} == want


# ----------------------------------------------------- the norm-act op

@pytest.mark.parametrize("act", [True, False])
def test_fp16_norm_act_matches_pallas_interpret(act):
    from jax.experimental.pallas import tpu as pltpu
    rng = np.random.default_rng(7)
    shape = (2, 4, 4, 8, 16)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float16)
    g = rng.standard_normal(shape).astype(np.float16)

    def f(xj):
        y = instance_norm_act_pallas(xj, None, None, act=act)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g, jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        want = instance_norm_act_pallas(jnp.asarray(x), None, None, act=act)
        want_dx = jax.grad(f)(jnp.asarray(x))
    assert want.dtype == jnp.float16 and want_dx.dtype == jnp.float16
    xt = torch.tensor(x, requires_grad=True)
    got = norm_act.instance_norm_act_fused(xt, act=act)
    assert got.dtype == torch.float16
    (got.float() * torch.from_numpy(g).float()).sum().backward()
    assert xt.grad.dtype == torch.float16
    for a, b in ((got.detach(), want), (xt.grad, want_dx)):
        b = np.asarray(b.astype(jnp.float32))
        err = float(np.abs(a.float().numpy() - b).max() / np.abs(b).max())
        assert err <= NORM_F16_TOL, err
