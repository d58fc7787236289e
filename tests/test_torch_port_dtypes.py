"""Every dtype the JAX trainer takes, in the port, against the JAX package
on the CPU.

* Routing by dtype (``use_pallas_conv=True``, a 16^3 three-stage plan whose
  convs and upsamples lie in the kernels' shape classes): a bf16, fp16 or
  fp32 model's forward and backward reach ``Conv3dK3Fn``,
  ``Conv3dK3PairFn`` and ``Upsample2xFn`` (the kernels take all three, as
  the JAX package dispatches by shape alone). The norm-act Functions are
  reached exactly as often as ``models/network.py::norm_launches`` derives
  for each dtype (fp16 as bf16). The fp16 Functions and model against JAX
  are in ``test_torch_port_fp16.py``.
* The three Functions at fp32 in every mode (pre-op, stats, stride 1 and
  2, the split-weight pair with its add-in, the upsample): outputs,
  statistics and every input's gradient against autograd of the fp32
  plain functions (FN_F32_TOL), and an fp32 kernel model against the JAX
  model at fp32 with ``use_pallas_conv=True``, its Pallas kernels in
  interpret mode: outputs to JAX_FWD_TOL of their max abs, every gradient
  by relative L2 (JAX_GRAD_TOL) and cosine (JAX_MIN_COS), PERF.md's CPU
  limits.
* ``compute_dtype`` float32 and float16: the port's ``Trainer`` (kernels
  on) against the JAX ``Trainer`` (its XLA path) for two SGD steps from
  the JAX trainer's initial parameters, on the same synthetic dataset
  (16^3, features (32, 64), one step an epoch, so each epoch's train loss
  is one step's): the losses by relative error, and the parameters' change
  over the run by relative L2. fp32 at lr 0.1: 1e-5 and 1e-4, as the step
  tests hold fp32 (measured 1.6e-6 and 2.3e-5). fp16 at lr 0.01 (at lr 0.1
  one fp16 step moves the normals loss from 0.93 to 0.19 in both packages,
  0.74 in fp32, too steep a slope to compare): 5x the measured 3.9e-3 and
  6.9e-2. The fp16 gradients of both packages are 5-10% (relative L2 per
  tensor) from their fp32 ones at this random init, and as far from each
  other; the port's are the nearer to fp32 in 29 of 30 tensors.
* ``param_dtype`` bfloat16 and float16: the JAX trainer's first three SGD
  steps (lr 0.01) against the port's from the same weights, carried by
  ``params_from_jax`` in their own dtype; the steps' metrics are recorded
  in both trainers. Each step's losses and grad_norm by relative error
  (the first step's losses apart: the forward alone), the parameters in
  ulps of the parameter dtype, as the share of elements more than one ulp
  apart. Limits in P16_LIMITS, 5x the values measured here (2x for the
  shares, which a 5x margin would leave near 1), each written beside
  them. With bf16 compute the first step's gradients of both packages are
  20-30% (relative L2 per tensor) from fp32 ones, so the steps after the
  first compare loosely; fp32 compute over bf16 parameters holds the
  parameters' path (clip, momentum, update in bf16) to a few ulps.
* AdamW on 16-bit parameters against optax on the same gradients: the
  moments in the parameters' dtype, the norm bit-equal, and the share of
  elements more than one ulp apart (bf16: measured 0) under
  ADAMW_ULP_SHARE.
* A bf16 checkpoint saves and restores in bf16 (parameters and AdamW's
  moments), and the engine loads it and writes the same finals, bit for
  bit, as from the same weights saved in fp32.
"""

import collections
import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.core.config import ConfigManager as JConfig
from mt3d_resenc_unet_tpu.models.network import ResEncUNet as JaxUNet
from mt3d_resenc_unet_tpu.train.trainer import Trainer as JTrainer
from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
from mt3d_resenc_unet_torch.infer.engine import ZarrInferenceEngine
from mt3d_resenc_unet_torch.models import blocks, network
from mt3d_resenc_unet_torch.models.network import ResEncUNet, norm_launches
from mt3d_resenc_unet_torch.ops import norm_act
from mt3d_resenc_unet_torch.tools.from_jax import params_from_jax
from mt3d_resenc_unet_torch.tools.synthetic_data import write_sheet_dataset
from mt3d_resenc_unet_torch.train import checkpoint as ck
from mt3d_resenc_unet_torch.train.trainer import Trainer

DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16}
PATCH = (16, 16, 16)
FN_BF16_TOL = 6e-2    # 5x the measured 1.2e-2
# the fp32 Functions against autograd of their plain versions: the same
# fp32 products summed in another order (relative L2)
FN_F32_TOL = 1e-5
JAX_FWD_TOL, JAX_GRAD_TOL, JAX_MIN_COS = 1e-4, 0.1, 0.995
LR = {"float32": 0.1, "float16": 0.01}
# (loss relative error, relative L2 of the parameters' change)
TRAINER_LIMITS = {"float32": (1e-5, 1e-4),     # measured 1.6e-6, 2.3e-5
                  "float16": (2e-2, 0.35)}     # measured 3.9e-3, 6.9e-2
P16_LR = 0.01
# (compute, param) -> (first step's losses, every step's losses, grad_norm,
# share of parameter elements > 1 ulp apart), relative errors; measured:
P16_LIMITS = {
    # 2.3e-4, 4.6e-2, 4.0e-2, 9.2e-2
    ("bfloat16", "bfloat16"): (1.2e-3, 0.24, 0.2, 0.19),
    # 2.0e-3, 3.4e-2, 1.9e-2, 0.19
    ("bfloat16", "float16"): (1e-2, 0.17, 0.1, 0.38),
    # 4.0e-7, 4.8e-4, 7.0e-3 (one bf16 ulp), 2.6e-3
    ("float32", "bfloat16"): (2e-6, 2.4e-3, 3.5e-2, 6e-3),
}
# measured 0 (bf16: bit-equal) and 5.8e-3 (fp16)
ADAMW_ULP_SHARE = {"bfloat16": 1e-3, "float16": 3e-2}


# ------------------------------------------------------------------ routing

def _plan(**kw):
    return plan_from_autoconfig(
        PATCH, 1, [TaskHead("sheet", 1, "sigmoid"),
                   TaskHead("normals", 3, "none")], max_features=64,
        use_pallas_conv=True, **kw)


def _spy_functions(monkeypatch):
    """Counts the applies of the conv and upsample kernels' Functions."""
    calls = collections.Counter()

    def spy(module, name):
        fn = getattr(module, name)

        class Spy:
            @staticmethod
            def apply(*args):
                calls[name] += 1
                return fn.apply(*args)

        monkeypatch.setattr(module, name, Spy)

    spy(blocks, "Conv3dK3Fn")
    spy(blocks, "Conv3dK3PairFn")
    spy(network, "Upsample2xFn")
    return calls


def _spy_norm(monkeypatch):
    """Counts the norm-act wrappers' calls (what launches on the card)."""
    calls = collections.Counter()

    def spy(name, attr):
        fn = getattr(norm_act, attr)

        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)

        monkeypatch.setattr(norm_act, attr, wrapped)

    spy("norm_act_tail", "norm_tail")
    spy("norm_act_tail_bwd", "norm_tail_bwd")
    spy("norm_act_raw_stats", "raw_stats")
    return calls


def _train_pass(model):
    model.train()
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2,) + PATCH + (1,), np.float32))
    out = model(x)
    assert all(torch.isfinite(v).all() for v in out.values())
    sum(v.float().square().mean() for v in out.values()).backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)


@pytest.fixture(scope="module")
def dispatch():
    """One training pass of the kernel model (no SE) in each dtype, with
    the conv and upsample Functions' applies and the norm-act wrappers'
    calls counted: {dtype: (Function counts, norm-act counts)}, which the
    two routing tests below read."""
    out = {}
    for dtype in DTYPES:
        with pytest.MonkeyPatch.context() as mp:
            functions, norms = _spy_functions(mp), _spy_norm(mp)
            _train_pass(ResEncUNet(_plan(), dtype=DTYPES[dtype]))
        out[dtype] = (functions, norms)
    return out


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_only_bf16_reaches_the_conv_and_upsample_kernels(dispatch, dtype):
    """Which dtypes reach the conv and upsample kernels' Functions: every
    compute dtype the trainer takes, bf16, fp16 and fp32 (the kernels take
    all three; the name is the test's from when only bf16 did)."""
    calls = dispatch[dtype][0]
    names = ("Conv3dK3Fn", "Conv3dK3PairFn", "Upsample2xFn")
    assert all(calls[n] > 0 for n in names), calls


@pytest.mark.parametrize("squeeze_excitation", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_norm_launches_predict_each_dtypes_dispatch(monkeypatch, dispatch,
                                                    dtype,
                                                    squeeze_excitation):
    plan = _plan(squeeze_excitation=squeeze_excitation)
    want = norm_launches(plan, PATCH, 2, DTYPES[dtype])
    if squeeze_excitation:
        calls = _spy_norm(monkeypatch)
        _train_pass(ResEncUNet(plan, dtype=DTYPES[dtype]))
    else:   # the model of the fixture's pass
        calls = dispatch[dtype][1]
    assert {k: calls[k] for k in want} == want
    assert want["norm_act_tail"] > 0 and want["norm_act_raw_stats"] > 0
    if dtype == "float16":      # 8 channels a vector, as bf16
        assert want == norm_launches(plan, PATCH, 2, torch.bfloat16)
    assert set(norm_launches(dataclasses.replace(plan, use_pallas_conv=False),
                             PATCH, 2, DTYPES[dtype]).values()) == {0}


def _plain_functions(monkeypatch):
    """The kernels' Functions replaced by their plain versions, which
    autograd differentiates."""
    from mt3d_resenc_unet_torch.ops.conv3d import conv3d_k3_plain
    from mt3d_resenc_unet_torch.ops.upsample import upsample_plain

    class Conv:
        @staticmethod
        def apply(x, w, pre, stride, slope):
            return conv3d_k3_plain(x, w, stride, pre=pre, emit_stats=True,
                                   negative_slope=slope)

    class Pair:
        @staticmethod
        def apply(x1, x2, w, stride):
            c1 = x1.shape[-1]
            y1 = conv3d_k3_plain(x1, w[..., :c1, :], stride)
            return conv3d_k3_plain(x2, w[..., c1:, :], stride, add_to=y1,
                                   emit_stats=True)

    class Up:
        @staticmethod
        def apply(x, wf):
            return upsample_plain(x, wf)

    monkeypatch.setattr(blocks, "Conv3dK3Fn", Conv)
    monkeypatch.setattr(blocks, "Conv3dK3PairFn", Pair)
    monkeypatch.setattr(network, "Upsample2xFn", Up)


def test_bf16_functions_backward_matches_autograd_of_plain(monkeypatch):
    """In a bf16 kernel model the Functions' backward, whose dx and dW kernels
    run their plain versions here, against autograd of the Functions'
    plain forward: every gradient within FN_BF16_TOL of its max abs. Both
    take fp32 products of the same bf16 operands and round them to bf16 at
    different points (measured 1.2e-2 at worst)."""
    torch.manual_seed(0)
    model = ResEncUNet(_plan(), dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2,) + PATCH + (1,), np.float32))

    def grads():
        model.zero_grad(set_to_none=True)
        model.train()
        out = model(x)
        sum(v.float().square().mean() for v in out.values()).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None}

    calls = _spy_functions(monkeypatch)
    got = grads()
    assert all(calls[n] > 0 for n in ("Conv3dK3Fn", "Conv3dK3PairFn",
                                      "Upsample2xFn"))
    monkeypatch.undo()
    _plain_functions(monkeypatch)
    want = grads()
    assert sorted(got) == sorted(want)
    worst = 0.0
    for name, g in got.items():
        sc = float(want[name].abs().max())
        assert sc > 0, name
        worst = max(worst, float((g - want[name]).abs().max()) / sc)
    assert worst <= FN_BF16_TOL, worst


def _rel_l2(got, want) -> float:
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / want.norm())


def _f32_case(mode: str, seed: int = 0):
    """Inputs of one fp32 Function case, from numpy at ``seed``."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32)
                            * scale, requires_grad=True)

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


def _f32_apply(mode, case, fn):
    """The outputs of one case through the Functions (``fn`` True) or the
    plain functions under autograd, and a scalar loss of them that weighs
    y and both statistics."""
    from mt3d_resenc_unet_torch.ops import conv3d as c3
    from mt3d_resenc_unet_torch.ops import upsample as up
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


SLOPE = 1e-2
F32_MODES = ("stats", "pre_stats", "s2_stats", "s2_pre_stats", "pair",
             "pair_s2", "upsample")


@pytest.mark.parametrize("mode", F32_MODES)
def test_fp32_functions_match_autograd_of_plain(mode):
    """Conv3dK3Fn (stats, pre-op, stride 1 and 2), Conv3dK3PairFn (the
    add-in at stride 1 and 2) and Upsample2xFn at fp32: forward outputs,
    statistics and the gradients of every input (x, x2, w, wf, pre)
    against autograd of the fp32 plain functions, by relative L2."""
    case = _f32_case(mode)
    got_out, got_loss = _f32_apply(mode, case, True)
    got_loss.backward()
    got = {k: v.grad.clone() for k, v in case.items()
           if isinstance(v, torch.Tensor)}
    for v in case.values():
        if isinstance(v, torch.Tensor):
            v.grad = None
    want_out, want_loss = _f32_apply(mode, case, False)
    want_loss.backward()
    for g, w in zip(got_out, want_out):
        assert g.dtype == torch.float32
        assert _rel_l2(g, w) <= FN_F32_TOL
    for k, v in case.items():
        if isinstance(v, torch.Tensor):
            assert got[k] is not None and v.grad is not None, k
            assert _rel_l2(got[k], v.grad) <= FN_F32_TOL, (k, _rel_l2(
                got[k], v.grad))


@pytest.fixture(scope="module")
def jax_fp32_kernels():
    """The 16^3 plan of the routing tests at fp32 with the kernels on in
    both packages, the JAX model's Pallas kernels in interpret mode; the
    same numpy weights and batch: (JAX outputs and gradients, the port's,
    the port's Function applies)."""
    from jax.experimental.pallas import tpu as pltpu
    from mt3d_resenc_unet_tpu.core.plan import TaskHead as JTaskHead
    from mt3d_resenc_unet_tpu.core.plan import plan_from_autoconfig as jplan
    jp = jplan(PATCH, 1, [JTaskHead("sheet", 1, "sigmoid"),
                          JTaskHead("normals", 3, "none")], max_features=64,
               use_pallas_conv=True)
    jmodel = JaxUNet(plan=jp, dtype=jnp.float32)
    x = np.random.default_rng(1).random((2,) + PATCH + (1,), np.float32)
    # the same parameter tree from the XLA plan, whose init is quick
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
    model = ResEncUNet(_plan(), dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    model.train()
    with pytest.MonkeyPatch.context() as mp:
        calls = _spy_functions(mp)
        out = model(torch.from_numpy(x))
        sum(v.float().square().mean() for v in out.values()).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return ({k: np.asarray(v) for k, v in jout.items()},
            params_from_jax(jax.tree.map(np.asarray, jgrads)),
            {k: v.detach().numpy() for k, v in out.items()}, grads, calls)


def test_fp32_kernel_model_matches_jax_pallas_forward(jax_fp32_kernels):
    jout, _, out, _, calls = jax_fp32_kernels
    assert all(calls[n] > 0 for n in ("Conv3dK3Fn", "Conv3dK3PairFn",
                                      "Upsample2xFn")), calls
    assert sorted(out) == sorted(jout)
    for k in jout:
        assert out[k].dtype == np.float32
        sc = float(np.abs(jout[k]).max())
        assert float(np.abs(out[k] - jout[k]).max()) <= JAX_FWD_TOL * sc, k


def test_fp32_kernel_model_matches_jax_pallas_gradients(jax_fp32_kernels):
    _, jgrads, _, grads, _ = jax_fp32_kernels
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        w = jgrads[name].numpy().ravel()
        if g is None:   # unused in the forward; JAX's gradient is 0
            assert not w.any(), name
            continue
        g = g.numpy().ravel()
        dist = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        cos = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
        assert dist <= JAX_GRAD_TOL and cos >= JAX_MIN_COS, (name, dist, cos)


# ----------------------------------------------------- trainers against JAX

@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    return write_sheet_dataset(tmp_path_factory.mktemp("vols"), (32, 40, 40),
                               seed=3, chunks=(16, 16, 16))


def _config(tmp_path, volumes, steps, compute_dtype, param_dtype="float32",
            optimizer="AdamW", lr=1e-3):
    return {
        "tr_setup": {"model_name": "tiny", "autoconfigure": False,
                     "tr_val_split": 0.8, "seed": 0,
                     "ckpt_out_base": str(tmp_path / "ckpts"),
                     "tensorboard_log_dir": str(tmp_path / "logs"),
                     "ckpt_interval_epochs": 0, "save_final": False},
        "tr_config": {"optimizer": optimizer, "initial_lr": lr,
                      "weight_decay": 1e-4, "patch_size": list(PATCH),
                      "batch_size": 2, "max_steps_per_epoch": 1,
                      "max_val_steps_per_epoch": 1, "max_epoch": steps,
                      "num_dataloader_workers": 2,
                      "compute_dtype": compute_dtype,
                      "param_dtype": param_dtype, "mesh_shape": [1]},
        "model_config": {
            "basic_encoder_block": "BasicBlockD",
            "basic_decoder_block": "ConvBlock",
            "bottleneck_block": "BasicBlockD",
            "features_per_stage": [32, 64], "num_stages": 2,
            "n_blocks_per_stage": [1, 1], "n_conv_per_stage_decoder": [1],
            "kernel_sizes": [3, 3], "strides": [1, 2]},
        "dataset_config": {
            "min_bbox_percent": 0.97, "min_labeled_ratio": 0.15,
            "use_cache": False, "in_channels": 1, "volume_paths": [volumes],
            "targets": {
                "sheet": {"channels": 1, "activation": "sigmoid",
                          "loss_fn": "BCEDiceLoss",
                          "loss_kwargs": {"alpha": 0.5, "beta": 0.5}},
                "normals": {"channels": 3, "activation": "none",
                            "loss_fn": "MaskedCosineLoss"}}},
        "inference_config": {},
    }


def _jax_init_params(cfg):
    """The JAX trainer's initial parameters (trainer.py:119-129), in its
    ``param_dtype``."""
    mgr = JConfig(config_dict=cfg)
    plan = mgr.build_plan()
    model = JaxUNet(plan=plan, dtype=jnp.dtype(mgr.compute_dtype),
                    param_dtype=jnp.dtype(mgr.param_dtype))
    sample = jnp.zeros((1,) + tuple(plan.patch_size) + (plan.in_channels,))
    return jax.jit(lambda k: model.init({"params": k}, sample,
                                        train=False))(
        jax.random.key(cfg["tr_setup"]["seed"]))["params"]


def _run_both(tmp_path, cfg):
    """The JAX trainer, then the port's (kernels on) from the JAX trainer's
    initial parameters: (JAX history, JAX final params, port history, port
    final params, initial params), the params as port state_dicts."""
    out = JTrainer(config_dict=copy.deepcopy(cfg), verbose=False).train()
    want_params = params_from_jax(jax.tree.map(np.asarray,
                                               out["state"].params))
    init = params_from_jax(jax.tree.map(np.asarray, _jax_init_params(cfg)))

    class FromJax(Trainer):
        def _build_model(self, plan):
            model = super()._build_model(plan)
            model.load_state_dict(init)
            return model

    port_cfg = copy.deepcopy(cfg)
    port_cfg["tr_config"]["use_pallas_conv"] = True
    port_cfg["tr_setup"]["ckpt_out_base"] = str(tmp_path / "port_ckpts")
    got = FromJax(config_dict=port_cfg, verbose=False, device="cpu").train()
    assert got["plan"].use_pallas_conv
    got_params = got["model"].state_dict()
    assert sorted(got_params) == sorted(want_params)
    return out["history"], want_params, got["history"], got_params, init


def _train_losses(history):
    return [[h[f"train/{t}_loss"] for t in ("sheet", "normals")]
            for h in history]


def _delta_rel(init, want, got):
    """Relative L2 of the parameters' change over the run, port vs JAX."""
    diff = moved = 0.0
    for k, v in init.items():
        d_want = want[k].double() - v.double()
        d_got = got[k].double() - v.double()
        diff += float(((d_got - d_want) ** 2).sum())
        moved += float((d_want ** 2).sum())
    assert moved > 0
    return (diff / moved) ** 0.5


@pytest.mark.parametrize("compute_dtype", ["float32", "float16"])
def test_trainer_matches_jax_at_each_compute_dtype(tmp_path, volumes,
                                                   monkeypatch,
                                                   compute_dtype):
    monkeypatch.chdir(tmp_path)
    cfg = _config(tmp_path, volumes, 2, compute_dtype, optimizer="SGD",
                  lr=LR[compute_dtype])
    want, want_p, got, got_p, init = _run_both(tmp_path, cfg)
    assert all(v.dtype == torch.float32 for v in got_p.values())
    lw, lg = np.array(_train_losses(want)), np.array(_train_losses(got))
    assert np.isfinite(lg).all()
    loss_rel = float(np.max(np.abs(lg - lw) / np.abs(lw)))
    delta = _delta_rel(init, want_p, got_p)
    loss_tol, delta_tol = TRAINER_LIMITS[compute_dtype]
    assert loss_rel <= loss_tol and delta <= delta_tol, (loss_rel, delta)


def _ulps_apart(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in ulps of ``want``'s dtype at ``want``'s magnitude
    (the spacing of its binade; the subnormal spacing below the normals)."""
    info = torch.finfo(want.dtype)
    w = want.double()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=info.tiny))))
    return (got.double() - w).abs() / (ulp * info.eps)


def _capture_steps(monkeypatch):
    """Records every training step's metrics in both trainers (the JAX
    step's prelowering, a compile-cache warm-up, is skipped)."""
    from mt3d_resenc_unet_tpu.train import trainer as jtrainer
    from mt3d_resenc_unet_torch.train import trainer as ttrainer
    seen = {"jax": [], "port": []}

    def capture(module, key):
        make = module.make_train_step

        def wrapped_make(*args, **kw):
            step = make(*args, **kw)

            def run(*a):
                out = step(*a)
                metrics = out[1] if key == "jax" else out
                seen[key].append({k: float(v) for k, v in metrics.items()
                                  if np.ndim(v) == 0})
                return out
            return run

        monkeypatch.setattr(module, "make_train_step", wrapped_make)

    capture(jtrainer, "jax")
    capture(ttrainer, "port")
    monkeypatch.setattr(jtrainer, "prelower", lambda *a, **k: None)
    return seen


@pytest.mark.parametrize("compute_dtype,param_dtype",
                         [("bfloat16", "bfloat16"), ("bfloat16", "float16"),
                          ("float32", "bfloat16")])
def test_trainer_matches_jax_at_each_param_dtype(tmp_path, volumes,
                                                 monkeypatch, compute_dtype,
                                                 param_dtype):
    monkeypatch.chdir(tmp_path)
    seen = _capture_steps(monkeypatch)
    cfg = _config(tmp_path, volumes, 3, compute_dtype, param_dtype,
                  optimizer="SGD", lr=P16_LR)
    want, want_p, got, got_p, init = _run_both(tmp_path, cfg)
    dt = DTYPES[param_dtype]
    assert all(v.dtype == dt for v in list(got_p.values())
               + list(want_p.values()) + list(init.values()))
    assert len(seen["jax"]) == len(seen["port"]) == 3
    losses = ("sheet", "normals", "total_loss")
    first = max(abs(seen["port"][0][k] - seen["jax"][0][k])
                / abs(seen["jax"][0][k]) for k in losses)
    rel = {k: max(abs(g[k] - w[k]) / abs(w[k])
                  for g, w in zip(seen["port"], seen["jax"]))
           for k in losses + ("grad_norm",)}
    far = sum(int((_ulps_apart(got_p[k], w) > 1.0).sum())
              for k, w in want_p.items())
    moved = sum(int((w != init[k]).sum()) for k, w in want_p.items())
    share = far / sum(w.numel() for w in want_p.values())
    assert moved > 0.25 * sum(w.numel() for w in want_p.values())
    first_tol, loss_tol, gnorm_tol, share_tol = P16_LIMITS[
        (compute_dtype, param_dtype)]
    assert first <= first_tol, (first, seen)
    assert max(rel[k] for k in losses) <= loss_tol, (rel, seen)
    assert rel["grad_norm"] <= gnorm_tol, (rel, seen)
    assert share <= share_tol, share


def test_bf16_checkpoint_round_trip_and_engine_load(tmp_path, volumes,
                                                    monkeypatch):
    """A param_dtype bfloat16 run's checkpoint holds bf16 parameters and
    AdamW moments, resumes into them, and the engine (bf16 compute) loads
    it and writes the same finals, bit for bit, as from the same weights
    saved in fp32."""
    monkeypatch.chdir(tmp_path)
    cfg = _config(tmp_path, volumes, 1, "bfloat16", "bfloat16")
    cfg["tr_setup"]["ckpt_interval_epochs"] = 1
    out = Trainer(config_dict=copy.deepcopy(cfg), verbose=False,
                  device="cpu").train()
    root = tmp_path / "ckpts" / "tiny"
    saved = ck.restore_flexible(root)
    assert all(v.dtype == torch.bfloat16 for v in saved["params"].values())
    moments = [t for st in saved["opt_state"]["state"].values()
               for k, t in st.items() if k in ("mu", "nu")]
    assert moments and all(t.dtype == torch.bfloat16 for t in moments)
    for k, v in out["model"].state_dict().items():
        assert torch.equal(saved["params"][k], v), k

    seen = {}

    class Probe(Trainer):
        def _restore(self, path, model, opt):
            epoch = super()._restore(path, model, opt)
            seen.update(params={k: v.clone() for k, v in
                                model.state_dict().items()},
                        opt=copy.deepcopy(opt.opt.state_dict()))
            return epoch

    cfg["tr_config"]["max_epoch"] = 2
    cfg["tr_setup"]["checkpoint_path"] = str(root)
    Probe(config_dict=cfg, verbose=False, device="cpu").train()
    for k, v in saved["params"].items():
        assert seen["params"][k].dtype == torch.bfloat16
        assert torch.equal(seen["params"][k], v), k
    got = seen["opt"]["state"]
    for i, st in saved["opt_state"]["state"].items():
        for k in ("mu", "nu"):
            assert got[i][k].dtype == torch.bfloat16
            assert torch.equal(got[i][k], st[k])

    fp32 = tmp_path / "fp32.pt"
    ck.save_params(fp32, {k: v.float() for k, v in saved["params"].items()})
    finals = []
    for name, ckpt in (("bf16", root / "0"), ("fp32", fp32)):
        icfg = copy.deepcopy(cfg)
        icfg["tr_config"]["use_pallas_conv"] = True
        icfg["inference_config"] = {
            "checkpoint_path": str(ckpt), "input_path": volumes["input"],
            "output_path": str(tmp_path / f"infer_{name}"),
            "overlap": 0.5, "patch_size": list(PATCH), "batch_size": 2,
            "normalization": "none", "num_dataloader_workers": 2,
            "output_targets": ["sheet", "normals"]}
        engine = ZarrInferenceEngine(config_dict=icfg, device="cpu")
        store = engine.infer()
        from mt3d_resenc_unet_torch.data.zio import open_zarr
        finals.append({t: open_zarr(f"{store}/{t}_final").read_all()
                       for t in ("sheet", "normals")})
    for t in ("sheet", "normals"):
        assert finals[0][t].size and np.array_equal(finals[0][t],
                                                    finals[1][t]), t


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float16"])
def test_adamw_moments_follow_the_param_dtype(param_dtype):
    """``build_optimizer``'s AdamW on 16-bit parameters (optax's rule in
    their dtype, an ``OptaxRule``) against optax's (the JAX step's chain,
    jitted) for three updates from the same 16-bit gradients (no moment
    underflows at this scale; optax's eps of 1e-8 rounds to 0 in fp16):
    the moments stay in the parameters' dtype, the pre-clip norm is
    ``optax.global_norm``'s, and the share of parameter elements more than
    one ulp apart stays under ADAMW_ULP_SHARE."""
    import optax
    from mt3d_resenc_unet_tpu.train import step as js
    from mt3d_resenc_unet_torch.train import step as ts
    dt = DTYPES[param_dtype]
    jdt = jnp.dtype(param_dtype)
    rng = np.random.default_rng(11)
    shapes = {"conv": (3, 3, 3, 32, 64), "square": (256, 256),
              "bias": (64,)}
    jp = {k: jnp.asarray(rng.standard_normal(s) * 0.05, jdt)
          for k, s in shapes.items()}

    def to_torch(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dt)

    tp = {k: torch.nn.Parameter(to_torch(v)) for k, v in jp.items()}
    tx = js.build_optimizer("AdamW", js.cosine_epoch_schedule(1e-3, 10, 1),
                            weight_decay=1e-4, grad_clip_norm=3.0)
    state = tx.init(jp)
    update = jax.jit(tx.update)
    opt = ts.build_optimizer(tp.values(), "AdamW",
                             ts.cosine_epoch_schedule(1e-3, 10, 1),
                             weight_decay=1e-4, grad_clip_norm=3.0)
    for scale in (1.0, 0.3, 2.0):   # the clip is active at two of them
        g = {k: jnp.asarray(rng.standard_normal(s) * scale / 50, jdt)
             for k, s in shapes.items()}
        u, state = update(g, state, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in tp.items():
            p.grad = to_torch(g[k])
        norm = opt.step()
        assert norm.dtype == dt
        assert float(norm) == float(optax.global_norm(g))
    for p in tp.values():
        st = opt.opt.state[p]
        assert st["mu"].dtype == st["nu"].dtype == dt
    far = sum(int((_ulps_apart(tp[k].detach(), to_torch(jp[k])) > 1).sum())
              for k in shapes)
    share = far / sum(int(np.prod(s)) for s in shapes.values())
    assert share <= ADAMW_ULP_SHARE[param_dtype], share
