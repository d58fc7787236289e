"""The torch port's ResEncUNet against the JAX model, on the CPU.

The plan is the flagship's block schedule cut to a 32^3 patch:
``plan_from_autoconfig((32,)*3, 1, [sheet/sigmoid, normals/none],
max_features=256)`` has 4 stages (32, 64, 128, 256) with blocks (1, 3, 4, 6),
so it reaches every dispatch class of the port: the stride-1 and stride-2
conv kernel classes, the split-weight decoder pair, the 2x upsample kernel
class, and the plain-torch stem, 128-channel stage, deep stride-2 conv and
generic upsample. The JAX side runs its plain XLA path
(``use_pallas_conv=False``) in fp32; the port runs fp32 on the CPU (its
3x3x3 convs and upsamples through the kernels' plain versions, as the
kernels take bf16 only), and a bf16 copy of it through the kernel wrappers,
which take their plain versions on the CPU.

Tolerance: rtol 1e-4 / atol 1e-4. Both sides are fp32, but convs sum in
another order (oneDNN vs XLA), the port takes instance-norm statistics as
[sum; sumsq] where XLA takes means, and each of the ~40 instance norms
rescales the difference by 1/std; the measured max difference is ~5e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.core.plan import TaskHead as JTaskHead
from mt3d_resenc_unet_tpu.core.plan import plan_from_autoconfig as jax_plan
from mt3d_resenc_unet_tpu.models.network import ResEncUNet as JaxUNet
from mt3d_resenc_unet_tpu.models.network import count_params as jax_count
from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
from mt3d_resenc_unet_torch.ops import conv3d, upsample
from mt3d_resenc_unet_torch.models.network import ResEncUNet, count_params
from mt3d_resenc_unet_torch.tools.from_jax import params_from_jax

RTOL = ATOL = 1e-4
PATCH = (32, 32, 32)


def _tasks(cls):
    return [cls("sheet", 1, "sigmoid"), cls("normals", 3, "none")]


def _port_plan(**kw):
    return plan_from_autoconfig(PATCH, 1, _tasks(TaskHead), max_features=256,
                                use_pallas_conv=True, **kw)


@pytest.fixture(scope="module")
def jax_run():
    plan = jax_plan(PATCH, 1, _tasks(JTaskHead), max_features=256)
    model = JaxUNet(plan=plan, dtype=jnp.float32)
    x = np.random.default_rng(0).standard_normal(
        (2,) + PATCH + (1,)).astype(np.float32)
    params = jax.jit(lambda k: model.init(
        {"params": k}, jnp.zeros((1,) + PATCH + (1,)), train=False))(
        jax.random.key(0))["params"]
    out = jax.jit(lambda p, v: model.apply({"params": p}, v, train=False))(
        params, x)
    return {"params": jax.tree.map(np.asarray, params), "x": x,
            "out": {k: np.asarray(v) for k, v in out.items()}}


@pytest.fixture(scope="module")
def port(jax_run):
    model = ResEncUNet(_port_plan())
    model.load_state_dict(params_from_jax(jax_run["params"]), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(jax_run["x"]))
    return model, out


def test_plan_copy_matches_jax_plan():
    jp = jax_plan((128,) * 3, 1, _tasks(JTaskHead), use_pallas_conv=True)
    tp = plan_from_autoconfig((128,) * 3, 1, _tasks(TaskHead),
                              use_pallas_conv=True)
    assert tp.features_per_stage == jp.features_per_stage \
        == (32, 64, 128, 256, 512, 512)
    for field in ("n_blocks_per_stage", "n_conv_per_stage_decoder",
                  "kernel_sizes", "strides", "patch_size", "stem_width"):
        assert getattr(tp, field) == getattr(jp, field), field


def test_state_dict_names_and_shapes_match_jax(jax_run):
    sd = params_from_jax(jax_run["params"])
    own = ResEncUNet(_port_plan()).state_dict()
    assert sorted(own) == sorted(sd)
    assert all(own[k].shape == sd[k].shape for k in own)
    assert "encoder.stage0.block0.conv1.conv.kernel" in own


def test_count_params_matches_jax(jax_run, port):
    assert count_params(port[0]) == jax_count(jax_run["params"])


@pytest.mark.parametrize("task,channels", [("sheet", 1), ("normals", 3)])
def test_forward_matches_jax(jax_run, port, task, channels):
    got = port[1][task]
    want = jax_run["out"][task]
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2,) + PATCH + (channels,)
    np.testing.assert_allclose(got.numpy(), want, RTOL, ATOL)


def test_kernel_dispatch_reaches_every_kernel_class(jax_run, port,
                                                    monkeypatch):
    """With use_pallas_conv the kernel shape classes of a bf16 model go
    through the wrappers (which on the card launch the kernels), by way of
    the autograd Functions: the stride-1 and stride-2 conv, the split
    pair's add-in, and the upsample. The fp32 model (the fixture's) reaches
    the same classes (the kernels take bf16 and fp32)."""
    seen = []

    def spy(name, fn):
        def wrapped(x, w, *args, **kw):
            stride = args[0] if args else 1
            mode = ("addin" if kw.get("add_to") is not None
                    else "pre" if kw.get("pre") is not None else "")
            seen.append((name, x.shape[-1], w.shape[-1], stride, mode))
            return fn(x, w, *args, **kw)
        return wrapped

    model = ResEncUNet(port[0].plan, dtype=torch.bfloat16)
    model.load_state_dict(port[0].state_dict())
    x = torch.from_numpy(jax_run["x"])
    with torch.no_grad():
        unspied = model(x)
    monkeypatch.setattr(conv3d, "conv3d_k3", spy("conv", conv3d.conv3d_k3))
    monkeypatch.setattr(upsample, "upsample2x",
                        spy("up", upsample.upsample2x))
    with torch.no_grad():
        out = model(x)
    keys = {(n, ci, co, s) for n, ci, co, s, _ in seen}
    assert ("conv", 32, 32, 1) in keys        # 32^3 stage 0 + decoder
    assert ("conv", 32, 64, 2) in keys        # stride-2 entry 32 -> 64
    assert ("conv", 64, 128, 2) in keys       # stride-2 entry 64 -> 128
    assert ("conv", 64, 64, 1) in keys
    assert ("conv", 256, 256, 1) in keys      # dense deep class at 4^3
    assert ("up", 128, 64, 1) in keys and ("up", 64, 32, 1) in keys
    assert ("conv", 128, 128, 1) not in keys  # 128-channel stage: plain
    assert ("conv", 128, 256, 2) not in keys  # deep stride-2: plain
    modes = {m for *_, m in seen}
    assert {"addin", "pre"} <= modes
    for k in out:
        np.testing.assert_array_equal(out[k].numpy(), unspied[k].numpy())
    seen.clear()
    with torch.no_grad():
        port[0](x)
    assert {(n, ci, co, s) for n, ci, co, s, _ in seen} == keys


def test_plain_path_equals_kernel_path_on_cpu(jax_run, port):
    """use_pallas_conv=False (all plain torch) computes the same function
    as the kernel dispatch, whose wrappers run their plain versions here."""
    plain = ResEncUNet(dataclasses.replace(port[0].plan,
                                           use_pallas_conv=False))
    plain.load_state_dict(port[0].state_dict())
    with torch.no_grad():
        out = plain(torch.from_numpy(jax_run["x"]))
    for k, v in out.items():
        np.testing.assert_allclose(v.numpy(), port[1][k].numpy(), 1e-6, 1e-6)


def test_seeded_init_is_torch_default_and_reproducible():
    a = ResEncUNet(_port_plan(), seed=3).state_dict()
    b = ResEncUNet(_port_plan(), seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    k = a["encoder.stage1.block1.conv1.conv.kernel"]      # (3,3,3,64,64)
    bound = 1.0 / np.sqrt(27 * 64)
    assert float(k.abs().max()) <= bound
    assert float(k.abs().max()) > 0.9 * bound
    up = a["decoder_sheet.up0.kernel"]                      # (2,2,2,256,128)
    assert float(up.abs().max()) <= 1.0 / np.sqrt(8 * 128)
