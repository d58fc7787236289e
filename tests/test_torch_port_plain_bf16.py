"""The torch port's plain classes in bf16 against the JAX package's unfused
XLA path in bf16 (``use_pallas`` off), on the CPU.

The shapes outside the kernel classes run, for a bf16 model, with bf16
operands and fp32 accumulation (``ops/lowp.py``), as the JAX package's
``Conv._dispatch``, ``_pool_proj``, stem GEMM, ``UpsampleConv`` and
``SegLayer`` run them; a pre-op's normalized input is rounded to bf16
before the conv, as JAX's InstanceNorm hands the next conv a bf16 tensor.
Inputs are made from a numpy seed and given to both.

Tolerances, each against the JAX output's max abs:
* a single op (conv, pool+projection, seg, upsample, the stem's dW): 1e-2.
  Both round an fp32 sum of the same bf16 products to bf16, summed in
  another order (oneDNN vs XLA), so an output may sit one bf16 step
  (2^-8 relative) apart; with a pre-op the two normalizations (sums vs
  means) may also round an input to the neighbouring bf16 value. Measured:
  0 to 1e-3 without a pre-op, 4.6e-3 to 6.3e-3 with one.
* the 32^3 4-stage model: sheet probability within 3e-2 absolute, normals
  at mean cosine >= 0.999: those one-step differences pass through ~40
  instance norms and the bf16 tail of every block (measured 5.4e-3 and
  0.99994).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.core.plan import TaskHead as JTaskHead
from mt3d_resenc_unet_tpu.core.plan import plan_from_autoconfig as jax_plan
from mt3d_resenc_unet_tpu.models import blocks as jblocks
from mt3d_resenc_unet_tpu.models import network as jnet
from mt3d_resenc_unet_tpu.ops.gemm_conv import conv3d_stem_cf
from mt3d_resenc_unet_tpu.ops.instance_norm import instance_norm_act
from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
from mt3d_resenc_unet_torch.models import blocks
from mt3d_resenc_unet_torch.models.network import (ResEncUNet, SegLayer,
                                                   UpsampleConv)
from mt3d_resenc_unet_torch.ops import instance_norm as tnorm
from mt3d_resenc_unet_torch.ops import lowp
from mt3d_resenc_unet_torch.tools.from_jax import params_from_jax

OP_TOL = 1e-2
SHEET_TOL = 3e-2
NORMALS_MIN_COS = 0.999
BF16 = torch.bfloat16


def _bf16(a: np.ndarray):
    """The same bf16 values for both: (jax array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


def _port_conv(ci, co, stride, kernel):
    conv = blocks.Conv(ci, co, (3, 3, 3), (stride,) * 3)
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(kernel))
    return conv


# (ci, co, stride, extent): the stem, the 128-channel stage, a deep
# stride-2 conv
CONV_CASES = [(1, 32, 1, 12), (128, 128, 1, 6), (128, 256, 2, 8)]


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("ci,co,stride,extent", CONV_CASES)
def test_conv_plain_class_matches_jax_bf16(ci, co, stride, extent, pre):
    rng = np.random.default_rng(ci + co + stride)
    raw = (rng.standard_normal((2, extent, extent, extent, ci)) * 2
           + 0.5).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 3, ci, co))
              / np.sqrt(27 * ci)).astype(np.float32)
    xj, xt = _bf16(raw)
    if pre:
        # JAX: the producer's norm + LeakyReLU as a bf16 pass, then the conv
        xj = instance_norm_act(xj, act=True)
    want = jblocks.Conv(
        features=co, kernel_size=(3, 3, 3), strides=(stride,) * 3,
        padding=((1, 1),) * 3, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(kernel)}}, xj)
    conv = _port_conv(ci, co, stride, kernel)
    vec = None
    if pre:
        vec = tnorm.stats_to_scale_shift(tnorm.instance_stats(xt),
                                         extent ** 3, 1e-5)
    with torch.no_grad():
        y, stats = conv(xt, pre=vec)
    assert y.dtype == BF16 and tuple(y.shape) == want.shape
    assert _rel(y, want) <= OP_TOL
    # the statistics are fp32 sums of the rounded bf16 output
    torch.testing.assert_close(stats, tnorm.instance_stats(y))


def test_plain_class_conv_input_is_the_rounded_activation(monkeypatch):
    rng = np.random.default_rng(7)
    _, x = _bf16(rng.standard_normal((2, 6, 6, 6, 128)).astype(np.float32))
    conv = _port_conv(128, 128, 1, (rng.standard_normal((3, 3, 3, 128, 128))
                                    * 0.01).astype(np.float32))
    inv, shift = tnorm.stats_to_scale_shift(tnorm.instance_stats(x), 216,
                                            1e-5)
    seen = []
    real = lowp._conv

    def spy(xin, w, stride):
        seen.append(xin)
        return real(xin, w, stride)

    monkeypatch.setattr(lowp, "_conv", spy)
    with torch.no_grad():
        conv(x, pre=(inv, shift))
    u = x.float() * inv[:, None, None, None] - shift[:, None, None, None]
    want = torch.where(u >= 0, u, u * 1e-2).to(BF16)
    assert len(seen) == 1 and seen[0].dtype == BF16
    assert torch.equal(seen[0], want)


@pytest.mark.parametrize("ci,co", [(32, 64), (64, 128), (128, 256)])
def test_pool_projection_matches_jax_bf16(ci, co):
    rng = np.random.default_rng(ci)
    xj, xt = _bf16(rng.standard_normal((2, 8, 8, 8, ci)).astype(np.float32))
    k = (rng.standard_normal((1, 1, 1, ci, co)) / np.sqrt(ci)).astype(
        np.float32)
    want = jblocks._pool_proj(xj, jnp.asarray(k, jnp.bfloat16), (2, 2, 2),
                              jnp.bfloat16)
    conv = blocks.Conv(ci, co, (1, 1, 1), (1, 1, 1), pre_pool=(2, 2, 2))
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(k))
        y, stats = conv(xt)
    assert y.dtype == BF16 and tuple(y.shape) == want.shape
    assert _rel(y, want) <= OP_TOL
    torch.testing.assert_close(stats, tnorm.instance_stats(y))


def test_seg_layer_matches_jax_bf16():
    rng = np.random.default_rng(3)
    xj, xt = _bf16(rng.standard_normal((2, 6, 6, 6, 32)).astype(np.float32))
    k = (rng.standard_normal((1, 1, 1, 32, 3)) * 0.2).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    want = jnet.SegLayer(features=3, dim=3, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}}, xj)
    seg = SegLayer(32, 3)
    with torch.no_grad():
        seg.kernel.copy_(torch.from_numpy(k))
        seg.bias.copy_(torch.from_numpy(b))
        got = seg(xt)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= OP_TOL


def test_deep_upsample_matches_jax_bf16():
    rng = np.random.default_rng(4)
    ci, co = 256, 128
    xj, xt = _bf16(rng.standard_normal((2, 4, 4, 4, ci)).astype(np.float32))
    k = (rng.standard_normal((2, 2, 2, ci, co)) / np.sqrt(8 * co)).astype(
        np.float32)
    want = jnet.UpsampleConv(features=co, kernel_size=(2, 2, 2),
                             dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(k)}}, xj)
    up = UpsampleConv(ci, co, (2, 2, 2))
    with torch.no_grad():
        up.kernel.copy_(torch.from_numpy(k))
        got = up(xt)
    assert got.dtype == BF16 and tuple(got.shape) == want.shape
    assert _rel(got, want) <= OP_TOL


def test_stem_gemm_gradients_match_jax():
    rng = np.random.default_rng(5)
    xj, xt = _bf16(rng.standard_normal((2, 8, 8, 8, 1)).astype(np.float32))
    wj, wt = _bf16((rng.standard_normal((3, 3, 3, 1, 32)) * 0.2).astype(
        np.float32))
    gj, gt = _bf16(rng.standard_normal((2, 8, 8, 8, 32)).astype(np.float32))
    y_j, vjp = jax.vjp(lambda w: conv3d_stem_cf(xj, w), wj)
    (dw_j,) = vjp(gj)
    wt.requires_grad_()
    y_t = lowp.StemConvFn.apply(xt, wt)
    y_t.backward(gt)
    assert y_t.dtype == BF16 and wt.grad.dtype == BF16
    assert _rel(y_t.detach(), y_j) <= OP_TOL
    assert _rel(wt.grad, dw_j) <= OP_TOL
    # and against plain autograd of the same rounded operands
    wf = wt.detach().float().requires_grad_()
    torch.nn.functional.conv3d(xt.float().permute(0, 4, 1, 2, 3),
                               wf.permute(4, 3, 0, 1, 2), padding=1
                               ).permute(0, 2, 3, 4, 1).backward(gt.float())
    assert _rel(wt.grad, wf.grad.numpy()) <= OP_TOL


def test_model_forward_bf16_matches_jax_bf16():
    patch = (32, 32, 32)
    tasks = [("sheet", 1, "sigmoid"), ("normals", 3, "none")]
    jplan = jax_plan(patch, 1, [JTaskHead(*t) for t in tasks],
                     max_features=256)
    jmodel = jnet.ResEncUNet(plan=jplan, dtype=jnp.bfloat16)
    x = np.random.default_rng(0).standard_normal(
        (2,) + patch + (1,)).astype(np.float32)
    params = jax.jit(lambda k: jmodel.init(
        {"params": k}, jnp.zeros((1,) + patch + (1,)), train=False))(
        jax.random.key(0))["params"]
    want = jax.jit(lambda p, v: jmodel.apply({"params": p}, v, train=False))(
        params, x)
    plan = plan_from_autoconfig(patch, 1, [TaskHead(*t) for t in tasks],
                                max_features=256, use_pallas_conv=False)
    model = ResEncUNet(plan, dtype=BF16)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    sheet = float(np.abs(got["sheet"].numpy()
                         - np.asarray(want["sheet"], np.float32)).max())
    a = got["normals"]
    b = torch.from_numpy(np.asarray(want["normals"], np.float32))
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=-1).mean())
    assert all(v.dtype == torch.float32 for v in got.values())
    assert sheet <= SHEET_TOL, sheet
    assert cos >= NORMALS_MIN_COS, cos
