"""The torch port's CUDA kernels against their plain PyTorch versions, on
an NVIDIA GPU. Marked ``cuda``; each test skips where no card is present.
Run on the GPU machine (its Python has no JAX, which ``tests/conftest.py``
imports, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: outputs are bf16 on both sides, rounded from fp32 sums taken
in another order, so they may differ by one bf16 step (2^-8 of the value):
1e-2 of the plain output's max abs. The fp32 statistics (the convs' and the
norm-act kernels') and the pre-op backward's [sum du*x; sum du]: 1e-3
relative. The fp32 weight gradients
share the bf16 inputs and differ by summation order (atomics): 1e-2 of the
max abs, as the outputs. The 32^3 training backward in bf16 through the
kernels against the plain fp32 path: loss within 1e-2 relative and the
gradients of each top-level module at cosine >= 0.95 (bf16 rounding between
~40 instance norms; 0.984 measured for the encoder in the same comparison
on the CPU; the full-width step's limits and measurements are in
chip_smoke.py).
"""

import dataclasses

import pytest
import torch

from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
from mt3d_resenc_unet_torch.models.network import ResEncUNet
from mt3d_resenc_unet_torch.ops import _build
from mt3d_resenc_unet_torch.ops.conv3d import (conv3d_k3, conv3d_k3_dw,
                                               conv3d_k3_dw_plain,
                                               conv3d_k3_dx,
                                               conv3d_k3_dx_plain,
                                               conv3d_k3_plain)
from mt3d_resenc_unet_torch.ops.upsample import (upsample2x, upsample2x_dw,
                                                 upsample2x_dw_plain,
                                                 upsample2x_dx,
                                                 upsample2x_dx_plain,
                                                 upsample_plain)
from mt3d_resenc_unet_torch.train import losses, step

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("mode", ["plain", "stats", "pre_stats",
                                  "addin_stats"])
@pytest.mark.parametrize("stride,ci,co,extent", [
    (1, 32, 32, 12), (1, 64, 64, 10), (1, 256, 256, 4), (1, 512, 512, 3),
    (1, 512, 512, 4), (1, 32, 32, 9), (1, 64, 96, 5),
    (2, 32, 64, 12), (2, 64, 128, 10), (2, 64, 64, 7)])
def test_conv_kernel_matches_plain(dev, stride, ci, co, extent, mode):
    g = torch.Generator().manual_seed(0)
    n = 2
    x = torch.randn(n, extent, extent + 1, extent + 2, ci,
                    generator=g).to(dev).bfloat16()
    w = (torch.randn(3, 3, 3, ci, co, generator=g)
         * (27 * ci) ** -0.5).to(dev).bfloat16()
    kw = {"emit_stats": mode != "plain"}
    if mode == "pre_stats":
        kw["pre"] = torch.stack([torch.rand(n, ci, generator=g) + 0.5,
                                 torch.randn(n, ci, generator=g)], 1).to(dev)
    if mode == "addin_stats":
        shape = [n] + [(s - 1) // stride + 1 for s in x.shape[1:4]] + [co]
        kw["add_to"] = torch.randn(*shape, generator=g).to(dev).bfloat16()
    before = _build.LAUNCHES[f"conv3d_k3_s{stride}"]
    got = conv3d_k3(x, w, stride, **kw)
    want = conv3d_k3_plain(x, w, stride, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[f"conv3d_k3_s{stride}"] == before + 1
    if mode == "plain":
        assert _rel(got, want) <= 1e-2
        return
    assert _rel(got[0], want[0]) <= 1e-2
    torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("ci,co,extent", [(128, 64, 5), (64, 32, 6),
                                          (32, 32, 3)])
def test_upsample_kernel_matches_plain(dev, ci, co, extent):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, extent, extent + 1, extent, ci,
                    generator=g).to(dev).bfloat16()
    wf = torch.randn(2, 2, 2, ci, co, generator=g).to(dev).bfloat16()
    got, want = upsample2x(x, wf), upsample_plain(x, wf)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-2


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 4, 4, 4, 32, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 3, 32, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        conv3d_k3(x.float(), w)                        # not bf16
    with pytest.raises(ValueError):
        conv3d_k3(x[..., :16].contiguous(), w[:, :, :, :16])  # 16 channels
    with pytest.raises(ValueError):
        conv3d_k3(x.transpose(1, 2), w)                # not contiguous
    with pytest.raises(ValueError):
        upsample2x(x, torch.zeros(2, 2, 2, 32, 32, device=dev))  # fp32 w


def test_model_kernel_path_matches_plain_fp32(dev):
    plan = plan_from_autoconfig(
        (32, 32, 32), 1,
        [TaskHead("sheet", 1, "sigmoid"), TaskHead("normals", 3, "none")],
        max_features=256, use_pallas_conv=True)
    fast = ResEncUNet(plan, dtype=torch.bfloat16, seed=0).to(dev)
    plain = ResEncUNet(dataclasses.replace(plan, use_pallas_conv=False),
                       dtype=torch.float32, seed=0).to(dev)
    x = torch.randn(2, 32, 32, 32, 1,
                    generator=torch.Generator().manual_seed(2)).to(dev)
    _build.LAUNCHES.clear()
    with torch.inference_mode():
        got, want = fast(x), plain(x)
    assert all(_build.LAUNCHES[k] > 0
               for k in ("conv3d_k3_s1", "conv3d_k3_s2", "upsample2x"))
    assert float((got["sheet"] - want["sheet"]).abs().max()) <= 2e-2
    cos = torch.nn.functional.cosine_similarity(
        got["normals"], want["normals"], dim=-1).mean()
    assert float(cos) >= 0.999


# (1, 32, 32, 9) is 9 x 10 x 11: no extent a multiple of the stride-1
# kernels' bricks (4 x 8 x 8 and 2 x 8 x 8)
_BWD_SHAPES = [(1, 32, 32, 12), (1, 64, 64, 10), (1, 256, 256, 4),
               (1, 512, 512, 3), (1, 512, 512, 4), (1, 32, 32, 9),
               (2, 32, 64, 12), (2, 64, 128, 10), (2, 64, 64, 7)]


def _bwd_case(dev, stride, ci, co, extent, seed):
    g = torch.Generator().manual_seed(seed)
    n = 2
    x = torch.randn(n, extent, extent + 1, extent + 2, ci,
                    generator=g).to(dev).bfloat16()
    oshape = [n] + [(s - 1) // stride + 1 for s in x.shape[1:4]] + [co]
    w = (torch.randn(3, 3, 3, ci, co, generator=g)
         * (27 * ci) ** -0.5).to(dev).bfloat16()
    gy = torch.randn(*oshape, generator=g).to(dev).bfloat16()
    y = torch.randn(*oshape, generator=g).to(dev).bfloat16()
    gs = (torch.randn(n, 2, co, generator=g) * 0.1).to(dev)
    pre = torch.stack([torch.rand(n, ci, generator=g) + 0.5,
                       torch.randn(n, ci, generator=g)], 1).to(dev)
    return x, w, gy, y, gs, pre


def _rel_vec(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("mode", ["plain", "corr", "corr_post"])
@pytest.mark.parametrize("stride,ci,co,extent", _BWD_SHAPES)
def test_conv_dx_kernel_matches_plain(dev, stride, ci, co, extent, mode):
    x, w, gy, y, gs, pre = _bwd_case(dev, stride, ci, co, extent, 3)
    kw = {"size": x.shape[1:4]}
    if mode != "plain":
        kw.update(y=y, gs=gs)
    if mode == "corr_post":
        kw.update(x=x, pre=pre)
    name = f"conv3d_k3_dx_s{stride}"
    before = _build.LAUNCHES[name]
    got = conv3d_k3_dx(gy, w, stride, **kw)
    want = conv3d_k3_dx_plain(gy, w, stride, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    if mode != "corr_post":
        assert got.shape == x.shape and _rel(got, want) <= 1e-2
        return
    assert _rel(got[0], want[0]) <= 1e-2
    assert _rel_vec(got[1], want[1]) <= 1e-3


@pytest.mark.parametrize("mode", ["plain", "pre", "corr", "pre_corr"])
@pytest.mark.parametrize("stride,ci,co,extent", _BWD_SHAPES)
def test_conv_dw_kernel_matches_plain(dev, stride, ci, co, extent, mode):
    x, w, gy, y, gs, pre = _bwd_case(dev, stride, ci, co, extent, 4)
    kw = {}
    if "pre" in mode:
        kw["pre"] = pre
    if "corr" in mode:
        kw.update(y=y, gs=gs)
    name = f"conv3d_k3_dw_s{stride}"
    before = _build.LAUNCHES[name]
    got = conv3d_k3_dw(x, gy, stride, **kw)
    want = conv3d_k3_dw_plain(x, gy, stride, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    assert got.dtype == torch.float32 and got.shape == w.shape
    assert _rel(got, want) <= 1e-2


@pytest.mark.parametrize("ci,co,extent", [(128, 64, 5), (64, 32, 6),
                                          (32, 32, 3)])
def test_upsample_bwd_kernels_match_plain(dev, ci, co, extent):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, extent, extent + 1, extent, ci,
                    generator=g).to(dev).bfloat16()
    wf = torch.randn(2, 2, 2, ci, co, generator=g).to(dev).bfloat16()
    gy = torch.randn(2, 2 * extent, 2 * extent + 2, 2 * extent, co,
                     generator=g).to(dev).bfloat16()
    dx, dx0 = upsample2x_dx(gy, wf), upsample2x_dx_plain(gy, wf)
    dw, dw0 = upsample2x_dw(x, gy), upsample2x_dw_plain(x, gy)
    torch.cuda.synchronize()
    assert dx.shape == x.shape and _rel(dx, dx0) <= 1e-2
    assert dw.shape == wf.shape and _rel(dw, dw0) <= 1e-2


def test_wrappers_refuse_grad_requiring_cuda_tensors(dev):
    x = torch.zeros(1, 4, 4, 4, 32, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.zeros(3, 3, 3, 32, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="records no gradient"):
        conv3d_k3(x, w)
    with torch.no_grad():
        conv3d_k3(x, w)


def test_model_backward_through_kernels_matches_plain_fp32(dev):
    patch = (32, 32, 32)
    plan = plan_from_autoconfig(
        patch, 1,
        [TaskHead("sheet", 1, "sigmoid"), TaskHead("normals", 3, "none")],
        max_features=256, use_pallas_conv=True)
    fast = ResEncUNet(plan, dtype=torch.bfloat16, seed=0).to(dev)
    plain = ResEncUNet(dataclasses.replace(plan, use_pallas_conv=False),
                       dtype=torch.float32, seed=0).to(dev)
    g = torch.Generator().manual_seed(6)
    batch = {"image": torch.rand(2, *patch, 1, generator=g).to(dev),
             "sheet": (torch.rand(2, *patch, 1, generator=g) > 0.5).float()
             .to(dev),
             "normals": torch.randn(2, *patch, 3, generator=g).to(dev)}
    loss_fns = losses.build_task_losses({
        "sheet": {"loss_fn": "BCEDiceLoss"},
        "normals": {"loss_fn": "MaskedCosineLoss"}})
    totals = []
    _build.LAUNCHES.clear()
    for model in (fast, plain):
        model.train()
        out = model(batch["image"])
        total, _ = step.multitask_loss(
            out, {k: v for k, v in batch.items() if k != "image"}, loss_fns,
            {"sheet": 1.0, "normals": 1.0})
        total.backward()
        totals.append(float(total.detach()))
    assert all(v > 0 for v in _build.LAUNCHES.values())
    assert len(_build.LAUNCHES) == 9
    assert abs(totals[0] - totals[1]) <= 1e-2 * abs(totals[1])
    for (name, a), b in zip(fast.named_children(), plain.children()):
        ga = torch.cat([p.grad.flatten() for p in a.parameters()
                        if p.grad is not None])
        gb = torch.cat([p.grad.flatten() for p in b.parameters()
                        if p.grad is not None])
        cos = torch.nn.functional.cosine_similarity(ga, gb, dim=0)
        assert float(cos) >= 0.95, (name, float(cos))


@pytest.mark.parametrize("extent,c", [(12, 32), (6, 64), (3, 512)])
@pytest.mark.parametrize("act", [True, False])
def test_norm_act_kernels_match_plain(dev, extent, c, act):
    from mt3d_resenc_unet_torch.ops import norm_act as na
    g = torch.Generator().manual_seed(7)
    x2 = (torch.randn(2, extent ** 3, c, generator=g) * 2 + 0.5).to(
        dev).bfloat16()
    g2 = torch.randn(2, extent ** 3, c, generator=g).to(dev).bfloat16()
    before = {k: _build.LAUNCHES[k] for k in (
        "norm_act_stats", "norm_act_norm", "norm_act_bwd_stats",
        "norm_act_bwd_dx")}
    st = na.norm_act_stats(x2)
    y = na.norm_act_norm(x2, st, 1e-2, act)
    gs = na.norm_act_bwd_stats(x2, st, g2, 1e-2, act)
    dx = na.norm_act_bwd_dx(x2, st, gs, g2, 1e-2, act)
    torch.cuda.synchronize()
    assert all(_build.LAUNCHES[k] == v + 1 for k, v in before.items())
    torch.testing.assert_close(st, na.norm_act_stats_plain(x2, 1e-5),
                               rtol=1e-3, atol=1e-5)
    assert _rel(y, na.norm_act_norm_plain(x2, st, 1e-2, act)) <= 1e-2
    assert _rel_vec(gs, na.norm_act_bwd_stats_plain(x2, st, g2, 1e-2,
                                                    act)) <= 1e-3
    assert _rel(dx, na.norm_act_bwd_dx_plain(x2, st, gs, g2, 1e-2,
                                             act)) <= 1e-2


def test_device_prefetch_copies_batches_to_the_card(dev):
    import numpy as np
    from mt3d_resenc_unet_torch.data.pipeline import device_prefetch
    rng = np.random.default_rng(0)
    host = [{"image": rng.standard_normal((2, 16, 16, 16), np.float32),
             "sheet": rng.integers(0, 256, (2, 16, 16, 16), dtype=np.uint8)}
            for _ in range(6)]
    got = []
    for batch in device_prefetch(iter(host), dev, bf16_keys=("image",)):
        assert batch["image"].dtype == torch.bfloat16
        assert batch["sheet"].dtype == torch.uint8
        assert all(v.device.type == "cuda" for v in batch.values())
        # consume on the current stream, as a step does
        got.append({k: v.float().sum(0).cpu() for k, v in batch.items()})
    assert len(got) == len(host)
    for g, h in zip(got, host):
        want_image = torch.from_numpy(h["image"]).bfloat16().float().sum(0)
        assert torch.equal(g["image"], want_image)
        assert torch.equal(g["sheet"],
                           torch.from_numpy(h["sheet"]).float().sum(0))

    def failing():
        yield host[0]
        raise ValueError("producer failed")

    with pytest.raises(ValueError, match="producer failed"):
        for _ in device_prefetch(failing(), dev):
            pass
