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
share the bf16 inputs and differ by summation order: 1e-2 of the max abs,
as the outputs. Every conv and upsample kernel sums in a fixed order (no
atomics): two runs on the same inputs must agree bit for bit. The 32^3 training backward in bf16 through the
kernels against the plain fp32 path: loss within 1e-2 relative and the
gradients of each top-level module at cosine >= 0.95 (bf16 rounding between
~40 instance norms; 0.984 measured for the encoder in the same comparison
on the CPU; the full-width step's limits and measurements are in
chip_smoke.py).
"""

import dataclasses

import pytest
import torch

from mt3d_resenc_unet_torch.core.config import set_precision
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
    set_precision()
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


# the flagship's upsample channels at extents that are no multiple of the
# kernels' tiles (16 along w, 4 / 8 / 16 along h), then the small cases
_UP_BWD = [(128, 64, 9), (64, 32, 17), (128, 64, 5), (64, 32, 6),
           (32, 32, 3), (64, 64, 4)]


def _up_inputs(dev, seed, ci, co, extent):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, extent, extent + 1, extent, ci,
                    generator=g).to(dev).bfloat16()
    wf = torch.randn(2, 2, 2, ci, co, generator=g).to(dev).bfloat16()
    return x, wf


# the forward also at channels whose weights stream through the ring in
# chunks (Ci 96, and 640 past what shared memory could hold resident)
_UP_FWD = _UP_BWD + [(96, 96, 5), (640, 32, 3)]


@pytest.mark.parametrize("ci,co,extent", _UP_FWD)
def test_upsample_kernel_matches_plain(dev, ci, co, extent):
    x, wf = _up_inputs(dev, 1, ci, co, extent)
    before = _build.LAUNCHES["upsample2x"]
    got, want = upsample2x(x, wf), upsample_plain(x, wf)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["upsample2x"] == before + 1
    assert got.shape == want.shape and _rel(got, want) <= 1e-2


@pytest.mark.parametrize("ci,co,extent", _UP_FWD)
def test_upsample_fwd_kernel_is_deterministic(dev, ci, co, extent):
    x, wf = _up_inputs(dev, 17, ci, co, extent)
    a, b = (upsample2x(x, wf) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_upsample_fwd_refuses_misaligned_inputs(dev):
    x, wf = _up_inputs(dev, 3, 64, 32, 4)

    def shifted(t):   # the same values 2 bytes past a 16-byte boundary
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=dev)
        out = buf[1:1 + t.numel()].view(t.shape)
        out.copy_(t)
        return out

    for args in ((shifted(x), wf), (x, shifted(wf))):
        assert args[0].is_contiguous() and args[1].is_contiguous()
        with pytest.raises(ValueError, match="16-byte aligned"):
            upsample2x(*args)


def test_upsample_fwd_launcher_refuses_a_plan_not_its_own(dev):
    """The C launcher checks the plan it is given: a co tile that does not
    divide Co, and shared memory or a tile count other than its own, are
    refused before anything launches."""
    from mt3d_resenc_unet_torch.ops import upsample as up
    x, wf = _up_inputs(dev, 5, 128, 96, 4)
    n, d, h, w, ci = x.shape
    y = torch.empty(n, 2 * d, 2 * h, 2 * w, 96, dtype=torch.bfloat16,
                    device=dev)
    good = up._up_fwd_plan(n, (d, h, w), ci, 96, 132)
    bad = [dict(good, tm=128, tco=64, smem=229376,
                tiles=up._up_fwd_plan(n, (d, h, w), 128, 64, 132)["tiles"]),
           dict(good, smem=good["smem"] + 16),
           dict(good, tiles=good["tiles"] + 1)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for plan in [good] + bad:
        rc = up._fn()(x.data_ptr(), wf.data_ptr(), y.data_ptr(), n, d, h, w,
                      ci, 96, plan["tm"], plan["tco"], plan["smem"],
                      plan["tiles"], plan["grid"][0], stream)
        assert (rc == 0) == (plan is good), plan
    torch.cuda.synchronize()


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


def _dx_kwargs(mode, x, y, gs, pre):
    kw = {"size": x.shape[1:4]}
    if "corr" in mode:
        kw.update(y=y, gs=gs)
    if "post" in mode:
        kw.update(x=x, pre=pre)
    return kw


_DX_MODES = ["plain", "corr", "corr_post", "post"]


@pytest.mark.parametrize("mode", _DX_MODES)
@pytest.mark.parametrize("stride,ci,co,extent", _BWD_SHAPES)
def test_conv_dx_kernel_matches_plain(dev, stride, ci, co, extent, mode):
    x, w, gy, y, gs, pre = _bwd_case(dev, stride, ci, co, extent, 3)
    kw = _dx_kwargs(mode, x, y, gs, pre)
    name = f"conv3d_k3_dx_s{stride}"
    before = _build.LAUNCHES[name]
    got = conv3d_k3_dx(gy, w, stride, **kw)
    want = conv3d_k3_dx_plain(gy, w, stride, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    if "post" not in mode:
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


_S2_SHAPES = [s for s in _BWD_SHAPES if s[0] == 2]


@pytest.mark.parametrize("mode", ["plain", "stats", "pre_stats",
                                  "addin_stats"])
@pytest.mark.parametrize("stride,ci,co,extent", _S2_SHAPES)
def test_s2_conv_kernel_is_deterministic(dev, stride, ci, co, extent, mode):
    x, w, gy, y, gs, pre = _bwd_case(dev, stride, ci, co, extent, 8)
    kw = {"emit_stats": mode != "plain"}
    if mode == "pre_stats":
        kw["pre"] = pre
    if mode == "addin_stats":
        kw["add_to"] = y
    runs = [conv3d_k3(x, w, stride, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    if mode == "plain":
        runs = [(r,) for r in runs]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("mode", ["plain", "pre", "corr", "pre_corr"])
@pytest.mark.parametrize("stride,ci,co,extent", _S2_SHAPES)
def test_s2_dw_kernel_is_deterministic(dev, stride, ci, co, extent, mode):
    x, w, gy, y, gs, pre = _bwd_case(dev, stride, ci, co, extent, 9)
    kw = {}
    if "pre" in mode:
        kw["pre"] = pre
    if "corr" in mode:
        kw.update(y=y, gs=gs)
    a, b = (conv3d_k3_dw(x, gy, stride, **kw) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# the flagship's stride-1 shapes as cubes: 16^3 x 256, 8^3 and 4^3 x 512
# split K across blocks (_s1_plan), 9 x 10 x 11 is no multiple of a brick
_DET_S1 = [(32, 32, (9, 10, 11)), (64, 64, (10, 10, 10)),
           (256, 256, (16,) * 3), (512, 512, (8,) * 3), (512, 512, (4,) * 3)]


def _cube_case(dev, ci, co, size, seed):
    g = torch.Generator().manual_seed(seed)
    n = 2
    x = torch.randn(n, *size, ci, generator=g).to(dev).bfloat16()
    w = (torch.randn(3, 3, 3, ci, co, generator=g)
         * (27 * ci) ** -0.5).to(dev).bfloat16()
    gy, y = (torch.randn(n, *size, co, generator=g).to(dev).bfloat16()
             for _ in range(2))
    gs = (torch.randn(n, 2, co, generator=g) * 0.1).to(dev)
    pre = torch.stack([torch.rand(n, ci, generator=g) + 0.5,
                       torch.randn(n, ci, generator=g)], 1).to(dev)
    return x, w, gy, y, gs, pre


@pytest.mark.parametrize("mode", ["plain", "stats", "pre_stats",
                                  "addin_stats"])
@pytest.mark.parametrize("ci,co,size", _DET_S1)
def test_s1_conv_kernel_is_deterministic(dev, ci, co, size, mode):
    from mt3d_resenc_unet_torch.ops.conv3d import _s1_plan
    x, w, gy, y, gs, pre = _cube_case(dev, ci, co, size, 10)
    if size[0] in (16, 8, 4):
        assert _s1_plan(2, size, ci, co, 132)["splits"] > 1
    kw = {"emit_stats": mode != "plain"}
    if mode == "pre_stats":
        kw["pre"] = pre
    if mode == "addin_stats":
        kw["add_to"] = y
    runs = [conv3d_k3(x, w, 1, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    if mode == "plain":
        runs = [(r,) for r in runs]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("mode", _DX_MODES)
@pytest.mark.parametrize("stride,ci,co,extent", _BWD_SHAPES)
def test_conv_dx_kernel_is_deterministic(dev, stride, ci, co, extent, mode):
    x, w, gy, y, gs, pre = _bwd_case(dev, stride, ci, co, extent, 11)
    kw = _dx_kwargs(mode, x, y, gs, pre)
    runs = [conv3d_k3_dx(gy, w, stride, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    if "post" not in mode:
        runs = [(r,) for r in runs]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("mode", _DX_MODES)
@pytest.mark.parametrize("ci,co,size", _DET_S1)
def test_s1_dx_kernel_split_shapes(dev, ci, co, size, mode):
    # the flagship's cubes at 16^3 x 256, 8^3 and 4^3 x 512 split K across
    # blocks (_dx_s1_plan): the finish adds the slices in split order and
    # applies the pre-op's backward to the sum
    from mt3d_resenc_unet_torch.ops.conv3d import _dx_s1_plan
    x, w, gy, y, gs, pre = _cube_case(dev, ci, co, size, 13)
    if size[0] in (16, 8, 4):
        assert _dx_s1_plan(2, size, ci, co, 132)["splits"] > 1
    kw = _dx_kwargs(mode, x, y, gs, pre)
    runs = [conv3d_k3_dx(gy, w, 1, **kw) for _ in range(2)]
    want = conv3d_k3_dx_plain(gy, w, 1, **kw)
    torch.cuda.synchronize()
    if "post" not in mode:
        runs, want = [(r,) for r in runs], (want,)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert _rel(runs[0][0], want[0]) <= 1e-2
    if "post" in mode:
        assert _rel_vec(runs[0][1], want[1]) <= 1e-3


@pytest.mark.parametrize("mode", ["plain", "pre", "corr", "pre_corr"])
@pytest.mark.parametrize("ci,co,size", _DET_S1)
def test_s1_dw_kernel_is_deterministic(dev, ci, co, size, mode):
    x, w, gy, y, gs, pre = _cube_case(dev, ci, co, size, 12)
    kw = {}
    if "pre" in mode:
        kw["pre"] = pre
    if "corr" in mode:
        kw.update(y=y, gs=gs)
    a, b = (conv3d_k3_dw(x, gy, 1, **kw) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("ci,co,extent", _UP_BWD)
def test_upsample_bwd_kernels_are_deterministic(dev, ci, co, extent):
    g = torch.Generator().manual_seed(13)
    x = torch.randn(2, extent, extent + 1, extent, ci,
                    generator=g).to(dev).bfloat16()
    wf = torch.randn(2, 2, 2, ci, co, generator=g).to(dev).bfloat16()
    gy = torch.randn(2, 2 * extent, 2 * extent + 2, 2 * extent, co,
                     generator=g).to(dev).bfloat16()
    dx = [upsample2x_dx(gy, wf) for _ in range(2)]
    dw = [upsample2x_dw(x, gy) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*dx) and torch.equal(*dw)


@pytest.mark.parametrize("ci,co,extent", _UP_BWD)
def test_upsample_bwd_kernels_match_plain(dev, ci, co, extent):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, extent, extent + 1, extent, ci,
                    generator=g).to(dev).bfloat16()
    wf = torch.randn(2, 2, 2, ci, co, generator=g).to(dev).bfloat16()
    gy = torch.randn(2, 2 * extent, 2 * extent + 2, 2 * extent, co,
                     generator=g).to(dev).bfloat16()
    before = {k: _build.LAUNCHES[k] for k in ("upsample2x_dx",
                                               "upsample2x_dw")}
    dx, dx0 = upsample2x_dx(gy, wf), upsample2x_dx_plain(gy, wf)
    dw, dw0 = upsample2x_dw(x, gy), upsample2x_dw_plain(x, gy)
    torch.cuda.synchronize()
    assert all(_build.LAUNCHES[k] == v + 1 for k, v in before.items())
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


@pytest.mark.parametrize("extent,c", [(12, 32), (6, 64), (3, 512)])
@pytest.mark.parametrize("res,pre", [(False, False), (True, False),
                                     (True, True)])
@pytest.mark.parametrize("act", [True, False])
def test_norm_tail_and_raw_stats_match_plain(dev, extent, c, res, pre, act):
    """The norm-act kernels' step modes against their plain versions: the
    tail forward bit-equal (the same fp32 operations, one rounding), the
    cotangents within one bf16 step, the fp32 sums 1e-3; twice bit-equal."""
    from mt3d_resenc_unet_torch.ops import norm_act as na
    g = torch.Generator().manual_seed(9)
    x2, r2, g2 = (torch.randn(2, extent ** 3, c, generator=g).to(
        dev).bfloat16() for _ in range(3))
    inv, a = ((torch.rand(2, c, generator=g) + 0.5).to(dev)
              for _ in range(2))
    shift, b = (torch.randn(2, c, generator=g).to(dev) for _ in range(2))
    rr = r2 if res else None
    aa, bb = (a, b) if pre else (None, None)
    names = ("norm_act_tail", "norm_act_tail_bwd", "norm_act_raw_stats")
    before = {k: _build.LAUNCHES[k] for k in names}
    y = na.norm_tail(x2, inv, shift, rr, aa, bb, 1e-2, act)
    dy, dr, sums = na.norm_tail_bwd(x2, rr, inv, shift, aa, bb, g2, 1e-2,
                                    act)
    st = na.raw_stats(x2)
    torch.cuda.synchronize()
    assert all(_build.LAUNCHES[k] == v + 1 for k, v in before.items())
    assert torch.equal(y, na.norm_tail_plain(x2, inv, shift, 1e-2, act, rr,
                                             aa, bb))
    dy0, dr0, sums0 = na.norm_tail_bwd_plain(x2, rr, inv, shift, aa, bb, g2,
                                             1e-2, act)
    assert _rel(dy, dy0) <= 1e-2
    if res:
        assert _rel(dr, dr0) <= 1e-2
    for k in range(sums.shape[1]):
        assert _rel(sums[:, k], sums0[:, k]) <= 1e-3, k
    torch.testing.assert_close(st, na.raw_stats_plain(x2), rtol=1e-3,
                               atol=1e-3)
    again = na.norm_tail_bwd(x2, rr, inv, shift, aa, bb, g2, 1e-2, act)
    assert all(torch.equal(u, v) for u, v in zip((dy, sums), again[::2]))
    assert torch.equal(st, na.raw_stats(x2))


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
