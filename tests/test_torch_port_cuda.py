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
chip_smoke.py). The fp32 kernels (FP64 MMA, csrc/conv3d_k3_f32_fwd.cu,
csrc/conv3d_k3_f32_dx.cu, csrc/conv3d_k3_f32_dw.cu and csrc/upsample2x_f32.cu)
against their plain
versions evaluated in fp64 on the same inputs: relative L2 1e-5 for
outputs, dx, dW and the pre-op backward's sums, 1e-5 relative for the
statistics, bit-equal over two runs (the forward, dx and dW also at extents
that are no multiple of their bricks and at the shapes where they split K);
an fp32 kernel model's training step launches all nine fp32 kernels and
its loss is within 1e-5 of the fp32 reference model's. The fp16 kernels
(the bf16 sources instantiated on __half, csrc/b16.cuh) against their plain
versions on the same fp16 inputs: outputs rounded from fp32 sums taken in
another order may differ by one fp16 step (2^-11 of the value): 2e-3 of the
plain output's max abs, the fp32 statistics and weight gradients as bf16's;
from cotangents at the flagship's ~2e-7 (fp16 subnormals) dx is subnormal
too, one step 2^-24 absolute, so it is held to the larger of the two;
bit-equal over two runs.
The norm-act kernels at fp16 as at bf16.
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
                      plan["tiles"], plan["grid"][0],
                      _build.DTYPE_CODES[torch.bfloat16], stream)
        assert (rc == 0) == (plan is good), plan
    torch.cuda.synchronize()


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 4, 4, 4, 32, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 3, 32, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        conv3d_k3(x.float(), w)                        # x, w in two dtypes
    with pytest.raises(ValueError):
        conv3d_k3(x.double(), w.double())              # fp64: no kernel
    with pytest.raises(ValueError):
        conv3d_k3(x.half(), w)                         # fp16 x, bf16 w
    with pytest.raises(ValueError):
        upsample2x(x.double(), torch.zeros(2, 2, 2, 32, 32, device=dev,
                                           dtype=torch.float64))
    with pytest.raises(ValueError):
        upsample2x(x.half(), torch.zeros(2, 2, 2, 32, 32, device=dev,
                                         dtype=torch.bfloat16))
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
    # the nine conv and upsample kernels (the norm-act step modes launch
    # beside them)
    assert len([k for k in _build.LAUNCHES
                if not k.startswith("norm_act")]) == 9
    assert abs(totals[0] - totals[1]) <= 1e-2 * abs(totals[1])
    for (name, a), b in zip(fast.named_children(), plain.children()):
        ga = torch.cat([p.grad.flatten() for p in a.parameters()
                        if p.grad is not None])
        gb = torch.cat([p.grad.flatten() for p in b.parameters()
                        if p.grad is not None])
        cos = torch.nn.functional.cosine_similarity(ga, gb, dim=0)
        assert float(cos) >= 0.95, (name, float(cos))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("extent,c", [(12, 32), (6, 64), (3, 512)])
@pytest.mark.parametrize("act", [True, False])
def test_norm_act_kernels_match_plain(dev, extent, c, act, dtype):
    from mt3d_resenc_unet_torch.ops import norm_act as na
    g = torch.Generator().manual_seed(7)
    x2 = (torch.randn(2, extent ** 3, c, generator=g) * 2 + 0.5).to(
        dev, dtype)
    g2 = torch.randn(2, extent ** 3, c, generator=g).to(dev, dtype)
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("extent,c", [(12, 32), (6, 64), (3, 512)])
@pytest.mark.parametrize("res,pre", [(False, False), (True, False),
                                     (True, True)])
@pytest.mark.parametrize("act", [True, False])
def test_norm_tail_and_raw_stats_match_plain(dev, extent, c, res, pre, act,
                                             dtype):
    """The norm-act kernels' step modes against their plain versions: the
    tail forward bit-equal (the same fp32 operations, one rounding), the
    cotangents within one bf16 step, the fp32 sums 1e-3; twice bit-equal."""
    from mt3d_resenc_unet_torch.ops import norm_act as na
    g = torch.Generator().manual_seed(9)
    x2, r2, g2 = (torch.randn(2, extent ** 3, c, generator=g).to(dev, dtype)
                  for _ in range(3))
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


# ------------------------------------------------------ the fp32 kernels

_F32_SHAPES = [(1, 32, 32, 9), (1, 64, 64, 6), (1, 256, 256, 4),
               (1, 512, 512, 3), (2, 32, 64, 10), (2, 64, 128, 6),
               (2, 64, 32, 7)]


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def _stats_rel(got, want):
    scale = torch.maximum(want[:, 0].abs(), want[:, 1].sqrt())
    return max(float(((got[:, 0] - want[:, 0]).abs() / scale).max()),
               float(((got[:, 1] - want[:, 1]).abs() / want[:, 1]).max()))


def _f64(kw):
    return {k: v.double() if isinstance(v, torch.Tensor) else v
            for k, v in kw.items()}


def _f32_case(dev, stride, ci, co, extent, seed=0):
    g = torch.Generator().manual_seed(seed)
    n = 2
    size = (extent, extent + 1, extent + 2)
    out = [(s - 1) // stride + 1 for s in size]
    x = torch.randn(n, *size, ci, generator=g).to(dev)
    w = (torch.randn(3, 3, 3, ci, co, generator=g) * (27 * ci) ** -0.5).to(dev)
    pre = torch.stack([torch.rand(n, ci, generator=g) + 0.5,
                       torch.randn(n, ci, generator=g)], 1).to(dev)
    gy, y = (torch.randn(n, *out, co, generator=g).to(dev) for _ in range(2))
    gs = (torch.randn(n, 2, co, generator=g) * 0.1).to(dev)
    return x, w, pre, gy, y, gs


@pytest.mark.parametrize("mode", ["plain", "stats", "pre_stats",
                                  "addin_stats"])
@pytest.mark.parametrize("stride,ci,co,extent", _F32_SHAPES)
def test_f32_conv_kernel_matches_plain_fp64(dev, stride, ci, co, extent,
                                            mode):
    x, w, pre, _, y, _ = _f32_case(dev, stride, ci, co, extent)
    kw = {"emit_stats": mode != "plain"}
    if mode == "pre_stats":
        kw["pre"] = pre
    if mode == "addin_stats":
        kw["add_to"] = y
    name = f"conv3d_k3_s{stride}_f32"
    before = _build.LAUNCHES[name]
    got = conv3d_k3(x, w, stride, **kw)
    want = conv3d_k3_plain(x.double(), w.double(), stride, **_f64(kw))
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    if mode == "plain":
        got, want = (got, None), (want, None)
    assert got[0].dtype == torch.float32
    assert _rel_l2(got[0], want[0]) <= 1e-5
    if got[1] is not None:
        assert _stats_rel(got[1], want[1]) <= 1e-5
    again = conv3d_k3(x, w, stride, **kw)
    again = again if isinstance(again, tuple) else (again,)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# the fp32 forward's bricks and splits (csrc/conv3d_k3_f32_fwd.cu,
# conv3d._f32_fwd_plan): extents that are no multiple of the brick at both
# strides, the small tile, and the flagship's split shapes (8^3 and 4^3 x
# 512), each (stride, ci, co, size, split or not on this card)
_F32_FWD_CASES = [(1, 32, 32, (13, 25, 33), False),
                  (1, 256, 256, (16, 16, 16), False),
                  (2, 32, 64, (33, 49, 17), False),
                  (1, 32, 32, (5, 9, 13), True), (1, 64, 64, (7, 3, 10), True),
                  (2, 32, 64, (9, 17, 5), True), (2, 64, 32, (3, 7, 12), True),
                  (1, 64, 64, (4, 3, 2), True), (1, 512, 512, (8, 8, 8), True),
                  (1, 512, 512, (4, 4, 4), True),
                  (1, 256, 256, (5, 6, 7), True)]


@pytest.mark.parametrize("mode", ["plain", "stats", "pre_stats",
                                  "addin_stats"])
@pytest.mark.parametrize("stride,ci,co,size,split", _F32_FWD_CASES)
def test_f32_fwd_bricks_and_splits_match_plain_fp64(dev, stride, ci, co,
                                                    size, split, mode):
    from mt3d_resenc_unet_torch.ops import conv3d as c3
    g = torch.Generator().manual_seed(1)
    n = 2
    out = [(s - 1) // stride + 1 for s in size]
    x = torch.randn(n, *size, ci, generator=g).to(dev)
    w = (torch.randn(3, 3, 3, ci, co, generator=g) * (27 * ci) ** -0.5).to(dev)
    kw = {"emit_stats": mode != "plain"}
    if mode == "pre_stats":
        kw["pre"] = torch.stack([torch.rand(n, ci, generator=g) + 0.5,
                                 torch.randn(n, ci, generator=g)], 1).to(dev)
    if mode == "addin_stats":
        kw["add_to"] = torch.randn(n, *out, co, generator=g).to(dev)
    plan = c3._f32_fwd_plan(n, size, ci, co, stride, c3._sm_count(x.device))
    assert (plan["splits"] > 1) == split
    name = f"conv3d_k3_s{stride}_f32"
    before = _build.LAUNCHES[name]
    got = conv3d_k3(x, w, stride, **kw)
    want = conv3d_k3_plain(x.double(), w.double(), stride, **_f64(kw))
    again = conv3d_k3(x, w, stride, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 2
    if mode == "plain":
        got, want, again = (got, None), (want, None), (again, None)
    assert got[0].shape == (n, *out, co)
    assert _rel_l2(got[0], want[0]) <= 1e-5
    if got[1] is not None:
        assert _stats_rel(got[1], want[1]) <= 1e-5
    assert all(torch.equal(a, b) for a, b in zip(got, again)
               if a is not None)


def test_f32_fwd_launcher_refuses_a_plan_not_its_own(dev):
    """The C launcher checks the plan it is handed: a split that does not
    divide the chunks, more blocks than units, a small tile at stride 2, a
    split without its scratch."""
    from mt3d_resenc_unet_torch.ops import conv3d as c3
    n, d, ci, co = 1, 4, 32, 64
    x = torch.randn(n, d, d, d, ci, device=dev)
    w = torch.randn(3, 3, 3, ci, co, device=dev)
    y = torch.empty(n, d, d, d, co, device=dev)
    part = torch.empty(8 * n * d ** 3 * co, dtype=torch.float64, device=dev)
    fn = c3._f32_fn("fwd")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(stride, tile, splits, grid, scratch):
        return fn(x.data_ptr(), w.data_ptr(), None, None, y.data_ptr(), None,
                  None, scratch, n, d, d, d, ci, co, stride, tile, splits,
                  grid, 0.01, stream)

    assert call(1, 1, 2, 2, part.data_ptr()) == 0
    torch.cuda.synchronize()
    assert call(1, 1, 3, 1, part.data_ptr()) != 0      # 3 does not divide 4
    assert call(1, 1, 2, 3, part.data_ptr()) != 0      # 3 blocks, 2 units
    assert call(2, 1, 1, 1, None) != 0                 # small tile, stride 2
    assert call(1, 0, 2, 1, None) != 0                 # split, no scratch


# the fp32 dx's bricks and splits (csrc/conv3d_k3_f32_dx.cu,
# conv3d._f32_dx_plan): extents that are no multiple of the brick at both
# strides, the small tile, and the flagship's split shapes (8^3 and 4^3 x
# 512), each (stride, ci, co, dx size, split or not on this card)
_F32_DX_CASES = [(1, 32, 32, (13, 25, 33), False),
                 (1, 256, 256, (16, 16, 16), False),
                 (2, 32, 64, (33, 49, 17), False),
                 (1, 32, 32, (5, 9, 13), True), (1, 64, 64, (7, 3, 10), True),
                 (2, 32, 64, (9, 17, 5), True), (2, 64, 32, (3, 7, 12), True),
                 (2, 64, 128, (12, 12, 18), True),
                 (1, 64, 64, (4, 3, 2), True), (1, 512, 512, (8, 8, 8), True),
                 (1, 512, 512, (4, 4, 4), True),
                 (1, 256, 256, (5, 6, 7), True)]


@pytest.mark.parametrize("mode", ["plain", "corr", "corr_post"])
@pytest.mark.parametrize("stride,ci,co,size,split", _F32_DX_CASES)
def test_f32_dx_bricks_and_splits_match_plain_fp64(dev, stride, ci, co,
                                                   size, split, mode):
    from mt3d_resenc_unet_torch.ops import conv3d as c3
    g = torch.Generator().manual_seed(2)
    n = 2
    out = [(s - 1) // stride + 1 for s in size]
    x = torch.randn(n, *size, ci, generator=g).to(dev)
    w = (torch.randn(3, 3, 3, ci, co, generator=g) * (27 * ci) ** -0.5).to(dev)
    gy, y = (torch.randn(n, *out, co, generator=g).to(dev) for _ in range(2))
    gs = (torch.randn(n, 2, co, generator=g) * 0.1).to(dev)
    pre = torch.stack([torch.rand(n, ci, generator=g) + 0.5,
                       torch.randn(n, ci, generator=g)], 1).to(dev)
    kw = _dx_kwargs(mode, x, y, gs, pre)
    plan = c3._f32_dx_plan(n, size, ci, co, stride, c3._sm_count(x.device),
                           corr="corr" in mode)
    assert (plan["splits"] > 1) == split
    name = f"conv3d_k3_dx_s{stride}_f32"
    before = _build.LAUNCHES[name]
    got = conv3d_k3_dx(gy, w, stride, **kw)
    want = conv3d_k3_dx_plain(gy.double(), w.double(), stride, **_f64(kw))
    again = conv3d_k3_dx(gy, w, stride, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 2
    got, want, again = ((t if isinstance(t, tuple) else (t,))
                        for t in (got, want, again))
    assert got[0].shape == (n, *size, ci)
    for a, b, c in zip(got, want, again):
        assert a.dtype == torch.float32
        assert _rel_l2(a, b) <= 1e-5
        assert torch.equal(a, c)


def test_f32_dx_launcher_refuses_a_plan_not_its_own(dev):
    """The C launcher checks the plan it is handed: a split that does not
    divide the chunks, more blocks than units, a stride-1 tile at stride 2
    or stride 2's at stride 1, a split without its scratch, shared memory
    other than the tile's in the launch's mode."""
    from mt3d_resenc_unet_torch.ops import conv3d as c3
    n, d, ci, co = 1, 4, 64, 32
    gy = torch.randn(n, d, d, d, co, device=dev)
    w = torch.randn(3, 3, 3, ci, co, device=dev)
    y = torch.randn(n, d, d, d, co, device=dev)
    gs = torch.randn(n, 2, co, device=dev)
    dx = torch.empty(n, d, d, d, ci, device=dev)
    part = torch.empty(4 * n * d ** 3 * ci, dtype=torch.float64, device=dev)
    fn = c3._f32_fn("dx")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(stride, tile, splits, grid, scratch, smem, corr=False):
        return fn(gy.data_ptr(), w.data_ptr(), y.data_ptr() if corr else None,
                  gs.data_ptr() if corr else None, None, None, dx.data_ptr(),
                  None, None, scratch, n, d, d, d, ci, co, stride, tile,
                  splits, grid, smem, 0.01, stream)

    small = c3.f32_dx_smem(1, False)
    assert call(1, 1, 2, 2, part.data_ptr(), small) == 0
    assert call(1, 1, 2, 2, part.data_ptr(), c3.f32_dx_smem(1, True),
                corr=True) == 0
    torch.cuda.synchronize()
    assert call(1, 1, 3, 1, part.data_ptr(), small) != 0   # 3 does not divide 4
    assert call(1, 1, 2, 3, part.data_ptr(), small) != 0   # 3 blocks, 2 units
    assert call(2, 1, 1, 1, None, small) != 0              # stride 2's tile is 2
    assert call(1, 2, 1, 1, None, c3.f32_dx_smem(2, False)) != 0
    assert call(1, 1, 2, 1, None, small) != 0              # split, no scratch
    assert call(1, 1, 2, 2, part.data_ptr(), small, corr=True) != 0
    assert call(1, 0, 1, 1, None, small) != 0              # big tile's smem


# the fp32 dW's bricks and splits (csrc/conv3d_k3_f32_dw.cu,
# conv3d._f32_dw_plan): extents that are no multiple of the brick at both
# strides, every tile (0: stride 1, 1: stride 1 where every output extent
# is at most 4, 2: stride 2 with co % 64 == 0, 3: stride 2 otherwise), and
# the flagship's 8^3 and 4^3 x 512 shapes (unsplit, persistent blocks over
# 512 units), each (stride, ci, co, x size, split or not on this card)
_F32_DW_CASES = [(1, 32, 32, (13, 25, 33), True),
                 (1, 32, 64, (5, 9, 13), True),
                 (1, 256, 256, (5, 6, 7), False),
                 (1, 64, 64, (4, 3, 2), True),
                 (1, 512, 512, (8, 8, 8), False),
                 (1, 512, 512, (4, 4, 4), False),
                 (2, 32, 64, (33, 49, 17), True),
                 (2, 64, 128, (12, 12, 18), True),
                 (2, 64, 32, (3, 7, 12), True),
                 (2, 64, 32, (30, 31, 29), True)]


@pytest.mark.parametrize("mode", ["plain", "pre", "corr", "pre_corr"])
@pytest.mark.parametrize("stride,ci,co,size,split", _F32_DW_CASES)
def test_f32_dw_bricks_and_splits_match_plain_fp64(dev, stride, ci, co,
                                                   size, split, mode):
    from mt3d_resenc_unet_torch.ops import conv3d as c3
    g = torch.Generator().manual_seed(3)
    n = 2
    out = [(s - 1) // stride + 1 for s in size]
    x = torch.randn(n, *size, ci, generator=g).to(dev)
    gy, y = (torch.randn(n, *out, co, generator=g).to(dev) for _ in range(2))
    gs = (torch.randn(n, 2, co, generator=g) * 0.1).to(dev)
    pre = torch.stack([torch.rand(n, ci, generator=g) + 0.5,
                       torch.randn(n, ci, generator=g)], 1).to(dev)
    kw = {}
    if "pre" in mode:
        kw["pre"] = pre
    if "corr" in mode:
        kw.update(y=y, gs=gs)
    plan = c3._f32_dw_plan(n, size, ci, co, stride, c3._sm_count(x.device),
                           "corr" in mode)
    assert (plan["splits"] > 1) == split
    name = f"conv3d_k3_dw_s{stride}_f32"
    before = _build.LAUNCHES[name]
    got = conv3d_k3_dw(x, gy, stride, **kw)
    want = conv3d_k3_dw_plain(x.double(), gy.double(), stride, **_f64(kw))
    again = conv3d_k3_dw(x, gy, stride, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 2
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3, ci, co)
    assert _rel_l2(got, want) <= 1e-5
    assert torch.equal(got, again)


def test_f32_dw_launcher_refuses_a_plan_not_its_own(dev):
    """The C launcher checks the plan it is handed: a stride-1 tile at
    stride 2 or stride 2's at stride 1, more splits than bricks, more
    blocks than units, shared memory other than the tile's in the launch's
    mode, a split without its scratch, a scratch length or finish grid
    other than the split's, a tile whose channels do not divide ci x co,
    a pre or gs that is not 16-byte aligned."""
    from mt3d_resenc_unet_torch.ops import conv3d as c3
    n, d, ci, co = 1, 4, 32, 32
    x = torch.randn(n, d, d, d, ci, device=dev)
    gy = torch.randn(n, d, d, d, co, device=dev)
    y = torch.randn(n, d, d, d, co, device=dev)
    gs = torch.randn(n, 2, co, device=dev)
    dw = torch.empty(3, 3, 3, ci, co, device=dev)
    length = 27 * ci * co
    part = torch.empty(2 * length, dtype=torch.float64, device=dev)
    fn = c3._f32_fn("dw")
    stream = torch.cuda.current_stream(dev).cuda_stream
    fin = -(-length // c3.F32_DW_FIN_THREADS)

    def call(stride, tile, splits, grid, smem, scratch=None, plen=0, fgrid=0,
             corr=False, dy=gy, pre=None, g=gs):
        return fn(x.data_ptr(), dy.data_ptr(), pre,
                  y.data_ptr() if corr else None,
                  g.data_ptr() if corr else None, dw.data_ptr(), scratch, n,
                  d, d, d, ci, co, stride, tile, splits, grid, smem, plen,
                  fgrid, 0.01, stream)

    small = c3.f32_dw_smem(1, False)
    # x 4^3 under tile 1 (4^3 bricks): one brick, two tiles (16 ci each)
    assert call(1, 1, 1, 2, small) == 0
    assert call(1, 1, 1, 1, c3.f32_dw_smem(1, True), corr=True) == 0
    torch.cuda.synchronize()
    assert call(2, 1, 1, 1, small) != 0                     # stride 2, tile 1
    assert call(1, 2, 1, 1, c3.f32_dw_smem(2, False)) != 0  # stride 1, tile 2
    assert call(1, 1, 2, 2, small, part.data_ptr(), 2 * length, fin) != 0
    assert call(1, 1, 1, 3, small) != 0                     # 3 blocks, 2 units
    assert call(1, 1, 1, 1, small, corr=True) != 0          # corr's smem
    assert call(1, 0, 1, 1, small) != 0                     # tile 0's smem
    # tile 0 (a 2 x 4 x 8 brick): x 4^3 is 2 bricks
    big = c3.f32_dw_smem(0, False)
    assert call(1, 0, 2, 4, big, part.data_ptr(), 2 * length, fin) == 0
    torch.cuda.synchronize()
    assert call(1, 0, 2, 4, big) != 0                       # split, no scratch
    assert call(1, 0, 2, 4, big, part.data_ptr(), length, fin) != 0
    assert call(1, 0, 2, 4, big, part.data_ptr(), 2 * length, fin + 1) != 0
    assert call(1, 0, 1, 2, big, part.data_ptr(), 2 * length, fin) != 0
    # tile 2 takes co % 64 == 0 only
    gy2 = torch.randn(n, 2, 2, 2, co, device=dev)
    assert call(2, 2, 1, 1, c3.f32_dw_smem(2, False), dy=gy2) != 0
    # the producers copy pre and gs in 16-byte pieces
    vec = torch.randn(2 * 2 * co + 4, device=dev)
    big_corr = c3.f32_dw_smem(0, True)
    assert call(1, 0, 1, 2, big, pre=vec.data_ptr()) == 0
    assert call(1, 0, 1, 2, big_corr, corr=True, g=vec[:2 * co]) == 0
    torch.cuda.synchronize()
    assert call(1, 0, 1, 2, big, pre=vec[1:].data_ptr()) != 0
    assert call(1, 0, 1, 2, big_corr, corr=True, g=vec[1:]) != 0


@pytest.mark.parametrize("stride", [1, 2])
def test_f32_dw_copies_a_misaligned_pre_or_gs(dev, stride):
    """A pre or gs view that starts 4 bytes into its storage (the kernel
    copies both in 16-byte pieces) gives the dW of aligned copies."""
    g = torch.Generator().manual_seed(5)
    n, ci, co, size = 2, 32, 64, (6, 7, 9)
    out = [(s - 1) // stride + 1 for s in size]
    x = torch.randn(n, *size, ci, generator=g).to(dev)
    gy, y = (torch.randn(n, *out, co, generator=g).to(dev) for _ in range(2))
    pre = torch.empty(n * 2 * ci + 1, device=dev)[1:].view(n, 2, ci)
    pre.copy_(torch.stack([torch.rand(n, ci, generator=g) + 0.5,
                           torch.randn(n, ci, generator=g)], 1))
    gs = torch.empty(n * 2 * co + 1, device=dev)[1:].view(n, 2, co)
    gs.copy_(torch.randn(n, 2, co, generator=g) * 0.1)
    assert pre.data_ptr() % 16 and gs.data_ptr() % 16
    got = conv3d_k3_dw(x, gy, stride, pre=pre, y=y, gs=gs)
    want = conv3d_k3_dw(x, gy, stride, pre=pre.clone(), y=y, gs=gs.clone())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", _DX_MODES)
@pytest.mark.parametrize("stride,ci,co,extent", _F32_SHAPES)
def test_f32_conv_dx_kernel_matches_plain_fp64(dev, stride, ci, co, extent,
                                               mode):
    x, w, pre, gy, y, gs = _f32_case(dev, stride, ci, co, extent)
    kw = _dx_kwargs(mode, x, y, gs, pre)
    got = conv3d_k3_dx(gy, w, stride, **kw)
    want = conv3d_k3_dx_plain(gy.double(), w.double(), stride, **_f64(kw))
    again = conv3d_k3_dx(gy, w, stride, **kw)
    torch.cuda.synchronize()
    got, want, again = ((t if isinstance(t, tuple) else (t,))
                        for t in (got, want, again))
    for g, wv, a in zip(got, want, again):
        assert g.dtype == torch.float32
        assert _rel_l2(g, wv) <= 1e-5
        assert torch.equal(g, a)


@pytest.mark.parametrize("mode", ["plain", "pre", "corr", "pre_corr"])
@pytest.mark.parametrize("stride,ci,co,extent", _F32_SHAPES)
def test_f32_conv_dw_kernel_matches_plain_fp64(dev, stride, ci, co, extent,
                                               mode):
    x, w, pre, gy, y, gs = _f32_case(dev, stride, ci, co, extent)
    kw = {}
    if "pre" in mode:
        kw["pre"] = pre
    if "corr" in mode:
        kw.update(y=y, gs=gs)
    got = conv3d_k3_dw(x, gy, stride, **kw)
    want = conv3d_k3_dw_plain(x.double(), gy.double(), stride, **_f64(kw))
    again = conv3d_k3_dw(x, gy, stride, **kw)
    torch.cuda.synchronize()
    assert _rel_l2(got, want) <= 1e-5
    assert torch.equal(got, again)


# the fp32 upsample (csrc/upsample2x_f32.cu): the bf16 kernels' odd extents,
# then the flagship's two upsamples at their full extents
_F32_UP = ([(ci, co, (e, e + 1, e)) for ci, co, e in _UP_BWD]
           + [(128, 64, (32,) * 3), (64, 32, (64,) * 3)])


@pytest.mark.parametrize("ci,co,size", _F32_UP)
def test_f32_upsample_kernels_match_plain_fp64(dev, ci, co, size):
    g = torch.Generator().manual_seed(0)
    n = 2
    x = torch.randn(n, *size, ci, generator=g).to(dev)
    wf = (torch.randn(2, 2, 2, ci, co, generator=g) * (8 * co) ** -0.5).to(dev)
    gy = torch.randn(n, *(2 * s for s in size), co, generator=g).to(dev)
    for fn, ref, args in ((upsample2x, upsample_plain, (x, wf)),
                          (upsample2x_dx, upsample2x_dx_plain, (gy, wf)),
                          (upsample2x_dw, upsample2x_dw_plain, (x, gy))):
        got, again = fn(*args), fn(*args)
        want = ref(*(a.double() for a in args))
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        assert _rel_l2(got, want) <= 1e-5, fn.__name__
        assert torch.equal(got, again), fn.__name__


def test_f32_up_launcher_refuses_a_plan_not_its_own(dev):
    """The fp32 forward's and dx's C launchers check the plan they are
    handed: a column group they have no configuration for (or, for dx, one
    that does not divide Ci; for the forward, one whose weights do not fit),
    more blocks than tiles or none, shared memory other than the
    configuration's, are refused before anything launches; so are a dW
    plan's other ci tile, splits other than the grid's or more than the
    steps or none, a grid short of its units, shared memory, a scratch
    length or a finish grid other than its own."""
    from mt3d_resenc_unet_torch.ops import upsample as up
    n, size, ci, co = 2, (3, 4, 40), 96, 32
    x = torch.randn(n, *size, ci, device=dev)
    gy = torch.randn(n, *(2 * s for s in size), co, device=dev)
    wf = torch.randn(2, 2, 2, ci, co, device=dev)
    y = torch.empty(n, *(2 * s for s in size), co, device=dev)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for kind, inp, out, plan in (
            ("", x, y, up._up_f32_fwd_plan(n, size, ci, co, 132)),
            ("dx", gy, dx, up._up_f32_dx_plan(n, size, ci, co, 132))):
        other = 256 if kind == "" else 64     # fwd: 256 x 96 > 16384
        bad = [dict(plan, ncol=other,
                    smem=up.f32_up_smem(kind or "fwd", other, ci)),
               dict(plan, ncol=96),
               dict(plan, grid=(plan["tiles"] + 1, 1)),
               dict(plan, grid=(0, 1)),
               dict(plan, smem=plan["smem"] + 16)]
        for p in [plan] + bad:
            rc = up._f32_fn(kind)(inp.data_ptr(), wf.data_ptr(),
                                  out.data_ptr(), n, *size, ci, co,
                                  p["ncol"], p["grid"][0], p["smem"], stream)
            assert (rc == 0) == (p is plan), (kind, p)
    # dW: its ci tile, splits, grid, shared memory, scratch length and
    # finish grid
    plan = up._up_f32_dw_plan(n, size, ci, co, 132)
    dw = torch.empty(2, 2, 2, ci, co, device=dev)
    part = torch.empty(plan["part_len"] + 8 * ci * co, dtype=torch.float64,
                       device=dev)
    more = plan["splits"] + 1
    bad = [dict(plan, ci_tile=64),
           dict(plan, splits=more),
           dict(plan, splits=plan["steps"] + 1,
                grid=(plan["steps"] + 1) * plan["tiles"],
                part_len=(plan["steps"] + 1) * 8 * ci * co),
           dict(plan, splits=0, grid=0, part_len=0),
           dict(plan, grid=plan["grid"] - 1),
           dict(plan, smem=plan["smem"] + 16),
           dict(plan, smem=up.f32_dw_smem(64)),
           dict(plan, part_len=plan["part_len"] + 1),
           dict(plan, fin_grid=plan["fin_grid"] + 1)]
    for p in [plan] + bad:
        rc = up._f32_fn("dw")(x.data_ptr(), gy.data_ptr(), dw.data_ptr(),
                              part.data_ptr(), n, *size, ci, co,
                              p["ci_tile"], p["splits"], p["grid"],
                              p["smem"], p["part_len"], p["fin_grid"],
                              stream)
        assert (rc == 0) == (p is plan), ("dw", p)
    torch.cuda.synchronize()
    assert plan["ci_tile"] == 32 and plan["splits"] < plan["steps"]
    with pytest.raises(ValueError, match="Ci <= 512"):
        upsample2x(torch.zeros(1, 2, 2, 2, 544, device=dev),
                   torch.zeros(2, 2, 2, 544, 32, device=dev))


def test_f32_model_step_launches_the_f32_kernels(dev):
    """An fp32 kernel model's training step at 32^3: all nine fp32 conv and
    upsample kernels launched, no bf16 one, and the loss and gradients
    against the fp32 reference model (kernels off) from the same weights."""
    plan = plan_from_autoconfig(
        (32, 32, 32), 1,
        [TaskHead("sheet", 1, "sigmoid"), TaskHead("normals", 3, "none")],
        max_features=256, use_pallas_conv=True)
    fast = ResEncUNet(plan, dtype=torch.float32, seed=0).to(dev)
    plain = ResEncUNet(dataclasses.replace(plan, use_pallas_conv=False),
                       dtype=torch.float32, seed=0).to(dev)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 32, 32, 32, 1, generator=g).to(dev)

    def loss_and_grads(model):
        model.train()
        model.zero_grad(set_to_none=True)
        out = model(x)
        loss = sum(v.float().square().mean() for v in out.values())
        loss.backward()
        return float(loss), torch.cat([p.grad.flatten()
                                       for p in model.parameters()
                                       if p.grad is not None])

    _build.LAUNCHES.clear()
    loss, grads = loss_and_grads(fast)
    names = ("conv3d_k3_s1", "conv3d_k3_s2", "upsample2x", "conv3d_k3_dx_s1",
             "conv3d_k3_dx_s2", "conv3d_k3_dw_s1", "conv3d_k3_dw_s2",
             "upsample2x_dx", "upsample2x_dw")
    assert all(_build.LAUNCHES[f"{k}_f32"] > 0 for k in names), \
        dict(_build.LAUNCHES)
    assert not any(_build.LAUNCHES[k] for k in names)
    want_loss, want_grads = loss_and_grads(plain)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    # gradients at random init move with LeakyReLU inputs within fp32
    # rounding of 0 (up to ~2% of a deep weight's gradient): all of them
    # together by relative L2
    assert _rel_l2(grads, want_grads) <= 1e-2


# ------------------------------------------------------------------- fp16

# one shape of each class at fp16: a brick-ragged 32 -> 32 and a K-split
# 256 -> 256 cube at stride 1, the flagship's two stride-2 convs, the
# flagship's upsample channels
_F16_CONV = [(1, 32, 32, 9), (1, 256, 256, 4), (2, 32, 64, 12),
             (2, 64, 128, 10)]
_F16_UP = [(128, 64, 9), (64, 32, 17)]


def _f16_case(dev, stride, ci, co, extent, seed, scale=1.0):
    """_bwd_case's tensors in fp16, the cotangent gy times ``scale``."""
    x, w, gy, y, gs, pre = _bwd_case(dev, stride, ci, co, extent, seed)
    return x.half(), w.half(), (gy.float() * scale).half(), y.half(), gs, pre


def _twice(f):
    """Two runs of f, bit-equal, and the first; tuples compared whole."""
    a, b = f(), f()
    torch.cuda.synchronize()
    pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
    assert all(torch.equal(u, v) for u, v in pairs)
    return a


@pytest.mark.parametrize("mode", ["plain", "stats", "pre_stats",
                                  "addin_stats"])
@pytest.mark.parametrize("stride,ci,co,extent", _F16_CONV)
def test_f16_conv_kernel_matches_plain(dev, stride, ci, co, extent, mode):
    x, w, _, y, _, pre = _f16_case(dev, stride, ci, co, extent, 21)
    kw = {"emit_stats": mode != "plain"}
    if mode == "pre_stats":
        kw["pre"] = pre
    if mode == "addin_stats":
        kw["add_to"] = y
    name = f"conv3d_k3_s{stride}_f16"
    before = _build.LAUNCHES[name]
    got = _twice(lambda: conv3d_k3(x, w, stride, **kw))
    want = conv3d_k3_plain(x, w, stride, **kw)
    assert _build.LAUNCHES[name] == before + 2
    if mode == "plain":
        got, want = (got,), (want,)
    assert got[0].dtype == torch.float16 and _rel(got[0], want[0]) <= 2e-3
    if mode != "plain":
        torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("scale", [1.0, 2e-7])
@pytest.mark.parametrize("mode", ["plain", "corr", "corr_post", "post"])
@pytest.mark.parametrize("stride,ci,co,extent", _F16_CONV)
def test_f16_conv_bwd_kernels_match_plain(dev, stride, ci, co, extent, mode,
                                          scale):
    x, w, gy, y, gs, pre = _f16_case(dev, stride, ci, co, extent, 22, scale)
    gs = gs * scale
    kw = _dx_kwargs(mode, x, y, gs, pre)
    dkw = {"pre": pre} if "post" in mode else {}
    if "corr" in mode:
        dkw.update(y=y, gs=gs)
    names = (f"conv3d_k3_dx_s{stride}_f16", f"conv3d_k3_dw_s{stride}_f16")
    before = {k: _build.LAUNCHES[k] for k in names}
    dx = _twice(lambda: conv3d_k3_dx(gy, w, stride, **kw))
    dw = _twice(lambda: conv3d_k3_dw(x, gy, stride, **dkw))
    dx0 = conv3d_k3_dx_plain(gy, w, stride, **kw)
    dw0 = conv3d_k3_dw_plain(x, gy, stride, **dkw)
    assert all(_build.LAUNCHES[k] == v + 2 for k, v in before.items())
    if "post" not in mode:
        dx, dx0 = (dx,), (dx0,)
    top = float(dx0[0].abs().max())
    diff = float((dx[0].double() - dx0[0].double()).abs().max())  # exact
    assert dx[0].dtype == torch.float16 and top > 0
    assert diff <= max(2e-3 * top, 2.0 ** -24)
    if "post" in mode:
        assert _rel_vec(dx[1], dx0[1]) <= 1e-3
    assert dw.dtype == torch.float32 and _rel(dw, dw0) <= 1e-2


@pytest.mark.parametrize("ci,co,extent", _F16_UP)
def test_f16_upsample_kernels_match_plain(dev, ci, co, extent):
    x, wf = (t.half() for t in _up_inputs(dev, 23, ci, co, extent))
    gy = torch.randn(2, 2 * extent, 2 * extent + 2, 2 * extent, co,
                     generator=torch.Generator().manual_seed(24)).to(
        dev).half()
    names = ("upsample2x_f16", "upsample2x_dx_f16", "upsample2x_dw_f16")
    before = {k: _build.LAUNCHES[k] for k in names}
    y = _twice(lambda: upsample2x(x, wf))
    dx = _twice(lambda: upsample2x_dx(gy, wf))
    dw = _twice(lambda: upsample2x_dw(x, gy))
    assert all(_build.LAUNCHES[k] == v + 2 for k, v in before.items())
    assert y.dtype == dx.dtype == torch.float16
    assert _rel(y, upsample_plain(x, wf)) <= 2e-3
    assert _rel(dx, upsample2x_dx_plain(gy, wf)) <= 2e-3
    assert _rel(dw, upsample2x_dw_plain(x, gy)) <= 1e-2


def test_f16_model_step_launches_the_f16_kernels(dev):
    """An fp16 kernel model's forward and backward at 32^3 launch the nine
    fp16 conv and upsample kernels and no bf16 or fp32 one."""
    plan = plan_from_autoconfig(
        (32, 32, 32), 1,
        [TaskHead("sheet", 1, "sigmoid"), TaskHead("normals", 3, "none")],
        max_features=256, use_pallas_conv=True)
    model = ResEncUNet(plan, dtype=torch.float16, seed=0).to(dev)
    x = torch.randn(2, 32, 32, 32, 1,
                    generator=torch.Generator().manual_seed(2)).to(dev)
    _build.LAUNCHES.clear()
    out = model(x)
    sum(v.float().square().mean() for v in out.values()).backward()
    torch.cuda.synchronize()
    kernels = [f"conv3d_k3{k}_s{s}" for k in ("", "_dx", "_dw")
               for s in (1, 2)] + ["upsample2x", "upsample2x_dx",
                                   "upsample2x_dw"]
    assert all(_build.LAUNCHES[k + "_f16"] > 0 for k in kernels)
    assert not any(_build.LAUNCHES[k + sfx] for k in kernels
                   for sfx in ("", "_f32"))
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)
