"""The torch port's CUDA kernels against their plain PyTorch versions, on
an NVIDIA GPU. Marked ``cuda``; each test skips where no card is present.
Run on the GPU machine (its Python has no JAX, which ``tests/conftest.py``
imports, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: outputs are bf16 on both sides, rounded from fp32 sums taken
in another order, so they may differ by one bf16 step (2^-8 of the value):
1e-2 of the plain output's max abs. The fp32 statistics: 1e-3 relative.
"""

import dataclasses

import pytest
import torch

from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
from mt3d_resenc_unet_torch.models.network import ResEncUNet
from mt3d_resenc_unet_torch.ops import _build
from mt3d_resenc_unet_torch.ops.conv3d import conv3d_k3, conv3d_k3_plain
from mt3d_resenc_unet_torch.ops.upsample import upsample2x, upsample_plain

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
