"""Shared-encoder / multi-decoder ResEnc U-Net in PyTorch, channels-last.

The port of ``mt3d_resenc_unet_tpu/models/network.py`` (reference:
build_network_from_config.py:20-326, encoder.py, decoder.py). ``forward``
takes (N, D, H, W, C_in) and returns ``{task: (N, D, H, W, C_task)}`` in
fp32: logits in train mode, each task's activation applied in eval mode,
as the JAX model does with ``train=True`` / ``train=False``.

Plan options the port does not run raise ``NotImplementedError`` at
construction (see :func:`check_plan`). ``plan.remat`` is ignored: the
flagship step at batch 2 fits the H100's 80 GB without recomputation.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from ..core.plan import NetworkPlan
from ..ops.instance_norm import stats_to_scale_shift
from ..ops.upsample import Upsample2xFn, upsample2x_supported, upsample_plain
from .blocks import (StackedConvBlocks, StackedResidualBlocks, torch_uniform_,
                     voxel_count)


def check_plan(plan: NetworkPlan) -> None:
    """Raise NotImplementedError for every plan option the port does not
    run yet (``remat`` is not one: it changes memory, not the function, and
    the port ignores it)."""
    unsupported = {
        "dim != 3": plan.dim != 3,
        "basic_encoder_block other than BasicBlockD":
            plan.basic_encoder_block != "BasicBlockD",
        "basic_decoder_block other than ConvBlock":
            plan.basic_decoder_block != "ConvBlock",
        "conv_bias": plan.conv_bias,
        "norm_affine": plan.norm_affine,
        "nonlin other than leaky_relu": plan.nonlin != "leaky_relu",
        "dropout_p > 0": plan.dropout_p > 0.0,
        "squeeze_excitation": plan.squeeze_excitation,
        "stochastic_depth_p > 0": plan.stochastic_depth_p > 0.0,
        "deep_supervision": plan.deep_supervision,
        "do_stem=False": not plan.do_stem,
        "kernel sizes other than 3x3x3":
            any(tuple(k) != (3, 3, 3) for k in plan.kernel_sizes),
        "strides other than 1 or 2 on all axes":
            any(tuple(s) not in ((1, 1, 1), (2, 2, 2)) for s in plan.strides),
    }
    bad = [name for name, hit in unsupported.items() if hit]
    if bad:
        raise NotImplementedError(
            "the torch port does not support: " + ", ".join(bad))


class UpsampleConv(nn.Module):
    """Transposed conv with kernel == stride (reference: decoder.py:76-79)
    as one pointwise GEMM written depth-to-space. The parameter keeps the
    flax ``ConvTranspose`` layout (*k, ci, co), which applies the kernel
    spatially flipped: y[k*i + a] = x[i] @ W[k-1-a] (JAX network.py:79-81).
    The 2x cube at the JAX package's Pallas shapes (128->64, 64->32) goes to
    the CUDA upsample through its autograd Function when ``use_kernels``;
    the flip stays outside it, so autograd takes its gradient."""

    def __init__(self, ci: int, co: int, kernel, use_kernels: bool = False):
        super().__init__()
        self.kernel_size = tuple(kernel)
        self.use_kernels = use_kernels
        self.kernel = nn.Parameter(torch.empty(*kernel, ci, co))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch ConvTranspose default: fan_in = co * prod(k) (its weight
        # layout (ci, co, *k) makes size(1) = co the "input fmaps")
        co = self.kernel.shape[-1]
        torch_uniform_(self.kernel, co * math.prod(self.kernel_size),
                       generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wf = torch.flip(self.kernel.to(x.dtype), dims=(0, 1, 2)).contiguous()
        ci, co = wf.shape[-2:]
        if (self.use_kernels and self.kernel_size == (2, 2, 2)
                and upsample2x_supported(x.shape, ci, co)):
            return Upsample2xFn.apply(x, wf)
        return upsample_plain(x, wf)


class SegLayer(nn.Module):
    """1x1x1 segmentation head with bias, as a channel matmul in fp32
    (reference: decoder.py:97-100). Layout: kernel (1, 1, 1, ci, co)."""

    def __init__(self, ci: int, co: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(1, 1, 1, ci, co))
        self.bias = nn.Parameter(torch.empty(co))

    def reset_parameters(self, generator: torch.Generator) -> None:
        ci = self.kernel.shape[-2]
        torch_uniform_(self.kernel, ci, generator)
        torch_uniform_(self.bias, ci, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ci, co = self.kernel.shape[-2:]
        y = x.float().reshape(-1, ci) @ self.kernel.float().reshape(ci, co)
        return (y + self.bias.float()).reshape(*x.shape[:-1], co)


class Encoder(nn.Module):
    """Stem conv + residual stages, returning every stage's output as a
    skip (reference: encoder.py:27-158). The stem's instance norm
    is handed to stage 0 as its first conv's pre-op (JAX network.py:196-219)
    instead of running as a pass of its own."""

    def __init__(self, plan: NetworkPlan):
        super().__init__()
        p = plan
        common = dict(eps=p.norm_eps, negative_slope=p.nonlin_negative_slope,
                      use_kernels=p.use_pallas_conv)
        self.eps = p.norm_eps
        self.stem = StackedConvBlocks(1, p.in_channels, p.stem_width,
                                      p.kernel_sizes[0], (1, 1, 1), **common)
        ci = p.stem_width
        self.stages = []
        for s in range(p.num_stages):
            stage = StackedResidualBlocks(
                p.n_blocks_per_stage[s], ci, p.features_per_stage[s],
                p.kernel_sizes[s], p.strides[s], **common)
            self.add_module(f"stage{s}", stage)
            self.stages.append(stage)
            ci = p.features_per_stage[s]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        y, stats = self.stem.raw(x)
        pre = stats_to_scale_shift(stats, voxel_count(y), self.eps)
        skips = []
        for s, stage in enumerate(self.stages):
            y = stage(y, pre if s == 0 else None)
            skips.append(y)
        return skips


class Decoder(nn.Module):
    """Per-task head: transposed-conv upsample, split-weight skip concat,
    conv stack per resolution, and the last stage's 1x1 seg layer
    (reference: decoder.py:16-162). Seg layers exist for every
    stage so checkpoints match the JAX package's."""

    def __init__(self, plan: NetworkPlan, num_classes: int):
        super().__init__()
        p = plan
        n = p.num_stages
        self.levels = []
        for s in range(1, n):
            skip_c = p.features_per_stage[n - 1 - s]
            up = UpsampleConv(p.features_per_stage[n - s], skip_c,
                              p.strides[n - s], p.use_pallas_conv)
            stage = StackedConvBlocks(
                p.n_conv_per_stage_decoder[s - 1], 2 * skip_c, skip_c,
                p.kernel_sizes[n - 1 - s], (1, 1, 1), eps=p.norm_eps,
                negative_slope=p.nonlin_negative_slope,
                use_kernels=p.use_pallas_conv)
            seg = SegLayer(skip_c, num_classes)
            self.add_module(f"up{s - 1}", up)
            self.add_module(f"stage{s - 1}", stage)
            self.add_module(f"seg{s - 1}", seg)
            self.levels.append((up, stage, seg))

    def forward(self, skips: List[torch.Tensor]) -> torch.Tensor:
        x = skips[-1]
        for s, (up, stage, _) in enumerate(self.levels, start=1):
            x = stage(up(x), skips[-1 - s])
        return self.levels[-1][2](x)


def _apply_activation(x: torch.Tensor, activation: str) -> torch.Tensor:
    a = activation.lower()
    if a == "sigmoid":
        return torch.sigmoid(x)
    if a == "softmax":
        return torch.softmax(x, dim=-1)
    return x


class ResEncUNet(nn.Module):
    """Multi-task network: shared Encoder, one Decoder per task. Starts in
    eval mode.

    ``dtype`` is the compute dtype of the activations (bf16 on the card,
    where the kernels need it); parameters stay fp32 and are cast at each
    call, as in the JAX model, so their gradients are fp32. Parameters start
    from torch's default init drawn from a ``torch.Generator`` seeded with
    ``seed``."""

    def __init__(self, plan: NetworkPlan, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__()
        check_plan(plan)
        self.plan = plan
        self.dtype = dtype
        self.encoder = Encoder(plan)
        for task in plan.tasks:
            self.add_module(f"decoder_{task.name}",
                            Decoder(plan, task.channels))
        generator = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        self.eval()

    def forward(self, x: torch.Tensor,
                apply_activations: Optional[bool] = None
                ) -> Dict[str, torch.Tensor]:
        """``apply_activations`` defaults to ``not self.training``, as in the
        JAX model: training losses take logits; validation asks for logits
        in eval mode with ``False``."""
        if apply_activations is None:
            apply_activations = not self.training
        skips = self.encoder(x.to(self.dtype).contiguous())
        out = {}
        for task in self.plan.tasks:
            logits = getattr(self, f"decoder_{task.name}")(skips)
            out[task.name] = (_apply_activation(logits, task.activation)
                              if apply_activations else logits)
        return out


def count_params(model: nn.Module) -> int:
    """Total learnable parameter count
    (reference: utils.py:8-9 get_number_of_learnable_parameters)."""
    return sum(p.numel() for p in model.parameters())
