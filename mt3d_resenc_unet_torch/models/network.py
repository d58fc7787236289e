"""Shared-encoder / multi-decoder ResEnc U-Net in PyTorch, channels-last.

The port of ``mt3d_resenc_unet_tpu/models/network.py`` (reference:
build_network_from_config.py:20-326, encoder.py, decoder.py). ``forward``
takes (N, D, H, W, C_in) and returns ``{task: (N, D, H, W, C_task)}`` in
fp32: logits in train mode, each task's activation applied in eval mode,
as the JAX model does with ``train=True`` / ``train=False``; with deep
supervision a list per task, full resolution first.

The port builds every plan the JAX package builds: BasicBlockD and
BottleneckD residual encoders or a ConvBlock encoder, with or without the
stem; ConvBlock or ResidualBlock decoders; squeeze-excitation, DropPath,
dropout, conv biases, affine norms, deep supervision; any ``dim``, kernel
size and stride. ``plan.nonlin`` is not read, as in the JAX package: every
nonlinearity is LeakyReLU(``nonlin_negative_slope``). ``plan.remat`` is
ignored: it changes memory, not the function, and the flagship step at
batch 2 fits the H100's 80 GB without recomputation.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

import torch
from torch import nn

from ..core.plan import NetworkPlan
from ..ops import lowp
from ..ops.upsample import Upsample2xFn, upsample2x_supported, upsample_plain
from .blocks import (StackedConvBlocks, StackedResidualBlocks, torch_uniform_,
                     voxel_count)


class UpsampleConv(nn.Module):
    """Transposed conv with kernel == stride (reference: decoder.py:76-79)
    as one pointwise GEMM written depth-to-space. The parameter keeps the
    flax ``ConvTranspose`` layout (*k, ci, co), which applies the kernel
    spatially flipped: y[k*i + a] = x[i] @ W[k-1-a] (JAX network.py:79-81).
    The 2x cube at the JAX package's Pallas shapes (128->64, 64->32) goes to
    the CUDA upsample through its autograd Function when ``use_kernels``;
    the flip stays outside it, so autograd takes its gradient. Other shapes
    run the GEMM in plain PyTorch: in fp32 for an fp32 input, in the
    input's dtype with fp32 accumulation for a bf16 one (ops/lowp.py).
    ``bias`` (with ``conv_bias``) is added in the output's dtype."""

    def __init__(self, ci: int, co: int, kernel, use_kernels: bool = False,
                 bias: bool = False):
        super().__init__()
        self.kernel_size = tuple(kernel)
        self.use_kernels = use_kernels
        self.kernel = nn.Parameter(torch.empty(*kernel, ci, co))
        self.bias = nn.Parameter(torch.empty(co)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch ConvTranspose default: fan_in = co * prod(k) (its weight
        # layout (ci, co, *k) makes size(1) = co the "input fmaps")
        fan_in = self.kernel.shape[-1] * math.prod(self.kernel_size)
        torch_uniform_(self.kernel, fan_in, generator)
        if self.bias is not None:
            torch_uniform_(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wf = torch.flip(self.kernel.to(x.dtype),
                        dims=tuple(range(len(self.kernel_size)))).contiguous()
        ci, co = wf.shape[-2:]
        if (self.use_kernels and self.kernel_size == (2, 2, 2)
                and upsample2x_supported(x.shape, ci, co)):
            y = Upsample2xFn.apply(x, wf)
        elif x.dtype != torch.float32:
            y = lowp.upsample(x, wf)
        else:
            y = upsample_plain(x, wf)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class SegLayer(nn.Module):
    """1x1x1 segmentation head with bias, as a channel matmul: in fp32 for
    an fp32 input, in the input's dtype (then fp32) for a bf16 one, as the
    JAX ``SegLayer`` (reference: decoder.py:97-100). Layout: kernel
    (*1, ci, co) with one 1 per spatial axis of a ``dim``-D plan."""

    def __init__(self, ci: int, co: int, dim: int = 3):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(*(1,) * dim, ci, co))
        self.bias = nn.Parameter(torch.empty(co))

    def reset_parameters(self, generator: torch.Generator) -> None:
        ci = self.kernel.shape[-2]
        torch_uniform_(self.kernel, ci, generator)
        torch_uniform_(self.bias, ci, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32:
            return lowp.seg(x, self.kernel, self.bias)
        ci, co = self.kernel.shape[-2:]
        y = x.float().reshape(-1, ci) @ self.kernel.float().reshape(ci, co)
        return (y + self.bias.float()).reshape(*x.shape[:-1], co)


class Encoder(nn.Module):
    """Stem conv + stages, returning every stage's output as a skip
    (reference: encoder.py:27-158): residual stages (``BasicBlockD``, or
    ``plan.bottleneck_block`` for a ``BottleneckBlockD`` encoder, as JAX
    network.py:226-229 picks it) or plain conv stacks (``ConvBlock``). The
    stem's instance norm is handed to a residual stage 0 as its first
    conv's pre-op (JAX network.py:196-219) where the stem runs the fused
    chain; a plain-conv encoder takes the stem's normalized output, as in
    JAX, whose handoff needs a residual encoder too."""

    def __init__(self, plan: NetworkPlan):
        super().__init__()
        p = plan
        common = dict(eps=p.norm_eps, negative_slope=p.nonlin_negative_slope,
                      use_kernels=p.use_pallas_conv, conv_bias=p.conv_bias,
                      norm_affine=p.norm_affine, dropout_p=p.dropout_p)
        ones = (1,) * p.dim
        residual = p.basic_encoder_block in ("BasicBlockD",
                                             "BottleneckBlockD")
        self.stem = (StackedConvBlocks(1, p.in_channels, p.stem_width,
                                       p.kernel_sizes[0], ones, **common)
                     if p.do_stem else None)
        self.handoff = self.stem is not None and self.stem.fused and residual
        block_type = (p.bottleneck_block
                      if p.basic_encoder_block == "BottleneckBlockD"
                      else "BasicBlockD")
        ci = p.stem_width if p.do_stem else p.in_channels
        self.stages = []
        for s in range(p.num_stages):
            args = (p.n_blocks_per_stage[s], ci, p.features_per_stage[s],
                    p.kernel_sizes[s], p.strides[s])
            if residual:
                stage = StackedResidualBlocks(
                    *args, block_type=block_type,
                    bottleneck_features=(p.bottleneck_channels[s]
                                         if p.bottleneck_channels else None),
                    squeeze_excitation=p.squeeze_excitation,
                    se_ratio=p.squeeze_excitation_reduction_ratio,
                    stochastic_depth_p=p.stochastic_depth_p, **common)
            else:
                stage = StackedConvBlocks(*args, **common)
            self.add_module(f"stage{s}", stage)
            self.stages.append(stage)
            ci = p.features_per_stage[s]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        pre = None
        if self.handoff:
            x, stats = self.stem.raw(x)
            pre = self.stem.convs[-1].norm.vectors(stats, voxel_count(x))
        elif self.stem is not None:
            x = self.stem(x, generator=generator)
        skips = []
        for stage in self.stages:
            if isinstance(stage, StackedResidualBlocks):
                x = stage(x, pre, generator=generator)
            else:
                x = stage(x, generator=generator)
            pre = None
            skips.append(x)
        return skips


class Decoder(nn.Module):
    """Per-task head: transposed-conv upsample, split-weight skip concat,
    a conv stack (``ConvBlock``) or residual stack (``ResidualBlock``) per
    resolution, and 1x1 seg layers (reference: decoder.py:16-162). Seg
    layers exist for every stage so checkpoints match the JAX package's
    with and without deep supervision; with it ``forward`` returns every
    stage's seg output, full resolution first (JAX network.py:324-335),
    else the last stage's."""

    def __init__(self, plan: NetworkPlan, num_classes: int):
        super().__init__()
        p = plan
        n = p.num_stages
        common = dict(eps=p.norm_eps, negative_slope=p.nonlin_negative_slope,
                      use_kernels=p.use_pallas_conv, conv_bias=p.conv_bias,
                      norm_affine=p.norm_affine, dropout_p=p.dropout_p)
        stack = (StackedResidualBlocks
                 if p.basic_decoder_block == "ResidualBlock"
                 else StackedConvBlocks)
        self.deep_supervision = p.deep_supervision
        self.levels = []
        for s in range(1, n):
            skip_c = p.features_per_stage[n - 1 - s]
            up = UpsampleConv(p.features_per_stage[n - s], skip_c,
                              p.strides[n - s], p.use_pallas_conv,
                              p.conv_bias)
            stage = stack(p.n_conv_per_stage_decoder[s - 1], 2 * skip_c,
                          skip_c, p.kernel_sizes[n - 1 - s], (1,) * p.dim,
                          **common)
            seg = SegLayer(skip_c, num_classes, p.dim)
            self.add_module(f"up{s - 1}", up)
            self.add_module(f"stage{s - 1}", stage)
            self.add_module(f"seg{s - 1}", seg)
            self.levels.append((up, stage, seg))

    def forward(self, skips: List[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        x = skips[-1]
        outs = []
        for s, (up, stage, seg) in enumerate(self.levels, start=1):
            x = stage(up(x), x2=skips[-1 - s], generator=generator)
            if self.deep_supervision or s == len(self.levels):
                outs.append(seg(x))
        return outs[::-1] if self.deep_supervision else outs[0]


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
    ``seed`` (affine norms start at ones and zeros)."""

    def __init__(self, plan: NetworkPlan, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__()
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
                apply_activations: Optional[bool] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Union[torch.Tensor, List[torch.Tensor]]]:
        """``apply_activations`` defaults to ``not self.training``, as in the
        JAX model: training losses take logits; validation asks for logits
        in eval mode with ``False``. ``generator``: the caller's
        ``torch.Generator`` on the input's device, from which dropout and
        DropPath draw in train mode (the JAX model's "dropout" and
        "droppath" rngs); needed only by a plan that has them."""
        if apply_activations is None:
            apply_activations = not self.training
        skips = self.encoder(x.to(self.dtype).contiguous(), generator)
        out = {}
        for task in self.plan.tasks:
            logits = getattr(self, f"decoder_{task.name}")(skips, generator)
            if apply_activations:
                logits = (
                    [_apply_activation(v, task.activation) for v in logits]
                    if isinstance(logits, list)
                    else _apply_activation(logits, task.activation))
            out[task.name] = logits
        return out


def count_params(model: nn.Module) -> int:
    """Total learnable parameter count
    (reference: utils.py:8-9 get_number_of_learnable_parameters)."""
    return sum(p.numel() for p in model.parameters())


def norm_launches(plan: NetworkPlan, patch, n: int,
                  dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """The norm-act kernel launches one forward of a kernel model
    (``use_pallas_conv``) makes at ``patch`` and batch ``n``, as the plan
    implies them: ``norm_act_tail`` once for each norm applied by a tail
    pass (each residual block's, each skip projection's, each decoder
    stage's, a handoff the first block cannot take), ``norm_act_raw_stats``
    once for each conv whose statistics no conv kernel emits (the stem,
    the convs outside the conv kernels' class, the 1x1 projections); the
    backward launches ``norm_act_tail_bwd`` once for each tail. Derived
    from the plan's stages and the conv kernels' shape classes, not from
    the model, so that a run can hold its launch counts against it. For a
    residual BasicBlockD encoder and a ConvBlock decoder without conv bias,
    affine norm or dropout in 3-D (the flagship's and ``tasks/ink.yaml``'s
    plans); raises on another plan."""
    from ..ops.conv3d import conv_s1_supported, conv_s2_supported
    p = plan
    if not (p.basic_encoder_block == "BasicBlockD" and p.dim == 3
            and p.basic_decoder_block == "ConvBlock" and p.do_stem
            and not (p.conv_bias or p.norm_affine or p.dropout_p > 0.0)):
        raise NotImplementedError("norm_launches: not a plan it counts")
    vec = 8 if dtype == torch.bfloat16 else 4

    def in_class(c: int) -> bool:
        return c % vec == 0 and c // vec <= 256

    def unfused(ext, ci, co, stride) -> bool:
        """A 3x3x3 conv whose statistics the raw mode takes: outside the
        conv kernels' class, in a 16-bit model (an fp32 model's run
        conv3d_k3_plain, which emits its own)."""
        if dtype == torch.float32 or not in_class(co):
            return False
        x, w = (n, *ext, ci), (3, 3, 3, ci, co)
        if stride == (1, 1, 1):
            return not conv_s1_supported(x, w)
        return not (stride == (2, 2, 2) and conv_s2_supported(x, w))

    if not p.use_pallas_conv:
        return {"norm_act_tail": 0, "norm_act_raw_stats": 0,
                "norm_act_tail_bwd": 0}
    tails = raw = 0
    ext, ci = tuple(patch), p.stem_width
    raw += unfused(ext, p.in_channels, ci, (1, 1, 1))     # the stem
    exts = []
    for s in range(p.num_stages):
        co, stride = p.features_per_stage[s], tuple(p.strides[s])
        for b in range(p.n_blocks_per_stage[s]):
            st = stride if b == 0 else (1, 1, 1)
            cin = ci if b == 0 else co
            out = tuple(e // t for e, t in zip(ext, st))
            has_skip = st != (1, 1, 1) or cin != co
            if s == 0 and b == 0 and (has_skip or p.squeeze_excitation
                                      or p.stochastic_depth_p > 0.0):
                tails += in_class(ci)                     # handoff applied
            if cin != co:                                 # the projection
                raw += in_class(co)
                tails += in_class(co)
            raw += unfused(ext, cin, co, st)
            raw += unfused(out, co, co, (1, 1, 1))
            tails += in_class(co)
            ext = out
        ci = co
        exts.append(ext)
    for _ in p.tasks:
        for s in range(1, p.num_stages):
            c, e = p.features_per_stage[-1 - s], exts[-1 - s]
            raw += unfused(e, c, c, (1, 1, 1)) * p.n_conv_per_stage_decoder[
                s - 1]                                    # the pair first
            tails += in_class(c)
    return {"norm_act_tail": tails, "norm_act_raw_stats": raw,
            "norm_act_tail_bwd": tails}
