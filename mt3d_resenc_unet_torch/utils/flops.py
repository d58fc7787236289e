"""Analytic FLOP accounting for the ResEnc U-Net.

A copy of ``mt3d_resenc_unet_tpu/utils/flops.py`` (pure Python over the
plan) whose default peak is the H100's.

Counts the multiply-accumulate work of every convolution / GEMM the network
executes (the reference carries an analogous analytic activation-size model,
builders/vram_estimation.py + compute_conv_feature_map_size — here the same
per-stage walk counts FLOPs instead of bytes). Used by ``chip_smoke.py`` to report
achieved TFLOP/s and MFU next to patches/sec, against the card's peak.

Convention: 1 MAC = 2 FLOPs; backward ≈ 2x forward (dx + dW are each a
conv-sized contraction); norm/activation/loss FLOPs are negligible (<1%) and
excluded, which makes the reported MFU slightly conservative.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

from ..core.plan import NetworkPlan

# dense bf16 tensor-core peak of one NVIDIA H100 SXM at its 700 W limit
# (NVIDIA's data sheet)
H100_PEAK_BF16_TFLOPS = 989.0


def _prod(xs) -> int:
    return int(math.prod(xs))


def _div(size, stride) -> Tuple[int, ...]:
    return tuple(s // st for s, st in zip(size, stride))


def forward_conv_flops(plan: NetworkPlan,
                       patch_size: Sequence[int] = None) -> int:
    """Forward-pass conv/GEMM FLOPs for ONE sample."""
    patch = tuple(patch_size or plan.patch_size)
    total = 0
    size = patch
    cin = plan.in_channels

    if plan.do_stem:
        taps = _prod(plan.kernel_sizes[0])
        total += 2 * _prod(size) * taps * cin * plan.stem_width
        cin = plan.stem_width

    # encoder
    for s in range(plan.num_stages):
        f = plan.features_per_stage[s]
        k = _prod(plan.kernel_sizes[s])
        out = _div(size, plan.strides[s])
        strided = any(st != 1 for st in plan.strides[s])
        is_res = plan.basic_encoder_block in ("BasicBlockD", "BottleneckBlockD")
        for b in range(plan.n_blocks_per_stage[s]):
            c_in_b = cin if b == 0 else f
            o = out
            total += 2 * _prod(o) * k * c_in_b * f          # conv1
            if is_res:
                total += 2 * _prod(o) * k * f * f           # conv2
                if b == 0 and (strided or c_in_b != f):
                    total += 2 * _prod(o) * c_in_b * f      # 1x1 skip proj
        size = out
        cin = f

    # decoders (one per task)
    n = plan.num_stages
    for task in plan.tasks:
        sz = _div(patch, [math.prod(st[d] for st in plan.strides)
                          for d in range(plan.dim)])
        c = plan.features_per_stage[-1]
        for s in range(1, n):
            skip_f = plan.features_per_stage[n - 1 - s]
            stride = plan.strides[n - s]
            up_out = tuple(a * b for a, b in zip(sz, stride))
            # UpsampleConv GEMM: every coarse voxel -> prod(k)*skip_f cols
            total += 2 * _prod(sz) * c * _prod(stride) * skip_f
            k = _prod(plan.kernel_sizes[n - 1 - s])
            c_cat = 2 * skip_f
            for b in range(plan.n_conv_per_stage_decoder[s - 1]):
                ci = c_cat if b == 0 else skip_f
                total += 2 * _prod(up_out) * k * ci * skip_f
                if plan.basic_decoder_block == "ResidualBlock":
                    total += 2 * _prod(up_out) * k * skip_f * skip_f
                    if b == 0 and ci != skip_f:
                        total += 2 * _prod(up_out) * ci * skip_f
            if plan.deep_supervision or s == n - 1:
                total += 2 * _prod(up_out) * skip_f * task.channels  # seg 1x1
            sz, c = up_out, skip_f
    return int(total)


def train_step_flops(plan: NetworkPlan, patch_size=None) -> int:
    """Full fwd+bwd MODEL FLOPs for ONE sample: dx and dW each cost ~one
    forward, so 3x forward. Remat recompute is deliberately excluded — this
    is MFU (model FLOPs utilization), not HFU; with plan.remat the hardware
    additionally executes ~1 extra forward."""
    return 3 * forward_conv_flops(plan, patch_size)


def mfu(patches_per_sec: float, flops_per_patch: int,
        peak_tflops: float = H100_PEAK_BF16_TFLOPS,
        n_devices: int = 1) -> Tuple[float, float]:
    """Returns (achieved_tflops, mfu_fraction). ``patches_per_sec`` is the
    aggregate rate over ``n_devices`` cards; MFU normalizes by the aggregate
    peak so per-card and MFU figures stay consistent."""
    achieved = patches_per_sec * flops_per_patch / 1e12
    return achieved, achieved / (peak_tflops * max(1, n_devices))
