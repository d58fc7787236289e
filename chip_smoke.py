#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100): builds the
port's CUDA kernels, holds each against its plain PyTorch version at the
flagship's shapes, runs the full-width flagship forward against the plain
fp32 path, serves a volume through ``predict_volume``, runs the full-width
flagship training step through the kernels against the plain fp32 path,
with and without squeeze-excitation, holds the fused instance-norm op
against its plain version, trains ``tasks/sheet_normals.yaml``'s network
(squeeze-excitation on) through the port's ``Trainer`` on a synthetic zarr
dataset, serves a zarr volume through the port's inference engine in each
of its model passes, runs ``tasks/ink.yaml``'s 5-stage plan at its
non-cubic patch through the kernels against the plain path, holds the
device augmentation and every optimizer of the factory on the card
against the CPU, runs the training step and the trainer with the
augmentation on the card, runs the training step and the engine's tiled
pass in several processes over ``torch.distributed``, and runs the
data-prep tools.

    python3 chip_smoke.py

(``chip_smoke.py --worker MODE ...`` is one rank of phase 14b or 15, as
the script itself starts them.)

Phases (any failure exits non-zero and prints no result line):
  1. build the kernels from ``mt3d_resenc_unet_torch/ops/csrc`` (one nvcc
     per source, all at once), print the registers, shared memory and
     spills ``-Xptxas -v`` reports (per entry for the eight tensor-core
     sources, every conv and upsample source) and the card's name and
     power limit; set the port's one precision
     (``core.config.set_precision``: TF32 off, fp32 split-K reductions in
     bf16 matmuls), as the trainer does;
  2. kernel vs plain on the card at the flagship's shapes (N=2): the conv
     at stride 1 (C=32 @128^3, 64 @64^3, 256 @16^3, 512 @8^3 and @4^3, each
     in the plain / stats / pre+stats / add-in+stats modes), at stride 2
     (32->64, 64->128, with stats) and the upsample forward (128->64,
     64->32; a GEMM on the tensor cores, as its backward). Plain
     versions run in fp32 (TF32 off). Printed per case: the max abs
     error relative to the plain output's max abs, the stats' relative
     error, the median ms of kernel, plain and the one bf16 library call of
     the same function (``library_ms``: cuDNN through F.conv3d /
     F.conv_transpose3d on the tensors viewed as channels-last NCDHW), the
     kernel's TFLOP/s and its bound (the larger of FLOPs at 989 TFLOP/s and
     bytes at 3.35 TB/s);
  3. the flagship plan (128^3 patch, 6 stages, sheet + normals heads) with
     torch-default init from seed 0: eval forward at batch 2 in bf16
     through the kernels against the plain path in fp32;
  4. serving: ``predict_volume`` on a seeded uint8 volume of (160, 256, 256)
     with patch 128^3, overlap 0.25 and batch 2; every launch counter is
     zeroed before it and the forward kernels' must be above zero after it;
  5. training: (a) the backward kernels vs plain at the flagship's shapes
     (N=2): conv dx at stride 1 in the plain / corr / corr+post modes (the
     16^3, 8^3 and 4^3 shapes split K) and at stride 2 with corr (the mode
     the step launches) and corr+post, conv dW in the plain / pre / corr /
     pre+corr modes and at stride 2 with corr, upsample dx and dW; printed
     per case: the error relative to the plain output's max abs, the
     [sum du*x; sum du] error where emitted, median ms of kernel, plain and
     library
     (``torch.nn.grad.conv3d_input`` / ``conv3d_weight``,
     ``aten.convolution_backward``), the kernel's TFLOP/s and its bound.
     (b) TRAIN_STEPS steps of the flagship training step (batch 2
     of 128^3, BCEDice + MaskedCosine, clip 3, AdamW on the cosine epoch
     schedule) through the kernels in bf16 and on the plain fp32 path from
     the same weights and a batch made from the seed with numpy (bench.py):
     per-step losses, the relative difference of the first step's
     grad_norm, the cosine of the two first-step gradients per top-level
     module, step ms, patches/s, model TFLOP/s, MFU against the card's bf16
     dense peak, and peak memory. (c) Every launch counter is zeroed before
     (b) and all nine kernels must have launched in it; its counts by shape
     and mode times the cases of 2 and 5a give each kernel's ms, library
     ms and bound per training step. Before (b), two first steps through
     the kernels from the same weights and batch are compared: whether
     their losses and grad_norm are bit-equal is printed, not held. (d)
     All nine conv and upsample kernels run twice on the same inputs at the
     flagship's shapes in the step's modes (dx at both strides with corr
     and corr+post): every output, statistic and [sum du*x; sum du] must be
     bit-equal (they sum in a fixed order, without atomics). (e) The
     flagship with ``squeeze_excitation=True`` (``tasks/sheet_normals.yaml``'s
     network), batch 2: the eval forward against plain fp32 with phase 3's
     limits, then TRAIN_STEPS steps as (b) with every counter zeroed before
     and all nine conv and upsample kernels launched, two first steps held
     bit-equal, the gradient cosines per module without the SE's
     ``reduce`` layers, whose gradients (rounding noise: their input's
     spatial mean is 0 up to rounding) are held by SE_REDUCE_ATOL on the
     max abs difference; its launches per step printed beside (c)'s;
  6. the fused instance norm + LeakyReLU (``ops/norm_act.py``) at N=2 bf16
     and the flagship's normalization shapes (128^3 x 32 ... 4^3 x 512),
     act on and off and one affine case: forward and backward through
     ``NormActFn`` (the op path: its launches are counted) against the op
     with every kernel replaced by its plain version. Printed per case: the
     y, stats and dx errors, and per kernel the median ms of kernel and
     plain and the kernel's GB/s;
  7. the trainer: a seeded synthetic sheet + normals dataset written as
     uncompressed zarr v2 (image u8 (256, 384, 384), sheet u8, normals u16)
     and ``Trainer(config_dict=...)`` on ``tasks/sheet_normals.yaml``'s
     settings, squeeze-excitation included, for 2 epochs of 6 steps and 2
     validation steps, then resumed from its checkpoint to a 3rd epoch: the
     resume must start at epoch 3 with the optimizer count at 12 and the
     parameters and momenta bit-equal to the saved ones; every launch
     counter is zeroed before and all nine conv and upsample kernels must
     have launched. Printed per epoch: losses, patches/s, t_fetch, t_step,
     the checkpoint's size and save time, and the trainer's patches/s next
     to phase 5e's step-alone rate (the same network).
  8. the zarr inference engine (``infer/engine.py::ZarrInferenceEngine``)
     with the flagship plan at full width (torch-default init from the
     seed, saved with ``save_params``), sheet + normals heads, patch 128^3,
     overlap 0.25, batch 2, ``standardize``, on a seeded u8 volume of
     (256, 512, 512) written as uncompressed zarr with 128^3 chunks:
     (a) ``device_accumulate: "auto"``, which must take the device pass
     (finals marked "finalized on device"), twice; (b) the rolling host
     pass; (c) the tiled pass at a budget of two y-bands, killed after its
     first tile and resumed, whose sums and counts must be bit-equal to an
     uninterrupted tiled run's; (d) ``postprocess_only`` twice on (b)'s
     store, which must skip the finalize and keep the finals' bits; (e) a
     uint16 copy of a (160, 256, 256) corner on the device pass against
     the rolling pass. The finals of (b), (c) and (e) are held against the
     device pass's with ``tests/test_infer_device.py``'s limits; every
     launch counter is zeroed before each run and the three forward
     kernels must be above zero after it. Printed per run, beside the
     card's name and power limit: patches/s and voxels/s (wall and loop),
     ``last_phases``, peak device memory and the host slab's peak.
  9. ``tasks/ink.yaml``'s plan (5 stages, 32-512 channels, BasicBlockD,
     the ink head with BCEWithLogitsLossZSmooth) at its (64, 192, 192)
     patch and batch 3: the eval forward against plain fp32 (ink
     probability within SHEET_TOL), INK_STEPS training steps as phase 5b
     (counters zeroed before, all nine kernels launched, peak memory; its
     grad_norm held by INK_GNORM_TOL, see there), and
     then every kernel the step launched, at each shape it launched it
     (non-cubic), against its plain version in phases 2 and 5a's modes.
 10. device augmentation (``data/augment_device.py``) on the wire-decoded
     flagship batch (2 x 128^3, u8 image and sheet, u16 normals): one
     ``AugParams`` drawn with a CUDA generator at the defaults, then every
     stage forced on with each blur type in turn; each stage applied on
     the card and, on a CPU copy of its input and the same draws, on the
     CPU, the image in fp32 (within AUG_FP32_TOL) and bf16 (within
     AUG_BF16_ULPS); flips, rot90 and the cutout mask bit-equal; ``apply``
     equal to its stages. Printed: the augmentation's ms at batch 2 back
     to back (draws included), its device time, and each blur type's ms
     with every stage on;
 11. phase 5b's flagship step with ``augment_fn=make_device_augment()``
     and a generator on the card: two first steps from the same seed held
     bit-equal (the draws included), TRAIN_STEPS steps with every counter
     zeroed before and all nine conv and upsample kernels launched; ms,
     patches/s, MFU and peak memory beside phase 5b's, launches per step
     beside 5c's, and the step's device time (torch.profiler) with the
     augmentation's share of it;
 12. phase 7 with ``augment_on_device: true`` (the dataset ships
     unaugmented wire bytes), its patches/s and ``t_fetch`` share beside
     phase 7's;
 13. every name of ``train/optimizers.py::create_optimizer`` on the
     flagship's 235.5 M parameters: 2 updates from one gradient set made
     on the card, held against the same rule on the CPU on copies of the
     largest conv kernel, a 512x512 one, a bias and a seg-head kernel
     (OPT_TOL of the move); each rule's ms per update on the card;
 14. the flagship step over ``torch.distributed`` (``parallel/``): (a) in
     this process, an NCCL group of one: DIST_STEPS steps at batch 2 from
     seeded weights bit-equal (metrics and parameters) to the same steps
     without a group, ms a step beside each other; (b) two worker
     processes on the one card over gloo (NCCL refuses two ranks on one
     device), each on one sample of the global batch of 2, so rows 1-9 run
     at N=1: the first step against (a)'s step without a group by
     TRAIN_LOSS_TOL and TRAIN_GNORM_TOL, the parameters by DIST_PARAM_TOL
     (relative L2) and DIST_PARAM_ATOL (elementwise), the first-step
     gradients by DIST_MIN_COS per module, both ranks' parameters and
     metrics bit-equal, all nine conv and upsample kernels launched; ms a
     step for each rank, the gradient all-reduce's ms and share, launches
     a step at N=1;
 15. phase 8's volume through the engine's tiled pass at
     ENGINE_MP_BUDGET_GB, whose y-band is not a multiple of the stores'
     chunks: one process, then two worker processes over gloo sharing the
     store (round-robin tiles): ``*_sum``, ``*_count`` and ``*_final``
     bit-equal, the ranks' tile sets disjoint and non-empty, both
     watermarks present; patches/s for each process;
 16. host only and tiny: PNG slices -> ``tools/tiff_to_zarr.py`` ->
     ``tools/zarr_crop.py`` -> the port's dataset, ``normals_slices`` and
     ``mesh_rasterize`` once each, on this machine's packages.
Two processes time-sharing one card measure correctness, not scaling.
Every worker process has a DIST_TIMEOUT_S limit; its failure fails the
run.
Then one JSON line of the thirteen kernels (launches, error, and ms,
plain_ms, library_ms and bound_ms summed over each kernel's cases) and,
last, the device line.

Imports torch and the port only: nothing of JAX or of the JAX package.
"""

import collections
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_TOL = 1e-2      # max |kernel - plain| / max |plain|, bf16 outputs
STATS_TOL = 1e-3       # relative error of the fp32 [sum; sumsq]
# bf16 kernels vs the fp32 plain path through the whole network; measured
# 3.6e-3 to 3.9e-3 and 0.99994 on an H100 at seed 0, so both limits keep
# >5x headroom
SHEET_TOL = 2e-2       # max |p_bf16 - p_fp32| of the sheet probability
NORMALS_MIN_COS = 0.999  # mean cosine of bf16 vs fp32 normals
# the training step, bf16 through the kernels vs fp32 plain, same weights
# and batch: limits set with >=5x headroom over the values measured on an
# H100 (NVIDIA H100 80GB HBM3, 700 W) at seed 0, written beside each. Since
# the bf16 model's plain classes round where the JAX package rounds (bf16
# operands, ops/lowp.py) the loss's difference measured 3.4e-5, 2.9x under
# its limit, which is kept; grad_norm 6.8e-4; the worst cosine 0.939
TRAIN_LOSS_TOL = 1e-4      # rel. diff of the first step's total loss; 4.6e-6
TRAIN_GNORM_TOL = 5e-3     # rel. diff of the first step's grad_norm; 4.1e-4
TRAIN_MIN_COS = 0.85       # gradient cosine per top-level module; 0.974
TRAIN_STEPS = 4
# phase 5e, the flagship with squeeze-excitation: the se.reduce gradients
# are held by their max abs difference, bf16 kernels against fp32 plain
# (their input's spatial mean is rounding noise, so the kernel's gradient
# is too, and the bias's is a small sum of near-cancelling terms); on an
# H100 (NVIDIA H100 80GB HBM3, 700 W) at seed 0: kernels 8.1e-9 and 1.0e-11
# at most, biases 1.3e-4 with differences up to 7.8e-6; limit 6.4x that
SE_REDUCE_ATOL = 5e-5
DST_TOL = 1e-3             # [sum du*x; sum du] of the pre-op backward
SEED = 0
# the card's published dense peaks (NVIDIA H100 SXM data sheet, 700 W):
# bf16 tensor cores, fp32 outside them, and HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# (stride, ci, co, extent) of the conv cases and (ci, co, extent) of the
# upsample cases: the flagship's kernel shapes at N=2
CONV_CASES = [(1, 32, 32, 128), (1, 64, 64, 64), (1, 256, 256, 16),
              (1, 512, 512, 8), (1, 512, 512, 4)]
CONV_MODES = ("plain", "stats", "pre_stats", "addin_stats")
S2_CASES = [(2, 32, 64, 128), (2, 64, 128, 64)]
UP_CASES = [(128, 64, 32), (64, 32, 64)]
DX_MODES = ("plain", "corr", "corr_post")
S2_DX_MODES = ("corr", "corr_post")
DW_MODES = ("plain", "pre", "corr", "pre_corr")
PATCH = (128, 128, 128)
VOLUME = (160, 256, 256)
# the flagship's two heads and their losses (bench.py)
FLAGSHIP_LOSSES = {"sheet": {"loss_fn": "BCEDiceLoss",
                             "loss_kwargs": {"alpha": 0.5, "beta": 0.5}},
                   "normals": {"loss_fn": "MaskedCosineLoss"}}
# phase 9: tasks/ink.yaml's plan, patch, batch and loss (the card has no
# pyyaml)
INK_PATCH = (64, 192, 192)
INK_BATCH = 3
INK_STEPS = 2
INK_MODEL = {
    "basic_encoder_block": "BasicBlockD", "basic_decoder_block": "ConvBlock",
    "bottleneck_block": "BasicBlockD",
    "features_per_stage": [32, 64, 128, 256, 512], "num_stages": 5,
    "n_blocks_per_stage": [1, 3, 4, 6, 6],
    "n_conv_per_stage_decoder": [1, 1, 1, 1], "kernel_sizes": [3] * 5,
    "strides": [1, 2, 2, 2, 2], "conv_bias": False,
    "squeeze_excitation": False}
INK_LOSSES = {"ink": {"loss_fn": "BCEWithLogitsLossZSmooth",
                      "loss_kwargs": {"center_smoothing": 0.1,
                                      "edge_smoothing": 0.4}}}
# the ink step's grad_norm, bf16 kernels against fp32 plain: measured
# 6.1e-3 on an H100 (NVIDIA H100 80GB HBM3, 700 W) at seed 0, over
# TRAIN_GNORM_TOL. The norm is the seg head's: its 32-weight kernel's
# gradient, a near-cancelling sum over 7.1 M voxels against random 0/1
# targets, moves by ~1% with the bf16 rounding of the logits and their
# cotangent (the phase prints the parameters that move the norm); loss
# and gradient cosines stay within TRAIN_LOSS_TOL and TRAIN_MIN_COS
# (3.7e-5, 0.9988). Limit ~5x the value
INK_GNORM_TOL = 3e-2
# (extent, C) of the flagship's instance norms, N=2 bf16; phase 6 runs each
# with act on and off, and the first with an affine
NORM_CASES = [(128, 32), (64, 64), (32, 128), (16, 256), (8, 512), (4, 512)]
# norm-act kernel -> (fp32 operations per element, (N, 2, C) vectors moved)
NORM_OPS = {"norm_act_stats": (3, 1), "norm_act_norm": (4, 1),
            "norm_act_bwd_stats": (6, 2), "norm_act_bwd_dx": (8, 2)}
# phase 7: the synthetic dataset and the trainer's cut of sheet_normals.yaml
TRAIN_DATA = (256, 384, 384)
TRAINER_EPOCHS = 2
TRAINER_STEPS = 6
TRAINER_VAL_STEPS = 2
WORK_DIR = "build/chip_smoke"
# phase 8: the engine's input volume (u8) and its uint16 copy's extent
ENGINE_VOLUME = (256, 512, 512)
ENGINE_U16_VOLUME = (160, 256, 256)
# the tiled pass's host-RAM budget: a 256-row y-band of the (256, 512, 512)
# volume's 24 B a voxel of sums and counts (two bands), under the 2.2 GB
# the rolling slab would take
ENGINE_TILE_BUDGET_GB = 0.75

_PC = "mt3d_resenc_unet_tpu/ops/pallas_conv.py"
_PU = "mt3d_resenc_unet_tpu/ops/pallas_upsample.py"
_PN = "mt3d_resenc_unet_tpu/ops/pallas_norm_act.py"
REPLACES = {
    "conv3d_k3_s1": f"{_PC}:381",
    "conv3d_k3_s2": f"{_PC}:1470",
    "upsample2x": f"{_PU}:59",
    "conv3d_k3_dx_s1": f"{_PC}:381",   # _conv_kernel, corr/post mode
    "conv3d_k3_dx_s2": f"{_PC}:1711",
    "conv3d_k3_dw_s1": f"{_PC}:865",
    "conv3d_k3_dw_s2": f"{_PC}:1581",
    "upsample2x_dx": f"{_PU}:70",
    "upsample2x_dw": f"{_PU}:81",
    "norm_act_stats": f"{_PN}:43",
    "norm_act_norm": f"{_PN}:63",
    "norm_act_bwd_stats": f"{_PN}:112",
    "norm_act_bwd_dx": f"{_PN}:138",
}
CONV_KERNELS = tuple(REPLACES)[:9]
NORM_KERNELS = tuple(REPLACES)[9:]
FORWARD = ("conv3d_k3_s1", "conv3d_k3_s2", "upsample2x")
_CS = "mt3d_resenc_unet_torch/ops/csrc"
SOURCES = {
    "conv3d_k3_s1": f"{_CS}/conv3d_k3_s1.cu",
    "conv3d_k3_s2": f"{_CS}/conv3d_k3_s2.cu",
    "upsample2x": f"{_CS}/upsample2x.cu",
    "conv3d_k3_dx_s1": f"{_CS}/conv3d_k3_dx_s1.cu",
    "conv3d_k3_dx_s2": f"{_CS}/conv3d_k3_dx_s2.cu",
    "conv3d_k3_dw_s1": f"{_CS}/conv3d_k3_dw_s1.cu",
    "conv3d_k3_dw_s2": f"{_CS}/conv3d_k3_dw_s2.cu",
    "upsample2x_dx": f"{_CS}/upsample2x_bwd.cu",
    "upsample2x_dw": f"{_CS}/upsample2x_bwd.cu",
    **{name: f"{_CS}/norm_act.cu" for name in NORM_KERNELS},
}


def median_ms(fn, reps=7, warmup=2):
    """Median ms of one call of ``fn`` on the card: each of ``reps``
    samples times a run of calls back to back between two CUDA events
    (enough for about 2 ms, at most 50) and divides by their number, so a
    short kernel is not charged the host's time to enqueue it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = (time.perf_counter() - t0) * 1e3
    inner = max(1, min(50, int(2.0 / max(once, 1e-3))))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def stats_err(got, want):
    """Relative error of [sum; sumsq]; sums are held against the scale
    sqrt(sumsq) because a channel's sum can cancel to near zero."""
    scale_sum = torch.maximum(want[:, 0].abs(), want[:, 1].sqrt())
    e_sum = ((got[:, 0] - want[:, 0]).abs() / scale_sum.clamp_min(1e-30))
    e_sq = ((got[:, 1] - want[:, 1]).abs() / want[:, 1].clamp_min(1e-30))
    return float(torch.maximum(e_sum.max(), e_sq.max()))


def bound(flops, nbytes, peak=PEAK_BF16):
    """The least time the card could take for ``flops`` operations (at
    ``peak``) and ``nbytes`` of device memory traffic (each input read once,
    each output written once): (ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _ext(extent):
    """A case's extent as (D, H, W): an int is a cube."""
    return tuple(extent) if isinstance(extent, tuple) else (extent,) * 3


def _at(extent) -> str:
    """"@128^3" for a cube, "@64x192x192" otherwise."""
    d, h, w = _ext(extent)
    return f"@{d}^3" if d == h == w else f"@{d}x{h}x{w}"


def conv_flops(n, ci, co, extent, stride):
    return 2 * 27 * ci * co * n * math.prod(e // stride
                                            for e in _ext(extent))


def _ncdhw(t):
    """NDHWC -> NCDHW view: channels-last-3d memory, as cuDNN takes it."""
    return t.permute(0, 4, 1, 2, 3)


def _lib_conv_w(w):
    """(k, k, k, Ci, Co) -> cuDNN's (Co, Ci, k, k, k), channels-last-3d."""
    return w.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)


def _lib_up_w(wf):
    """Flipped (2, 2, 2, Ci, Co) -> conv_transpose3d's (Ci, Co, 2, 2, 2)."""
    return wf.permute(3, 4, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)


def tensor_core_usage(logs):
    """Registers, shared memory and spills of each tensor-core kernel entry
    (nvcc -Xptxas -v), and the dynamic shared memory its launch asks for."""
    import math
    from mt3d_resenc_unet_torch.ops import conv3d as c3
    halo = math.prod(b + 2 for b in c3.S1_BRICK)
    w_chunk = 27 * c3.S1_KC * c3.S1_CT * 2
    s1 = 2 * (halo * c3.S1_KC * 2 + w_chunk)
    dw_x = math.prod(b + 2 for b in c3.DW_BRICK) * c3.DW_CT * 2
    dw_g = math.prod(c3.DW_BRICK) * c3.DW_CT * 2
    # stride 2: the (2b + 1)-wide input footprint of an output brick
    foot = {b: math.prod(2 * e + 1 for e in b)
            for b in (c3.S2_BRICK, c3.S2_PRE_BRICK, c3.DW_BRICK)}
    s2 = 2 * (foot[c3.S2_BRICK] * c3.S1_KC * 2 + w_chunk)
    s2_pre = 3 * foot[c3.S2_PRE_BRICK] * c3.S1_KC * 2 + 2 * w_chunk
    dw2_x = foot[c3.DW_BRICK] * c3.DW_CT * 2
    # dx: 2-stage rings of the stride-1 halo'd cotangent brick or the
    # stride-2 footprint q .. q + 1, with corr y's beside it, and the 27
    # taps' weights
    dx1_g = math.prod(b + 2 for b in c3.DX1_BRICK) * c3.S1_KC * 2
    dx2_g = math.prod(b + 1 for b in c3.DX2_BRICK) * c3.S1_KC * 2
    print(f"  dynamic shared memory per block: conv3d_k3_s1 {s1} B, with "
          f"pre {s1 + halo * c3.S1_KC * 2} B; conv3d_k3_dw_s1 "
          f"{2 * (dw_x + dw_g)} B, with corr {2 * (dw_x + 2 * dw_g)} B; "
          f"conv3d_k3_s2 {s2} B, with pre {s2_pre} B; conv3d_k3_dw_s2 "
          f"{2 * (dw2_x + dw_g)} B, with corr {2 * (dw2_x + 2 * dw_g)} B; "
          f"conv3d_k3_dx_s1 {2 * (dx1_g + w_chunk)} B, with corr "
          f"{2 * (2 * dx1_g + w_chunk)} B; conv3d_k3_dx_s2 "
          f"{2 * (dx2_g + w_chunk)} B, with corr "
          f"{2 * (2 * dx2_g + w_chunk)} B")
    # the upsample at the flagship's two shapes: the forward's resident
    # weights, 2-stage ring of x tiles and one (a, b)'s staged outputs; the
    # backward's dx resident weights, ring of one (a, b) x kc co and output
    # tile; dW's ring of 64 voxels of x and the tile's parities of gy
    from mt3d_resenc_unet_torch.ops import upsample as up
    for ci, co, extent in UP_CASES:
        f = up._up_fwd_plan(2, (extent,) * 3, ci, co, 132)
        p = up._up_bwd_plan(2, (extent,) * 3, ci, co, 132)
        xd, wd = p["dx"], p["dw"]
        print(f"  upsample {ci}->{co}: upsample2x {f['smem']} B (tile "
              f"{f['tm']} x {f['tco']} co, "
              f"{'weights resident' if f['resident'] else 'streamed'}), "
              f"upsample2x_dx {xd['smem']} B (tile "
              f"{xd['tm']} x {xd['tci']}, {xd['stages']} stages of "
              f"{xd['kc']} co), upsample2x_dw {wd['smem']} B (tile "
              f"{wd['pb']} x {wd['tci']} x {wd['tco']}, {wd['splits']} "
              "splits)")
    for source in ("conv3d_k3_s1", "conv3d_k3_s2", "conv3d_k3_dx_s1",
                   "conv3d_k3_dx_s2", "conv3d_k3_dw_s1", "conv3d_k3_dw_s2",
                   "upsample2x", "upsample2x_bwd"):
        entry = None
        for line in logs[source].splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and ("spill" in line or "registers" in line):
                usage = line.split(":", 1)[-1].strip()
                print(f"  {source} {entry[:60]}: {usage}")


def kernel_cases(dev, gen, conv_cases, s2_cases, up_cases, n=2,
                 timed=True):
    """Phase 2 (and the ink plan's forward cases in phase 10, untimed: no
    ms, and no library call). Returns (per-case records, failures). Each
    record holds the kernel's and the plain version's median ms, the bf16
    library call's (``library_ms``: cuDNN through F.conv3d /
    F.conv_transpose3d on the same tensors viewed as channels-last NCDHW,
    weights laid out for it before timing) and the bound. An extent is an
    int (a cube) or (D, H, W)."""
    import torch.nn.functional as F
    from mt3d_resenc_unet_torch.ops.conv3d import conv3d_k3, conv3d_k3_plain
    from mt3d_resenc_unet_torch.ops.upsample import upsample2x, upsample_plain

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def ms_of(fn):
        return median_ms(fn) if timed else None

    records, failures = [], []
    todo = [(s, ci, co, e, m) for s, ci, co, e in conv_cases
            for m in CONV_MODES]
    todo += [(s, ci, co, e, "stats") for s, ci, co, e in s2_cases]
    lib_ms = {}
    for stride, ci, co, extent, mode in todo:
        x = randn(n, *_ext(extent), ci).bfloat16()
        w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).bfloat16()
        eo = tuple(e // stride for e in _ext(extent))
        kw = dict(emit_stats=mode != "plain")
        if mode == "pre_stats":
            kw["pre"] = torch.stack(
                [torch.rand(n, ci, generator=gen) * 1.5 + 0.5,
                 torch.randn(n, ci, generator=gen)], 1).to(dev)
        if mode == "addin_stats":
            kw["add_to"] = randn(n, *eo, co).bfloat16()
        got = conv3d_k3(x, w, stride, **kw)
        want = conv3d_k3_plain(x, w, stride, **kw)
        torch.cuda.synchronize()
        if mode == "plain":
            got, want = (got, None), (want, None)
        err = rel_err(got[0], want[0])
        s_err = stats_err(got[1], want[1]) if got[1] is not None else None
        ms = ms_of(lambda: conv3d_k3(x, w, stride, **kw))
        plain_ms = ms_of(lambda: conv3d_k3_plain(x, w, stride, **kw))
        key = (stride, ci, co, extent)
        if timed and key not in lib_ms:
            # one library call per shape: the conv alone
            xl, wl = _ncdhw(x), _lib_conv_w(w)
            lib = F.conv3d(xl, wl, stride=stride, padding=1)
            # the first case of a shape is its plain or stats mode, whose
            # output is the conv alone
            print(f"  library conv3d {ci}->{co} {_at(extent)} s{stride}: err "
                  f"{rel_err(lib.permute(0, 2, 3, 4, 1), want[0]):.3e} "
                  "vs plain")
            lib_ms[key] = median_ms(
                lambda: F.conv3d(xl, wl, stride=stride, padding=1))
            del xl, wl, lib
        nbytes = 2 * (x.numel() + w.numel() + n * math.prod(eo) * co * (
            2 if "addin" in mode else 1)) + (8 * n * ci if "pre" in mode
                                             else 0) + (8 * n * co if mode
                                                        != "plain" else 0)
        b_ms, b_by = bound(conv_flops(n, ci, co, extent, stride), nbytes)
        name = f"conv3d_k3_s{stride}"
        case = f"{ci}->{co} {_at(extent)} {mode}"
        records.append(dict(kernel=name, shape=(ci, co, extent), mode=mode,
                            case=case, max_abs_err=err, stats_err=s_err,
                            ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms.get(key), bound_ms=b_ms,
                            bound_by=b_by,
                            tflops=conv_flops(n, ci, co, extent, stride)
                            / ms / 1e9 if timed else None))
        if not err <= KERNEL_TOL or (s_err is not None
                                     and not s_err <= STATS_TOL):
            failures.append(f"{name} {case}: err {err} stats {s_err}")
        del x, w, kw, got, want
    for ci, co, extent in up_cases:
        x = randn(n, *_ext(extent), ci).bfloat16()
        wf = randn(2, 2, 2, ci, co, scale=(8 * co) ** -0.5).bfloat16()
        got, want = upsample2x(x, wf), upsample_plain(x, wf)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        flops = 2 * 8 * ci * co * x.numel() // ci
        b_ms, b_by = bound(flops, 2 * (x.numel() + wf.numel() + got.numel()))
        lib = None
        if timed:
            xl, wu = _ncdhw(x), _lib_up_w(wf)
            out = F.conv_transpose3d(xl, wu, stride=2)
            print(f"  library conv_transpose3d {ci}->{co} {_at(extent)}: err "
                  f"{rel_err(out.permute(0, 2, 3, 4, 1), want):.3e} vs plain")
            lib = median_ms(lambda: F.conv_transpose3d(xl, wu, stride=2))
            del xl, wu, out
        ms = ms_of(lambda: upsample2x(x, wf))
        case = f"{ci}->{co} {_at(extent)}"
        records.append(dict(kernel="upsample2x", shape=(ci, co, extent),
                            mode="plain", case=case, max_abs_err=err,
                            stats_err=None, ms=ms,
                            plain_ms=ms_of(lambda: upsample_plain(x, wf)),
                            library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                            tflops=flops / ms / 1e9 if timed else None))
        if not err <= KERNEL_TOL:
            failures.append(f"upsample2x {case}: err {err}")
        del x, wf, got, want
    return records, failures


def flagship_models(dev, patch, **overrides):
    """The flagship plan (with the plan ``overrides``) in bf16 through the
    kernels, and the plain fp32 path with the same weights."""
    import dataclasses
    from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
    plan = plan_from_autoconfig(
        patch, 1,
        [TaskHead("sheet", 1, "sigmoid"), TaskHead("normals", 3, "none")],
        model_name="flagship", use_pallas_conv=True, **overrides)
    return paired_models(dev, plan, "flagship plan" + (
        f" {overrides}" if overrides else ""))


def paired_models(dev, plan, label):
    import dataclasses
    from mt3d_resenc_unet_torch.models.network import ResEncUNet, count_params
    fast = ResEncUNet(plan, dtype=torch.bfloat16, seed=SEED).to(dev)
    plain = ResEncUNet(dataclasses.replace(plan, use_pallas_conv=False),
                       dtype=torch.float32, seed=SEED).to(dev)
    plain.load_state_dict(fast.state_dict())
    print(f"{label}: features {plan.features_per_stage} blocks "
          f"{plan.n_blocks_per_stage} params {count_params(fast)}")
    return fast, plain


def compare_outputs(got, want, label, failures):
    sheet = float((got["sheet"] - want["sheet"]).abs().max())
    a, b = got["normals"], want["normals"]
    cos = float((torch.nn.functional.cosine_similarity(a, b, dim=-1,
                                                       eps=1e-12)).mean())
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    print(f"{label}: sheet max abs diff {sheet} normals mean cosine {cos} "
          f"finite {finite}")
    if not (sheet <= SHEET_TOL and cos >= NORMALS_MIN_COS and finite):
        failures.append(f"{label}: sheet {sheet} cosine {cos} "
                        f"finite {finite}")
    return sheet, cos


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from mt3d_resenc_unet_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable: {exc}",
              file=sys.stderr)
        return 1
    from mt3d_resenc_unet_torch.core.config import set_precision
    set_precision()
    dev = torch.device("cuda", 0)
    failures = []

    # 1. build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)}")
    # the compiler's report, kept beside each library (also for one built
    # by an earlier run)
    logs = {name: _build.build_log(name) for name in _build.SOURCES}
    for name, log in logs.items():
        usage = sorted({line.split(":", 1)[-1].strip()
                        for line in log.splitlines()
                        if "registers" in line or "spill" in line})
        print(f"  {name}: " + "; ".join(usage))
    tensor_core_usage(logs)
    print(card())

    t0 = time.perf_counter()
    rc = run(dev, CONV_CASES, S2_CASES, UP_CASES, PATCH, VOLUME,
             TRAIN_STEPS, NORM_CASES, TRAIN_DATA, ENGINE_VOLUME,
             ENGINE_U16_VOLUME, INK_PATCH, INK_BATCH)
    print(f"phases 2-16: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return rc


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run(dev, conv_cases, s2_cases, up_cases, patch, volume,
        train_steps, norm_cases, train_data, engine_volume,
        engine_u16_volume, ink_patch, ink_batch) -> int:
    """Phases 2-16 and the result lines; the case lists and sizes are
    arguments so the phases can be rehearsed at a tiny size."""
    from mt3d_resenc_unet_torch.ops import _build
    failures = []
    # 2. kernels vs plain
    gen = torch.Generator().manual_seed(SEED)
    records, fails = kernel_cases(dev, gen, conv_cases, s2_cases, up_cases)
    failures += fails
    for r in records:
        print(f"  {r['kernel']:13s} {r['case']:28s} err {r['max_abs_err']:.3e}"
              f" stats {r['stats_err'] if r['stats_err'] is None else '%.3e' % r['stats_err']}"
              f"  {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  library "
              f"{r['library_ms']:.3f} ms  {r['tflops']:.1f} TFLOP/s  bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()

    # 3. full-width flagship forward, kernels in bf16 vs plain in fp32
    fast, plain = flagship_models(dev, patch)
    x = torch.randn(2, *patch, 1, generator=gen).to(dev)
    with torch.inference_mode():
        got = fast(x)
        want = plain(x)
        torch.cuda.synchronize()
        fwd_ms = median_ms(lambda: fast(x), reps=3, warmup=1)
        plain_fwd_ms = median_ms(lambda: plain(x), reps=3, warmup=1)
    compare_outputs(got, want, f"flagship forward 2x{patch[0]}^3", failures)
    print(f"flagship forward batch 2: {fwd_ms:.1f} ms through the kernels "
          f"(bf16), {plain_fwd_ms:.1f} ms plain (fp32)")
    del got, want, x
    torch.cuda.empty_cache()

    # 4. serving through predict_volume
    from mt3d_resenc_unet_torch.data.positions import sliding_window_grid
    from mt3d_resenc_unet_torch.infer.engine import predict_volume
    vol = np.random.default_rng(SEED).integers(0, 256, volume,
                                               dtype=np.uint8)
    n_patches = len(sliding_window_grid(vol.shape, patch, 0.25))
    _build.clear_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = predict_volume(fast, vol, patch, 0.25, 2, dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"serving {vol.shape}: {n_patches} patches in {dt:.2f} s, "
          f"{n_patches / dt:.2f} patches/s, {vol.size / dt:.4g} voxels/s; "
          f"launches {launches}")
    for name, arr in pred.items():
        if arr.shape[:3] != vol.shape or not np.isfinite(arr).all():
            failures.append(f"serving: {name} shape {arr.shape} or "
                            "non-finite values")
    for name in FORWARD:
        if launches.get(name, 0) <= 0:
            failures.append(f"serving: kernel {name} was never launched")
    small = vol[:patch[0], :patch[1], :patch[2] + patch[2] // 4]
    pred_fast = predict_volume(fast, small, patch, 0.25, 2, dev)
    pred_plain = predict_volume(plain, small, patch, 0.25, 2, dev)
    compare_outputs({k: torch.from_numpy(v) for k, v in pred_fast.items()},
                    {k: torch.from_numpy(v) for k, v in pred_plain.items()},
                    f"serving blend {small.shape} bf16 kernels vs fp32 plain",
                    failures)

    del pred, pred_fast, pred_plain
    torch.cuda.empty_cache()

    # 5a. backward kernels vs plain
    bwd, fails = backward_cases(dev, gen, conv_cases, s2_cases, up_cases)
    failures += fails
    records += bwd
    for r in bwd:
        dst = "" if r["dst_err"] is None else f" dst {r['dst_err']:.3e}"
        print(f"  {r['kernel']:15s} {r['case']:32s} err {r['max_abs_err']:.3e}"
              f"{dst}  {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  "
              f"library {r['library_ms']:.3f} ms  {r['tflops']:.1f} TFLOP/s"
              f"  bound {r['bound_ms']:.3f} ms ({r['bound_by']}, "
              f"{r['bound_ms'] / r['ms']:.1%})")
    failures += deterministic_cases(dev, gen, conv_cases, s2_cases,
                                    up_cases)
    torch.cuda.empty_cache()

    # 5b, 5c. the flagship training step
    step_summary, step_launches, step_shapes, fails = training(
        fast, plain, flagship_batch(dev, patch, 2), train_steps, "flagship")
    failures += fails
    step_table(records, step_shapes, train_steps)
    del fast, plain
    torch.cuda.empty_cache()

    # 5e. the flagship with squeeze-excitation, as tasks/sheet_normals.yaml
    step_rate, fails = se_phase(dev, gen, patch, train_steps, step_launches)
    failures += fails
    torch.cuda.empty_cache()

    # 6. the fused instance norm + LeakyReLU op
    norm, norm_launches, fails = norm_act_cases(dev, gen, norm_cases)
    failures += fails
    records += norm
    for r in norm:
        print(f"  {r['kernel']:18s} {r['case']:22s} err {r['max_abs_err']:.3e}"
              f"  {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  "
              f"{r['gbs']:.0f} GB/s")
    torch.cuda.empty_cache()

    # 7. the trainer on a synthetic zarr dataset
    train_launches, fails, host_trainer = trainer_phase(patch, train_data,
                                                        step_rate)
    failures += fails
    launches = {**{k: train_launches.get(k, 0) for k in CONV_KERNELS},
                **{k: norm_launches.get(k, 0) for k in NORM_KERNELS}}
    failures += [f"kernels line: {k} has no launches"
                 for k, v in launches.items() if v <= 0]

    # 8. the zarr inference engine at full width
    failures += engine_phase(patch, engine_volume, engine_u16_volume)

    # 9. tasks/ink.yaml's 5-stage plan at its patch and batch
    failures += ink_phase(dev, gen, ink_patch, ink_batch)

    # 10. device augmentation at the flagship batch, card against CPU
    aug_ms, fails = augment_phase(dev, patch)
    failures += fails
    torch.cuda.empty_cache()

    # 11. the flagship training step with device augmentation
    failures += augmented_step_phase(dev, patch, train_steps, step_summary,
                                     step_launches, aug_ms)
    torch.cuda.empty_cache()

    # 12. phase 7's trainer with augment_on_device: true
    _, fails, _ = trainer_phase(patch, train_data, step_rate,
                                device_augment=True, host=host_trainer)
    failures += fails
    torch.cuda.empty_cache()

    # 13. every optimizer of the factory on the flagship's parameters
    failures += optimizer_phase(dev, patch)
    torch.cuda.empty_cache()

    # 14. the flagship step over torch.distributed
    failures += dist_step_phase(dev, patch, DIST_STEPS)
    torch.cuda.empty_cache()

    # 15. the engine's tiled pass in two processes over one store
    failures += dist_engine_phase(patch, engine_volume)
    torch.cuda.empty_cache()

    # 16. the data-prep tools on this machine's packages
    failures += tools_phase()

    if failures:
        print("FAILED:\n  " + "\n  ".join(failures))
        return 1
    kernels = []
    for name in REPLACES:
        mine = [r for r in records if r["kernel"] == name]
        by = collections.Counter()
        for r in mine:
            by[r["bound_by"]] += r["bound_ms"]
        lib = [r["library_ms"] for r in mine if r["library_ms"] is not None]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches.get(name, 0),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=sum(r["ms"] for r in mine),
            plain_ms=sum(r["plain_ms"] for r in mine),
            bound_ms=sum(r["bound_ms"] for r in mine),
            bound_by=by.most_common(1)[0][0],
            library_ms=sum(lib) if len(lib) == len(mine) else None))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def backward_cases(dev, gen, conv_cases, s2_cases, up_cases, n=2,
                   timed=True):
    """Phase 5a (and the ink plan's backward cases in phase 10, untimed).
    Returns (per-case records, failures). ``library_ms`` is the bf16 cuDNN
    call of the same function: ``torch.nn.grad.conv3d_input`` /
    ``conv3d_weight`` for the conv, ``aten.convolution_backward`` of the
    transposed conv for the upsample, timed once per shape."""
    from mt3d_resenc_unet_torch.ops.conv3d import (conv3d_k3_dw,
                                                   conv3d_k3_dw_plain,
                                                   conv3d_k3_dx,
                                                   conv3d_k3_dx_plain)
    from mt3d_resenc_unet_torch.ops.upsample import (upsample2x_dw,
                                                     upsample2x_dw_plain,
                                                     upsample2x_dx,
                                                     upsample2x_dx_plain)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def ms_of(fn):
        return median_ms(fn) if timed else None

    records, failures = [], []
    todo = [(s, ci, co, e, "dx", m) for s, ci, co, e in conv_cases
            for m in DX_MODES]
    todo += [(s, ci, co, e, "dw", m) for s, ci, co, e in conv_cases
             for m in DW_MODES]
    todo += [(s, ci, co, e, "dx", m) for s, ci, co, e in s2_cases
             for m in S2_DX_MODES]
    todo += [(s, ci, co, e, "dw", "corr") for s, ci, co, e in s2_cases]
    lib_ms = {}
    for stride, ci, co, extent, op, mode in todo:
        eo = tuple(e // stride for e in _ext(extent))
        x = randn(n, *_ext(extent), ci).bfloat16()
        w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).bfloat16()
        gy = randn(n, *eo, co).bfloat16()
        kw = {}
        if "corr" in mode:
            kw.update(y=randn(n, *eo, co).bfloat16(),
                      gs=randn(n, 2, co, scale=0.1))
        if mode in ("pre", "pre_corr", "corr_post"):
            kw["pre"] = torch.stack(
                [torch.rand(n, ci, generator=gen) * 1.5 + 0.5,
                 torch.randn(n, ci, generator=gen)], 1).to(dev)
        if op == "dx":
            if "pre" in kw:
                kw["x"] = x
            fn = lambda: conv3d_k3_dx(gy, w, stride, size=x.shape[1:4], **kw)
            ref = lambda: conv3d_k3_dx_plain(gy, w, stride,
                                             size=x.shape[1:4], **kw)
            lib = lambda: torch.nn.grad.conv3d_input(
                xl.shape, wl, gl, stride=stride, padding=1)
        else:
            fn = lambda: conv3d_k3_dw(x, gy, stride, **kw)
            ref = lambda: conv3d_k3_dw_plain(x, gy, stride, **kw)
            lib = lambda: torch.nn.grad.conv3d_weight(
                xl, wl.shape, gl, stride=stride, padding=1)
        got, want = fn(), ref()
        torch.cuda.synchronize()
        dst_err = None
        if isinstance(got, tuple):
            dst_err = rel_err(got[1], want[1])
            got, want = got[0], want[0]
        err = rel_err(got, want)
        ms, plain_ms = ms_of(fn), ms_of(ref)
        key = (op, stride, ci, co, extent)
        if timed and key not in lib_ms:
            # the first case of a shape is its plain mode
            xl, wl, gl = _ncdhw(x), _lib_conv_w(w), _ncdhw(gy)
            out = lib()
            if op == "dx":
                out = out.permute(0, 2, 3, 4, 1)
            else:
                out = out.permute(2, 3, 4, 1, 0)
            print(f"  library {op} {ci}->{co} {_at(extent)} s{stride}: err "
                  f"{rel_err(out, want):.3e} vs plain ({mode})")
            lib_ms[key] = median_ms(lib)
            del xl, wl, gl, out
        flops = conv_flops(n, ci, co, extent, stride)
        io = x.numel() if op == "dw" or "post" in mode else 0
        nbytes = 2 * (io + gy.numel()) + (
            2 * gy.numel() + 8 * n * co if "corr" in mode else 0) + (
            8 * n * ci if "pre" in kw else 0) + (
            2 * (x.numel() + w.numel()) + (8 * n * ci if "post" in mode
                                           else 0)
            if op == "dx" else 4 * w.numel())
        b_ms, b_by = bound(flops, nbytes)
        name = f"conv3d_k3_{op}_s{stride}"
        case = f"{ci}->{co} {_at(extent)} {mode}"
        records.append(dict(kernel=name, shape=(ci, co, extent), mode=mode,
                            case=case, max_abs_err=err, dst_err=dst_err,
                            ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms.get(key), bound_ms=b_ms,
                            bound_by=b_by,
                            tflops=flops / ms / 1e9 if timed else None))
        if not err <= KERNEL_TOL or (dst_err is not None
                                     and not dst_err <= DST_TOL):
            failures.append(f"{name} {case}: err {err} dst {dst_err}")
        del x, w, gy, kw, got, want, fn, ref
    for ci, co, extent in up_cases:
        x = randn(n, *_ext(extent), ci).bfloat16()
        wf = randn(2, 2, 2, ci, co, scale=(8 * co) ** -0.5).bfloat16()
        gy = randn(n, *(2 * e for e in _ext(extent)), co).bfloat16()
        xl, wu, gl = _ncdhw(x), _lib_up_w(wf), _ncdhw(gy)

        def conv_bwd(mask):
            return torch.ops.aten.convolution_backward(
                gl, xl, wu, None, [2] * 3, [0] * 3, [1] * 3, True, [0] * 3, 1,
                mask)

        flops = 2 * 8 * ci * co * x.numel() // ci
        for name, fn, ref, lib, out_bytes in (
                ("upsample2x_dx", lambda: upsample2x_dx(gy, wf),
                 lambda: upsample2x_dx_plain(gy, wf),
                 lambda: conv_bwd([True, False, False]), 2 * x.numel()),
                ("upsample2x_dw", lambda: upsample2x_dw(x, gy),
                 lambda: upsample2x_dw_plain(x, gy),
                 lambda: conv_bwd([False, True, False]), 4 * wf.numel())):
            got, want = fn(), ref()
            torch.cuda.synchronize()
            err = rel_err(got, want)
            ms, plain_ms = ms_of(fn), ms_of(ref)
            case = f"{ci}->{co} {_at(extent)}"
            nbytes = 2 * gy.numel() + out_bytes + (
                2 * wf.numel() if name == "upsample2x_dx" else 2 * x.numel())
            b_ms, b_by = bound(flops, nbytes)
            records.append(dict(kernel=name, shape=(ci, co, extent),
                                mode="plain", case=case, max_abs_err=err,
                                dst_err=None, ms=ms, plain_ms=plain_ms,
                                library_ms=ms_of(lib), bound_ms=b_ms,
                                bound_by=b_by,
                                tflops=flops / ms / 1e9 if timed else None))
            if not err <= KERNEL_TOL:
                failures.append(f"{name} {case}: err {err}")
            del got, want
        del x, wf, gy, xl, wu, gl
    return records, failures


def deterministic_cases(dev, gen, conv_cases, s2_cases, up_cases):
    """Phase 5d: all nine conv and upsample kernels twice each on the same
    inputs at the flagship's shapes, in the training step's modes (forward
    with stats, pre-op + stats and add-in + stats; dx with the correction,
    and with the pre-op backward too; dW with the correction, and with the
    pre-op at stride 1; the upsample forward, dx and dW). Every
    output, statistic and [sum du*x; sum du] must be bit-equal: the kernels
    sum in a fixed order, without atomics. Returns the failures."""
    from mt3d_resenc_unet_torch.ops.conv3d import (conv3d_k3, conv3d_k3_dw,
                                                   conv3d_k3_dx)
    from mt3d_resenc_unet_torch.ops.upsample import (upsample2x,
                                                     upsample2x_dw,
                                                     upsample2x_dx)
    failures, n = [], 2

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def check(name, case, fn):
        runs = [fn() for _ in range(2)]
        torch.cuda.synchronize()
        runs = [r if isinstance(r, tuple) else (r,) for r in runs]
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        print(f"  deterministic {name:16s} {case}: bit-equal {same}")
        if not same:
            failures.append(f"{name} {case}: two runs differ")

    for stride, ci, co, extent in list(conv_cases) + list(s2_cases):
        eo = extent // stride
        x = randn(n, extent, extent, extent, ci).bfloat16()
        w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).bfloat16()
        gy, y = (randn(n, eo, eo, eo, co).bfloat16() for _ in range(2))
        gs = randn(n, 2, co, scale=0.1)
        pre = torch.stack([torch.rand(n, ci, generator=gen) * 1.5 + 0.5,
                           torch.randn(n, ci, generator=gen)], 1).to(dev)
        shape = f"{ci}->{co} @{extent}^3"
        for mode, kw in (("stats", {}), ("pre_stats", {"pre": pre}),
                         ("addin_stats", {"add_to": y})):
            check(f"conv3d_k3_s{stride}", f"{shape} {mode}",
                  lambda: conv3d_k3(x, w, stride, emit_stats=True, **kw))
        dx_modes = [("corr", {}), ("corr_post", {"x": x, "pre": pre})]
        dw_modes = [("corr", {})]
        if stride == 1:
            dw_modes.append(("pre_corr", {"pre": pre}))
        for mode, kw in dx_modes:
            check(f"conv3d_k3_dx_s{stride}", f"{shape} {mode}",
                  lambda: conv3d_k3_dx(gy, w, stride, y, gs,
                                       size=x.shape[1:4], **kw))
        for mode, kw in dw_modes:
            check(f"conv3d_k3_dw_s{stride}", f"{shape} {mode}",
                  lambda: conv3d_k3_dw(x, gy, stride, y=y, gs=gs, **kw))
        del x, w, gy, y, gs, pre
    for ci, co, extent in up_cases:
        x = randn(n, extent, extent, extent, ci).bfloat16()
        wf = randn(2, 2, 2, ci, co, scale=(8 * co) ** -0.5).bfloat16()
        gy = randn(n, 2 * extent, 2 * extent, 2 * extent, co).bfloat16()
        shape = f"{ci}->{co} @{extent}^3"
        check("upsample2x", shape, lambda: upsample2x(x, wf))
        check("upsample2x_dx", shape, lambda: upsample2x_dx(gy, wf))
        check("upsample2x_dw", shape, lambda: upsample2x_dw(x, gy))
        del x, wf, gy
    return failures


def step_repeatability(model, batch, losses, augment_fn=None):
    """Two first training steps through the kernels from the same weights
    and batch (and, with ``augment_fn``, the same generator seed): prints
    whether their metrics (losses, grad_norm) are bit-equal and returns
    it; the weights are restored after."""
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    runs = []
    for i in range(2):
        model.load_state_dict(state)
        runs.append(train_path(model, batch, 1, f"repeat {i}", losses,
                               augment_fn)[0][0])
    model.load_state_dict(state)
    del state
    same = runs[0] == runs[1]
    diff = {k: runs[1][k] - v for k, v in runs[0].items() if runs[1][k] != v}
    print(f"train step repeatability: two first steps from the same weights "
          f"and batch bit-equal {same}" + (f" (differences {diff})"
                                           if not same else ""))
    return same


def flagship_batch(dev, patch, n):
    """bench.py's float batch (bench.py:113-119), made from the seed with
    numpy."""
    rng = np.random.default_rng(SEED)
    batch = {
        "image": rng.random((n,) + patch + (1,), np.float32),
        "sheet": (rng.random((n,) + patch + (1,)) > 0.5).astype(np.float32),
        "normals": rng.standard_normal((n,) + patch + (3,)).astype(
            np.float32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def train_path(model, batch, steps, label, losses, augment_fn=None):
    """Runs ``steps`` training steps from the model's current weights with
    the task ``losses`` (``build_task_losses``' config, weight 1 each) and,
    given an ``augment_fn``, a generator on the card seeded SEED + 1 for
    it, as the trainer seeds its own; returns (per-step metrics, median
    step ms, peak bytes, first-step gradients by parameter name)."""
    from mt3d_resenc_unet_torch.train.losses import build_task_losses
    from mt3d_resenc_unet_torch.train.step import (build_optimizer,
                                                   cosine_epoch_schedule,
                                                   make_train_step)
    opt = build_optimizer(model.parameters(), "AdamW",
                          cosine_epoch_schedule(1e-3, 500, 250),
                          weight_decay=1e-4, grad_clip_norm=3.0)
    gen = None
    if augment_fn is not None:
        gen = torch.Generator(device=batch["image"].device).manual_seed(
            SEED + 1)
    step = make_train_step(model, build_task_losses(losses),
                           {task: 1.0 for task in losses}, generator=gen,
                           augment_fn=augment_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, times, grads = [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        m = step(opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {name: p.grad.detach().clone()
                     for name, p in model.named_parameters()
                     if p.grad is not None}
        print(f"  {label} step {i}: " + " ".join(
            f"{k} {v:.6f}" for k, v in metrics[-1].items())
            + f"  {times[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated()
    del opt, step
    model.zero_grad(set_to_none=True)
    model.eval()
    return metrics, statistics.median(times[1:] or times), peak, grads


def training(fast, plain, batch, steps, label, losses=FLAGSHIP_LOSSES,
             absolute=(), hold_repeat=False, gnorm_tol=TRAIN_GNORM_TOL):
    """Phases 5b-5c (and 5e, 9): two first steps through the kernels
    (bit-equal or not: held with ``hold_repeat``), then ``steps`` steps of
    the kernel path in bf16 with every launch counter zeroed before and
    read after, and of the plain fp32 path from the same weights; their
    first steps compared: the total loss and grad_norm by relative
    difference (TRAIN_LOSS_TOL, ``gnorm_tol``), the gradients by cosine
    per top-level module, except the parameters whose name holds one of
    ``absolute``, whose gradients are held by SE_REDUCE_ATOL on the max
    abs difference. Returns (a summary of the kernel path, its launch
    counts by kernel, by shape and mode, failures); the summary holds the
    kernel path's patches/s (``rate``), median step ``ms`` and ``peak``
    bytes."""
    from mt3d_resenc_unet_torch.ops import _build
    from mt3d_resenc_unet_torch.utils.flops import (H100_PEAK_BF16_TFLOPS,
                                                     mfu, train_step_flops)
    n = batch["image"].shape[0]
    failures = []
    same = step_repeatability(fast, batch, losses)
    if hold_repeat and not same:
        failures.append(f"{label}: two first steps differ")
    torch.cuda.empty_cache()
    plain.load_state_dict(fast.state_dict())
    _build.clear_counts()
    got = train_path(fast, batch, steps, f"{label} kernels bf16", losses)
    launches = dict(_build.LAUNCHES)
    shapes = dict(_build.LAUNCH_SHAPES)
    torch.cuda.empty_cache()
    want = train_path(plain, batch, steps, f"{label} plain fp32", losses)
    print(f"{label} training launches {launches}")
    flops = train_step_flops(fast.plan, tuple(batch["image"].shape[1:4]))
    smi = card()
    for (metrics, ms, peak, _), path in ((got, "kernels bf16"),
                                         (want, "plain fp32")):
        tflops, frac = mfu(n / (ms / 1e3), flops)
        print(f"{label} train step {path} [{smi}]: {ms:.1f} ms median, "
              f"{n / (ms / 1e3):.3f} patches/s, {tflops:.2f} model TFLOP/s, "
              f"MFU {frac:.4f} of {H100_PEAK_BF16_TFLOPS} TFLOP/s bf16, "
              f"peak memory {peak / 2 ** 30:.2f} GiB")
        for i, m in enumerate(metrics):
            if not all(np.isfinite(v) for v in m.values()):
                failures.append(f"{label} {path} step {i}: non-finite {m}")
    m0, p0 = got[0][0], want[0][0]
    loss_diff = abs(m0["total_loss"] - p0["total_loss"]) / abs(
        p0["total_loss"])
    gn_diff = abs(m0["grad_norm"] - p0["grad_norm"]) / p0["grad_norm"]
    print(f"{label} first step: total loss rel diff {loss_diff:.3e} "
          f"(limit {TRAIN_LOSS_TOL}), grad_norm rel diff {gn_diff:.3e} "
          f"(limit {gnorm_tol})")
    if not (loss_diff <= TRAIN_LOSS_TOL and gn_diff <= gnorm_tol):
        failures.append(f"{label}: loss diff {loss_diff} grad_norm diff "
                        f"{gn_diff}")
    g_fast, g_plain = got[3], want[3]
    # which parameters move the squared norm between the two paths
    moves = sorted(((float(g_fast[k].float().square().sum()
                           - g_plain[k].square().sum()), k) for k in g_fast),
                   key=lambda t: -abs(t[0]))
    total = sum(d for d, _ in moves)
    print(f"{label} first step: grad_norm^2 kernels - plain {total:.3e}, "
          "largest parts " + ", ".join(f"{k} {d:.3e}" for d, k in moves[:3]))
    modules = collections.defaultdict(list)
    worst = (0.0, None)
    for name in g_fast:
        if any(a in name for a in absolute):
            diff = float((g_fast[name] - g_plain[name]).abs().max())
            worst = max(worst, (diff, name), key=lambda t: t[0])
            continue
        modules[name.split(".")[0]].append(name)
    for mod, names in modules.items():
        cos = float(torch.nn.functional.cosine_similarity(
            torch.cat([g_fast[k].flatten() for k in names]),
            torch.cat([g_plain[k].flatten() for k in names]), dim=0))
        print(f"{label} first-step gradient cosine {mod}"
              + (f" without {absolute}" if absolute else "")
              + f": {cos:.6f} (limit {TRAIN_MIN_COS})")
        if not cos >= TRAIN_MIN_COS:
            failures.append(f"{label}: gradient cosine {mod} {cos}")
    if absolute:
        held = collections.defaultdict(list)
        for k in g_fast:
            if any(a in k for a in absolute):
                held[k.rsplit(".", 1)[-1]].append(k)
        for kind, names in held.items():
            print(f"{label} first-step gradients of {len(names)} {absolute} "
                  f"{kind} tensors: max abs " + ", ".join(
                      f"{max(float(g[k].abs().max()) for k in names):.3e} "
                      f"({path})" for g, path in ((g_fast, "kernels bf16"),
                                                  (g_plain, "plain fp32")))
                  + ", max abs difference " + "%.3e" % max(
                      float((g_fast[k] - g_plain[k]).abs().max())
                      for k in names))
        print(f"{label}: worst {absolute} gradient difference {worst[0]:.3e}"
              f" at {worst[1]} (limit {SE_REDUCE_ATOL})")
        if not worst[0] <= SE_REDUCE_ATOL:
            failures.append(f"{label}: {worst[1]} gradient differs by "
                            f"{worst[0]}")
    summary = {"rate": n / (got[1] / 1e3), "ms": got[1], "peak": got[2]}
    del g_fast, g_plain, got, want
    for name in CONV_KERNELS:
        if launches.get(name, 0) <= 0:
            failures.append(f"{label}: kernel {name} was never launched")
    return summary, launches, shapes, failures


def se_phase(dev, gen, patch, steps, flagship_launches):
    """Phase 5e: the flagship with ``squeeze_excitation=True`` at full
    width, batch 2: the eval forward, bf16 through the kernels against
    plain fp32 (phase 3's limits), then the training step as phase 5b, with
    two first steps held bit-equal and the se.reduce gradients held by an
    absolute limit. Its launches per step are printed beside phase 5c's.
    Returns (the kernel path's patches/s, failures)."""
    failures = []
    fast, plain = flagship_models(dev, patch, squeeze_excitation=True)
    x = torch.randn(2, *patch, 1, generator=gen).to(dev)
    with torch.inference_mode():
        got = fast(x)
        want = plain(x)
        torch.cuda.synchronize()
        fwd_ms = median_ms(lambda: fast(x), reps=3, warmup=1)
    compare_outputs(got, want, f"SE flagship forward 2x{patch[0]}^3",
                    failures)
    print(f"SE flagship forward batch 2 [{card()}]: {fwd_ms:.1f} ms "
          "through the kernels (bf16)")
    del got, want, x
    torch.cuda.empty_cache()
    summary, launches, _, fails = training(
        fast, plain, flagship_batch(dev, patch, 2), steps, "SE flagship",
        absolute=("se.reduce",), hold_repeat=True)
    failures += fails
    per_step = {k: launches.get(k, 0) / steps for k in CONV_KERNELS}
    base = {k: flagship_launches.get(k, 0) / steps for k in CONV_KERNELS}
    print(f"SE flagship launches per step {per_step}; without SE (phase "
          f"5c) {base}: {'equal' if per_step == base else 'they differ'}")
    del fast, plain
    return summary["rate"], failures


def ink_phase(dev, gen, patch, n):
    """Phase 9: ``tasks/ink.yaml``'s 5-stage plan (32-512 channels) at its
    (64, 192, 192) patch and batch 3 in bf16 through the kernels against
    plain fp32: the eval forward (the ink head's probability within
    SHEET_TOL), then the training step as phase 5b with its
    BCEWithLogitsLossZSmooth loss and peak memory; then every kernel the
    step launched, at each non-cubic shape it launched it, against its
    plain version in each mode of phases 2 and 5a (untimed). Returns the
    failures."""
    import dataclasses
    from mt3d_resenc_unet_torch.core.plan import (TaskHead,
                                                  plan_from_manual_config)
    failures = []
    plan = dataclasses.replace(plan_from_manual_config(
        INK_MODEL, patch, 1, [TaskHead("ink", 1, "sigmoid")],
        model_name="ink"), use_pallas_conv=True)
    fast, plain = paired_models(dev, plan, f"ink plan {patch} batch {n}")
    x = torch.randn(n, *patch, 1, generator=gen).to(dev)
    with torch.inference_mode():
        got = fast(x)["ink"]
        want = plain(x)["ink"]
        torch.cuda.synchronize()
        fwd_ms = median_ms(lambda: fast(x), reps=3, warmup=1)
    diff = float((got - want).abs().max())
    finite = bool(torch.isfinite(got).all())
    print(f"ink forward batch {n} [{card()}]: ink max abs diff {diff} "
          f"(limit {SHEET_TOL}), finite {finite}, {fwd_ms:.1f} ms through "
          "the kernels (bf16)")
    if not (diff <= SHEET_TOL and finite):
        failures.append(f"ink forward: diff {diff} finite {finite}")
    del got, want, x
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in {
        "image": rng.random((n,) + patch + (1,), np.float32),
        "ink": (rng.random((n,) + patch + (1,)) > 0.5).astype(
            np.float32)}.items()}
    _, launches, shapes, fails = training(fast, plain, batch, INK_STEPS,
                                          "ink", losses=INK_LOSSES,
                                          gnorm_tol=INK_GNORM_TOL)
    failures += fails
    del fast, plain, batch
    torch.cuda.empty_cache()
    print("ink launches per step by shape and mode: " + ", ".join(
        f"{k} {ci}->{co} {_at((d, h, w))} {mode} {c / INK_STEPS:g}"
        for (k, (ci, co, d, h, w), mode), c in sorted(shapes.items())))

    def launched(kernel):
        return sorted({(ci, co, (d, h, w)) for (k, (ci, co, d, h, w), _)
                       in shapes if k == kernel})

    conv = [(1, *c) for c in launched("conv3d_k3_s1")]
    s2 = [(2, *c) for c in launched("conv3d_k3_s2")]
    up = launched("upsample2x")
    records, fails = kernel_cases(dev, gen, conv, s2, up, n=n, timed=False)
    failures += fails
    bwd, fails = backward_cases(dev, gen, conv, s2, up, n=n, timed=False)
    failures += fails
    records += bwd
    for r in records:
        extra = r.get("stats_err") if r.get("stats_err") is not None \
            else r.get("dst_err")
        print(f"  ink {r['kernel']:15s} {r['case']:34s} err "
              f"{r['max_abs_err']:.3e}"
              + (f" stats/dst {extra:.3e}" if extra is not None else ""))
    for name in CONV_KERNELS:
        if not any(r["kernel"] == name for r in records):
            failures.append(f"ink: kernel {name} was not held against its "
                            "plain version")
    torch.cuda.empty_cache()
    return failures


def step_table(records, shapes, steps):
    """The kernel table's per-step columns: each conv and upsample
    kernel's launches per training step (phase 5c's counts by shape and
    mode) times its phase-2 or 5a case of the same shape and mode: the
    kernel's ms, the library call's, the bound and the kernel / library
    factor per step. A launch whose mode has no case takes the shape's
    first case (marked)."""
    cases = {}
    for r in records:
        if "shape" in r:
            cases.setdefault((r["kernel"], r["shape"], r["mode"]), r)
            cases.setdefault((r["kernel"], r["shape"], None), r)
    print("per training step (phase 5c launches x phase 2 / 5a cases):")
    for name in CONV_KERNELS:
        tot, by, stand_in = collections.Counter(), collections.Counter(), []
        for (kname, shape, mode), count in sorted(shapes.items()):
            if kname != name:
                continue
            per = count / steps
            tot["launches"] += per
            ci, co, d, h, w = shape
            r = cases.get((name, (ci, co, d), mode))
            if r is None:
                r = cases.get((name, (ci, co, d), None))
                stand_in.append(f"{ci}->{co} @{d}x{h}x{w} {mode}")
            if r is None or not d == h == w:
                tot["uncovered"] += per
                continue
            for k in ("ms", "library_ms", "bound_ms"):
                tot[k] += per * r[k]
            by[r["bound_by"]] += per * r["bound_ms"]
        mix = ", ".join(f"{shape[0]}->{shape[1]} @{shape[2]}^3 {mode} "
                        f"{count / steps:g}" for (kname, shape, mode), count
                        in sorted(shapes.items()) if kname == name)
        if mix:
            print(f"  {name} launches per step by shape and mode: {mix}")
        factor = tot["ms"] / tot["library_ms"] if tot["library_ms"] else 0.0
        print(f"  {name:16s} {tot['launches']:5.1f} launches  kernel "
              f"{tot['ms']:8.3f} ms  library {tot['library_ms']:8.3f} ms  "
              f"bound {tot['bound_ms']:7.3f} ms ("
              f"{by.most_common(1)[0][0] if by else '-'})  kernel/library "
              f"{factor:.2f}x" + (f"  uncovered {tot['uncovered']:.1f}"
                                  if tot["uncovered"] else "")
              + (f"  stand-in cases for {stand_in}" if stand_in else ""))


def _norm_act_plain_op(x, scale, bias, act, gy, eps, slope):
    """``instance_norm_act_fused`` forward and backward with every kernel
    replaced by its plain version; returns (y, stats, dx)."""
    from mt3d_resenc_unet_torch.ops import norm_act as na
    n, c = x.shape[0], x.shape[-1]
    x2 = x.reshape(n, -1, c)
    fuse = act and scale is None
    stats = na.norm_act_stats_plain(x2, eps)
    yn = na.norm_act_norm_plain(x2, stats, slope, fuse).reshape(x.shape)
    yn.requires_grad_()
    y = yn
    if scale is not None:
        y = y * scale.to(y.dtype) + bias.to(y.dtype)
        y = na._leaky(y, slope) if act else y
    (gn,) = torch.autograd.grad(y, yn, gy)
    g2 = gn.reshape(x2.shape).contiguous()
    gsums = na.norm_act_bwd_stats_plain(x2, stats, g2, slope, fuse)
    dx = na.norm_act_bwd_dx_plain(x2, stats, gsums, g2, slope, fuse)
    return y.detach(), stats, dx.reshape(x.shape)


def _mean_inv_err(got, want):
    """Error of (N, 2, C) [mean; inv]: the mean's against the standard
    deviation 1/inv, inv's relative."""
    inv = want[:, 1]
    return float(torch.maximum(((got[:, 0] - want[:, 0]).abs() * inv).max(),
                               ((got[:, 1] - inv).abs() / inv).max()))


def norm_act_cases(dev, gen, cases):
    """Phase 6. Returns (per-kernel records, the op path's launch counts,
    failures)."""
    import collections
    from mt3d_resenc_unet_torch.ops import _build
    from mt3d_resenc_unet_torch.ops import norm_act as na
    eps, slope, n = 1e-5, 1e-2, 2
    records, failures = [], []
    op_launches = collections.Counter()
    todo = [(e, c, act, False) for e, c in cases for act in (True, False)]
    todo.insert(1, (cases[0][0], cases[0][1], True, True))
    for extent, c, act, affine in todo:
        shape = (n, extent, extent, extent, c)
        x = (torch.randn(*shape, generator=gen) * 2 + 0.5).to(dev).bfloat16()
        gy = torch.randn(*shape, generator=gen).to(dev).bfloat16()
        scale = bias = None
        if affine:
            scale = (torch.rand(c, generator=gen) + 0.5).to(dev)
            bias = torch.randn(c, generator=gen).to(dev)
        label = (f"{extent}^3 x {c} " + ("affine" if affine else
                                         "act" if act else "no act"))
        # the op path: forward and backward through NormActFn
        before = dict(_build.LAUNCHES)
        xg = x.clone().requires_grad_()
        y = na.instance_norm_act_fused(xg, scale, bias, eps=eps,
                                       negative_slope=slope, act=act)
        y.backward(gy)
        torch.cuda.synchronize()
        for k, v in _build.LAUNCHES.items():
            op_launches[k] += v - before.get(k, 0)
        y0, st0, dx0 = _norm_act_plain_op(x, scale, bias, act, gy, eps,
                                          slope)
        y_err, dx_err = rel_err(y.detach(), y0), rel_err(xg.grad, dx0)
        # each kernel against its plain version on the same inputs
        fuse = act and not affine
        x2, g2 = x.reshape(n, -1, c), gy.reshape(n, -1, c)
        with torch.no_grad():
            st = na.norm_act_stats(x2, eps)
            gs = na.norm_act_bwd_stats(x2, st, g2, slope, fuse)
            pairs = {
                "norm_act_stats": (
                    lambda: na.norm_act_stats(x2, eps),
                    lambda: na.norm_act_stats_plain(x2, eps), 1),
                "norm_act_norm": (
                    lambda: na.norm_act_norm(x2, st, slope, fuse),
                    lambda: na.norm_act_norm_plain(x2, st, slope, fuse), 2),
                "norm_act_bwd_stats": (
                    lambda: na.norm_act_bwd_stats(x2, st, g2, slope, fuse),
                    lambda: na.norm_act_bwd_stats_plain(x2, st, g2, slope,
                                                        fuse), 2),
                "norm_act_bwd_dx": (
                    lambda: na.norm_act_bwd_dx(x2, st, gs, g2, slope, fuse),
                    lambda: na.norm_act_bwd_dx_plain(x2, st, gs, g2, slope,
                                                     fuse), 3),
            }
            errs = {"norm_act_stats": _mean_inv_err(st, st0)}
            for name in ("norm_act_norm", "norm_act_bwd_stats",
                         "norm_act_bwd_dx"):
                got, want = pairs[name][0](), pairs[name][1]()
                errs[name] = rel_err(got, want)
            torch.cuda.synchronize()
            for name, (fn, ref, tensors) in pairs.items():
                ms, plain_ms = median_ms(fn), median_ms(ref)
                # fp32 operations per element on the CUDA cores and the
                # (N, 2, C) fp32 vectors read or written beside the tensors
                ops, vecs = NORM_OPS[name]
                b_ms, b_by = bound(ops * x.numel(), tensors * x.numel()
                                   * x.element_size() + vecs * 8 * n * c,
                                   PEAK_FP32)
                records.append(dict(
                    kernel=name, case=label, max_abs_err=errs[name], ms=ms,
                    plain_ms=plain_ms, library_ms=median_ms(
                        lambda: torch.var_mean(x2, dim=1))
                    if name == "norm_act_stats" else None,
                    bound_ms=b_ms, bound_by=b_by,
                    gbs=tensors * x.numel() * x.element_size() / ms / 1e6))
        tol = {"norm_act_stats": STATS_TOL, "norm_act_bwd_stats": STATS_TOL}
        print(f"norm-act {label}: y err {y_err:.3e} dx err {dx_err:.3e} "
              + " ".join(f"{k.removeprefix('norm_act_')} {v:.3e}"
                         for k, v in errs.items()))
        if not (y_err <= KERNEL_TOL and dx_err <= KERNEL_TOL):
            failures.append(f"norm-act op {label}: y {y_err} dx {dx_err}")
        for name, err in errs.items():
            if not err <= tol.get(name, KERNEL_TOL):
                failures.append(f"{name} {label}: err {err}")
        del x, gy, xg, y, y0, st0, dx0, st, gs, pairs
    for name in NORM_KERNELS:
        if op_launches.get(name, 0) <= 0:
            failures.append(f"norm-act: kernel {name} was never launched")
    return records, {k: op_launches[k] for k in NORM_KERNELS}, failures


def sheet_normals_config(work, volume_paths, patch, max_epoch,
                         device_augment=False):
    """``tasks/sheet_normals.yaml``'s settings as a dict (the card has no
    pyyaml), squeeze-excitation included, cut to a few steps, on the
    synthetic dataset; ``device_augment`` sets ``augment_on_device``."""
    return {
        "tr_setup": {"model_name": "sheet_normals", "autoconfigure": True,
                     "tr_val_split": 0.9, "dilate_label": False,
                     "load_weights_only": False,
                     "ckpt_out_base": str(work / "ckpt"),
                     "tensorboard_log_dir": str(work / "logs"), "seed": SEED},
        "tr_config": {"optimizer": "SGD", "initial_lr": 1e-3,
                      "weight_decay": 1e-4, "gradient_accumulation": 1,
                      "num_dataloader_workers": 8, "patch_size": list(patch),
                      "batch_size": 2, "max_steps_per_epoch": TRAINER_STEPS,
                      "max_val_steps_per_epoch": TRAINER_VAL_STEPS,
                      "max_epoch": max_epoch, "compute_dtype": "bfloat16",
                      "augment_on_device": device_augment},
        "model_config": {"squeeze_excitation": True},
        "dataset_config": {
            "min_bbox_percent": 0.97, "min_labeled_ratio": 0.15,
            "use_cache": True, "cache_folder": str(work / "patch_cache"),
            "in_channels": 1, "volume_paths": [volume_paths],
            "targets": {
                "sheet": {"channels": 1, "activation": "sigmoid",
                          "weight": 1.0, "loss_fn": "BCEDiceLoss",
                          "loss_kwargs": {"alpha": 0.5, "beta": 0.5}},
                "normals": {"channels": 3, "activation": "none",
                            "weight": 1.0, "loss_fn": "MaskedCosineLoss"}}},
        "inference_config": {},
    }


def host_sample_cost(cfg, n=24):
    """The trainer's per-sample host work (read + augment) on one thread,
    for the samples of the first epoch: what the loader threads share.
    Where cv2 is importable it is timed with cv2 and again on the
    ``scipy.ndimage`` branches that a machine without cv2 runs."""
    from mt3d_resenc_unet_torch.core.config import ConfigManager
    from mt3d_resenc_unet_torch.data import augment
    from mt3d_resenc_unet_torch.data.dataset import ZarrPatchDataset
    ds = ZarrPatchDataset(ConfigManager(config_dict=cfg), seed=SEED,
                          wire=True)
    has_cv2 = augment._HAS_CV2
    try:
        for use_cv2 in sorted({has_cv2, False}, reverse=True):
            augment._HAS_CV2 = use_cv2
            ds.set_seed(SEED * 100003)
            times = []
            for idx in range(min(n, len(ds))):
                t0 = time.perf_counter()
                ds[idx]
                times.append((time.perf_counter() - t0) * 1e3)
            print(f"host sample cost ({len(times)} samples, augmentation "
                  f"on, one thread, {'cv2' if use_cv2 else 'scipy.ndimage'}"
                  f" filters): mean {statistics.mean(times):.1f} ms, median "
                  f"{statistics.median(times):.1f} ms, max "
                  f"{max(times):.1f} ms")
    finally:
        augment._HAS_CV2 = has_cv2


def trainer_phase(patch, train_data, step_rate, device_augment=False,
                  host=None):
    """Phase 7 (and, with ``device_augment``, phase 12: the same runs with
    ``augment_on_device: true``, printed beside ``host``, phase 7's
    summary). Returns (launch counts of the two trainer runs, failures,
    a summary: the mean patches/s and t_fetch's share of epochs 2-3)."""
    import os
    import shutil
    from pathlib import Path
    from mt3d_resenc_unet_torch.ops import _build
    from mt3d_resenc_unet_torch.tools.synthetic_data import \
        write_sheet_dataset
    from mt3d_resenc_unet_torch.train.checkpoint import CheckpointManager
    from mt3d_resenc_unet_torch.train.trainer import Trainer
    failures = []
    label = "trainer, device augmentation" if device_augment else "trainer"
    work = Path(WORK_DIR).absolute()
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    paths = write_sheet_dataset(work / "data", train_data, seed=SEED)
    print(f"trainer data {train_data}: written in "
          f"{time.perf_counter() - t0:.1f} s")
    probe = {}

    class ResumeProbe(Trainer):
        """Records the state right after the resume."""

        def _restore(self, path, model, opt):
            epoch = super()._restore(path, model, opt)
            probe.update(
                epoch=epoch, count=opt.count,
                params={k: v.detach().cpu().clone()
                        for k, v in model.state_dict().items()},
                momenta=[v["momentum_buffer"].cpu().clone() for _, v in
                         sorted(opt.opt.state_dict()["state"].items())])
            return epoch

    cwd = os.getcwd()
    os.chdir(work)      # the final weights and the debug GIF land in the cwd
    try:
        _build.clear_counts()
        t0 = time.perf_counter()
        first = Trainer(config_dict=sheet_normals_config(
            work, paths, patch, TRAINER_EPOCHS, device_augment),
            verbose=False).train()
        history = first["history"]
        del first
        torch.cuda.empty_cache()
        cfg = sheet_normals_config(work, paths, patch, TRAINER_EPOCHS + 1,
                                   device_augment)
        cfg["tr_setup"]["checkpoint_path"] = str(work / "ckpt" /
                                                 "sheet_normals")
        second = ResumeProbe(config_dict=cfg, verbose=False).train()
        history += second["history"]
        del second
        launches = dict(_build.LAUNCHES)
        print(f"{label}: {time.perf_counter() - t0:.1f} s for "
              f"{TRAINER_EPOCHS} + 1 epochs; launches {launches}")
    finally:
        os.chdir(cwd)
    torch.cuda.empty_cache()

    for h in history:
        losses = {k: v for k, v in h.items() if k.endswith("_loss")}
        print(f"{label} epoch {h['epoch'] + 1}: " + " ".join(
            f"{k} {v:.6f}" for k, v in losses.items())
            + f"  {h['train/patches_per_sec']:.3f} patches/s, t_fetch "
            f"{h['train/t_fetch_s']:.2f} s, t_step {h['train/t_step_s']:.2f} s"
            + (f", checkpoint {h['ckpt/bytes'] / 2 ** 30:.3f} GiB saved in "
               f"{h['ckpt/seconds']:.2f} s" if "ckpt/bytes" in h else ""))
        if not all(np.isfinite(v) for v in losses.values()):
            failures.append(f"{label} epoch {h['epoch'] + 1}: non-finite "
                            f"{losses}")
    if [h["epoch"] for h in history] != list(range(TRAINER_EPOCHS + 1)):
        failures.append(f"{label}: epochs {[h['epoch'] for h in history]}")
    steady = history[1:]
    rate = sum(h["train/patches_per_sec"] for h in steady) / len(steady)
    fetch = sum(h["train/t_fetch_s"] for h in steady)
    step = sum(h["train/t_step_s"] for h in steady)
    summary = {"rate": rate, "fetch_share": fetch / (fetch + step),
               "t_fetch": fetch, "t_step": step}
    print(f"{label} epochs 2-{len(history)} [{card()}]: {rate:.3f} "
          f"patches/s against {step_rate:.3f} for the step alone (phase "
          f"5e, the same network); t_fetch is "
          f"{summary['fetch_share']:.1%} of fetch + step (t_fetch "
          f"{fetch:.2f} s, t_step {step:.2f} s)")
    if host is not None:
        print(f"{label} against host augmentation (phase 7) [{card()}]: "
              f"{rate:.3f} against {host['rate']:.3f} patches/s, t_fetch "
              f"share {summary['fetch_share']:.1%} against "
              f"{host['fetch_share']:.1%}, t_step {step:.2f} s against "
              f"{host['t_step']:.2f} s")
    if not device_augment:
        host_sample_cost(sheet_normals_config(work, paths, patch, 1))

    saved = CheckpointManager(work / "ckpt", "sheet_normals").restore(
        TRAINER_EPOCHS - 1)
    want_count = TRAINER_EPOCHS * TRAINER_STEPS
    same_params = bool(probe) and sorted(probe["params"]) == sorted(
        saved["params"]) and all(torch.equal(v, saved["params"][k])
                                 for k, v in probe["params"].items())
    saved_m = [v["momentum_buffer"] for _, v in
               sorted(saved["opt_state"]["state"].items())]
    same_momenta = bool(probe) and len(saved_m) == len(probe["momenta"]) \
        and all(torch.equal(a, b) for a, b in zip(probe["momenta"], saved_m))
    print(f"{label} resume: start epoch {probe.get('epoch', -1) + 1}, "
          f"optimizer count {probe.get('count')} (want {want_count}), params "
          f"bit-equal {same_params}, momenta bit-equal {same_momenta}")
    if not (probe.get("epoch") == TRAINER_EPOCHS
            and probe.get("count") == want_count and same_params
            and same_momenta):
        failures.append(f"{label}: the resume did not restore the state")
    for name in CONV_KERNELS:
        if launches.get(name, 0) <= 0:
            failures.append(f"{label}: kernel {name} was never launched")
    shutil.rmtree(work, ignore_errors=True)
    return launches, failures, summary


# sheet: median u8 difference and share of voxels off by more than 3;
# normals: mean and share over 3e-2 of the decoded vectors' distance
# (tests/test_infer_device.py::_assert_outputs_close)
FINALS_SHEET_MEDIAN = 1
FINALS_SHEET_OVER3 = 5e-3
FINALS_NORMALS_MEAN = 1e-3
FINALS_NORMALS_OVER = 5e-3


def outputs_close(store_a, store_b, label, failures):
    """``tests/test_infer_device.py::_assert_outputs_close`` on two stores'
    finals: the two passes sum in another order and the bf16 forward
    amplifies input ulps, so they agree to arithmetic noise."""
    import os
    from mt3d_resenc_unet_torch.data.zio import open_zarr
    fa = open_zarr(os.path.join(store_a, "sheet_final")).read_all()
    fb = open_zarr(os.path.join(store_b, "sheet_final")).read_all()
    ok = fa.dtype == fb.dtype == np.uint8 and fa.shape == fb.shape
    diff = np.abs(fa.astype(np.int16) - fb.astype(np.int16))
    median, over3 = float(np.median(diff)), float((diff > 3).mean())
    del fa, fb, diff
    na = open_zarr(os.path.join(store_a, "normals_final")).read_all()
    nb = open_zarr(os.path.join(store_b, "normals_final")).read_all()
    ok = ok and na.dtype == nb.dtype == np.uint16 and na.shape == nb.shape
    err = np.linalg.norm(na.astype(np.float32) / 32767.5
                         - nb.astype(np.float32) / 32767.5, axis=0)
    mean, over = float(err.mean()), float((err > 3e-2).mean())
    print(f"engine finals {label}: sheet median diff {median} (limit "
          f"{FINALS_SHEET_MEDIAN}), share > 3 {over3:.3e} (limit "
          f"{FINALS_SHEET_OVER3}); normals mean err {mean:.3e} (limit "
          f"{FINALS_NORMALS_MEAN}), share > 3e-2 {over:.3e} (limit "
          f"{FINALS_NORMALS_OVER})")
    if not (ok and median <= FINALS_SHEET_MEDIAN
            and over3 < FINALS_SHEET_OVER3 and mean < FINALS_NORMALS_MEAN
            and over < FINALS_NORMALS_OVER):
        failures.append(f"engine finals {label}: sheet median {median} "
                        f"over3 {over3}, normals mean {mean} over {over}")


def engine_config(ckpt, img, out, patch, device_accumulate, **infer):
    """The flagship (autoconfigured at ``patch``, sheet + normals heads,
    bf16) served from ``ckpt`` over ``img`` into ``out``."""
    return {
        "tr_setup": {"model_name": "flagship", "autoconfigure": True,
                     "seed": SEED},
        "tr_config": {"patch_size": list(patch), "batch_size": 2,
                      "compute_dtype": "bfloat16"},
        "model_config": {},
        "dataset_config": {
            "in_channels": 1, "volume_paths": [],
            "targets": {"sheet": {"channels": 1, "activation": "sigmoid"},
                        "normals": {"channels": 3, "activation": "none"}}},
        "inference_config": {
            "checkpoint_path": str(ckpt), "input_path": str(img),
            "output_path": str(out), "patch_size": list(patch),
            "overlap": 0.25, "batch_size": 2,
            "normalization": "standardize", "gaussian_blend": True,
            "device_accumulate": device_accumulate, **infer},
    }


class _KillAfterTile(Exception):
    """Raised by phase 8's tile callback to cut a tiled pass."""


def engine_phase(patch, volume, u16_volume):
    """Phase 8. Returns the failures."""
    import contextlib
    import io
    import os
    import shutil
    from pathlib import Path
    from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
    from mt3d_resenc_unet_torch.data.positions import sliding_window_grid
    from mt3d_resenc_unet_torch.data.zio import create_zarr, open_zarr
    from mt3d_resenc_unet_torch.infer.engine import ZarrInferenceEngine
    from mt3d_resenc_unet_torch.models.network import ResEncUNet, count_params
    from mt3d_resenc_unet_torch.ops import _build
    from mt3d_resenc_unet_torch.train.checkpoint import save_params
    failures = []
    smi = card()
    t_phase = time.perf_counter()
    work = Path(WORK_DIR).absolute() / "engine"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        plan = plan_from_autoconfig(
            patch, 1, [TaskHead("sheet", 1, "sigmoid"),
                       TaskHead("normals", 3, "none")], model_name="flagship")
        model = ResEncUNet(plan, seed=SEED)
        n_params = count_params(model)
        ckpt = work / "flagship.pt"
        save_params(ckpt, model.state_dict())
        del model
        rng = np.random.default_rng(SEED)
        vol = rng.integers(0, 256, volume, dtype=np.uint8)
        img = work / "image.zarr"
        create_zarr(str(img), volume, np.uint8, patch,
                    compressor=None)[...] = vol
        d, h, w = u16_volume
        img16 = work / "image_u16.zarr"
        create_zarr(str(img16), u16_volume, np.uint16, patch,
                    compressor=None)[...] = vol[:d, :h, :w].astype(
                        np.uint16) * 257
        del vol
        print(f"engine: flagship checkpoint ({n_params} params), u8 volume "
              f"{volume} and u16 volume {u16_volume} written in "
              f"{time.perf_counter() - t_phase:.1f} s")

        def serve(label, out, want_mode, shape=volume, input_path=img,
                  device_accumulate=False, resume=False, **infer):
            """One engine run from a fresh model; checks its pass and its
            launches and prints its rates over the grid's patches (not
            for a resumed run, which completes part of the grid). Returns
            the store."""
            n = len(sliding_window_grid(shape, patch, 0.25))
            cfg = engine_config(ckpt, input_path, work / out, patch,
                                device_accumulate, **infer)
            _build.clear_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            engine = ZarrInferenceEngine(config_dict=cfg, device=None,
                                         resume=resume)
            try:
                store = engine.infer()
            finally:
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                launches = dict(_build.LAUNCHES)
                phases = engine.last_phases
                stepped = phases.get("first_step", 0.0) + phases.get(
                    "loop", 0.0)
                voxels = int(np.prod(shape))
                print(f"engine {label} [{smi}]: pass {engine.last_mode}, "
                      f"{n} patches of {shape} in {dt:.2f} s: " + (
                          f"{n / dt:.3f} patches/s, {voxels / dt:.4g} "
                          f"voxels/s wall; {n / stepped:.3f} patches/s, "
                          f"{voxels / stepped:.4g} voxels/s in first_step "
                          "+ loop; " if stepped and not resume else "")
                      + "phases " + ", ".join(
                          f"{k} {v:.3f} s" for k, v in phases.items())
                      + f"; peak device memory "
                      f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
                      f"GiB; max_slab_bytes {engine.max_slab_bytes}; "
                      f"launches {launches}")
            if engine.last_mode != want_mode:
                failures.append(f"engine {label}: ran the "
                                f"{engine.last_mode} pass, not {want_mode}")
            for name in FORWARD:
                if launches.get(name, 0) <= 0:
                    failures.append(f"engine {label}: kernel {name} was "
                                    "never launched")
            return store

        # (a) "auto" must take the device pass; run twice
        store_a = serve("(a) auto", "auto_1", "device",
                           device_accumulate="auto")
        with open(os.path.join(store_a, ".finalized")) as f:
            marker = f.read().strip()
        print(f"engine (a) marker: {marker!r}")
        if marker != "finalized on device":
            failures.append(f"engine (a): marker {marker!r}")
        again = serve("(a) auto, second run", "auto_2", "device",
                         device_accumulate="auto")
        shutil.rmtree(again)

        # (b) the rolling host pass
        store_b = serve("(b) rolling", "rolling", "rolling")
        outputs_close(store_b, store_a, "(b) rolling vs (a) device",
                      failures)

        # (c) tiled: killed after its first tile, resumed, and held bit for
        # bit against an uninterrupted tiled run
        def kill(tile):
            raise _KillAfterTile(tile)

        tiled = dict(host_ram_budget_gb=ENGINE_TILE_BUDGET_GB)
        cut = ZarrInferenceEngine(config_dict=engine_config(
            ckpt, img, work / "tiled_resumed", patch, False, **tiled),
            device=None)
        cut.tile_callback = kill
        try:
            cut.infer()
            failures.append("engine (c): the tile callback did not cut "
                            "the pass")
        except _KillAfterTile as exc:
            print(f"engine (c): cut after tile {exc.args[0]}")
        del cut
        store_c = serve("(c) tiled, resumed", "tiled_resumed", "tiled",
                        resume=True, **tiled)
        store_ref = serve("(c) tiled, uninterrupted", "tiled", "tiled",
                             **tiled)
        for name in ("sheet_sum", "sheet_count", "normals_sum",
                     "normals_count"):
            same = np.array_equal(
                open_zarr(os.path.join(store_c, name)).read_all(),
                open_zarr(os.path.join(store_ref, name)).read_all())
            print(f"engine (c) resumed {name} bit-equal to uninterrupted: "
                  f"{same}")
            if not same:
                failures.append(f"engine (c): resumed {name} differs")
        outputs_close(store_c, store_a, "(c) tiled vs (a) device", failures)
        shutil.rmtree(store_ref)
        shutil.rmtree(store_c)

        # (d) postprocess_only twice on (b)'s store: skips, keeps the bits
        finals_b = {n: open_zarr(os.path.join(store_b, f"{n}_final"))
                    .read_all() for n in ("sheet", "normals")}
        for i in range(2):
            log = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                ZarrInferenceEngine(config_dict=engine_config(
                    ckpt, img, work / "rolling", patch, False),
                    postprocess_only=True, device=None).infer()
            skipped = log.getvalue().count("already finalized; skipping")
            same = all(np.array_equal(
                open_zarr(os.path.join(store_b, f"{n}_final")).read_all(),
                v) for n, v in finals_b.items())
            print(f"engine (d) postprocess_only run {i + 1}: "
                  f"{time.perf_counter() - t0:.2f} s, finalize skipped for "
                  f"{skipped} of 2 targets, finals bit-equal {same}")
            if skipped != 2 or not same:
                failures.append(f"engine (d) run {i + 1}: skipped "
                                f"{skipped}, finals kept {same}")
        del finals_b

        # (e) uint16 input: the device pass's decode against the host's
        store_e = serve("(e) u16 device", "u16_device", "device",
                           shape=u16_volume, input_path=img16,
                           device_accumulate=True)
        store_e2 = serve("(e) u16 rolling", "u16_rolling", "rolling",
                            shape=u16_volume, input_path=img16)
        outputs_close(store_e2, store_e, "(e) u16 rolling vs device",
                      failures)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 8 (engine): {time.perf_counter() - t_phase:.1f} s")
    return failures


# ---------------------------------------------------------------------------
# phases 10-13: device augmentation and the optimizer factory
# ---------------------------------------------------------------------------

# device augmentation, card against CPU on the same batch and draws: each
# stage's image in fp32 within AUG_FP32_TOL, a bf16 image within
# AUG_BF16_ULPS of the larger value; flips, rot90 and the cutout mask
# bit-equal (they move or select values)
AUG_FP32_TOL = 1e-5
AUG_BF16_ULPS = 1
AUG_REPS = 7            # median_ms samples of the augmentation
# every optimizer: 2 updates on the card against the same rule on the CPU
# on copies of a few tensors, max |card - CPU| over the card's move. The
# learning rate keeps each move far above the parameters' fp32 spacing (at
# lr 1e-3 one ulp of a 0.006 weight is up to 2e-4 of some rules' moves);
# lars scales its step by its trust coefficient 1e-3, so it takes
# OPT_LR / 1e-3 (its fp32 error against float64 on the CPU: 8.6e-6 of the
# move at lr 1, 8.7e-5 at 0.1)
OPT_TOL = 1e-5
OPT_LR = 0.1
OPT_LARS_LR = OPT_LR / 1e-3
OPT_GRAD_SCALE = 1e-3


def wire_batch(dev, patch, n):
    """A wire-format batch (u8 image, u8 0/255 sheet, u16 normals) made
    from the seed with numpy, decoded on the card as the step decodes it."""
    from mt3d_resenc_unet_torch.train.step import decode_wire
    rng = np.random.default_rng(SEED)
    wire = {"image": rng.integers(0, 256, (n,) + patch + (1,),
                                  dtype=np.uint8),
            "sheet": ((rng.random((n,) + patch + (1,)) > 0.5) * 255).astype(
                np.uint8),
            "normals": rng.integers(0, 65536, (n,) + patch + (3,)).astype(
                np.uint16)}
    return decode_wire({k: torch.from_numpy(v).to(dev)
                        for k, v in wire.items()}, ("normals",))


def bf16_ulps(got, want):
    """Largest |got - want| in bf16 ulps of the larger magnitude."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.ones_like(g), e - 8)
    return float(torch.where(g == w, 0.0, (g - w).abs() / ulp).max())


def profiled_ms(fn, n=2):
    """(wall ms, device ms) per call of ``fn`` over ``n`` calls traced by
    torch.profiler; the device time sums every CUDA kernel, without the
    spans of annotations that cover kernels counted already."""
    from mt3d_resenc_unet_torch.tools.profile_step import _device_us
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    device = sum(_device_us(e) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.key.startswith(("Optimizer.", "ProfilerStep")))
    return wall, device / 1e3 / n


def forced_params(params, blur_type):
    """``params`` with every stage on, both picks of each per-sample choice
    (sample 0 takes the first branch, sample 1 the second), blur type
    ``blur_type``, sample 0 flipped on every axis and a rot90 choice that
    follows the blur type."""
    import dataclasses
    dev = params.gate_1.device
    on = torch.ones_like(params.gate_1)
    pick = torch.tensor([True, False], device=dev)
    return dataclasses.replace(
        params, gate_1=on, pick_1=pick, gate_2=on, pick_2=~pick,
        gate_blur=on, blur_type=torch.tensor(blur_type, device=dev),
        gate_cutout=on,
        flip=torch.tensor([[True] * 3, [blur_type % 2 == 0, True, False]],
                          device=dev),
        rot_gate=torch.tensor(True, device=dev),
        rot_pick=torch.tensor(2 * blur_type + 1, device=dev))


def augment_phase(dev, patch, n=2):
    """Phase 10: ``data/augment_device.py`` on the wire-decoded flagship
    batch (n x patch, normals). One ``AugParams`` drawn with a CUDA
    generator at the defaults, and then with every stage forced on for each
    blur type in turn; each applied stage by stage on the card and, on a
    CPU copy of the stage's input and the same draws, on the CPU, with the
    image in fp32 and in bf16. Then the augmentation's ms at batch n, timed
    back to back (draws included), and its device time. Returns (the
    augmentation's device ms at the defaults, failures)."""
    from mt3d_resenc_unet_torch.data import augment_device as ad
    failures = []
    smi = card()
    t_phase = time.perf_counter()
    cfg = ad.DeviceAugConfig()
    on = ad.DeviceAugConfig(p_intensity_1=1.0, p_intensity_2=1.0,
                            p_blur=1.0, p_cutout=1.0, p_flip_axis=1.0,
                            p_flip_transform=1.0, p_rot90=1.0)
    base = wire_batch(dev, patch, n)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    drawn = ad.draw_params(gen, n, patch, cfg)
    cases = [("defaults as drawn", drawn, cfg)] + [
        (f"all on, {kind}", forced_params(drawn, t), on)
        for t, kind in enumerate(ad.BLUR_TYPES)]
    for label, params, c in cases:
        pc = params.to("cpu")
        blur_type, rot_gate, rot_pick = torch.stack(
            [params.blur_type, params.rot_gate.long(),
             params.rot_pick]).tolist()
        stages = (("intensity 1", ad.intensity_1), ("intensity 2",
                                                   ad.intensity_2),
                  ("blur " + ad.BLUR_TYPES[blur_type],
                   lambda x, p: ad.blur(x, p, blur_type)),
                  ("cutout", lambda x, p: ad.cutout(x, p, c)))
        mask = ad.cutout_mask(params.hole_count, params.hole_start,
                              params.hole_size, patch)
        mask_cpu = ad.cutout_mask(pc.hole_count, pc.hole_start,
                                  pc.hole_size, patch)
        if not torch.equal(mask.cpu(), mask_cpu):
            failures.append(f"augment {label}: cutout masks differ")
        for dtype in (torch.float32, torch.bfloat16):
            batch = {**base, "image": base["image"].to(dtype)}
            x = batch["image"]
            errs = []
            for name, fn in stages:
                y = fn(x, params)
                y_cpu = fn(x.cpu(), pc)
                if dtype == torch.float32:
                    err = float((y.cpu() - y_cpu).abs().max())
                    ok = err <= AUG_FP32_TOL
                else:
                    err = bf16_ulps(y.cpu(), y_cpu)
                    ok = err <= AUG_BF16_ULPS
                ok = ok and y.dtype == dtype and bool(torch.isfinite(y).all())
                errs.append(f"{name} {err:.3g}")
                if not ok:
                    failures.append(f"augment {label} {dtype}: {name} "
                                    f"card vs CPU {err}")
                x = y
            geo = ad.geometry({**batch, "image": x}, params, c,
                              bool(rot_gate), rot_pick)
            geo_cpu = ad.geometry({k: v.cpu() for k, v in
                                   {**batch, "image": x}.items()}, pc, c,
                                  bool(rot_gate), rot_pick)
            same = all(torch.equal(geo[k].cpu(), geo_cpu[k]) for k in geo)
            whole = ad.apply(batch, params, c)
            same_apply = all(torch.equal(whole[k], geo[k]) for k in geo)
            unit = "abs" if dtype == torch.float32 else "bf16 ulps"
            print(f"augment {label} {str(dtype)[6:]}: card vs CPU per stage "
                  + ", ".join(errs) + f" ({unit}); flips + rot90 bit-equal "
                  f"{same}; apply = the stages {same_apply}")
            if not (same and same_apply):
                failures.append(f"augment {label} {dtype}: geometry "
                                f"{same}, apply {same_apply}")
            del batch, geo, geo_cpu, whole, x
    # the augmentation's cost at batch n, draws and the host read included
    augment = ad.make_device_augment(cfg)
    batch = {**base, "image": base["image"].to(torch.bfloat16)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ms = median_ms(lambda: augment(batch, gen), reps=AUG_REPS)
    wall, device = profiled_ms(lambda: augment(batch, gen), n=20)
    forced = []
    for t, kind in enumerate(ad.BLUR_TYPES):
        params = forced_params(drawn, t)
        f_ms = median_ms(lambda: ad.apply(batch, params, on), reps=3)
        forced.append(f"{kind} {f_ms:.3f}")
    print(f"augment batch {n} x {patch} bf16 at the defaults [{smi}]: "
          f"{ms:.3f} ms back to back (median of {AUG_REPS}), {device:.3f} "
          f"ms device time and {wall:.3f} ms wall per call over 20 calls; "
          "all stages on, per blur type (ms): " + ", ".join(forced))
    print(f"phase 10 (augment): {time.perf_counter() - t_phase:.1f} s")
    return device, failures


def augmented_step_phase(dev, patch, steps, base, base_launches, aug_ms):
    """Phase 11: the flagship training step (phase 5b's model, batch and
    optimizer) with ``augment_fn=make_device_augment()`` drawing from a
    generator on the card: two first steps from the same seed held
    bit-equal, then ``steps`` steps with every launch counter zeroed before
    and read after, printed beside phase 5b's figures (``base``) and 5c's
    launches, and the step's device time by torch.profiler. Returns the
    failures."""
    from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
    from mt3d_resenc_unet_torch.data.augment_device import make_device_augment
    from mt3d_resenc_unet_torch.models.network import ResEncUNet
    from mt3d_resenc_unet_torch.ops import _build
    from mt3d_resenc_unet_torch.train.losses import build_task_losses
    from mt3d_resenc_unet_torch.train.step import (build_optimizer,
                                                   cosine_epoch_schedule,
                                                   make_train_step)
    from mt3d_resenc_unet_torch.utils.flops import (H100_PEAK_BF16_TFLOPS,
                                                     mfu, train_step_flops)
    failures = []
    smi = card()
    t_phase = time.perf_counter()
    plan = plan_from_autoconfig(
        patch, 1,
        [TaskHead("sheet", 1, "sigmoid"), TaskHead("normals", 3, "none")],
        model_name="flagship", use_pallas_conv=True)
    model = ResEncUNet(plan, dtype=torch.bfloat16, seed=SEED).to(dev)
    batch = flagship_batch(dev, patch, 2)
    n = batch["image"].shape[0]
    augment = make_device_augment()
    if not step_repeatability(model, batch, FLAGSHIP_LOSSES, augment):
        failures.append("augmented step: two first steps differ")
    torch.cuda.empty_cache()
    _build.clear_counts()
    metrics, ms, peak, _ = train_path(model, batch, steps,
                                      "augmented flagship kernels bf16",
                                      FLAGSHIP_LOSSES, augment)
    launches = dict(_build.LAUNCHES)
    for i, m in enumerate(metrics):
        if not all(np.isfinite(v) for v in m.values()):
            failures.append(f"augmented step {i}: non-finite {m}")
    for name in CONV_KERNELS:
        if launches.get(name, 0) <= 0:
            failures.append(f"augmented step: kernel {name} was never "
                            "launched")
    flops = train_step_flops(plan, patch)
    tflops, frac = mfu(n / (ms / 1e3), flops)
    b_tflops, b_frac = mfu(base["rate"], flops)
    print(f"augmented flagship train step kernels bf16 [{smi}]: {ms:.1f} ms "
          f"median, {n / (ms / 1e3):.3f} patches/s, {tflops:.2f} model "
          f"TFLOP/s, MFU {frac:.4f} of {H100_PEAK_BF16_TFLOPS} TFLOP/s bf16, "
          f"peak memory {peak / 2 ** 30:.2f} GiB; without augmentation "
          f"(phase 5b) {base['ms']:.1f} ms, {base['rate']:.3f} patches/s, "
          f"MFU {b_frac:.4f}, peak memory {base['peak'] / 2 ** 30:.2f} GiB")
    per_step = {k: launches.get(k, 0) / steps for k in CONV_KERNELS}
    before = {k: base_launches.get(k, 0) / steps for k in CONV_KERNELS}
    print(f"augmented flagship launches per step {per_step}; without "
          f"augmentation (phase 5c) {before}: "
          f"{'equal' if per_step == before else 'they differ'}")
    # device time of the augmented step and the augmentation's share of it
    opt = build_optimizer(model.parameters(), "AdamW",
                          cosine_epoch_schedule(1e-3, 500, 250),
                          weight_decay=1e-4, grad_clip_norm=3.0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    step = make_train_step(model, build_task_losses(FLAGSHIP_LOSSES),
                           {t: 1.0 for t in FLAGSHIP_LOSSES}, generator=gen,
                           augment_fn=augment)
    wall, device = profiled_ms(lambda: step(opt, batch), n=2)
    if device > 0 and aug_ms > 0:
        print(f"augmented flagship step profiled [{smi}]: {wall:.1f} ms "
              f"wall, {device:.1f} ms device time (busy {device / wall:.1%});"
              f" the augmentation's device time {aug_ms:.3f} ms (phase 10) "
              f"is {aug_ms / device:.2%} of it")
    else:
        print(f"augmented flagship step profiled [{smi}]: {wall:.1f} ms "
              "wall; device time not measured (the profiler saw no kernel)")
    del opt, step, model, batch
    print(f"phase 11 (augmented step): {time.perf_counter() - t_phase:.1f} s")
    return failures


def optimizer_phase(dev, patch):
    """Phase 13: every name of ``train/optimizers.py::create_optimizer`` on
    the flagship's parameters on the card (lr OPT_LR, lars OPT_LARS_LR,
    weight decay 1e-4, no clip: a clip's global norm would differ between
    the model and the held tensors), 2 updates from one fixed gradient set
    made on the card from the seed; the same rule on the CPU on copies of
    the largest conv kernel, a 512x512 one (adafactor's tie), a bias and a seg-head kernel
    with their gradients. Each held tensor's largest difference within
    OPT_TOL of its largest move on the card. Prints each rule's ms per
    update on the card (the first update, which builds the state, and the
    second). Returns the failures."""
    from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
    from mt3d_resenc_unet_torch.models.network import ResEncUNet
    from mt3d_resenc_unet_torch.train.optimizers import (NAMES,
                                                         create_optimizer)
    failures = []
    smi = card()
    t_phase = time.perf_counter()
    plan = plan_from_autoconfig(
        patch, 1,
        [TaskHead("sheet", 1, "sigmoid"), TaskHead("normals", 3, "none")],
        model_name="flagship", use_pallas_conv=True)
    model = ResEncUNet(plan, dtype=torch.bfloat16, seed=SEED).to(dev)
    params = dict(model.named_parameters())
    largest = max(params, key=lambda k: params[k].numel())
    tie = max((k for k, v in params.items()
               if v.dim() == 5 and v.shape[-2] == v.shape[-1] >= 128),
              key=lambda k: params[k].numel())
    bias = next(k for k, v in params.items() if k.endswith("bias"))
    seg = next(k for k, v in params.items() if ".seg" in k
               and k.endswith("kernel"))
    held = (largest, tie, bias, seg)
    print(f"optimizers: {len(params)} tensors, "
          f"{sum(v.numel() for v in params.values())} parameters; held on "
          "the CPU: " + ", ".join(f"{k} {tuple(params[k].shape)}"
                                  for k in held))
    init = {k: v.detach().clone() for k, v in params.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    grads = {k: torch.randn(v.shape, generator=gen, device=dev)
             * OPT_GRAD_SCALE for k, v in params.items()}
    for name in NAMES:
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(init[k])
        lr = OPT_LARS_LR if name == "lars" else OPT_LR
        opt = create_optimizer(params.values(), name, lr, weight_decay=1e-4)
        cpu = {k: torch.nn.Parameter(init[k].cpu().clone()) for k in held}
        opt_cpu = create_optimizer(cpu.values(), name, lr, weight_decay=1e-4)
        times = []
        for _ in range(2):
            for k, v in params.items():
                v.grad = grads[k]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            for k, v in cpu.items():
                v.grad = grads[k].cpu()
            opt_cpu.step()
        errs = []
        for k in held:
            got = params[k].detach()
            move = float((got - init[k]).abs().max())
            diff = float((got.cpu() - cpu[k].detach()).abs().max())
            err = diff / move if move > 0 else math.inf
            errs.append(err)
            if not (err <= OPT_TOL and bool(torch.isfinite(got).all())):
                failures.append(f"optimizer {name}: {k} card vs CPU "
                                f"{diff} of a move {move}")
        print(f"optimizer {name} [{smi}]: {times[0]:.2f} ms first update, "
              f"{times[1]:.2f} ms second; card vs CPU over the move "
              + ", ".join(f"{e:.2e}" for e in errs)
              + f" (limit {OPT_TOL})")
        del opt, opt_cpu, cpu
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    del model, params, init, grads
    print(f"phase 13 (optimizers): {time.perf_counter() - t_phase:.1f} s")
    return failures



# ---------------------------------------------------------------------------
# phases 14-16: multi-process training and inference, the data-prep tools
# ---------------------------------------------------------------------------

# phase 14: the flagship step over torch.distributed. (a) one process in an
# NCCL group of one, two steps bit-equal to the step without a group; (b)
# two processes on the one card over gloo (NCCL refuses two ranks on one
# device), one sample each of the global batch of 2, held against the
# single-process step at batch 2 by TRAIN_LOSS_TOL / TRAIN_GNORM_TOL and by
# DIST_PARAM_TOL on the parameters' relative L2; both ranks bit-equal
DIST_STEPS = 3
DIST_PROFILED = 3          # (a): steps a turn under torch.profiler
DIST_WORKER_STEPS = 4      # (b): the held first step, then three timed
# the first AdamW update moves an element by about lr (1e-3) whatever its
# gradient's size, so a gradient element that rounding moves across 0
# moves its parameter by 2 lr: the parameters are held by DIST_PARAM_ATOL
# elementwise and DIST_PARAM_TOL in relative L2 (5.7e-2 in a CPU rehearsal
# at 32^3, bf16; 5.8e-2 on the card), the gradients by their cosine per
# module with phase 5b's limit: bf16 rounding that differs between N=1 and
# N=2 moves LeakyReLU inputs across 0 in the 4^3 stage, as it does between
# the kernels and plain fp32 (the encoder's 0.990 on the card)
DIST_PARAM_TOL = 0.1
DIST_PARAM_ATOL = 2.1e-3
DIST_MIN_COS = TRAIN_MIN_COS
DIST_TIMEOUT_S = 300       # a worker process's limit
# phase 15: phase 8's volume through the tiled pass at a budget whose
# y-band (192 rows: 0.5625 GiB / (6 planes x 4 B x 256 x 512)) is 1.5 of
# the stores' 128-row chunks, so two ranks' adjacent tiles share chunks
ENGINE_MP_BUDGET_GB = 0.5625


def _flagship_plan(patch):
    from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
    return plan_from_autoconfig(
        patch, 1,
        [TaskHead("sheet", 1, "sigmoid"), TaskHead("normals", 3, "none")],
        model_name="flagship", use_pallas_conv=True)


def dist_steps(model, batch, steps):
    """``steps`` flagship training steps (train_path's optimizer and
    losses) from the model's weights; returns (per-step metrics, per-step
    ms, the parameters after the first step and after the last, the first
    step's clipped gradients, all fp32 copies on the card, and the
    optimizer)."""
    from mt3d_resenc_unet_torch.train.losses import build_task_losses
    from mt3d_resenc_unet_torch.train.step import (build_optimizer,
                                                   cosine_epoch_schedule,
                                                   make_train_step)
    opt = build_optimizer(model.parameters(), "AdamW",
                          cosine_epoch_schedule(1e-3, 500, 250),
                          weight_decay=1e-4, grad_clip_norm=3.0)
    step = make_train_step(model, build_task_losses(FLAGSHIP_LOSSES),
                           {task: 1.0 for task in FLAGSHIP_LOSSES})
    metrics, times, first, grads = [], [], None, None
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            first = {k: v.detach().clone()
                     for k, v in model.state_dict().items()}
            grads = {k: p.grad.detach().clone()
                     for k, p in model.named_parameters()
                     if p.grad is not None}
    last = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return metrics, times, first, last, grads, opt


def module_cosines(got, want):
    """The cosine of two gradient sets per top-level module."""
    modules = collections.defaultdict(list)
    for name in want:
        modules[name.split(".")[0]].append(name)
    return {mod: float(torch.nn.functional.cosine_similarity(
        torch.cat([got[k].double().flatten() for k in names]),
        torch.cat([want[k].double().flatten() for k in names]), dim=0))
        for mod, names in modules.items()}


def _rel_l2(got, want, base=None):
    """Relative L2 over every tensor of two state dicts (of the moves from
    ``base``, given one)."""
    num = den = 0.0
    for k, w in want.items():
        g = got[k].float()
        w = w.float()
        if base is not None:
            g, w = g - base[k].float(), w - base[k].float()
        num += float((g - w).double().square().sum())
        den += float(w.double().square().sum())
    return math.sqrt(num / max(den, 1e-300))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _workers(mode, world, work, extra=()):
    """Runs ``chip_smoke.py --worker mode`` as ``world`` processes (ranks
    of one gloo group) and returns each rank's JSON result; a worker that
    fails or outlives DIST_TIMEOUT_S fails the phase, and every worker is
    ended."""
    import os
    port = _free_port()
    procs, logs = [], []
    for rank in range(world):
        log = open(work / f"{mode}_r{rank}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", mode,
             str(rank), str(world), str(port), str(work), *extra],
            stdout=log, stderr=subprocess.STDOUT))
    failed = []
    deadline = time.perf_counter() + DIST_TIMEOUT_S
    try:
        for rank, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {rank} timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        lines = [x for x in text.splitlines() if x.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            failed.append(f"rank {rank} rc {p.returncode}")
            print(f"--- {mode} rank {rank} log (last 3000 chars) ---\n"
                  f"{text[-3000:]}")
            continue
        results.append(json.loads(lines[-1][len("RESULT "):]))
    return results, failed


def dist_step_phase(dev, patch, steps):
    """Phase 14. Returns the failures."""
    import shutil
    from pathlib import Path
    from mt3d_resenc_unet_torch.models.network import ResEncUNet
    from mt3d_resenc_unet_torch.parallel import distributed
    failures = []
    smi = card()
    t_phase = time.perf_counter()
    work = Path(WORK_DIR).absolute() / "dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        model = ResEncUNet(_flagship_plan(patch), dtype=torch.bfloat16,
                           seed=SEED).to(dev)
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        batch = flagship_batch(dev, patch, 2)
        # (a) a warm-up step, then the steps without a group, then in an
        # NCCL group of one, each from the same weights
        dist_steps(model, batch, 1)
        model.load_state_dict(init)
        alone = dist_steps(model, batch, steps)
        model.load_state_dict(init)
        distributed.initialize(f"localhost:{_free_port()}", 1, 0,
                               backend="nccl")
        try:
            grouped = dist_steps(model, batch, steps)
        finally:
            distributed.shutdown()
        same_m = alone[0] == grouped[0]
        same_p = all(torch.equal(alone[3][k], grouped[3][k]) for k in init)
        print(f"phase 14a [{smi}]: {steps} steps at batch 2 in an NCCL "
              f"group of one, metrics bit-equal to no group {same_m}, "
              f"parameters bit-equal {same_p}; ms a step "
              + ", ".join(f"{t:.1f}" for t in grouped[1])
              + f" (median {statistics.median(grouped[1]):.1f}) against "
              + ", ".join(f"{t:.1f}" for t in alone[1])
              + f" (median {statistics.median(alone[1]):.1f}) without a "
              "group, after a warm-up step")
        if not (same_m and same_p):
            failures.append(f"phase 14a: metrics equal {same_m}, "
                            f"parameters equal {same_p}")
        ref_metrics, ref_first, ref_grads = alone[0][0], alone[2], alone[4]
        del grouped, alone
        # the group's cost in device time, which the host-bound wall
        # hides: torch.profiler over DIST_PROFILED steps, in turns
        costs = collections.defaultdict(list)
        for mode in ("none", "group", "group", "none"):
            if mode == "group":
                distributed.initialize(f"localhost:{_free_port()}", 1, 0,
                                       backend="nccl")
            try:
                costs[mode].append(group_step_ms(model, batch))
            finally:
                distributed.shutdown()
        print(f"phase 14a [{smi}]: (wall, device) ms a step under "
              "torch.profiler, in turns: " + "; ".join(
                  f"{mode} " + ", ".join(f"({w:.1f}, {d:.2f})" for w, d in v)
                  for mode, v in costs.items())
              + "; the group's device-time cost "
              f"{_mean_device(costs['group']) - _mean_device(costs['none']):.2f}"
              " ms")
        del model
        torch.cuda.empty_cache()

        # (b) two processes on the one card, one sample each
        torch.save(init, work / "init.pt")
        results, failed = _workers("step", 2, work, (
            str(DIST_WORKER_STEPS), ",".join(map(str, patch))))
        failures += [f"phase 14b: {f}" for f in failed]
        if len(results) == 2:
            r0, r1 = sorted(results, key=lambda r: r["rank"])
            saved = torch.load(work / "first_r0.pt", map_location=dev)
            got = saved["params"]
            m = r0["metrics"][0]
            loss_diff = abs(m["total_loss"] - ref_metrics["total_loss"]) / \
                abs(ref_metrics["total_loss"])
            gn_diff = abs(m["grad_norm"] - ref_metrics["grad_norm"]) / \
                ref_metrics["grad_norm"]
            p_err = _rel_l2(got, ref_first)
            u_err = _rel_l2(got, ref_first, init)
            p_max = max(float((got[k] - ref_first[k]).abs().max())
                        for k in ref_first)
            cos = module_cosines(saved["grads"], ref_grads)
            same = r0["digest"] == r1["digest"] and \
                r0["metrics"] == r1["metrics"]
            print(f"phase 14b [{smi}]: 2 processes on one card over gloo, "
                  "1 sample each of the global batch of 2, first step "
                  f"against one process at batch 2: total loss rel diff "
                  f"{loss_diff:.3e} (limit {TRAIN_LOSS_TOL}), grad_norm rel "
                  f"diff {gn_diff:.3e} (limit {TRAIN_GNORM_TOL}), parameters "
                  f"rel L2 {p_err:.3e} (limit {DIST_PARAM_TOL}) and max "
                  f"abs diff {p_max:.3e} (limit {DIST_PARAM_ATOL}), the "
                  f"update's rel L2 {u_err:.3e}; first-step gradient "
                  "cosine per module " + ", ".join(
                      f"{k} {v:.6f}" for k, v in cos.items())
                  + f" (limit {DIST_MIN_COS}); ranks bit-equal {same}")
            for r in (r0, r1):
                print(f"  rank {r['rank']}: ms a step "
                      + ", ".join(f"{t:.1f}" for t in r["ms"])
                      + f"; the gradient all-reduce alone "
                      f"{r['allreduce_ms']:.1f} ms, "
                      f"{r['allreduce_ms'] / r['step_ms']:.1%} of the "
                      f"median {r['step_ms']:.1f} ms step; peak "
                      f"{r['peak'] / 2 ** 30:.2f} GiB; launches a step "
                      f"at N=1 {r['launches']}")
            print("  (two processes time-share one card: these times say "
                  "nothing of scaling across cards)")
            if not (loss_diff <= TRAIN_LOSS_TOL and gn_diff <=
                    TRAIN_GNORM_TOL and p_err <= DIST_PARAM_TOL
                    and p_max <= DIST_PARAM_ATOL and same
                    and min(cos.values()) >= DIST_MIN_COS):
                failures.append(
                    f"phase 14b: loss {loss_diff} grad_norm {gn_diff} "
                    f"params {p_err} / {p_max} cosines {cos} ranks equal "
                    f"{same}")
            for name in CONV_KERNELS:
                if r0["launches"].get(name, 0) <= 0:
                    failures.append(f"phase 14b: kernel {name} was never "
                                    "launched at N=1")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 14 (distributed step): {time.perf_counter() - t_phase:.1f}"
          " s")
    return failures


def _mean_device(runs):
    return statistics.mean(device for _, device in runs)


def group_step_ms(model, batch):
    """(wall, device) ms of a flagship training step (dist_steps'
    optimizer and losses) under torch.profiler, over DIST_PROFILED steps
    after one untraced."""
    from mt3d_resenc_unet_torch.train.losses import build_task_losses
    from mt3d_resenc_unet_torch.train.step import (build_optimizer,
                                                   cosine_epoch_schedule,
                                                   make_train_step)
    opt = build_optimizer(model.parameters(), "AdamW",
                          cosine_epoch_schedule(1e-3, 500, 250),
                          weight_decay=1e-4, grad_clip_norm=3.0)
    step = make_train_step(model, build_task_losses(FLAGSHIP_LOSSES),
                           {task: 1.0 for task in FLAGSHIP_LOSSES})
    return profiled_ms(lambda: step(opt, batch), n=DIST_PROFILED)


def step_worker(rank, world, port, work, steps, patch):
    """A rank of phase 14b: the flagship's first ``steps`` steps on its
    sample of the global batch; rank 0 saves its parameters after the
    first."""
    import hashlib
    from mt3d_resenc_unet_torch.core.config import resolve_device
    from mt3d_resenc_unet_torch.models.network import ResEncUNet
    from mt3d_resenc_unet_torch.ops import _build
    from mt3d_resenc_unet_torch.parallel import distributed
    # gloo: the two ranks share the one card, which NCCL refuses
    distributed.initialize(f"localhost:{port}", world, rank,
                           backend="gloo", timeout_s=DIST_TIMEOUT_S)
    dev = resolve_device(None)
    patch = tuple(int(p) for p in patch.split(","))
    model = ResEncUNet(_flagship_plan(patch), dtype=torch.bfloat16,
                       seed=SEED).to(dev)
    model.load_state_dict(torch.load(work / "init.pt", map_location=dev))
    batch = flagship_batch(dev, patch, 2)
    sl = distributed.process_batch_slice(2)
    batch = {k: v[sl].contiguous() for k, v in batch.items()}
    _build.clear_counts()
    torch.cuda.reset_peak_memory_stats()
    metrics, times, first, _, grads, opt = dist_steps(model, batch,
                                                      int(steps))
    launches = {k: v // int(steps) for k, v in _build.LAUNCHES.items()}
    digest = hashlib.sha256()
    for k, v in first.items():
        digest.update(k.encode())
        digest.update(v.float().cpu().numpy().tobytes())
    if rank == 0:
        torch.save({"params": first, "grads": grads}, work / "first_r0.pt")
    params = [p for g in opt.opt.param_groups for p in g["params"]]
    ar = []
    for _ in range(3):
        distributed.sync_global_devices("allreduce timing")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        distributed.all_reduce_grads(params)
        torch.cuda.synchronize()
        ar.append((time.perf_counter() - t0) * 1e3)
    return {"metrics": metrics, "ms": times,
            "step_ms": statistics.median(times[1:]),
            "allreduce_ms": statistics.median(ar),
            "digest": digest.hexdigest(), "launches": launches,
            "peak": torch.cuda.max_memory_allocated()}


def dist_engine_phase(patch, volume):
    """Phase 15. Returns the failures."""
    import os
    import shutil
    from pathlib import Path
    from mt3d_resenc_unet_torch.data.zio import create_zarr, open_zarr
    from mt3d_resenc_unet_torch.infer.engine import ZarrInferenceEngine
    from mt3d_resenc_unet_torch.models.network import ResEncUNet
    from mt3d_resenc_unet_torch.train.checkpoint import save_params
    failures = []
    smi = card()
    t_phase = time.perf_counter()
    work = Path(WORK_DIR).absolute() / "dist_engine"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        plan = _flagship_plan(patch)
        save_params(work / "flagship.pt",
                    ResEncUNet(plan, seed=SEED).state_dict())
        vol = np.random.default_rng(SEED).integers(0, 256, volume,
                                                   dtype=np.uint8)
        create_zarr(str(work / "image.zarr"), volume, np.uint8, patch,
                    compressor=None)[...] = vol
        del vol
        t0 = time.perf_counter()
        one = ZarrInferenceEngine(config_dict=engine_config(
            work / "flagship.pt", work / "image.zarr", work / "one", patch,
            False, host_ram_budget_gb=ENGINE_MP_BUDGET_GB), device=None)
        store_one = one.infer()
        n_one = _tile_patches(store_one, patch, volume,
                              ".model_pass_progress.json")
        stepped = one.last_phases.get("first_step", 0.0) + \
            one.last_phases.get("loop", 0.0)
        print(f"phase 15 [{smi}]: one process, pass {one.last_mode}, "
              f"{n_one} patch forwards in {time.perf_counter() - t0:.2f} s "
              f"wall, {n_one / stepped:.3f} patches/s over first_step + "
              "loop")
        if one.last_mode != "tiled":
            failures.append(f"phase 15: one process ran {one.last_mode}")
        del one
        torch.cuda.empty_cache()
        results, failed = _workers("engine", 2, work, (
            ",".join(map(str, patch)), str(ENGINE_MP_BUDGET_GB)))
        failures += [f"phase 15: {f}" for f in failed]
        if len(results) == 2:
            store_two = results[0]["store"]
            tiles = []
            for r in sorted(results, key=lambda r: r["rank"]):
                name = f".model_pass_progress.p{r['rank']}.json"
                path = os.path.join(store_two, name)
                with open(path) as f:
                    tiles.append({tuple(t) for t in
                                  json.load(f)["tiles_done"]})
                n = _tile_patches(store_two, patch, volume, name)
                print(f"  rank {r['rank']}: pass {r['mode']}, "
                      f"{len(tiles[-1])} tiles, {n} patch forwards, "
                      f"{n / r['stepped']:.3f} patches/s over first_step + "
                      f"loop, {r['wall']:.2f} s wall")
                if r["mode"] != "tiled":
                    failures.append(f"phase 15: rank {r['rank']} ran "
                                    f"{r['mode']}")
            disjoint = not (tiles[0] & tiles[1]) and all(tiles)
            same = {}
            for name in ("sheet_sum", "sheet_count", "sheet_final",
                         "normals_sum", "normals_count", "normals_final"):
                same[name] = np.array_equal(
                    open_zarr(os.path.join(store_one, name)).read_all(),
                    open_zarr(os.path.join(store_two, name)).read_all())
            print(f"phase 15: tiles disjoint and non-empty {disjoint}; "
                  "two processes bit-equal to one: " + ", ".join(
                      f"{k} {v}" for k, v in same.items())
                  + " (two processes time-share one card: no scaling)")
            if not (disjoint and all(same.values())):
                failures.append(f"phase 15: disjoint {disjoint}, "
                                f"bit-equal {same}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 15 (distributed engine): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return failures


def _tile_patches(store, patch, volume, watermark):
    """Patch forwards of the tiles a watermark lists (a patch runs once
    for each tile it touches)."""
    import os
    from mt3d_resenc_unet_torch.data.positions import sliding_window_grid
    with open(os.path.join(store, watermark)) as f:
        tiles = json.load(f)["tiles_done"]
    grid = sliding_window_grid(volume, patch, 0.25)
    return sum(1 for z0, z1, y0, y1 in tiles for z, y, _ in grid
               if z < z1 and z + patch[0] > z0 and y < y1
               and y + patch[1] > y0)


def engine_worker(rank, world, port, work, patch, budget_gb):
    """A rank of phase 15: the engine's tiled pass over the shared
    volume."""
    from mt3d_resenc_unet_torch.infer.engine import ZarrInferenceEngine
    from mt3d_resenc_unet_torch.parallel import distributed
    distributed.initialize(f"localhost:{port}", world, rank,
                           backend="gloo", timeout_s=DIST_TIMEOUT_S)
    patch = tuple(int(p) for p in patch.split(","))
    t0 = time.perf_counter()
    engine = ZarrInferenceEngine(config_dict=engine_config(
        work / "flagship.pt", work / "image.zarr", work / "two", patch,
        False, host_ram_budget_gb=float(budget_gb)), device=None)
    store = engine.infer()
    return {"store": store, "mode": engine.last_mode,
            "wall": time.perf_counter() - t0,
            "stepped": engine.last_phases.get("first_step", 0.0)
            + engine.last_phases.get("loop", 0.0)}


def tools_phase():
    """Phase 16, host only and tiny: PNG slices -> ``tiff_to_zarr`` ->
    ``zarr_crop`` -> the port's dataset; ``normals_slices`` and
    ``mesh_rasterize`` once each. Returns the failures."""
    import os
    import shutil
    from pathlib import Path
    from mt3d_resenc_unet_torch.core.config import ConfigManager
    from mt3d_resenc_unet_torch.data.dataset import ZarrPatchDataset
    from mt3d_resenc_unet_torch.data.zio import create_zarr, open_zarr
    from mt3d_resenc_unet_torch.tools import mesh_rasterize
    from mt3d_resenc_unet_torch.tools.images import read_image, write_image
    from mt3d_resenc_unet_torch.tools.normals_slices import (
        write_normals_slices)
    from mt3d_resenc_unet_torch.tools.tiff_to_zarr import stack_images_to_zarr
    from mt3d_resenc_unet_torch.tools.zarr_crop import cut_zarr_bounding_box
    failures = []
    t_phase = time.perf_counter()
    work = Path(WORK_DIR).absolute() / "tools"
    shutil.rmtree(work, ignore_errors=True)
    try:
        seg = work / "seg"
        (seg / "layers").mkdir(parents=True)
        (seg / "inklabels").mkdir()
        rng = np.random.default_rng(SEED)
        layers = rng.integers(0, 65536, (24, 48, 48), dtype=np.uint16)
        ink = np.zeros((24, 48, 48), np.uint8)
        ink[:, 8:40, 8:40] = 255
        for z in range(24):
            write_image(str(seg / "layers" / f"{z:02d}.png"), layers[z])
            write_image(str(seg / "inklabels" / f"{z:02d}.png"), ink[z])
        group = stack_images_to_zarr(str(seg), 0, 23, chunks=(8, 16, 16))
        crops = {}
        for name in ("layers", "inklabels"):
            crops[name] = cut_zarr_bounding_box(
                os.path.join(group, f"{name}.zarr"),
                str(work / f"{name}_crop.zarr"), 4, 20, 8, 40, 8, 40)
        got = open_zarr(crops["layers"]).read_all()
        ok_crop = np.array_equal(got, (layers // 257).astype(np.uint8)
                                 [4:20, 8:40, 8:40])
        cfg = {
            "tr_setup": {"model_name": "tools", "autoconfigure": False},
            "tr_config": {"patch_size": [16, 16, 16], "batch_size": 1},
            "model_config": {},
            "dataset_config": {
                "min_bbox_percent": 0.5, "min_labeled_ratio": 0.1,
                "use_cache": False, "in_channels": 1,
                "volume_paths": [{"input": crops["layers"],
                                  "ink": crops["inklabels"],
                                  "ref_label": "ink"}],
                "targets": {"ink": {"channels": 1, "activation": "sigmoid",
                                    "loss_fn": "BCEWithLogitsLoss"}}},
            "inference_config": {}}
        dataset = ZarrPatchDataset(ConfigManager(config_dict=cfg,
                                                 verbose=False), seed=SEED)
        sample = dataset[0]
        shapes = {k: tuple(np.asarray(v).shape) for k, v in sample.items()}
        ok_data = len(dataset) > 0 and all(
            np.isfinite(np.asarray(v, np.float32)).all()
            for v in sample.values())
        with open(os.path.join(crops["layers"], ".zarray")) as f:
            compressor = json.load(f)["compressor"]
        print(f"phase 16: 24 PNG slices -> tiff_to_zarr -> zarr_crop "
              f"(16, 32, 32) equal {ok_crop}, compressor {compressor} -> "
              f"dataset of {len(dataset)} patches, sample {shapes}")
        normals = create_zarr(str(work / "normals.zarr"), (3, 4, 16, 16),
                              np.uint16, (3, 4, 16, 16), compressor=None)
        normals[...] = rng.integers(0, 65536, (3, 4, 16, 16),
                                    dtype=np.uint16)
        n = write_normals_slices(str(work / "normals.zarr"),
                                 str(work / "normals_png"), use_16bit=True)
        ok_normals = n == 4 and np.array_equal(
            read_image(str(work / "normals_png" / "normals_z0001.png")),
            np.transpose(normals[:, 1], (1, 2, 0)))
        obj = work / "plane.obj"
        obj.write_text("v 1 1 3\nv 14 1 3\nv 14 14 3\nv 1 14 3\n"
                       + "vn 0 0 1\n" * 4 + "f 1//1 2//2 3//3\n"
                       "f 1//1 3//3 4//4\n")
        mesh_rasterize.write_face_normals([str(obj)], str(work / "mesh"),
                                          (2, 5), 16, 16, num_threads=2)
        hit = read_image(str(work / "mesh" / "00003.png"))
        ok_mesh = bool(hit.any()) and not read_image(
            str(work / "mesh" / "00002.png")).any()
        print(f"phase 16: normals_slices wrote {n} slices, equal {ok_normals};"
              f" mesh_rasterize hit the plane at z 3 only {ok_mesh} "
              f"({time.perf_counter() - t_phase:.1f} s)")
        if not (ok_crop and ok_data and ok_normals and ok_mesh):
            failures.append(f"phase 16: crop {ok_crop} dataset {ok_data} "
                            f"normals {ok_normals} mesh {ok_mesh}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return failures


def worker_main(argv) -> int:
    """``chip_smoke.py --worker MODE RANK WORLD PORT WORK [ARG]``: one rank
    of phase 14b (``step``) or 15 (``engine``); prints its result as a
    ``RESULT {json}`` line."""
    from pathlib import Path
    from mt3d_resenc_unet_torch.core.config import set_precision
    from mt3d_resenc_unet_torch.parallel import distributed
    mode, rank, world, port, work, *extra = argv
    set_precision()
    fn = {"step": step_worker, "engine": engine_worker}[mode]
    try:
        result = fn(int(rank), int(world), int(port), Path(work), *extra)
        result["rank"] = int(rank)
        print("RESULT " + json.dumps(result), flush=True)
        distributed.sync_global_devices("done")
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker_main(sys.argv[2:]))
    sys.exit(main())
