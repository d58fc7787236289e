#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100): builds the
port's CUDA kernels, holds each against its plain PyTorch version at the
flagship's shapes, runs the full-width flagship forward against the plain
fp32 path, serves a volume through ``predict_volume``, runs the full-width
flagship training step through the kernels against the plain fp32 path,
with and without squeeze-excitation (its norm tail and unfused statistics
on the norm-act kernels), holds the fused instance-norm op and the step
modes of its kernels against their plain versions, trains
``tasks/sheet_normals.yaml``'s network (squeeze-excitation on) through the
port's ``Trainer`` on a synthetic zarr dataset, serves a zarr volume
through the port's inference engine in each of its model passes, runs
``tasks/ink.yaml``'s 5-stage plan at its non-cubic patch through the
kernels against the plain path, holds the device augmentation and every
optimizer of the factory on the card against the CPU, runs the training
step and the trainer with the augmentation on the card, runs the training
step and the engine's tiled pass in several processes over
``torch.distributed``, runs the data-prep tools, holds the port's own
zarr chunk codec against golden chunks that tensorstore and ``zstandard``
wrote, runs every dtype the trainer and the engine take (compute
float32 and float16 with the kernels left on, ``param_dtype`` bfloat16),
runs the port's two CLIs in subprocesses on a task file written from
``tasks/sheet_normals.yaml``'s own text, and last reads and writes
private s3 and gs buckets, signed, on an emulator that checks the
signatures. Every zarr store it makes is
Blosc zstd-5 bit shuffle, the system's own format, read and written by the
port's codec, also over HTTP. Every task setting it uses is read from
``tasks/*.yaml`` through the port's own YAML reader.

    python3 chip_smoke.py

(``chip_smoke.py --worker MODE ...`` is one rank of phase 14b or 15;
``--serve`` and ``--cas-writer`` are phase 7/8's HTTP server and phase
22's chunk writers, as the script itself starts them.)

Phases (any failure exits non-zero and prints no result line):
  1. build the kernels from ``mt3d_resenc_unet_torch/ops/csrc`` (one nvcc
     per source, all at once), print the registers, shared memory and
     spills ``-Xptxas -v`` reports (per entry for the twelve tensor-core
     sources, every conv and upsample source), the fp32 conv's and
     upsample's instruction counts (``tools/sass_stats.py``) and the card's
     name and power limit, and which of ``yaml``, ``PIL``, ``imageio``, ``cv2`` and
     ``torch.utils.tensorboard`` import on this machine (tried in a child
     process: the port needs none of them); set the port's one precision
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
     bytes at 3.35 TB/s); (2h) the same cases through the fp16 kernels
     (``*_f16``: the bf16 sources instantiated on ``__half``) on fp16
     tensors against the plain version on them, F16_TOL, library ms of the
     fp16 cuDNN call; (2f) the same cases through the fp32 kernels
     (``conv3d_k3_*_f32``, ``upsample2x_f32``: FP64 MMA, csrc/
     conv3d_k3_f32_fwd.cu, conv3d_k3_f32_dx.cu, conv3d_k3_f32_dw.cu and
     upsample2x_f32.cu), the stride-2 forward
     in every mode (its modes other than stats from a generator of their
     own), on fp32 tensors, held by
     relative L2 F32_TOL (statistics F32_STATS_TOL) against the plain
     version evaluated in fp64 on the same inputs, the fp32 plain
     version's own error beside it, library ms of the fp32 cuDNN call,
     bound max(3 x FLOPs at 494.7 TFLOP/s (3xTF32), bytes at 3.35 TB/s);
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
     ms and bound per training step. The norm-act kernels' step modes (the
     tail forward and backward, the raw statistics) must have launched as
     often as ``models/network.py::norm_launches`` derives from the plan,
     and the plain fp32 path must launch no kernel at all (counters zeroed
     before it). Before (b), two first steps through the kernels from the
     same weights and batch must be bit-equal (losses and grad_norm). (d)
     All nine conv and upsample kernels run twice on the same inputs at the
     flagship's shapes in the step's modes (dx at both strides with corr
     and corr+post), and the norm-act stats, raw-stats, bwd-stats, tail
     and tail-backward kernels at the flagship's norm shapes: every output,
     statistic and [sum du*x; sum du] must be bit-equal (they sum in a
     fixed order, without floating-point atomics); (a) and (d) run the
     nine fp32 kernels too, held as in (2f), and the nine fp16 ones, held
     as in (2h) ((a) adds the stride-1 dx and dW from a cotangent at
     F16_SMALL, fp16 subnormals; (d) the norm-act kernels at fp16 too).
     (e) The
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
     with every kernel replaced by its plain version, each of its four
     kernels against its plain version; then, at the same shapes, the
     kernels' step modes against their plain versions: the raw statistics,
     and the tail forward and backward with no residual, a residual and a
     residual through ``residual_pre``, act on and off. Printed per case:
     the errors, the median ms of kernel, plain and library call
     (``torch.var_mean`` for the statistics; ``F.instance_norm`` on the
     channels-last NCDHW view and its backward by ``torch.autograd.grad``
     for rows 10 and 11, whose device kernels are listed once), the bound
     and its share; per kernel the sums over the cases; and the step modes'
     ms, plain ms and bound per training step (phase 5c's launches by shape
     and mode times these cases); then the op, its four kernels and the
     step modes again at fp16 (cases named ``<kernel>_f16``, F16_TOL);
  7. the trainer: a seeded synthetic sheet + normals dataset written as
     Blosc zstd-5 bit shuffle zarr v2, as the reference writes it (image
     u8 (256, 384, 384), sheet u8, normals u16), whose first 8 samples must
     be bit-equal to those of an uncompressed copy of the same volumes and
     to those of the same volumes read over HTTP (``http_root``: a local
     ``http.server`` in a child process; the image's read rate over
     HTTP printed beside the local one, ``read_rates``), and
     ``Trainer(config_dict=...)`` on ``tasks/sheet_normals.yaml`` as the
     port's YAML reader reads it, squeeze-excitation included, for 2
     epochs of 6 steps and 2 validation steps, then resumed from its checkpoint to a 3rd epoch: the
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
     (256, 512, 512) written as Blosc zstd-5 bit shuffle zarr with 128^3
     chunks, into the engine's default (Blosc) stores:
     (a) ``device_accumulate: "auto"``, which must take the device pass
     (finals marked "finalized on device"), then three more times, in
     turns on an uncompressed copy of the input and on the Blosc input
     (cut from five to keep the command in time): every
     run's finals bit-equal to the first run's, the median loop rate of
     each input, and the input's decode cost (CPU seconds of every chunk
     on one thread, the volume read on the pool, against the uncompressed
     copy's read); (b) the rolling host
     pass; (c) the tiled pass at a budget of two y-bands, killed after its
     first tile and resumed, whose sums and counts must be bit-equal to an
     uninterrupted tiled run's; (d) ``postprocess_only`` twice on (b)'s
     store, which must skip the finalize and keep the finals' bits; (e) a
     uint16 copy of a (160, 256, 256) corner on the device pass against
     the rolling pass; (f) the rolling and the uncut tiled pass again on the
     uncompressed input into uncompressed stores, for their rates beside
     (b)'s and (c)'s; (g) the device pass with its input read over HTTP
     (``http_root``), whose finals must be bit-equal to (a)'s, its loop
     rate and the input's read rate printed beside the local ones. The
     finals of (b), (c) and (e) are held against the
     device pass's with ``tests/test_infer_device.py``'s limits; every
     launch counter is zeroed before each run and the three forward
     kernels must be above zero after it. Printed per run, beside the
     card's name and power limit: patches/s and voxels/s (wall and loop),
     ``last_phases``, peak device memory and the host slab's peak; then the
     bytes on disk of the inputs and of each pass's stores, beside their
     raw size.
  9. ``tasks/ink.yaml``'s plan as the port's YAML reader reads it (5
     stages, 32-512 channels, BasicBlockD, the ink head with
     BCEWithLogitsLossZSmooth) at its (64, 192, 192)
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
     unaugmented wire bytes), cut to one epoch and a resumed second
     (AUG_TRAINER_EPOCHS) to keep the command in time, its patches/s and
     ``t_fetch`` share beside phase 7's;
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
 15. phase 8's volume (Blosc, as phase 8's) through the engine's tiled
     pass at ENGINE_MP_BUDGET_GB, whose y-band is not a multiple of the
     stores' chunks, so the two ranks write parts of the same compressed
     chunks: one process, then two worker processes over gloo sharing the
     store (round-robin tiles): ``*_sum``, ``*_count`` and ``*_final``
     bit-equal, the ranks' tile sets disjoint and non-empty, both
     watermarks present; patches/s for each process;
 16. host only and tiny: PNG slices -> ``tools/tiff_to_zarr.py`` ->
     ``tools/zarr_crop.py`` -> the port's dataset, ``normals_slices`` and
     ``mesh_rasterize`` once each, on this machine's packages; the crop
     must be Blosc zstd, the JAX tool's default;
 17. host only: the port's zarr chunk codec (``data/codec.py``, built by
     g++ from ``data/csrc/zcodec.cpp``): every golden chunk of
     ``tests/data/zarr_codec/`` decoded to its manifest's sha256 (the only
     decode on this machine of bytes another encoder wrote; Blosc snappy
     among them), every writable compressor round-tripped over a seeded
     u8, u16 and f4 128^3 chunk, decode and encode MB/s of raw bytes on one
     thread and on the store's chunk pool and the compression ratio for
     Blosc zstd-5 bit shuffle on a 128^3 u8 image chunk and a 128^3 fp32
     sum chunk, the same on one thread for Blosc snappy bit shuffle, and
     ``ldd`` of the library (no codec library linked);
 18. the flagship step at compute dtype float32 and float16, the plan
     from the config with ``use_pallas_conv`` unset (the kernels on for
     the card), TRAIN_STEPS steps each with every counter zeroed before:
     all nine conv and upsample kernels of the dtype (``_f32`` / ``_f16``)
     launched and none of another dtype; no plain version of a conv or
     upsample kernel called (``counting_plain``); the norm-act modes
     exactly as ``norm_launches`` derives for the dtype (fp16 as bf16),
     the losses finite, the first step's loss and grad_norm within
     DTYPE_LIMITS of the plain fp32 path's; median ms beside plain's; each
     step's launches by shape and mode times the cases of 2f / 2h and 5a
     give each fp32 and fp16 kernel's ms, library ms and bound per step,
     and the fp16 step's norm-act modes times phase 6's fp16 cases;
 19. the flagship step with ``param_dtype`` bfloat16 and bf16 compute:
     two first steps bit-equal, TRAIN_STEPS steps with every counter
     zeroed before, all nine conv and upsample kernels launched and the
     norm-act modes as ``norm_launches`` derives; ms and peak memory
     beside phase 5b's;
 20. the engine's device pass at compute dtype float32 (the fp32
     forward kernels of rows 1, 4 and 7 launch, no other), bfloat16 and
     float16 (run in bf16, as the JAX engine runs it: finals bit-equal to
     bf16's) on a seeded (160, 256, 256) u8 Blosc volume from one
     checkpoint, the fp32 finals held against the bf16 ones by
     ENGINE_DTYPE_LIMITS; then ``predict_volume`` on that volume with an
     fp16 kernel model (rows 1h, 4h, 7h launched) against the bf16 one,
     phase 3's limits;
 21. the CLIs as a user runs them (``cli_phase``): ``python -m
     mt3d_resenc_unet_torch.train --config_path FILE --verbose`` and
     ``python -m mt3d_resenc_unet_torch.infer --config_path FILE`` in
     subprocesses, on ``tasks/sheet_normals.yaml``'s text with only its
     paths, steps and epochs cut line by line, at full width on phase 7's
     dataset: rc 0, kernels on, checkpoints and final weights, losses
     bit-equal to phase 7's run of the same config, the CLI's finals
     bit-equal to the engine's in this process on a (160, 256, 256) u8
     Blosc input; then the overwrite guard, ``--postprocess_only`` twice,
     ``--write_layers``, a legacy ``tr_params:`` file and
     ``--debug_dataloader`` (these two beside the training CLI); the
     training CLI must leave the debug GIF
     (``sheet_normals_debug.gif``, through PIL where imageio is absent)
     with a frame a z-slice of the patch. A failed subprocess fails the
     run.
 22. private buckets (``bucket_phase``), through the S3 + GCS emulator
     of the CPU tests (``tests/bucket_emulator.py``, standard library
     only) in a child process, strict: it refuses anonymous requests,
     checks SigV4 with its own code (``sigv4_ok``) and grants bearer
     tokens only for a JWT whose RS256 signature verifies against the
     golden test key (``jwt_claims_ok``); the port's clients carry
     AWS's example credentials and the test service account: (a) the
     golden requests of ``tests/data/remote_auth/`` (tensorstore's)
     signed again by the port and accepted by ``sigv4_ok``, the golden
     JWT signed again; an anonymous request and a wrong secret refused;
     (b) phase 7's dataset copied into ``s3://`` and ``gs://`` by the
     port, its first SAME_SAMPLES samples from each bit-equal to the
     local read; (c) ``tools/zarr_crop.py`` local -> s3 -> gs twice (the
     second over the first: ``delete_existing``), bit-equal to a local
     crop, Blosc zstd; (d) the engine's device pass at full width on a
     (160, 256, 256) u8 input (phase 8's volume cut so that the pass
     stays within 60 s) read from ``s3://``, finals bit-equal to the
     same pass on the local input, every counter zeroed before each run,
     rows 1, 4, 7 and the norm tail and raw statistics (10a, 10b)
     launched and no backward kernel; (e) two
     processes (``chip_smoke.py --cas-writer``) writing the halves of
     one chunk CAS_ROUNDS times each on s3 and on gs: both halves kept,
     overtaken writes (412) seen; (f) the loopback's write and read MB/s,
     labelled host rates, beside the card's name and power limit.
Two processes time-sharing one card measure correctness, not scaling.
Every worker process has a DIST_TIMEOUT_S limit; its failure fails the
run.
Then one JSON line of the thirteen kernels, the three step modes of the
norm-act kernels, the nine fp32 conv and upsample kernels and all sixteen
at fp16 (``_f16``; launches;
``max_abs_err``, the worst case's: for a bf16 or norm-act kernel its max
abs difference from the plain version over the plain output's max abs,
for an fp32 kernel its relative L2 from the plain version evaluated in
fp64; ``stats_err``, the worst statistics or [sum du*x; sum du] error
of the same kind as the phase's limit on it, or null where the kernel
emits none; ms, plain_ms, library_ms and bound_ms summed over each
kernel's cases; the conv and upsample kernels' launches from phase 7's
trainer, the fp32 and fp16 ones' and the fp16 step modes' from phase
18's steps, the norm-act op's from phase 6, the bf16 step modes' from
phase 5c) and, last, the device line.

Imports torch and the port only: nothing of JAX or of the JAX package.
"""

import collections
import concurrent.futures
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# the helper processes (the HTTP server, the chunk writers) start faster
# without torch, which they do not use
if not (__name__ == "__main__" and sys.argv[1:2] in (
        ["--serve"], ["--cas-writer"])):
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
# the fp32 kernels (FP64 MMA) against their plain versions evaluated in fp64
# on the same inputs: relative L2 of outputs, dx, dW and dst, and stats_err
# of the [sum; sumsq]. The fp32 plain version's own error (cuDNN / cuBLAS
# in fp32, TF32 off) is printed beside each case
F32_TOL = 1e-5
F32_STATS_TOL = 1e-5
# the fp16 kernels (the bf16 sources on __half) against the plain version on
# the same fp16 inputs: both round fp32 sums taken in another order to
# fp16, one fp16 step (2^-11 of a value) apart; statistics as bf16's. From
# a cotangent at the flagship's ~2e-7 (F16_SMALL: fp16 subnormals) dx is
# subnormal too, and one step is F16_SUBNORMAL_STEP (2^-24) absolute: on
# an H100 (NVIDIA H100 80GB HBM3, 700 W) 5% of dx's max abs at 32->32
# @128^3, so such a case is held to the larger of the two
F16_TOL = 2e-3
F16_SMALL = 2e-7
F16_SUBNORMAL_STEP = 2.0 ** -24
SEED = 0
# the card's published dense peaks (NVIDIA H100 SXM data sheet, 700 W):
# bf16 tensor cores, fp32 outside them, and HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
# TF32 on the tensor cores; the fp32 kernels' bound takes three products
# for each fp32 one at this rate (3xTF32, the card's fastest fp32-accurate
# route; the kernels run on the FP64 tensor cores, 67 TFLOP/s)
PEAK_TF32 = 494.7e12
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
# phase 9: tasks/ink.yaml's plan, patch, batch and loss, read through the
# port's YAML reader (``task_file``); the steps it runs
INK_STEPS = 2
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
# the tail modes phase 6 runs at each NORM_CASES shape: (residual,
# residual_pre) for no residual, a residual, and a residual through (a, b);
# each with act on and off
TAIL_MODES = ((False, False), (True, False), (True, True))
# phase 7: the synthetic dataset and the trainer's cut of sheet_normals.yaml
TRAIN_DATA = (256, 384, 384)
TRAINER_EPOCHS = 2
AUG_TRAINER_EPOCHS = 1      # phase 12's, cut to keep the command in time
TRAINER_STEPS = 6
TRAINER_VAL_STEPS = 2
WORK_DIR = "build/chip_smoke"
ROOT = os.path.dirname(os.path.abspath(__file__))
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
_IN = "mt3d_resenc_unet_tpu/ops/instance_norm.py"
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
    # the modes of the same kernels on the training step: the JAX package's
    # XLA functions they stand for (not Pallas)
    "norm_act_raw_stats": f"{_IN}:111",       # packed_stats_xla
    "norm_act_tail": f"{_IN}:121",            # norm_apply_packed
    "norm_act_tail_bwd": f"{_IN}:121",        # its backward (autodiff)
}
CONV_KERNELS = tuple(REPLACES)[:9]
NORM_KERNELS = tuple(REPLACES)[9:13]
TAIL_KERNELS = tuple(REPLACES)[13:16]
FORWARD = ("conv3d_k3_s1", "conv3d_k3_s2", "upsample2x")
# rows 1-9 at compute dtype float32: the same TPU kernels, the fp32 kernels
# of csrc/conv3d_k3_f32_fwd.cu (rows 1f, 4f), csrc/conv3d_k3_f32_dx.cu
# (rows 2f, 6f), csrc/conv3d_k3_f32_dw.cu (rows 3f, 5f) and
# csrc/upsample2x_f32.cu
F32_KERNELS = tuple(f"{k}_f32" for k in CONV_KERNELS)
F32_FORWARD = tuple(f"{k}_f32" for k in FORWARD)
REPLACES.update({f"{k}_f32": REPLACES[k] for k in CONV_KERNELS})
# rows 1-11 at compute dtype float16: the bf16 sources instantiated on
# __half (csrc/b16.cuh; the conv and upsample wrappers count them as
# <name>_f16) and the norm-act kernels at fp16 (counted under their own
# names at every dtype; their fp16 cases here are named <name>_f16)
F16_KERNELS = tuple(f"{k}_f16" for k in CONV_KERNELS)
F16_FORWARD = tuple(f"{k}_f16" for k in FORWARD)
F16_NORM = tuple(f"{k}_f16" for k in NORM_KERNELS)
F16_TAIL = tuple(f"{k}_f16" for k in TAIL_KERNELS)
REPLACES.update({f"{k}_f16": REPLACES[k]
                 for k in CONV_KERNELS + NORM_KERNELS + TAIL_KERNELS})
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
    **{name: f"{_CS}/norm_act.cu" for name in NORM_KERNELS + TAIL_KERNELS},
    **{f"{name}_f32": f"{_CS}/upsample2x_f32.cu" if "upsample" in name
       else f"{_CS}/conv3d_k3_f32_fwd.cu" if name in FORWARD
       else f"{_CS}/conv3d_k3_f32_dx.cu" if "_dx_" in name
       else f"{_CS}/conv3d_k3_f32_dw.cu" for name in CONV_KERNELS},
}
SOURCES.update({f"{k}_f16": SOURCES[k]
                for k in CONV_KERNELS + NORM_KERNELS + TAIL_KERNELS})


def dtype_tols(dtype):
    """(suffix, element bytes, output limit, sums limit) of the kernels at
    ``dtype``: bf16 KERNEL_TOL, fp16 F16_TOL (both STATS_TOL), fp32
    F32_TOL / F32_STATS_TOL."""
    if dtype == torch.float32:
        return "_f32", 4, F32_TOL, F32_STATS_TOL
    if dtype == torch.float16:
        return "_f16", 2, F16_TOL, STATS_TOL
    return "", 2, KERNEL_TOL, STATS_TOL


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
    print("  fp32 forward (conv3d_k3_f32_fwd): "
          + ", ".join(f"{'big' if t == 0 else 'small'} tile stride {s} "
                      f"{c3.f32_fwd_smem(t, s)} B" for t, s in
                      ((0, 1), (1, 1), (0, 2))))
    print("  fp32 dx (conv3d_k3_f32_dx): "
          + ", ".join(f"tile {t} ({c3.F32_DX_TILES[t]['brick']} x "
                      f"{c3.F32_DX_TILES[t]['bn']}) {c3.f32_dx_smem(t, False)}"
                      f" B, with corr {c3.f32_dx_smem(t, True)} B"
                      for t in c3.F32_DX_TILES))
    for ci, co, extent in UP_CASES:
        f = up._up_f32_fwd_plan(2, (extent,) * 3, ci, co, 132)
        x = up._up_f32_dx_plan(2, (extent,) * 3, ci, co, 132)
        w = up._up_f32_dw_plan(2, (extent,) * 3, ci, co, 132)
        print(f"  fp32 upsample {ci}->{co} (upsample2x_f32.cu): forward "
              f"{f['smem']} B (tile {f['m']} x {f['ncol']} of 8 x co, "
              f"{f['groups']} groups, weights resident), dx {x['smem']} B "
              f"(tile {x['m']} x {x['ncol']} ci, steps of {x['kc']} co), "
              f"dW {w['smem']} B (tile 8 parities x {up.F32_DW_CO} co x "
              f"{w['ci_tile']} ci, {w['tiles']} tiles x {w['splits']} "
              f"splits of {w['steps']} steps of {up.F32_DW_R} voxels, "
              f"{w['part_len'] * 8} B of fp64 scratch)")
    print("  fp32 dW (conv3d_k3_f32_dw): "
          + ", ".join(f"tile {t} (stride {d['stride']}, {d['brick']} x "
                      f"{d['co']} co x {d['ci']} ci, {d['stages']} stages) "
                      f"{c3.f32_dw_smem(t, False)} B, with corr "
                      f"{c3.f32_dw_smem(t, True)} B"
                      for t, d in c3.F32_DW_TILES.items()))
    for source in ("conv3d_k3_s1", "conv3d_k3_s2", "conv3d_k3_dx_s1",
                   "conv3d_k3_dx_s2", "conv3d_k3_dw_s1", "conv3d_k3_dw_s2",
                   "upsample2x", "upsample2x_bwd", "conv3d_k3_f32_fwd",
                   "conv3d_k3_f32_dx", "conv3d_k3_f32_dw",
                   "upsample2x_f32"):
        entry = None
        for line in logs[source].splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and ("spill" in line or "registers" in line):
                usage = line.split(":", 1)[-1].strip()
                print(f"  {source} {entry[:60]}: {usage}")


def _f64(kw):
    """The tensors of ``kw`` in fp64 (the plain versions' exact yardstick)."""
    return {k: v.double() if isinstance(v, torch.Tensor) else v
            for k, v in kw.items()}


def rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def case_errors(got, want, exact, f32, i=0):
    """The error of output ``i`` of a case (a tensor or a tuple): bf16, the
    max abs difference from the plain version over its max abs; fp32 the
    relative L2 from the plain version evaluated in fp64 on the same
    inputs (``exact``), and the fp32 plain version's own (cuDNN / cuBLAS,
    TF32 off) beside it. Returns (err, plain version's err or None)."""
    pick = (lambda t: t[i] if isinstance(t, tuple) else t)
    if not f32:
        return rel_err(pick(got), pick(want)), None
    return rel_l2(pick(got), pick(exact)), rel_l2(pick(want), pick(exact))


def kernel_cases(dev, gen, conv_cases, s2_cases, up_cases, n=2,
                 timed=True, dtype=None, s2_modes=("stats",)):
    """Phase 2 (and the ink plan's forward cases in phase 10, untimed: no
    ms, and no library call), for the bf16 kernels or, with ``dtype``
    float32 / float16, the fp32 / fp16 ones (names ending in ``_f32`` /
    ``_f16``; fp16 held by F16_TOL). Returns (per-case
    records, failures). Each record holds the kernel's and the plain
    version's median ms, the library call's in the same dtype
    (``library_ms``: cuDNN through F.conv3d / F.conv_transpose3d on the
    same tensors viewed as channels-last NCDHW, weights laid out for it
    before timing) and the bound. bf16 kernels are held against the plain
    version by KERNEL_TOL / STATS_TOL; fp32 kernels against the plain
    version evaluated in fp64 on the same inputs by F32_TOL /
    F32_STATS_TOL (the fp32 plain version's own error printed beside). The
    stride-2 cases run in ``s2_modes``. An extent is an int (a cube) or (D,
    H, W)."""
    import torch.nn.functional as F
    from mt3d_resenc_unet_torch.ops.conv3d import conv3d_k3, conv3d_k3_plain
    from mt3d_resenc_unet_torch.ops.upsample import upsample2x, upsample_plain
    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    sfx, esize, tol, s_tol = dtype_tols(dtype)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=gen.device)
                * scale).to(dev)

    def ms_of(fn):
        return median_ms(fn) if timed else None

    def bound_of(flops, nbytes):
        """(bound ms, its limit, and at fp32 the FP64 tensor cores' bound
        ms beside the 3xTF32 one)."""
        if not f32:
            return bound(flops, nbytes) + (None,)
        return bound(3 * flops, nbytes, PEAK_TF32) + (
            bound(flops, nbytes, PEAK_FP32)[0],)

    records, failures = [], []
    todo = [(s, ci, co, e, m) for s, ci, co, e in conv_cases
            for m in CONV_MODES]
    todo += [(s, ci, co, e, m) for s, ci, co, e in s2_cases
             for m in s2_modes]
    lib_ms = {}
    for stride, ci, co, extent, mode in todo:
        x = randn(n, *_ext(extent), ci).to(dtype)
        w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).to(dtype)
        eo = tuple(e // stride for e in _ext(extent))
        kw = dict(emit_stats=mode != "plain")
        if mode == "pre_stats":
            kw["pre"] = torch.stack(
                [torch.rand(n, ci, generator=gen, device=gen.device) * 1.5
                 + 0.5, torch.randn(n, ci, generator=gen, device=gen.device)],
                1).to(dev)
        if mode == "addin_stats":
            kw["add_to"] = randn(n, *eo, co).to(dtype)
        got = conv3d_k3(x, w, stride, **kw)
        want = conv3d_k3_plain(x, w, stride, **kw)
        exact = (conv3d_k3_plain(x.double(), w.double(), stride, **_f64(kw))
                 if f32 else None)
        torch.cuda.synchronize()
        if mode == "plain":
            got, want = (got, None), (want, None)
            exact = (exact, None) if f32 else None
        err, plain_err = case_errors(got, want, exact, f32)
        s_err = (stats_err(got[1], exact[1] if f32 else want[1])
                 if got[1] is not None else None)
        del exact
        ms = ms_of(lambda: conv3d_k3(x, w, stride, **kw))
        plain_ms = ms_of(lambda: conv3d_k3_plain(x, w, stride, **kw))
        key = (stride, ci, co, extent)
        if timed and key not in lib_ms:
            # one library call per shape: the conv alone
            xl, wl = _ncdhw(x), _lib_conv_w(w)
            lib = F.conv3d(xl, wl, stride=stride, padding=1)
            # the first case of a shape is its plain or stats mode, whose
            # output is the conv alone
            print(f"  library conv3d {ci}->{co} {_at(extent)} s{stride} "
                  f"{dtype}: err "
                  f"{rel_err(lib.permute(0, 2, 3, 4, 1), want[0]):.3e} "
                  "vs plain")
            lib_ms[key] = median_ms(
                lambda: F.conv3d(xl, wl, stride=stride, padding=1))
            del xl, wl, lib
        nbytes = esize * (x.numel() + w.numel() + n * math.prod(eo) * co * (
            2 if "addin" in mode else 1)) + (8 * n * ci if "pre" in mode
                                             else 0) + (8 * n * co if mode
                                                        != "plain" else 0)
        b_ms, b_by, b64 = bound_of(conv_flops(n, ci, co, extent, stride),
                                   nbytes)
        name = f"conv3d_k3_s{stride}{sfx}"
        case = f"{ci}->{co} {_at(extent)} {mode}"
        records.append(dict(kernel=name, shape=(ci, co, extent), mode=mode,
                            case=case, max_abs_err=err, stats_err=s_err,
                            plain_err=plain_err,
                            ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms.get(key), bound_ms=b_ms,
                            bound_by=b_by, fp64_bound_ms=b64,
                            tflops=conv_flops(n, ci, co, extent, stride)
                            / ms / 1e9 if timed else None))
        if not err <= tol or (s_err is not None and not s_err <= s_tol):
            failures.append(f"{name} {case}: err {err} stats {s_err}")
        del x, w, kw, got, want
    for ci, co, extent in up_cases:
        x = randn(n, *_ext(extent), ci).to(dtype)
        wf = randn(2, 2, 2, ci, co, scale=(8 * co) ** -0.5).to(dtype)
        got, want = upsample2x(x, wf), upsample_plain(x, wf)
        exact = upsample_plain(x.double(), wf.double()) if f32 else None
        torch.cuda.synchronize()
        err, plain_err = case_errors(got, want, exact, f32)
        del exact
        flops = 2 * 8 * ci * co * x.numel() // ci
        b_ms, b_by, b64 = bound_of(flops, esize * (x.numel() + wf.numel()
                                              + got.numel()))
        lib = None
        if timed:
            xl, wu = _ncdhw(x), _lib_up_w(wf)
            out = F.conv_transpose3d(xl, wu, stride=2)
            print(f"  library conv_transpose3d {ci}->{co} {_at(extent)} "
                  f"{dtype}: err "
                  f"{rel_err(out.permute(0, 2, 3, 4, 1), want):.3e} vs plain")
            lib = median_ms(lambda: F.conv_transpose3d(xl, wu, stride=2))
            del xl, wu, out
        ms = ms_of(lambda: upsample2x(x, wf))
        case = f"{ci}->{co} {_at(extent)}"
        records.append(dict(kernel=f"upsample2x{sfx}", shape=(ci, co, extent),
                            mode="plain", case=case, max_abs_err=err,
                            stats_err=None, plain_err=plain_err, ms=ms,
                            plain_ms=ms_of(lambda: upsample_plain(x, wf)),
                            library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                            fp64_bound_ms=b64,
                            tflops=flops / ms / 1e9 if timed else None))
        if not err <= tol:
            failures.append(f"upsample2x{sfx} {case}: err {err}")
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
    # the fp32 forward's, dx's, dW's and upsample's compiled code: their MMAs,
    # shared-memory loads and fp32 -> fp64 conversions (tools/sass_stats.py)
    from mt3d_resenc_unet_torch.tools import sass_stats
    sass_stats.main(["conv3d_k3_f32_fwd", "conv3d_k3_f32_dx",
                     "conv3d_k3_f32_dw", "upsample2x_f32"])
    print(card())
    print("packages on this machine: " + ", ".join(
        f"{name} {'imports' if ok else 'missing'}"
        for name, ok in importable(OPTIONAL_PACKAGES).items()))

    ink = task_file("ink")["tr_config"]
    t0 = time.perf_counter()
    rc = run(dev, CONV_CASES, S2_CASES, UP_CASES, PATCH, VOLUME,
             TRAIN_STEPS, NORM_CASES, TRAIN_DATA, ENGINE_VOLUME,
             ENGINE_U16_VOLUME, tuple(ink["patch_size"]), ink["batch_size"])
    print(f"phases 2-22: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    return rc


# the optional packages the JAX package and the port may reach for; phase 1
# says which import on the card's machine (the port needs none of them)
OPTIONAL_PACKAGES = ("yaml", "PIL", "imageio", "cv2",
                     "torch.utils.tensorboard")


def importable(names):
    """{name: whether ``import name`` succeeds}, tried in a child process,
    so that this script imports none of them."""
    code = ("import importlib, json, sys\n"
            "ok = {}\n"
            "for name in sys.argv[1:]:\n"
            "    try:\n"
            "        importlib.import_module(name)\n"
            "        ok[name] = True\n"
            "    except Exception:\n"
            "        ok[name] = False\n"
            "print(json.dumps(ok))\n")
    out = subprocess.run([sys.executable, "-c", code, *names],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def task_file(name):
    """``tasks/{name}.yaml`` as the config system reads it: through the
    port's own YAML reader (``core/yaml_load.py``)."""
    from mt3d_resenc_unet_torch.core.yaml_load import safe_load
    with open(os.path.join(ROOT, "tasks", f"{name}.yaml"),
              encoding="utf-8") as f:
        return safe_load(f)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run(dev, conv_cases, s2_cases, up_cases, patch, volume,
        train_steps, norm_cases, train_data, engine_volume,
        engine_u16_volume, ink_patch, ink_batch) -> int:
    """Phases 2-22 and the result lines; the case lists and sizes are
    arguments so the phases can be rehearsed at a tiny size."""
    from mt3d_resenc_unet_torch.ops import _build
    failures = []
    mark = [time.perf_counter()]

    def lap(label=None):
        """Prints the seconds since the last lap under ``label`` (as the
        phases that time themselves print theirs); None only restarts."""
        now = time.perf_counter()
        if label:
            print(f"phase {label}: {now - mark[0]:.1f} s")
        mark[0] = now

    # 2. kernels vs plain; the cases of 2, 2f, 5a, 5d, 6 and 9 draw their
    # inputs on the card (at 128^3 the host's draws took most of these
    # phases)
    gen = torch.Generator().manual_seed(SEED)
    gen_dev = torch.Generator(device=dev).manual_seed(SEED)
    records, fails = kernel_cases(dev, gen_dev, conv_cases, s2_cases,
                                  up_cases)
    failures += fails
    lap("2 (kernels)")
    # 2f. the fp32 kernels vs their plain versions in fp64
    f32, fails = kernel_cases(dev, gen_dev, conv_cases, s2_cases, up_cases,
                              dtype=torch.float32)
    failures += fails
    # row 4f in its other modes, from a generator of their own (the later
    # phases draw what they drew before)
    more, fails = kernel_cases(
        dev, torch.Generator(device=dev).manual_seed(SEED + 1), [], s2_cases,
        [], dtype=torch.float32,
        s2_modes=tuple(m for m in CONV_MODES if m != "stats"))
    failures += fails
    f32 += more
    lap("2f (fp32 kernels)")
    records += f32
    # 2h. the fp16 kernels (the bf16 sources on __half) vs plain
    f16, fails = kernel_cases(dev, gen_dev, conv_cases, s2_cases, up_cases,
                              dtype=torch.float16)
    failures += fails
    lap("2h (fp16 kernels)")
    records += f16
    smi = card()
    for r in records:
        p_err = ("" if r["plain_err"] is None
                 else f" (plain fp32 {r['plain_err']:.3e})")
        print(f"  {r['kernel']:17s} {r['case']:28s} err {r['max_abs_err']:.3e}"
              f" stats {r['stats_err'] if r['stats_err'] is None else '%.3e' % r['stats_err']}"
              f"{p_err}  {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  "
              f"library {r['library_ms']:.3f} ms  {r['tflops']:.1f} TFLOP/s"
              f"  bound {r['bound_ms']:.3f} ms ({r['bound_by']})"
              + (f" [{smi}]" if r["plain_err"] is not None else ""))
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
    lap("3 (forward)")

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
    lap("4 (serving)")

    # 5a. backward kernels vs plain
    bwd, fails = backward_cases(dev, gen_dev, conv_cases, s2_cases,
                                up_cases)
    failures += fails
    lap("5a (backward kernels)")
    bwd32, fails = backward_cases(dev, gen_dev, conv_cases, s2_cases,
                                  up_cases, dtype=torch.float32)
    failures += fails
    lap("5a (fp32 backward kernels)")
    bwd16, fails = backward_cases(dev, gen_dev, conv_cases, s2_cases,
                                  up_cases, dtype=torch.float16)
    failures += fails
    lap("5a (fp16 backward kernels)")
    bwd += bwd32 + bwd16
    records += bwd
    for r in bwd:
        dst = "" if r["dst_err"] is None else f" dst {r['dst_err']:.3e}"
        p_err = ("" if r["plain_err"] is None
                 else f" (plain fp32 {r['plain_err']:.3e})")
        print(f"  {r['kernel']:19s} {r['case']:32s} err {r['max_abs_err']:.3e}"
              f"{dst}{p_err}  {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  "
              f"library {r['library_ms']:.3f} ms  {r['tflops']:.1f} TFLOP/s"
              f"  bound {r['bound_ms']:.3f} ms ({r['bound_by']}, "
              f"{r['bound_ms'] / r['ms']:.1%})"
              + (f" [{smi}]" if r["plain_err"] is not None else ""))
    lap()
    failures += deterministic_cases(dev, gen_dev, conv_cases, s2_cases,
                                    up_cases, norm_cases)
    lap("5d (bit-equal)")
    failures += deterministic_cases(dev, gen_dev, conv_cases, s2_cases,
                                    up_cases, dtype=torch.float32)
    torch.cuda.empty_cache()
    lap("5d (fp32 bit-equal)")
    failures += deterministic_cases(dev, gen_dev, conv_cases, s2_cases,
                                    up_cases, norm_cases,
                                    dtype=torch.float16)
    torch.cuda.empty_cache()
    lap("5d (fp16 bit-equal)")

    # 5b, 5c. the flagship training step
    step_summary, step_launches, step_shapes, fails = training(
        fast, plain, flagship_batch(dev, patch, 2), train_steps, "flagship",
        hold_repeat=True)
    failures += fails
    step_table(records, step_shapes, train_steps)
    del fast, plain
    torch.cuda.empty_cache()
    lap("5b, 5c (training step)")

    # 5e. the flagship with squeeze-excitation, as tasks/sheet_normals.yaml
    step_rate, fails = se_phase(dev, gen, patch, train_steps, step_launches)
    failures += fails
    torch.cuda.empty_cache()
    lap("5e (SE)")

    # 6. the fused instance norm + LeakyReLU op, and the step's modes of
    # its kernels
    norm, op_launches, fails = norm_act_cases(dev, gen_dev, norm_cases)
    failures += fails
    tail, fails = norm_tail_cases(dev, gen_dev, norm_cases)
    failures += fails
    # ... and at fp16 (records named <kernel>_f16)
    norm16, op16, fails = norm_act_cases(dev, gen_dev, norm_cases,
                                         torch.float16)
    failures += fails
    tail16, fails = norm_tail_cases(dev, gen_dev, norm_cases, torch.float16)
    failures += fails
    op_launches.update(op16)
    norm += norm16
    tail += tail16
    records += norm + tail
    for r in norm + tail:
        lib = ("" if r["library_ms"] is None
               else f"  library {r['library_ms']:.3f} ms")
        print(f"  {r['kernel']:18s} {r['case']:30s} err "
              f"{r['max_abs_err']:.3e}  {r['ms']:.3f} ms  plain "
              f"{r['plain_ms']:.3f} ms{lib}  bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%})")
    for name in NORM_KERNELS + TAIL_KERNELS + F16_NORM + F16_TAIL:
        mine = [r for r in norm + tail if r["kernel"] == name]
        ms = sum(r["ms"] for r in mine)
        b_ms = sum(r["bound_ms"] for r in mine)
        lib = [r["library_ms"] for r in mine if r["library_ms"] is not None]
        print(f"{name} over phase 6's {len(mine)} cases [{card()}]: "
              f"{ms:.3f} ms, plain {sum(r['plain_ms'] for r in mine):.3f} "
              f"ms, bound {b_ms:.3f} ms ({b_ms / ms:.1%} of it)"
              + (f", library {sum(lib):.3f} ms" if lib else ""))
    norm_step_table(tail, step_shapes, train_steps)
    torch.cuda.empty_cache()
    lap("6 (norm-act)")

    # 7. the trainer on a synthetic zarr dataset
    train_launches, fails, host_trainer = trainer_phase(patch, train_data,
                                                        step_rate)
    failures += fails
    launches = {**{k: train_launches.get(k, 0) for k in CONV_KERNELS},
                **{k: op_launches.get(k, 0) for k in NORM_KERNELS + F16_NORM},
                **{k: step_launches.get(k, 0) for k in TAIL_KERNELS}}
    failures += [f"kernels line: {k} has no launches"
                 for k, v in launches.items() if v <= 0]
    lap("7 (trainer)")

    # 8. the zarr inference engine at full width
    failures += engine_phase(patch, engine_volume, engine_u16_volume)
    lap()

    # 9. tasks/ink.yaml's 5-stage plan at its patch and batch
    failures += ink_phase(dev, gen_dev, ink_patch, ink_batch)
    lap("9 (ink)")

    # 10. device augmentation at the flagship batch, card against CPU
    aug_ms, fails = augment_phase(dev, patch)
    failures += fails
    torch.cuda.empty_cache()

    # 11. the flagship training step with device augmentation
    failures += augmented_step_phase(dev, patch, train_steps, step_summary,
                                     step_launches, aug_ms)
    torch.cuda.empty_cache()
    lap()

    # 12. phase 7's trainer with augment_on_device: true, one epoch and a
    # resumed second (phase 7 trains two and a resumed third)
    _, fails, _ = trainer_phase(patch, train_data, step_rate,
                                device_augment=True, host=host_trainer,
                                epochs=AUG_TRAINER_EPOCHS)
    failures += fails
    torch.cuda.empty_cache()
    lap("12 (trainer, device augmentation)")

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
    lap()
    failures += tools_phase()
    lap("16 (tools)")

    # 17. the port's zarr chunk codec
    failures += codec_phase()

    # 18. the flagship step at compute dtype float32 and float16
    fails, step_runs = dtype_phase(dev, patch)
    failures += fails
    f32_launches, f32_shapes = step_runs["float32"]
    f16_launches, f16_shapes = step_runs["float16"]
    step_table(records, f32_shapes, TRAIN_STEPS, F32_KERNELS,
               "phase 18's fp32 launches x phase 2f / 5a fp32 cases")
    step_table(records, f16_shapes, TRAIN_STEPS, F16_KERNELS,
               "phase 18's fp16 launches x phase 2h / 5a fp16 cases")
    norm_step_table(tail, f16_shapes, TRAIN_STEPS, "_f16",
                    "phase 18's fp16 launches x phase 6 fp16 cases")
    launches.update({k: f32_launches.get(k, 0) for k in F32_KERNELS})
    launches.update({k: f16_launches.get(k, 0) for k in F16_KERNELS})
    launches.update({k + "_f16": f16_launches.get(k, 0)
                     for k in TAIL_KERNELS})
    failures += [f"kernels line: {k} has no launches"
                 for k in F32_KERNELS + F16_KERNELS + F16_TAIL
                 if launches.get(k, 0) <= 0]
    torch.cuda.empty_cache()

    # 19. the flagship step with param_dtype bfloat16
    failures += param_dtype_phase(dev, patch, step_summary)
    torch.cuda.empty_cache()

    # 20. the engine's device pass at compute dtype float32
    failures += engine_dtype_phase(patch, volume)
    torch.cuda.empty_cache()

    # 21. both CLIs on a task file, as a user runs them
    failures += cli_phase(patch, train_data, volume, host_trainer["history"])
    torch.cuda.empty_cache()

    # 22. private buckets: s3 and gs, signed, through the port's stores
    failures += bucket_phase(patch, train_data, volume)
    torch.cuda.empty_cache()

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
        sums = [e for r in mine for e in (r.get("stats_err"),
                                          r.get("dst_err")) if e is not None]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches.get(name, 0),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            stats_err=max(sums) if sums else None,
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
                   timed=True, dtype=None):
    """Phase 5a (and the ink plan's backward cases in phase 10, untimed),
    for the bf16 kernels or, with ``dtype`` float32 / float16, the fp32 /
    fp16 ones, held as :func:`kernel_cases` holds them (dst, the pre-op
    backward's [sum du*x; sum du], by DST_TOL or F32_STATS_TOL); at fp16
    also the stride-1 dx and dW of the first shape with the correction from
    a cotangent at F16_SMALL (mode ``corr_small``, fp16 subnormals; dx held
    to the larger of F16_TOL and one F16_SUBNORMAL_STEP over its max abs).
    Returns (per-case
    records, failures). ``library_ms`` is the cuDNN call of the same
    function in the same dtype: ``torch.nn.grad.conv3d_input`` /
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
    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    sfx, esize, tol, _ = dtype_tols(dtype)
    d_tol = F32_STATS_TOL if f32 else DST_TOL

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=gen.device)
                * scale).to(dev)

    def ms_of(fn):
        return median_ms(fn) if timed else None

    def bound_of(flops, nbytes):
        """(bound ms, its limit, and at fp32 the FP64 tensor cores' bound
        ms beside the 3xTF32 one)."""
        if not f32:
            return bound(flops, nbytes) + (None,)
        return bound(3 * flops, nbytes, PEAK_TF32) + (
            bound(flops, nbytes, PEAK_FP32)[0],)

    records, failures = [], []
    todo = [(s, ci, co, e, "dx", m) for s, ci, co, e in conv_cases
            for m in DX_MODES]
    todo += [(s, ci, co, e, "dw", m) for s, ci, co, e in conv_cases
             for m in DW_MODES]
    todo += [(s, ci, co, e, "dx", m) for s, ci, co, e in s2_cases
             for m in S2_DX_MODES]
    todo += [(s, ci, co, e, "dw", "corr") for s, ci, co, e in s2_cases]
    if dtype == torch.float16 and conv_cases:
        todo += [tuple(conv_cases[0]) + (op, "corr_small")
                 for op in ("dx", "dw")]
    lib_ms = {}
    for stride, ci, co, extent, op, mode in todo:
        eo = tuple(e // stride for e in _ext(extent))
        small = F16_SMALL if mode == "corr_small" else 1.0
        x = randn(n, *_ext(extent), ci).to(dtype)
        w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).to(dtype)
        gy = randn(n, *eo, co, scale=small).to(dtype)
        kw = {}
        if "corr" in mode:
            kw.update(y=randn(n, *eo, co).to(dtype),
                      gs=randn(n, 2, co, scale=0.1 * small))
        if mode in ("pre", "pre_corr", "corr_post"):
            kw["pre"] = torch.stack(
                [torch.rand(n, ci, generator=gen, device=gen.device) * 1.5
                 + 0.5, torch.randn(n, ci, generator=gen, device=gen.device)],
                1).to(dev)
        if op == "dx":
            if "pre" in kw:
                kw["x"] = x
            fn = lambda: conv3d_k3_dx(gy, w, stride, size=x.shape[1:4], **kw)
            ref = lambda: conv3d_k3_dx_plain(gy, w, stride,
                                             size=x.shape[1:4], **kw)
            ref64 = lambda: conv3d_k3_dx_plain(gy.double(), w.double(),
                                               stride, size=x.shape[1:4],
                                               **_f64(kw))
            lib = lambda: torch.nn.grad.conv3d_input(
                xl.shape, wl, gl, stride=stride, padding=1)
        else:
            fn = lambda: conv3d_k3_dw(x, gy, stride, **kw)
            ref = lambda: conv3d_k3_dw_plain(x, gy, stride, **kw)
            ref64 = lambda: conv3d_k3_dw_plain(x.double(), gy.double(),
                                               stride, **_f64(kw))
            lib = lambda: torch.nn.grad.conv3d_weight(
                xl, wl.shape, gl, stride=stride, padding=1)
        got, want = fn(), ref()
        exact = ref64() if f32 else None
        torch.cuda.synchronize()
        err, plain_err = case_errors(got, want, exact, f32)
        dst_err = None
        if isinstance(got, tuple):
            dst_err = case_errors(got, want, exact, f32, 1)[0]
            got, want = got[0], want[0]
        del exact
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
            print(f"  library {op} {ci}->{co} {_at(extent)} s{stride} "
                  f"{dtype}: err {rel_err(out, want):.3e} vs plain ({mode})")
            lib_ms[key] = median_ms(lib)
            del xl, wl, gl, out
        flops = conv_flops(n, ci, co, extent, stride)
        io = x.numel() if op == "dw" or "post" in mode else 0
        nbytes = esize * (io + gy.numel()) + (
            esize * gy.numel() + 8 * n * co if "corr" in mode else 0) + (
            8 * n * ci if "pre" in kw else 0) + (
            esize * (x.numel() + w.numel()) + (8 * n * ci if "post" in mode
                                               else 0)
            if op == "dx" else 4 * w.numel())
        b_ms, b_by, b64 = bound_of(flops, nbytes)
        name = f"conv3d_k3_{op}_s{stride}{sfx}"
        case = f"{ci}->{co} {_at(extent)} {mode}"
        records.append(dict(kernel=name, shape=(ci, co, extent), mode=mode,
                            case=case, max_abs_err=err, dst_err=dst_err,
                            plain_err=plain_err, ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms.get(key), bound_ms=b_ms,
                            bound_by=b_by, fp64_bound_ms=b64,
                            tflops=flops / ms / 1e9 if timed else None))
        ok = err <= tol
        if mode == "corr_small":
            # the absolute difference in fp64, exact for fp16 values
            top = float(want.abs().max())
            diff = float((got.double() - want.double()).abs().max())
            limit = max(tol * top, F16_SUBNORMAL_STEP if op == "dx" else 0)
            ok = diff <= limit
            print(f"  {name} {case}: gy max {float(gy.abs().max()):.3e} "
                  f"(fp16 subnormal below 6.1e-5), {op} max {top:.3e}, "
                  f"max abs diff {diff:.3e} (limit {limit:.3e})")
            if not float(got.abs().max()) > 0:
                failures.append(f"{name} {case}: all zero")
        if not ok or (dst_err is not None and not dst_err <= d_tol):
            failures.append(f"{name} {case}: err {err} dst {dst_err}")
        del x, w, gy, kw, got, want, fn, ref, ref64
    for ci, co, extent in up_cases:
        x = randn(n, *_ext(extent), ci).to(dtype)
        wf = randn(2, 2, 2, ci, co, scale=(8 * co) ** -0.5).to(dtype)
        gy = randn(n, *(2 * e for e in _ext(extent)), co).to(dtype)
        xl, wu, gl = _ncdhw(x), _lib_up_w(wf), _ncdhw(gy)

        def conv_bwd(mask):
            return torch.ops.aten.convolution_backward(
                gl, xl, wu, None, [2] * 3, [0] * 3, [1] * 3, True, [0] * 3, 1,
                mask)

        flops = 2 * 8 * ci * co * x.numel() // ci
        for name, fn, ref, ref64, lib, out_bytes in (
                ("upsample2x_dx", lambda: upsample2x_dx(gy, wf),
                 lambda: upsample2x_dx_plain(gy, wf),
                 lambda: upsample2x_dx_plain(gy.double(), wf.double()),
                 lambda: conv_bwd([True, False, False]), esize * x.numel()),
                ("upsample2x_dw", lambda: upsample2x_dw(x, gy),
                 lambda: upsample2x_dw_plain(x, gy),
                 lambda: upsample2x_dw_plain(x.double(), gy.double()),
                 lambda: conv_bwd([False, True, False]), 4 * wf.numel())):
            got, want = fn(), ref()
            exact = ref64() if f32 else None
            torch.cuda.synchronize()
            err, plain_err = case_errors(got, want, exact, f32)
            del exact
            ms, plain_ms = ms_of(fn), ms_of(ref)
            case = f"{ci}->{co} {_at(extent)}"
            nbytes = esize * gy.numel() + out_bytes + esize * (
                wf.numel() if name == "upsample2x_dx" else x.numel())
            b_ms, b_by, b64 = bound_of(flops, nbytes)
            records.append(dict(kernel=name + sfx, shape=(ci, co, extent),
                                mode="plain", case=case, max_abs_err=err,
                                dst_err=None, plain_err=plain_err, ms=ms,
                                plain_ms=plain_ms,
                                library_ms=ms_of(lib), bound_ms=b_ms,
                                bound_by=b_by, fp64_bound_ms=b64,
                                tflops=flops / ms / 1e9 if timed else None))
            if not err <= tol:
                failures.append(f"{name}{sfx} {case}: err {err}")
            del got, want
        del x, wf, gy, xl, wu, gl
    return records, failures


def deterministic_cases(dev, gen, conv_cases, s2_cases, up_cases,
                        norm_cases=(), dtype=None):
    """Phase 5d: all nine conv and upsample kernels twice each on the same
    inputs at the flagship's shapes, in the training step's modes (forward
    with stats, pre-op + stats and add-in + stats; dx with the correction,
    and with the pre-op backward too; dW with the correction, and with the
    pre-op at stride 1; the upsample forward, dx and dW), and the norm-act
    kernels at the flagship's norm shapes (``norm_cases``): the stats
    kernel in both modes, the bwd-stats kernel, and the tail forward and
    backward with a residual through (a, b). Every output, statistic and
    [sum du*x; sum du] must be bit-equal: the kernels sum in a fixed
    order, without floating-point atomics. With ``dtype`` float32 /
    float16 the fp32 / fp16 conv and upsample kernels (names ending in
    ``_f32`` / ``_f16``) and the norm-act kernels in that dtype. Returns
    the failures."""
    from mt3d_resenc_unet_torch.ops.conv3d import (conv3d_k3, conv3d_k3_dw,
                                                   conv3d_k3_dx)
    from mt3d_resenc_unet_torch.ops.upsample import (upsample2x,
                                                     upsample2x_dw,
                                                     upsample2x_dx)
    failures, n = [], 2
    dtype = dtype or torch.bfloat16
    sfx = dtype_tols(dtype)[0]

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=gen.device)
                * scale).to(dev)

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
        x = randn(n, extent, extent, extent, ci).to(dtype)
        w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).to(dtype)
        gy, y = (randn(n, eo, eo, eo, co).to(dtype) for _ in range(2))
        gs = randn(n, 2, co, scale=0.1)
        pre = torch.stack(
            [torch.rand(n, ci, generator=gen, device=gen.device) * 1.5 + 0.5,
             torch.randn(n, ci, generator=gen, device=gen.device)], 1).to(dev)
        shape = f"{ci}->{co} @{extent}^3"
        for mode, kw in (("stats", {}), ("pre_stats", {"pre": pre}),
                         ("addin_stats", {"add_to": y})):
            check(f"conv3d_k3_s{stride}{sfx}", f"{shape} {mode}",
                  lambda: conv3d_k3(x, w, stride, emit_stats=True, **kw))
        dx_modes = [("corr", {}), ("corr_post", {"x": x, "pre": pre})]
        dw_modes = [("corr", {})]
        if stride == 1:
            dw_modes.append(("pre_corr", {"pre": pre}))
        for mode, kw in dx_modes:
            check(f"conv3d_k3_dx_s{stride}{sfx}", f"{shape} {mode}",
                  lambda: conv3d_k3_dx(gy, w, stride, y, gs,
                                       size=x.shape[1:4], **kw))
        for mode, kw in dw_modes:
            check(f"conv3d_k3_dw_s{stride}{sfx}", f"{shape} {mode}",
                  lambda: conv3d_k3_dw(x, gy, stride, y=y, gs=gs, **kw))
        del x, w, gy, y, gs, pre
    for ci, co, extent in up_cases:
        x = randn(n, extent, extent, extent, ci).to(dtype)
        wf = randn(2, 2, 2, ci, co, scale=(8 * co) ** -0.5).to(dtype)
        gy = randn(n, 2 * extent, 2 * extent, 2 * extent, co).to(dtype)
        shape = f"{ci}->{co} @{extent}^3"
        check(f"upsample2x{sfx}", shape, lambda: upsample2x(x, wf))
        check(f"upsample2x_dx{sfx}", shape, lambda: upsample2x_dx(gy, wf))
        check(f"upsample2x_dw{sfx}", shape, lambda: upsample2x_dw(x, gy))
        del x, wf, gy
    from mt3d_resenc_unet_torch.ops import norm_act as na
    for extent, c in norm_cases:
        x2, r2, g2 = (randn(n, extent ** 3, c).to(dtype) for _ in range(3))
        inv, a = (torch.rand(n, c, generator=gen, device=gen.device).to(dev)
                  + 0.5 for _ in range(2))
        shift, b = randn(n, c), randn(n, c)
        st = na.norm_act_stats(x2)
        shape = f"{extent}^3 x {c}"
        check(f"norm_act_stats{sfx}", shape, lambda: na.norm_act_stats(x2))
        check(f"norm_act_raw_stats{sfx}", shape, lambda: na.raw_stats(x2))
        check(f"norm_act_bwd_stats{sfx}", shape,
              lambda: na.norm_act_bwd_stats(x2, st, g2))
        check(f"norm_act_tail{sfx}", f"{shape} residual_pre_act",
              lambda: na.norm_tail(x2, inv, shift, r2, a, b))
        check(f"norm_act_tail_bwd{sfx}", f"{shape} residual_pre_act",
              lambda: na.norm_tail_bwd(x2, r2, inv, shift, a, b, g2))
        del x2, r2, g2, st
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
    _build.clear_counts()
    want = train_path(plain, batch, steps, f"{label} plain fp32", losses)
    plain_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    print(f"{label} training launches {launches}; the fp32 plain path's "
          f"{plain_launches}")
    if plain_launches:
        failures.append(f"{label}: the fp32 plain path launched "
                        f"{plain_launches}")
    from mt3d_resenc_unet_torch.models.network import norm_launches
    implied = {k: v * steps for k, v in norm_launches(
        fast.plan, tuple(batch["image"].shape[1:4]), n).items()}
    got_tail = {k: launches.get(k, 0) for k in implied}
    print(f"{label} norm-act modes launched in {steps} steps {got_tail}, "
          f"as the plan implies {implied}: {got_tail == implied}")
    if got_tail != implied:
        failures.append(f"{label}: norm-act modes launched {got_tail}, the "
                        f"plan implies {implied}")
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
    task = task_file("ink")
    targets = task["dataset_config"]["targets"]
    losses = {name: {"loss_fn": t["loss_fn"],
                     "loss_kwargs": t.get("loss_kwargs", {})}
              for name, t in targets.items()}
    plan = dataclasses.replace(plan_from_manual_config(
        task["model_config"], patch, task["dataset_config"]["in_channels"],
        [TaskHead(name, t["channels"], t["activation"])
         for name, t in targets.items()],
        model_name=task["tr_setup"]["model_name"]), use_pallas_conv=True)
    fast, plain = paired_models(dev, plan, f"ink plan {patch} batch {n}")
    x = torch.randn(n, *patch, 1, generator=gen, device=dev)
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
                                          "ink", losses=losses,
                                          gnorm_tol=INK_GNORM_TOL)
    failures += fails
    del fast, plain, batch
    torch.cuda.empty_cache()
    shapes = {k: v for k, v in shapes.items() if k[0] in CONV_KERNELS}
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


def step_table(records, shapes, steps, names=CONV_KERNELS,
               source="phase 5c launches x phase 2 / 5a cases"):
    """The kernel table's per-step columns: each conv and upsample
    kernel's (of ``names``) launches per training step (phase 5c's counts
    by shape and mode, or phase 18's at fp32) times its phase-2 or 5a case
    of the same shape and mode: the kernel's ms, the library call's, the
    bound (at fp32 also the FP64 tensor cores' bound, FLOPs at PEAK_FP32,
    beside the 3xTF32 one) and the kernel / library factor per step. A
    launch whose mode
    has no case takes the shape's first case (marked)."""
    cases = {}
    for r in records:
        if "shape" in r:
            cases.setdefault((r["kernel"], r["shape"], r["mode"]), r)
            cases.setdefault((r["kernel"], r["shape"], None), r)
    print(f"per training step ({source}) [{card()}]:")
    for name in names:
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
            tot["fp64_bound_ms"] += per * (r.get("fp64_bound_ms") or 0.0)
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
              f"{by.most_common(1)[0][0] if by else '-'})"
              + (f"  FP64 bound {tot['fp64_bound_ms']:7.3f} ms"
                 if tot["fp64_bound_ms"] else "")
              + f"  kernel/library {factor:.2f}x"
              + (f"  uncovered {tot['uncovered']:.1f}"
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


def library_norm_ms(x, act, slope, eps, show=False):
    """The PyTorch calls rows 10-11 are held against, on the same bf16
    data: ``torch.var_mean`` over the voxels (the stats kernel),
    ``F.instance_norm`` (then ``F.leaky_relu`` when ``act``) on x's
    channels-last NCDHW view (the norm, with its own statistics: row 10's
    function) and its backward through ``torch.autograd.grad`` (row 11's:
    the cotangent given). ``show``: print the device kernels each runs, so
    the copies PyTorch makes for the channels-last view can be read.
    Returns {kernel: ms} for the stats, norm and bwd_dx kernels (bwd_stats
    has no call of its own)."""
    import torch.nn.functional as F
    n, c = x.shape[0], x.shape[-1]
    x2 = x.reshape(n, -1, c)
    xl = x.permute(0, 4, 1, 2, 3).detach().requires_grad_()
    gl = torch.randn_like(x).permute(0, 4, 1, 2, 3)

    def fwd():
        y = F.instance_norm(xl, eps=eps)
        return F.leaky_relu(y, slope) if act else y

    y = fwd()

    def bwd():
        return torch.autograd.grad(y, xl, gl, retain_graph=True)

    out = {"norm_act_stats": median_ms(lambda: torch.var_mean(x2, dim=1)),
           "norm_act_norm": median_ms(fwd), "norm_act_bwd_dx": median_ms(bwd)}
    if show:
        for what, fn in (("F.instance_norm", fwd), ("its backward", bwd)):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = [e.key[:90] for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            print(f"library {what} on the channels-last view "
                  f"{tuple(x.shape)}: device kernels {names}")
    del y
    return out


def sums_err(got, want):
    """Error of (N, K, C) fp32 sums: each row k's max abs error against
    that row's max abs (a channel's sum can cancel to near zero)."""
    return max(float((got[:, k] - want[:, k]).abs().max()
                     / want[:, k].abs().max().clamp_min(1e-30))
               for k in range(want.shape[1]))


def norm_tail_cases(dev, gen, cases, dtype=None):
    """Phase 6, the step's modes: at each (extent, C) of ``cases``, N=2
    bf16 (or ``dtype``: fp16's records named ``<kernel>_f16``, held by
    F16_TOL), the raw statistics (mode (a)), the tail forward (b) and the tail
    backward (c) in each of TAIL_MODES with act on and off, each against
    its plain version on the same inputs (errors: KERNEL_TOL on the
    outputs and cotangents, STATS_TOL on the fp32 sums), timed against it
    (``torch.var_mean`` the raw statistics' library call; the tail has no
    one PyTorch call). Returns (records, failures); a record's ``shape``
    and ``mode`` are those ``_build.LAUNCH_SHAPES`` records."""
    from mt3d_resenc_unet_torch.ops import _build
    from mt3d_resenc_unet_torch.ops import norm_act as na
    slope, n = 1e-2, 2
    records, failures = [], []
    dtype = dtype or torch.bfloat16
    sfx, _, tol, _ = dtype_tols(dtype)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    for extent, c in cases:
        s = extent ** 3
        x2 = (randn(n, s, c) * 2 + 0.5).to(dtype)
        r2, g2 = (randn(n, s, c).to(dtype) for _ in range(2))
        inv, a = (torch.rand(n, c, generator=gen, device=dev) + 0.5
                  for _ in range(2))
        shift, b = (randn(n, c) for _ in range(2))
        tensor = x2.numel() * x2.element_size()
        vec = n * c * 4
        at = f"{extent}^3 x {c}"
        with torch.no_grad():
            got, want = na.raw_stats(x2), na.raw_stats_plain(x2)
            err = stats_err(got, want)
            b_ms, b_by = bound(3 * x2.numel(), tensor + 2 * vec, PEAK_FP32)
            records.append(dict(
                kernel="norm_act_raw_stats" + sfx, case=at, shape=(n, s, c),
                mode="plain", max_abs_err=err,
                ms=median_ms(lambda: na.raw_stats(x2)),
                plain_ms=median_ms(lambda: na.raw_stats_plain(x2)),
                library_ms=median_ms(lambda: torch.var_mean(x2, dim=1)),
                bound_ms=b_ms, bound_by=b_by))
            if not err <= STATS_TOL:
                failures.append(f"norm_act_raw_stats {at}: err {err}")
            for (res, pre), act in ((m, act) for m in TAIL_MODES
                                    for act in (True, False)):
                rr = r2 if res else None
                aa, bb = (a, b) if pre else (None, None)
                mode = _build.mode_name(residual=res, pre=pre, act=act)
                label = f"{at} {mode}"
                fwd = (lambda: na.norm_tail(x2, inv, shift, rr, aa, bb,
                                            slope, act))
                fwd0 = (lambda: na.norm_tail_plain(x2, inv, shift, slope,
                                                   act, rr, aa, bb))
                bwd = (lambda: na.norm_tail_bwd(x2, rr, inv, shift, aa, bb,
                                                g2, slope, act))
                bwd0 = (lambda: na.norm_tail_bwd_plain(x2, rr, inv, shift,
                                                       aa, bb, g2, slope,
                                                       act))
                y, y0 = fwd(), fwd0()
                (dy, dr, sm), (dy0, dr0, sm0) = bwd(), bwd0()
                torch.cuda.synchronize()
                e_fwd = rel_err(y, y0)
                e_bwd = max([rel_err(dy, dy0)]
                            + ([rel_err(dr, dr0)] if res else []))
                e_sums = sums_err(sm, sm0)
                print(f"norm tail {dtype} {label}: out err {e_fwd:.3e} "
                      f"(bit-equal "
                      f"{torch.equal(y, y0)}), dy/dr err {e_bwd:.3e} "
                      f"(bit-equal {torch.equal(dy, dy0)}), sums err "
                      f"{e_sums:.3e}")
                if not (e_fwd <= tol and e_bwd <= tol
                        and e_sums <= STATS_TOL):
                    failures.append(f"norm tail {label}: out {e_fwd} "
                                    f"dy/dr {e_bwd} sums {e_sums}")
                k = 4 if pre else 2
                ops = 2 + res + 3 * pre + act
                reads = (2 + res) * tensor      # y, g (and the residual)
                b_ms, b_by = bound(ops * x2.numel(), (1 + res) * tensor
                                   + tensor + (2 + 2 * pre) * vec, PEAK_FP32)
                records.append(dict(
                    kernel="norm_act_tail" + sfx, case=label, shape=(n, s, c),
                    mode=mode, max_abs_err=e_fwd, ms=median_ms(fwd),
                    plain_ms=median_ms(fwd0), library_ms=None,
                    bound_ms=b_ms, bound_by=b_by))
                b_ms, b_by = bound((ops + 5 + 5 * pre) * x2.numel(),
                                   reads + (1 + res) * tensor
                                   + (2 + 2 * pre) * vec + k * vec,
                                   PEAK_FP32)
                records.append(dict(
                    kernel="norm_act_tail_bwd" + sfx, case=label,
                    shape=(n, s, c),
                    mode=mode, max_abs_err=max(e_bwd, e_sums),
                    ms=median_ms(bwd), plain_ms=median_ms(bwd0),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by))
                del y, y0, dy, dr, sm, dy0, dr0, sm0
        del x2, r2, g2
        torch.cuda.empty_cache()
    return records, failures


def norm_step_table(records, shapes, steps, sfx="",
                    source="phase 5c launches x phase 6 cases"):
    """Rows 10-11's modes per training step: each kernel's launches per
    step (phase 5c's counts by (N, S, C) and mode, or phase 18's fp16
    step's with ``sfx`` "_f16") times phase 6's case of the same shape and
    mode (named with ``sfx``): kernel ms, plain ms and bound per step.
    Returns {kernel: (launches, ms, plain ms, bound ms)} per step."""
    cases = {(r["kernel"], r["shape"], r["mode"]): r for r in records
             if "shape" in r}
    out = {}
    print(f"rows 10-11's modes per training step ({source}) [{card()}]:")
    for name in TAIL_KERNELS:
        tot = collections.Counter()
        for (kname, shape, mode), count in sorted(shapes.items()):
            if kname != name:
                continue
            per = count / steps
            tot["launches"] += per
            r = cases.get((name + sfx, tuple(shape), mode))
            if r is None:
                tot["uncovered"] += per
                continue
            for k in ("ms", "plain_ms", "bound_ms"):
                tot[k] += per * r[k]
        mix = ", ".join(f"S={shape[1]} C={shape[2]} {mode} {c / steps:g}"
                        for (kname, shape, mode), c in sorted(shapes.items())
                        if kname == name)
        print(f"  {name} launches per step by shape and mode: {mix}")
        print(f"  {name + sfx:22s} {tot['launches']:5.1f} launches  kernel "
              f"{tot['ms']:8.3f} ms  plain {tot['plain_ms']:8.3f} ms  bound "
              f"{tot['bound_ms']:7.3f} ms (bytes)"
              + (f"  uncovered {tot['uncovered']:.1f}" if tot["uncovered"]
                 else ""))
        out[name + sfx] = (tot["launches"], tot["ms"], tot["plain_ms"],
                           tot["bound_ms"])
    return out


def norm_act_cases(dev, gen, cases, dtype=None):
    """Phase 6, at bf16 (or ``dtype``: fp16's records and launch counts
    named ``<kernel>_f16``, held by F16_TOL). Returns (per-kernel records,
    the op path's launch counts, failures)."""
    import collections
    from mt3d_resenc_unet_torch.ops import _build
    from mt3d_resenc_unet_torch.ops import norm_act as na
    eps, slope, n = 1e-5, 1e-2, 2
    records, failures = [], []
    dtype = dtype or torch.bfloat16
    sfx, _, kernel_tol, _ = dtype_tols(dtype)
    op_launches = collections.Counter()
    todo = [(e, c, act, False) for e, c in cases for act in (True, False)]
    todo.insert(1, (cases[0][0], cases[0][1], True, True))
    for extent, c, act, affine in todo:
        shape = (n, extent, extent, extent, c)
        x = (torch.randn(*shape, generator=gen, device=dev) * 2
             + 0.5).to(dtype)
        gy = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        scale = bias = None
        if affine:
            scale = torch.rand(c, generator=gen, device=dev) + 0.5
            bias = torch.randn(c, generator=gen, device=dev)
        label = (f"{extent}^3 x {c} {dtype} " + ("affine" if affine else
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
        # each kernel against its plain version on the same inputs, and
        # the library calls rows 10-11 are held against
        fuse = act and not affine
        lib_ms = library_norm_ms(x, fuse, slope, eps, show=not records)
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
                    kernel=name + sfx, case=label, max_abs_err=errs[name],
                    ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms.get(name),
                    bound_ms=b_ms, bound_by=b_by,
                    gbs=tensors * x.numel() * x.element_size() / ms / 1e6))
        tol = {"norm_act_stats": STATS_TOL, "norm_act_bwd_stats": STATS_TOL}
        print(f"norm-act {label}: y err {y_err:.3e} dx err {dx_err:.3e} "
              + " ".join(f"{k.removeprefix('norm_act_')} {v:.3e}"
                         for k, v in errs.items()))
        if not (y_err <= kernel_tol and dx_err <= kernel_tol):
            failures.append(f"norm-act op {label}: y {y_err} dx {dx_err}")
        for name, err in errs.items():
            if not err <= tol.get(name, kernel_tol):
                failures.append(f"{name} {label}: err {err}")
        del x, gy, xg, y, y0, st0, dx0, st, gs, pairs
    for name in NORM_KERNELS:
        if op_launches.get(name, 0) <= 0:
            failures.append(f"norm-act {dtype}: kernel {name} was never "
                            "launched")
    return records, {k + sfx: op_launches[k] for k in NORM_KERNELS}, failures


def sheet_normals_config(work, volume_paths, patch, max_epoch,
                         device_augment=False):
    """``tasks/sheet_normals.yaml`` read through the port's YAML reader
    (squeeze-excitation on), with what phases 7, 12 and 21 cut: the
    output paths and the patch cache under ``work``, the synthetic
    dataset's ``volume_paths``, TRAINER_STEPS and TRAINER_VAL_STEPS steps
    an epoch, ``max_epoch`` epochs and, for a rehearsal, the patch;
    ``device_augment`` sets ``augment_on_device``."""
    cfg = task_file("sheet_normals")
    cfg["tr_setup"].update(ckpt_out_base=str(work / "ckpt"),
                           tensorboard_log_dir=str(work / "logs"))
    cfg["tr_config"].update(patch_size=list(patch),
                            max_steps_per_epoch=TRAINER_STEPS,
                            max_val_steps_per_epoch=TRAINER_VAL_STEPS,
                            max_epoch=max_epoch)
    if device_augment:
        cfg["tr_config"]["augment_on_device"] = True
    cfg["dataset_config"].update(cache_folder=str(work / "patch_cache"),
                                 volume_paths=[dict(volume_paths)])
    return cfg


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


def store_bytes(path) -> int:
    """Bytes on disk of every file under ``path``."""
    import os
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


SAME_SAMPLES = 8


def first_samples(work, vols, patch, label):
    """The first SAME_SAMPLES samples (read, augmented, wire format) of
    phase 7's dataset on the volumes ``vols``."""
    from mt3d_resenc_unet_torch.core.config import ConfigManager
    from mt3d_resenc_unet_torch.data.dataset import ZarrPatchDataset
    cfg = sheet_normals_config(work, vols, patch, 1)
    cfg["dataset_config"]["use_cache"] = False
    t0 = time.perf_counter()
    ds = ZarrPatchDataset(ConfigManager(config_dict=cfg, verbose=False),
                          seed=SEED, wire=True)
    t_open = time.perf_counter() - t0
    print(f"trainer data ({label}): dataset of {len(ds)} patches opened "
          f"(volumes read into RAM, patches mined) in {t_open:.2f} s")
    return [ds[i] for i in range(min(SAME_SAMPLES, len(ds)))]


def equal_samples(a, b) -> bool:
    """Two lists of SAME_SAMPLES samples, bit for bit."""
    return len(a) == SAME_SAMPLES and len(a) == len(b) and all(
        x.keys() == y.keys() and all(
            x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
            for k in x) for x, y in zip(a, b))


def same_samples(work, paths, patch, train_data):
    """Phase 7's check: the dataset's first SAME_SAMPLES samples (read,
    augmented, wire format) from the Blosc volumes against those of an
    uncompressed copy, bit for bit. Returns the failures."""
    from mt3d_resenc_unet_torch.tools.synthetic_data import \
        write_sheet_dataset
    t0 = time.perf_counter()
    raw_paths = write_sheet_dataset(work / "data_raw", train_data, seed=SEED,
                                    compressor=None)
    t_raw = time.perf_counter() - t0
    samples = [first_samples(work, paths, patch, "blosc"),
               first_samples(work, raw_paths, patch, "raw")]
    # the remote reads: the same Blosc volumes over a local HTTP server
    with http_root(work) as url:
        samples.append(first_samples(work, {
            k: v if k == "ref_label" else v.replace(str(work), url)
            for k, v in paths.items()}, patch, "blosc over http"))
        read_same = read_rates(paths["input"], paths["input"].replace(
            str(work), url), f"phase 7 image {train_data}")
    raw_equal = equal_samples(samples[0], samples[1])
    http_equal = equal_samples(samples[0], samples[2]) and read_same
    print(f"trainer data: first {SAME_SAMPLES} samples of the Blosc dataset "
          f"bit-equal to the uncompressed copy's: {raw_equal} (copy written "
          f"in {t_raw:.1f} s, {store_bytes(work / 'data_raw')} bytes on "
          f"disk); to the same dataset's over http: {http_equal}")
    import shutil
    shutil.rmtree(work / "data_raw", ignore_errors=True)
    return ([] if raw_equal else ["trainer data: the Blosc dataset's samples "
                                  "differ from the uncompressed copy's"]) + (
        [] if http_equal else ["trainer data: the dataset's samples over "
                               "http differ from the local ones"])


def trainer_phase(patch, train_data, step_rate, device_augment=False,
                  host=None, epochs=TRAINER_EPOCHS):
    """Phase 7 (and, with ``device_augment``, phase 12: the same runs with
    ``augment_on_device: true``, printed beside ``host``, phase 7's
    summary): ``epochs`` epochs, then one more resumed from the last
    checkpoint. Returns (launch counts of the two trainer runs, failures,
    a summary: the mean patches/s and t_fetch's share of the epochs after
    the first, and the first run's history, which phase 21 holds the
    CLI's against)."""
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
          f"{time.perf_counter() - t0:.1f} s, "
          f"{store_bytes(work / 'data')} bytes on disk (Blosc zstd-5 bit "
          "shuffle)")
    if not device_augment:
        failures += same_samples(work, paths, patch, train_data)
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
            work, paths, patch, epochs, device_augment),
            verbose=False).train()
        history = list(first["history"])
        first_history = list(history)
        del first
        torch.cuda.empty_cache()
        cfg = sheet_normals_config(work, paths, patch, epochs + 1,
                                   device_augment)
        cfg["tr_setup"]["checkpoint_path"] = str(work / "ckpt" /
                                                 "sheet_normals")
        second = ResumeProbe(config_dict=cfg, verbose=False).train()
        history += second["history"]
        del second
        launches = dict(_build.LAUNCHES)
        print(f"{label}: {time.perf_counter() - t0:.1f} s for "
              f"{epochs} + 1 epochs; launches {launches}")
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
    if [h["epoch"] for h in history] != list(range(epochs + 1)):
        failures.append(f"{label}: epochs {[h['epoch'] for h in history]}")
    steady = history[1:]
    rate = sum(h["train/patches_per_sec"] for h in steady) / len(steady)
    fetch = sum(h["train/t_fetch_s"] for h in steady)
    step = sum(h["train/t_step_s"] for h in steady)
    summary = {"rate": rate, "fetch_share": fetch / (fetch + step),
               "t_fetch": fetch, "t_step": step, "history": first_history}
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
        epochs - 1)
    want_count = epochs * TRAINER_STEPS
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
    if not (probe.get("epoch") == epochs
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
FINALS_LIMITS = (FINALS_SHEET_MEDIAN, FINALS_SHEET_OVER3, FINALS_NORMALS_MEAN,
                 FINALS_NORMALS_OVER)


def outputs_close(store_a, store_b, label, failures, limits=FINALS_LIMITS):
    """``tests/test_infer_device.py::_assert_outputs_close`` on two stores'
    finals: the two passes sum in another order and the bf16 forward
    amplifies input ulps, so they agree to arithmetic noise (``limits``:
    sheet median, sheet share > 3, normals mean, normals share > 3e-2)."""
    sheet_median, sheet_over3, normals_mean, normals_over = limits
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
          f"{sheet_median}), share > 3 {over3:.3e} (limit {sheet_over3}); "
          f"normals mean err {mean:.3e} (limit {normals_mean}), share > "
          f"3e-2 {over:.3e} (limit {normals_over})")
    if not (ok and median <= sheet_median and over3 < sheet_over3
            and mean < normals_mean and over < normals_over):
        failures.append(f"engine finals {label}: sheet median {median} "
                        f"over3 {over3}, normals mean {mean} over {over}")


def engine_config(ckpt, img, out, patch, device_accumulate, **infer):
    """The flagship (``flagship_config``, bf16) served from ``ckpt`` over
    ``img`` into ``out``."""
    cfg = flagship_config(patch)
    cfg["inference_config"] = {
        "checkpoint_path": str(ckpt), "input_path": str(img),
        "output_path": str(out), "patch_size": list(patch),
        "overlap": 0.25, "batch_size": 2,
        "normalization": "standardize", "gaussian_blend": True,
        "device_accumulate": device_accumulate, **infer}
    return cfg


def input_decode_cost(img, img_raw, patch, volume):
    """Phase 8's input read three ways: every chunk decoded on one thread
    (the decode's CPU seconds), the whole volume on the store's pool, and
    the uncompressed copy on the pool; per patch of the grid."""
    import os
    from mt3d_resenc_unet_torch.data import codec
    from mt3d_resenc_unet_torch.data.positions import sliding_window_grid
    from mt3d_resenc_unet_torch.data.zio import open_zarr
    vol = open_zarr(str(img))
    n = len(sliding_window_grid(volume, patch, 0.25))
    files = [f for f in os.listdir(img) if not f.startswith(".")]
    nbytes = int(np.prod(vol.chunks)) * vol.dtype.itemsize
    cpu = 0.0
    for name in files:
        with open(os.path.join(img, name), "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        codec.decode_chunk(vol.store.compressor, data, nbytes)
        cpu += time.perf_counter() - t0
    t0 = time.perf_counter()
    vol.read_all()
    pool = time.perf_counter() - t0
    t0 = time.perf_counter()
    open_zarr(str(img_raw)).read_all()
    raw = time.perf_counter() - t0
    print(f"engine input decode [{_host_cpu()}]: {len(files)} Blosc chunks "
          f"in {cpu:.3f} s on one thread ({1e3 * cpu / n:.2f} ms of CPU a "
          f"patch over {n} patches); the volume read on the pool in "
          f"{pool:.3f} s, uncompressed in {raw:.3f} s")


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
        create_zarr(str(img), volume, np.uint8, patch)[...] = vol
        img_raw = work / "image_raw.zarr"
        create_zarr(str(img_raw), volume, np.uint8, patch,
                    compressor=None)[...] = vol
        d, h, w = u16_volume
        img16 = work / "image_u16.zarr"
        create_zarr(str(img16), u16_volume, np.uint16,
                    patch)[...] = vol[:d, :h, :w].astype(np.uint16) * 257
        del vol
        print(f"engine: flagship checkpoint ({n_params} params), u8 volume "
              f"{volume} (Blosc and uncompressed) and u16 volume "
              f"{u16_volume} written in "
              f"{time.perf_counter() - t_phase:.1f} s")
        on_disk, rates = {}, {}

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
            rates[label] = (n / stepped if stepped else 0.0, n / dt)
            if engine.last_mode != want_mode:
                failures.append(f"engine {label}: ran the "
                                f"{engine.last_mode} pass, not {want_mode}")
            for name in FORWARD:
                if launches.get(name, 0) <= 0:
                    failures.append(f"engine {label}: kernel {name} was "
                                    "never launched")
            on_disk[label] = {
                name: store_bytes(os.path.join(store, name))
                for name in sorted(os.listdir(store))
                if os.path.isdir(os.path.join(store, name))}
            return store

        # (a) "auto" must take the device pass; run twice
        store_a = serve("(a) auto", "auto_1", "device",
                           device_accumulate="auto")
        with open(os.path.join(store_a, ".finalized")) as f:
            marker = f.read().strip()
        print(f"engine (a) marker: {marker!r}")
        if marker != "finalized on device":
            failures.append(f"engine (a): marker {marker!r}")
        # the device pass in turns on the uncompressed copy and the Blosc
        # input: two loop rates of each, and the finals bit-equal
        finals_a = {n: open_zarr(os.path.join(store_a, f"{n}_final"))
                    .read_all() for n in ("sheet", "normals")}
        loops = {"blosc": [rates["(a) auto"][0]], "raw": []}
        same = {"blosc": True, "raw": True}
        for i in range(1, 4):
            kind = "raw" if i % 2 else "blosc"
            label = (f"(a) auto, uncompressed input, run {(i + 1) // 2}"
                     if kind == "raw" else f"(a) auto, run {i // 2 + 1}")
            again = serve(label, f"auto_turn_{i}", "device",
                          device_accumulate="auto",
                          input_path=img_raw if kind == "raw" else img)
            loops[kind].append(rates[label][0])
            same[kind] = same[kind] and all(np.array_equal(open_zarr(
                os.path.join(again, f"{n}_final")).read_all(), v)
                for n, v in finals_a.items())
            shutil.rmtree(again)
        del finals_a
        med = {k: statistics.median(v) for k, v in loops.items()}
        # (g) the device pass with its input over HTTP: the port's remote
        # store, served from this directory by a child process
        with http_root(work) as url:
            remote = f"{url}/{img.name}"
            store_g = serve("(g) auto, input over http", "auto_http",
                            "device", device_accumulate="auto",
                            input_path=remote)
            read_same = read_rates(str(img), remote,
                                   f"phase 8 input {volume}")
        same_g = all(np.array_equal(
            open_zarr(os.path.join(store_g, f"{n}_final")).read_all(),
            open_zarr(os.path.join(store_a, f"{n}_final")).read_all())
            for n in ("sheet", "normals"))
        print(f"engine (g) input over http [{smi}]: loop "
              f"{rates['(g) auto, input over http'][0]:.3f} patches/s "
              f"against {med['blosc']:.3f} (median of (a) on the local "
              f"Blosc input); finals bit-equal to (a)'s: {same_g}")
        if not (same_g and read_same):
            failures.append(f"engine (g): over http finals equal {same_g}, "
                            f"input read equal {read_same}")
        shutil.rmtree(store_g)
        print(f"engine (a) device loop patches/s in turns [{smi}]: Blosc "
              f"input {', '.join(f'{r:.3f}' for r in loops['blosc'])} "
              f"(median {med['blosc']:.3f}), uncompressed "
              f"{', '.join(f'{r:.3f}' for r in loops['raw'])} (median "
              f"{med['raw']:.3f}): {med['blosc'] / med['raw'] - 1:+.1%}; "
              f"finals bit-equal to the first run's: Blosc {same['blosc']}, "
              f"uncompressed input {same['raw']}")
        if not (same["raw"] and same["blosc"]):
            failures.append(f"engine (a): finals differ from the first "
                            f"run's: {same}")
        input_decode_cost(img, img_raw, patch, volume)

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

        # (f) the host passes on the uncompressed input into uncompressed
        # stores: their rates beside (b)'s and (c)'s
        from mt3d_resenc_unet_torch.infer import engine as engine_mod
        default = engine_mod.DEFAULT_COMPRESSOR
        engine_mod.DEFAULT_COMPRESSOR = None
        try:
            serve("(f) rolling, uncompressed", "rolling_raw", "rolling",
                  input_path=img_raw)
            serve("(f) tiled, uncompressed", "tiled_raw", "tiled",
                  input_path=img_raw, **tiled)
        finally:
            engine_mod.DEFAULT_COMPRESSOR = default
        raw_in = int(np.prod(volume))
        print(f"engine inputs on disk: u8 {volume} Blosc "
              f"{store_bytes(img)} bytes, uncompressed "
              f"{store_bytes(img_raw)} bytes ({raw_in} raw); u16 "
              f"{u16_volume} Blosc {store_bytes(img16)} bytes "
              f"({2 * int(np.prod(u16_volume))} raw)")
        for label, arrays in on_disk.items():
            print(f"engine stores on disk, {label}: " + ", ".join(
                f"{k} {v}" for k, v in arrays.items()) + " bytes")
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
        create_zarr(str(work / "image.zarr"), volume, np.uint8,
                    patch)[...] = vol
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
            with open(os.path.join(store_two, "sheet_sum", ".zarray")) as f:
                compressor = json.load(f)["compressor"]
            print(f"phase 15: tiles disjoint and non-empty {disjoint}; "
                  "two processes bit-equal to one: " + ", ".join(
                      f"{k} {v}" for k, v in same.items())
                  + f" (stores' compressor {compressor}; two processes "
                  "time-share one card: no scaling)")
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
                              np.uint16, (3, 4, 16, 16))
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
        ok_crop = ok_crop and compressor["cname"] == "zstd"
        if not (ok_crop and ok_data and ok_normals and ok_mesh):
            failures.append(f"phase 16: crop {ok_crop} dataset {ok_data} "
                            f"normals {ok_normals} mesh {ok_mesh}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return failures


CODEC_CHUNK = (128, 128, 128)
CODEC_POOL_CHUNKS = 16      # chunks decoded / encoded at once on the pool
CODEC_REPS = 3              # best of, for the one-thread times


def _host_cpu() -> str:
    """The host CPU (``/proc/cpuinfo``: its model name, or where that is not
    exposed its vendor, family, model and clock) and its CPU count."""
    import os
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip().lower(), value.strip())
    except OSError:
        pass
    model = fields.get("model name", "unknown")
    if model == "unknown":
        model = (f"{fields.get('vendor_id', '?')} family "
                 f"{fields.get('cpu family', '?')} model "
                 f"{fields.get('model', '?')} at {fields.get('cpu mhz', '?')}"
                 " MHz (model name not exposed)")
    return f"{model}, {os.cpu_count()} CPUs"


def codec_chunks():
    """A 128^3 u8 image chunk (layers blurred by noise, as phase 7's
    image) and a 128^3 fp32 sum chunk (a Gaussian-weighted blend of
    smooth probabilities, as the engine's ``*_sum``), seeded."""
    from mt3d_resenc_unet_torch.infer.gaussian import gaussian_map
    rng = np.random.default_rng(SEED)
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float32)
                            for n in CODEC_CHUNK), indexing="ij")
    layers = (z + 4 * np.sin(y / 23) + 3 * np.sin(x / 17)) % 3 >= 1
    image = np.clip(60 + 120 * layers + rng.normal(0, 30, CODEC_CHUNK),
                    0, 255).astype(np.uint8)
    prob = 1 / (1 + np.exp(-3 * (np.sin(z / 9) + np.cos(y / 13)
                                 + np.sin(x / 11))))
    sums = (prob * (gaussian_map(CODEC_CHUNK) + np.roll(
        gaussian_map(CODEC_CHUNK), 48, axis=(0, 1, 2)))).astype(np.float32)
    return image, sums


def codec_phase():
    """Phase 17, host only. Returns the failures."""
    import hashlib
    from pathlib import Path
    from mt3d_resenc_unet_torch.data import codec, zio
    failures = []
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    lib = codec.load()
    path = codec.library_path()
    print(f"phase 17: codec library {path.relative_to(codec._ROOT)} "
          f"(g++ {' '.join(codec.GXX_FLAGS)} on "
          f"{codec.SOURCE.relative_to(codec._ROOT)}, sha256 "
          f"{hashlib.sha256(codec.SOURCE.read_bytes()).hexdigest()[:16]}),"
          f" loaded in {time.perf_counter() - t0:.2f} s; host CPU "
          f"{_host_cpu()}")
    del lib
    ldd = subprocess.run(["ldd", str(path)], capture_output=True, text=True)
    linked = [line.split()[0] for line in ldd.stdout.splitlines()
              if line.strip()]
    codecs = [name for name in linked if any(
        k in name for k in ("zstd", "lz4", "libz.", "blosc", "snappy"))]
    print(f"phase 17: ldd: {', '.join(linked)}; codec libraries: "
          f"{codecs or 'none'}")
    if ldd.returncode != 0 or codecs:
        failures.append(f"phase 17: ldd rc {ldd.returncode}, codec "
                        f"libraries {codecs}")

    # golden chunks another encoder wrote
    root = Path(__file__).resolve().parent / "tests" / "data" / "zarr_codec"
    manifest = json.loads((root / "manifest.json").read_text())
    bad = []
    for e in manifest:
        nbytes = int(np.prod(e["shape"])) * np.dtype(e["dtype"]).itemsize
        try:
            raw = codec.decode_chunk(e["compressor"],
                                     (root / e["file"]).read_bytes(), nbytes)
            if hashlib.sha256(raw).hexdigest() != e["sha256"]:
                bad.append(e["file"])
        except ValueError as exc:
            bad.append(f"{e['file']} ({exc})")
    snappy = [e for e in manifest
              if e["compressor"].get("cname") == "snappy"]
    print(f"phase 17: {len(manifest) - len(bad)} of {len(manifest)} golden "
          "chunks (tensorstore's Blosc zstd/lz4/lz4hc/blosclz/zlib/snappy x "
          "shuffle 0/1/2 x u1/u2/f4, zstandard's frames; "
          f"{len(snappy)} of them snappy) decoded to their "
          f"sha256{': failed ' + ', '.join(bad) if bad else ''}")
    if len(snappy) < 11:
        failures.append(f"phase 17: {len(snappy)} snappy golden chunks")
    if bad:
        failures.append(f"phase 17: golden chunks failed: {bad}")

    # every writable compressor over seeded 128^3 chunks
    rng = np.random.default_rng(SEED)
    image, sums = codec_chunks()
    chunks = {"u8": image,
              "u16": (image.astype(np.uint16) * 251
                      + rng.integers(0, 8, CODEC_CHUNK).astype(np.uint16)),
              "f4": sums}
    comps = [{"id": "blosc", "cname": c, "clevel": 5, "shuffle": sh}
             for c in ("zstd", "lz4", "lz4hc", "blosclz", "zlib", "snappy")
             for sh in (0, 1, 2)] + [
        {"id": "zstd", "level": 1}, {"id": "zstd", "level": 5},
        {"id": "zlib", "level": 1}, {"id": "gzip", "level": 1},
        {"id": "bz2", "level": 1}]
    jobs = [(c, k) for c in comps for k in chunks]

    def round_trip(job):
        comp, key = job
        raw = chunks[key].tobytes()
        stored = codec.encode_chunk(comp, raw, chunks[key].itemsize)
        return len(stored), codec.decode_chunk(comp, stored,
                                               len(raw)) == raw

    t0 = time.perf_counter()
    results = list(zio._pool("chunks").map(round_trip, jobs))
    wrong = [f"{c} {k}" for (c, k), (_, ok) in zip(jobs, results) if not ok]
    print(f"phase 17: {len(jobs) - len(wrong)} of {len(jobs)} round trips "
          f"(every writable compressor x u8/u16/f4 128^3) bit-equal in "
          f"{time.perf_counter() - t0:.1f} s on the pool; ratios " + ", ".join(
              f"{c.get('cname', c['id'])}/{c.get('shuffle', '-')}/{k} "
              f"{chunks[k].nbytes / n:.3f}"
              for (c, k), (n, _) in zip(jobs, results)))
    if wrong:
        failures.append(f"phase 17: round trips differ: {wrong}")

    # the default compressor's rates, one thread and the pool
    comp = dict(zio.DEFAULT_COMPRESSOR)
    workers = zio._pool("chunks")._max_workers
    for label, arr in (("u8 image", image), ("fp32 sum", sums)):
        raw = arr.tobytes()
        enc_s, dec_s = [], []
        for _ in range(CODEC_REPS):
            t0 = time.perf_counter()
            stored = codec.encode_chunk(comp, raw, arr.itemsize)
            enc_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            codec.decode_chunk(comp, stored, len(raw))
            dec_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        many = list(zio._pool("chunks").map(
            lambda _: codec.encode_chunk(comp, raw, arr.itemsize),
            range(CODEC_POOL_CHUNKS)))
        enc_pool = time.perf_counter() - t0
        t0 = time.perf_counter()
        list(zio._pool("chunks").map(
            lambda b: codec.decode_chunk(comp, b, len(raw)), many))
        dec_pool = time.perf_counter() - t0
        mb = len(raw) / 1e6
        print(f"phase 17 [{_host_cpu()}]: Blosc zstd-5 bit shuffle, 128^3 "
              f"{label}: ratio {len(raw) / len(stored):.3f} "
              f"({len(stored)} of {len(raw)} bytes); one thread: decode "
              f"{mb / min(dec_s):.1f} MB/s, encode {mb / min(enc_s):.1f} "
              f"MB/s; the pool ({workers} threads, {CODEC_POOL_CHUNKS} "
              f"chunks): decode {CODEC_POOL_CHUNKS * mb / dec_pool:.1f} "
              f"MB/s, encode {CODEC_POOL_CHUNKS * mb / enc_pool:.1f} MB/s "
              "(MB of raw bytes)")
    # Blosc snappy (bit shuffle, as the default) on the same chunks, one
    # thread
    comp = {"id": "blosc", "cname": "snappy", "clevel": 5, "shuffle": 2}
    for label, arr in (("u8 image", image), ("fp32 sum", sums)):
        raw = arr.tobytes()
        enc_s, dec_s = [], []
        for _ in range(CODEC_REPS):
            t0 = time.perf_counter()
            stored = codec.encode_chunk(comp, raw, arr.itemsize)
            enc_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            codec.decode_chunk(comp, stored, len(raw))
            dec_s.append(time.perf_counter() - t0)
        mb = len(raw) / 1e6
        print(f"phase 17 [{_host_cpu()}]: Blosc snappy bit shuffle, 128^3 "
              f"{label}: ratio {len(raw) / len(stored):.3f} ({len(stored)} "
              f"of {len(raw)} bytes); one thread: decode "
              f"{mb / min(dec_s):.1f} MB/s, encode {mb / min(enc_s):.1f} "
              "MB/s (MB of raw bytes)")
    print(f"phase 17 (codec): {time.perf_counter() - t_phase:.1f} s")
    return failures


# ---------------------------------------------------------------------------
# phases 18-20: every dtype the trainer and the engine take; the remote
# reads run inside phases 7 and 8, where their data are
# ---------------------------------------------------------------------------

# phase 18: the flagship's first step at compute dtype float32 and float16
# with the kernels left on (``use_pallas_conv`` auto), against the plain
# fp32 path from the same weights and batch: relative differences of the
# total loss and of grad_norm, 5x the values measured on an H100 (NVIDIA
# H100 80GB HBM3, 700 W) at seed 0: fp32 through the fp32 kernels 0 and
# 6.947e-7 (the loss's floor 1e-6; both within the ceilings 1e-5 and 1e-4
# that a one-pass TF32 or bf16 kernel would exceed), fp16 3.3e-6 and
# 4.0e-2 (no loss scaler, as in the JAX step: the per-voxel cotangents of
# a mean over 4 M voxels, ~2e-7, are fp16 subnormals)
DTYPE_LIMITS = {"float32": (1e-6, 3.5e-6), "float16": (2e-5, 0.2)}
# phase 20: the engine's fp32 finals against its bf16 ones (sheet median
# code difference, share > 3; normals mean vector error, share > 3e-2):
# measured 0, 0, 7.3e-3 and 1.45e-2 on the H100 at seed 0 + 1, limits 5x
# (the sheet's at phase 8's)
ENGINE_DTYPE_LIMITS = (FINALS_SHEET_MEDIAN, FINALS_SHEET_OVER3, 4e-2, 7.5e-2)


def flagship_config(patch, compute_dtype="bfloat16", **tr_config):
    """The flagship as the config system builds it (autoconfigured at
    ``patch``, sheet + normals heads, ``use_pallas_conv`` unset: the
    kernels on for the card) at ``compute_dtype``."""
    return {
        "tr_setup": {"model_name": "flagship", "autoconfigure": True,
                     "seed": SEED},
        "tr_config": {"patch_size": list(patch), "batch_size": 2,
                      "compute_dtype": compute_dtype, **tr_config},
        "model_config": {},
        "dataset_config": {
            "in_channels": 1, "volume_paths": [],
            "targets": {"sheet": {"channels": 1, "activation": "sigmoid"},
                        "normals": {"channels": 3, "activation": "none"}}},
        "inference_config": {},
    }


@contextlib.contextmanager
def counting_plain():
    """Counts the calls of the conv and upsample kernels' plain versions,
    under every name the port calls them by (the wrappers' CPU route, the
    fp32 reference model's convs and upsamples): yields the Counter."""
    from mt3d_resenc_unet_torch.models import blocks, network
    from mt3d_resenc_unet_torch.ops import conv3d, upsample
    calls = collections.Counter()
    names = {conv3d: ("conv3d_k3_plain", "conv3d_k3_dx_plain",
                      "conv3d_k3_dw_plain"),
             upsample: ("upsample_plain", "upsample2x_dx_plain",
                        "upsample2x_dw_plain"),
             blocks: ("conv3d_k3_plain",), network: ("upsample_plain",)}
    saved = []

    def counted(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    for module, attrs in names.items():
        for attr in attrs:
            fn = getattr(module, attr)
            saved.append((module, attr, fn))
            setattr(module, attr, counted(attr, fn))
    try:
        yield calls
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def dtype_phase(dev, patch):
    """Phase 18: TRAIN_STEPS flagship steps at batch 2 for each of compute
    dtype float32 and float16, the plan from the config with
    ``use_pallas_conv`` unset (the kernels on), every counter zeroed
    before: each of the nine conv and upsample kernels of the dtype
    (``_f32`` / ``_f16``) launched and none of another dtype; no plain
    version of a conv or upsample kernel called (``counting_plain``); the
    norm-act modes exactly as ``norm_launches`` derives for the dtype
    (more than 0); finite losses, and the first step's loss and grad_norm
    within DTYPE_LIMITS of the plain fp32 path's from the same weights and
    batch; median ms of each beside the plain path's. Returns (failures,
    {dtype name: (its launches, its launches by shape and mode)})."""
    import dataclasses
    from mt3d_resenc_unet_torch.core.config import ConfigManager
    from mt3d_resenc_unet_torch.models.network import ResEncUNet, norm_launches
    from mt3d_resenc_unet_torch.ops import _build
    failures = []
    smi = card()
    t_phase = time.perf_counter()
    plan = ConfigManager(config_dict=flagship_config(patch),
                         verbose=False).build_plan(dev)
    print(f"phase 18: the config's plan has use_pallas_conv "
          f"{plan.use_pallas_conv} on {dev}")
    if not plan.use_pallas_conv:
        failures.append("phase 18: use_pallas_conv auto is off on the card")
    batch = flagship_batch(dev, patch, 2)
    plain = ResEncUNet(dataclasses.replace(plan, use_pallas_conv=False),
                       dtype=torch.float32, seed=SEED).to(dev)
    want, plain_ms, _, _ = train_path(plain, batch, TRAIN_STEPS,
                                      "phase 18 plain fp32", FLAGSHIP_LOSSES)
    want = want[0]
    del plain
    torch.cuda.empty_cache()
    runs = {}
    for name, (loss_tol, gnorm_tol) in DTYPE_LIMITS.items():
        model = ResEncUNet(plan, dtype=getattr(torch, name), seed=SEED).to(dev)
        _build.clear_counts()
        with counting_plain() as plain_calls:
            metrics, ms, peak, _ = train_path(
                model, batch, TRAIN_STEPS, f"phase 18 {name} (kernels on)",
                FLAGSHIP_LOSSES)
        launches = dict(_build.LAUNCHES)
        runs[name] = (launches, dict(_build.LAUNCH_SHAPES))
        del model
        torch.cuda.empty_cache()
        m = metrics[0]
        mine = F32_KERNELS if name == "float32" else F16_KERNELS
        conv = {k: launches.get(k, 0) for k in mine}
        other = {k: launches.get(k, 0) for k in CONV_KERNELS + F32_KERNELS
                 + F16_KERNELS if k not in mine and launches.get(k, 0)}
        implied = {k: v * TRAIN_STEPS for k, v in norm_launches(
            plan, patch, 2, getattr(torch, name)).items()}
        modes = {k: launches.get(k, 0) for k in implied}
        loss_diff = abs(m["total_loss"] - want["total_loss"]) / abs(
            want["total_loss"])
        gn_diff = abs(m["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
        finite = all(np.isfinite(v) for s in metrics for v in s.values())
        print(f"phase 18 {name} step [{smi}]: {ms:.1f} ms median (plain "
              f"fp32 {plain_ms:.1f} ms), peak "
              f"{peak / 2 ** 30:.2f} GiB; conv/upsample launches {conv}, "
              f"of another dtype {other}; plain versions called "
              f"{dict(plain_calls)}; "
              f"norm-act modes {modes}, norm_launches {implied}; against "
              f"plain fp32: total loss rel diff {loss_diff:.3e} (limit "
              f"{loss_tol}), grad_norm rel diff {gn_diff:.3e} (limit "
              f"{gnorm_tol}); finite {finite}")
        if not all(conv.values()):
            failures.append(f"phase 18 {name}: its kernels {conv}")
        if other:
            failures.append(f"phase 18 {name}: kernels of another dtype "
                            f"launched {other}")
        if plain_calls:
            failures.append(f"phase 18 {name}: plain versions called "
                            f"{dict(plain_calls)}")
        if modes != implied or not all(implied.values()):
            failures.append(f"phase 18 {name}: norm-act modes {modes}, "
                            f"norm_launches {implied}")
        if not (finite and loss_diff <= loss_tol and gn_diff <= gnorm_tol):
            failures.append(f"phase 18 {name}: loss diff {loss_diff} "
                            f"grad_norm diff {gn_diff} finite {finite}")
    print(f"phase 18 (compute dtypes): {time.perf_counter() - t_phase:.1f} s")
    return failures, runs


def param_dtype_phase(dev, patch, base):
    """Phase 19: the flagship step with ``param_dtype`` bfloat16 and bf16
    compute (every parameter, gradient and AdamW moment in bf16; AdamW is
    optax's rule in bf16, ``OptaxRule``): two first steps from the same
    weights and batch bit-equal, then TRAIN_STEPS steps with every counter
    zeroed before: all nine conv and upsample kernels launched, the
    norm-act modes as ``norm_launches`` derives them, finite losses; ms and
    peak memory beside phase 5b's (``base``). Returns the failures."""
    from mt3d_resenc_unet_torch.core.config import ConfigManager
    from mt3d_resenc_unet_torch.models.network import ResEncUNet, norm_launches
    from mt3d_resenc_unet_torch.ops import _build
    failures = []
    smi = card()
    t_phase = time.perf_counter()
    plan = ConfigManager(config_dict=flagship_config(
        patch, param_dtype="bfloat16"), verbose=False).build_plan(dev)
    model = ResEncUNet(plan, dtype=torch.bfloat16,
                       param_dtype=torch.bfloat16, seed=SEED).to(dev)
    batch = flagship_batch(dev, patch, 2)
    same = step_repeatability(model, batch, FLAGSHIP_LOSSES)
    if not same:
        failures.append("phase 19: two first steps differ")
    torch.cuda.empty_cache()
    _build.clear_counts()
    metrics, ms, peak, _ = train_path(model, batch, TRAIN_STEPS,
                                      "phase 19 param bf16", FLAGSHIP_LOSSES)
    launches = dict(_build.LAUNCHES)
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    del model
    torch.cuda.empty_cache()
    implied = {k: v * TRAIN_STEPS
               for k, v in norm_launches(plan, patch, 2).items()}
    modes = {k: launches.get(k, 0) for k in implied}
    print(f"phase 19 param_dtype bfloat16 step [{smi}]: parameters "
          f"{dtypes}; {ms:.1f} ms median against {base['ms']:.1f} ms (phase "
          f"5b, fp32 parameters); peak memory {peak / 2 ** 30:.2f} GiB "
          f"against {base['peak'] / 2 ** 30:.2f} GiB (phase 5b); launches "
          f"{launches}; norm-act modes {modes}, as the plan implies "
          f"{implied}: {modes == implied}")
    if dtypes != ["torch.bfloat16"]:
        failures.append(f"phase 19: parameters in {dtypes}")
    for name in CONV_KERNELS:
        if launches.get(name, 0) <= 0:
            failures.append(f"phase 19: kernel {name} was never launched")
    if modes != implied:
        failures.append(f"phase 19: norm-act modes {modes}, implied "
                        f"{implied}")
    for i, m in enumerate(metrics):
        if not all(np.isfinite(v) for v in m.values()):
            failures.append(f"phase 19 step {i}: non-finite {m}")
    print(f"phase 19 (param_dtype): {time.perf_counter() - t_phase:.1f} s")
    return failures


def engine_dtype_phase(patch, volume):
    """Phase 20: the engine's device pass at compute dtype float32 (the
    kernels left on: the fp32 forward kernels of rows 1, 4 and 7 and the
    norm-act kernels run, no conv kernel of another dtype), bfloat16 and
    float16 (which the engine, as the JAX engine, runs in bf16: finals
    bit-equal to bf16's) on a seeded u8 Blosc volume from the same
    checkpoint; then ``predict_volume`` on the same volume with an fp16
    kernel model (rows 1h, 4h and 7h launched, no other conv kernel)
    against the bf16 one, phase 3's limits; the fp32 finals held against
    the bf16 ones with
    ENGINE_DTYPE_LIMITS (5x one seed's measurement on the card: phase 8's
    limits are for two orders of the same sums, and bf16 against fp32
    compute moves the normals further). Returns the failures."""
    import dataclasses
    import os
    import shutil
    from pathlib import Path
    from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
    from mt3d_resenc_unet_torch.data.zio import create_zarr, open_zarr
    from mt3d_resenc_unet_torch.infer.engine import (ZarrInferenceEngine,
                                                     predict_volume)
    from mt3d_resenc_unet_torch.models.network import ResEncUNet
    from mt3d_resenc_unet_torch.ops import _build
    from mt3d_resenc_unet_torch.train.checkpoint import save_params
    failures = []
    smi = card()
    t_phase = time.perf_counter()
    work = Path(WORK_DIR).absolute() / "engine_dtypes"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        plan = plan_from_autoconfig(
            patch, 1, [TaskHead("sheet", 1, "sigmoid"),
                       TaskHead("normals", 3, "none")], model_name="flagship")
        ckpt = work / "flagship.pt"
        save_params(ckpt, ResEncUNet(plan, seed=SEED).state_dict())
        img = work / "image.zarr"
        vol = np.random.default_rng(SEED + 1).integers(0, 256, volume,
                                                       dtype=np.uint8)
        create_zarr(str(img), volume, np.uint8, patch)[...] = vol
        stores = {}
        # the engine maps compute_dtype float16 to bf16, as the JAX engine
        # does (its _DTYPES, mt3d_resenc_unet_tpu/infer/engine.py:52, 246)
        forward = {"bfloat16": FORWARD, "float32": F32_FORWARD,
                   "float16": FORWARD}
        for name in ("bfloat16", "float32", "float16"):
            cfg = engine_config(ckpt, img, work / name, patch, True)
            cfg["tr_config"]["compute_dtype"] = name
            _build.clear_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine = ZarrInferenceEngine(config_dict=cfg, device=None)
            stores[name] = engine.infer()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
            print(f"phase 20 engine {name} [{smi}]: pass {engine.last_mode} "
                  f"in {dt:.2f} s, phases " + ", ".join(
                      f"{k} {v:.3f} s" for k, v in engine.last_phases.items())
                  + f"; launches {launches}")
            if engine.last_mode != "device":
                failures.append(f"phase 20 {name}: the {engine.last_mode} "
                                "pass ran, not the device pass")
            other = {k: v for k, v in launches.items()
                     if k in CONV_KERNELS + F32_KERNELS + F16_KERNELS
                     and k not in forward[name]}
            if other or not all(launches.get(k, 0) for k in forward[name]):
                failures.append(f"phase 20 {name}: forward kernels "
                                f"{launches}, of another dtype {other}")
        outputs_close(stores["float32"], stores["bfloat16"],
                      "phase 20 fp32 vs bf16", failures, ENGINE_DTYPE_LIMITS)
        same = all(np.array_equal(
            open_zarr(os.path.join(stores["float16"], f"{t}_final"))
            .read_all(), open_zarr(os.path.join(stores["bfloat16"],
                                                f"{t}_final")).read_all())
            for t in ("sheet", "normals"))
        print(f"phase 20 engine float16: finals bit-equal to bf16's {same} "
              "(the engine runs bf16 for it, as the JAX engine does)")
        if not same:
            failures.append("phase 20 float16: finals differ from bf16's")
        # the fp16 forward kernels serving: predict_volume with an fp16
        # kernel model against the bf16 one, same weights and volume
        dev = engine.device
        served = {}
        for name in ("bfloat16", "float16"):
            model = ResEncUNet(dataclasses.replace(plan, use_pallas_conv=True),
                               dtype=getattr(torch, name), seed=SEED).to(dev)
            _build.clear_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            served[name] = predict_volume(model, vol, patch, 0.25, 2, dev)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
            want = FORWARD if name == "bfloat16" else F16_FORWARD
            print(f"phase 20 predict_volume {name} [{smi}]: {dt:.2f} s; "
                  f"launches {launches}")
            other = {k: v for k, v in launches.items()
                     if k in CONV_KERNELS + F32_KERNELS + F16_KERNELS
                     and k not in want}
            if other or not all(launches.get(k, 0) for k in want):
                failures.append(f"phase 20 predict_volume {name}: "
                                f"launches {launches}")
            del model
        compare_outputs({k: torch.from_numpy(v)
                         for k, v in served["float16"].items()},
                        {k: torch.from_numpy(v)
                         for k, v in served["bfloat16"].items()},
                        f"phase 20 predict_volume {vol.shape} fp16 vs bf16 "
                        "kernels", failures)
        for name, store in stores.items():
            print(f"phase 20 {name} stores on disk: " + ", ".join(
                f"{k} {store_bytes(os.path.join(store, k))}"
                for k in sorted(os.listdir(store))
                if os.path.isdir(os.path.join(store, k))) + " bytes")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 20 (engine dtypes): {time.perf_counter() - t_phase:.1f} s")
    return failures


# ---------------------------------------------------------------------------
# phase 21: the port's two CLIs as a user runs them, on a task file
# ---------------------------------------------------------------------------

CLI_TRAIN_TIMEOUT_S = 900   # the training CLI, 2 epochs at full width
CLI_TIMEOUT_S = 300         # each other CLI run
CLI_DEBUG_SAMPLES = 25      # what --debug_dataloader dumps


def cli_task_text(work, paths, image, patch, max_epoch):
    """``tasks/sheet_normals.yaml``'s own text, its comments and block
    lists kept, with only the lines phase 21 must cut replaced line by line
    (this machine has no YAML writer): the output paths, the patch cache
    and the synthetic dataset's and image's paths under ``work``,
    TRAINER_STEPS / TRAINER_VAL_STEPS steps, ``max_epoch`` epochs and the
    patch's six list items (the file's 128s at full size). Raises where a
    line to cut is missing."""
    with open(os.path.join(ROOT, "tasks", "sheet_normals.yaml"),
              encoding="utf-8") as f:
        text = f.read()
    cuts = {
        "ckpt_out_base: ./checkpoints": work / "ckpt",
        "tensorboard_log_dir: ./logs": work / "logs",
        "max_steps_per_epoch: 500": TRAINER_STEPS,
        "max_val_steps_per_epoch: 25": TRAINER_VAL_STEPS,
        "max_epoch: 500": max_epoch,
        "cache_folder: patch_cache/sheet_normals": work / "patch_cache",
        "- input: /data/s1.zarr": paths["input"],
        "sheet: /data/s1_sheet.zarr": paths["sheet"],
        "normals: /data/s1_normals.zarr": paths["normals"],
        "checkpoint_path: ./checkpoints/sheet_normals":
            work / "ckpt" / "sheet_normals",
        "input_path: ./data/layers.zarr": image,
        "output_path: ./outputs": work / "out",
    }
    for value in cuts.values():
        if any(c in str(value) for c in (": ", " #", "\n")):
            raise ValueError(f"{value!r} is not a plain YAML scalar")
    sizes = iter(list(patch) * 2)
    seen = collections.Counter()
    out = []
    for line in text.splitlines():
        body = line.lstrip(" ")
        indent = line[:len(line) - len(body)]
        if body in cuts:
            key = body.split(":")[0]
            line = f"{indent}{key}: {cuts[body]}"
        elif body == "- 128":
            line = f"{indent}- {next(sizes)}"
        seen[body] += 1
        out.append(line)
    missing = [k for k in cuts if seen[k] != 1]
    if missing or seen["- 128"] != 6:
        raise ValueError(f"tasks/sheet_normals.yaml lacks the lines "
                         f"{missing} or six patch items")
    return "\n".join(out) + "\n"


def _cli(module, args, cwd, timeout):
    """``python -m mt3d_resenc_unet_torch.<module> <args>`` in ``cwd``, the
    repository on its path; the CompletedProcess with its output as text
    (``returncode`` None where ``timeout`` cut it, after killing it)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", f"mt3d_resenc_unet_torch.{module}", *args]
    try:
        return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                              text=True, timeout=timeout)
    except subprocess.TimeoutExpired as exc:
        out = exc.stdout or ""
        if isinstance(out, bytes):
            out = out.decode(errors="replace")
        return subprocess.CompletedProcess(
            cmd, None, out, f"killed after the {timeout} s limit")


def _tail(proc, n=12):
    return "\n    ".join((proc.stdout + proc.stderr).splitlines()[-n:])


def _jsonl_losses(path):
    """{epoch: {key: value}} of the ``*_loss`` scalars a trainer wrote to
    its metrics JSONL (train and validation records merged)."""
    out = collections.defaultdict(dict)
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            out[rec["step"]].update({k: v for k, v in rec.items()
                                     if k.endswith("_loss")})
    return dict(out)


def cli_phase(patch, train_data, volume, trainer_history):
    """Phase 21: the training and inference CLIs in subprocesses, on a task
    file written from ``tasks/sheet_normals.yaml``'s text
    (``cli_task_text``) and read by the port's own YAML reader, the model at
    full width (the autoconfigured 6-stage plan at ``patch``, SE on, batch
    2, bf16) on phase 7's synthetic dataset. The file must read to phase
    7's config; the training CLI must exit 0 with the kernels on, write the
    checkpoints, the final weights and finite losses equal to phase 7's
    first run (``trainer_history``: the same config in this process) bit
    for bit. The inference CLI serves a seeded ``volume`` u8 Blosc input
    from that checkpoint, bit-equal to ``ZarrInferenceEngine`` in this
    process on the same file (the device pass adds its patches in a fixed
    order). Then the probes: a rerun stops at the overwrite guard
    (``FileExistsError``), ``--postprocess_only`` twice says "already
    finalized; skipping" the second time, ``--write_layers`` writes a JPEG
    per z-slice and target, a legacy ``tr_params:`` file exits non-zero
    naming the five sections, ``--debug_dataloader`` writes its TIFFs into
    ``./debug_dir`` and trains nothing; the last two, which need no trained
    model, run one after the other beside the training CLI. Returns the
    failures."""
    import shutil
    from pathlib import Path
    from mt3d_resenc_unet_torch.core.yaml_load import safe_load
    from mt3d_resenc_unet_torch.data.zio import create_zarr, open_zarr
    from mt3d_resenc_unet_torch.infer.engine import ZarrInferenceEngine
    from mt3d_resenc_unet_torch.tools.synthetic_data import \
        write_sheet_dataset
    checks, seconds = {}, {}
    smi = card()
    t_phase = time.perf_counter()
    work = Path(WORK_DIR).absolute()
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        paths = write_sheet_dataset(work / "data", train_data, seed=SEED)
        image = work / "image.zarr"
        create_zarr(str(image), volume, np.uint8, patch)[...] = \
            np.random.default_rng(SEED + 1).integers(0, 256, volume,
                                                     dtype=np.uint8)
        task = work / "sheet_normals.yaml"
        task.write_text(cli_task_text(work, paths, image, patch,
                                      TRAINER_EPOCHS), encoding="utf-8")
        cfg = safe_load(task.read_text(encoding="utf-8"))
        want = sheet_normals_config(work, paths, patch, TRAINER_EPOCHS)
        checks["the file reads to phase 7's config"] = all(
            cfg[k] == want[k] for k in ("tr_setup", "tr_config",
                                        "model_config", "dataset_config"))

        def run_cli(label, module, args, cwd=work, timeout=CLI_TIMEOUT_S):
            t0 = time.perf_counter()
            proc = _cli(module, args, cwd, timeout)
            seconds[label] = time.perf_counter() - t0
            return proc

        # the two probes that need no trained model run beside the
        # training CLI: a legacy tr_params: file, --debug_dataloader
        legacy = work / "legacy.yaml"
        legacy.write_text("tr_params:\n  model_name: legacy\n"
                          "inference_params:\n  input_path: x.zarr\n")
        debug = work / "debug"
        debug.mkdir()
        beside = pool.submit(lambda: (
            run_cli("legacy config (beside train)", "train",
                    ["--config_path", str(legacy)]),
            run_cli("debug_dataloader (beside train)", "train", [
                "--config_path", str(task), "--debug_dataloader"],
                cwd=debug)))

        # training
        proc = run_cli("train", "train", ["--config_path", str(task),
                                          "--verbose"],
                       timeout=CLI_TRAIN_TIMEOUT_S)
        checks["train: rc 0"] = proc.returncode == 0
        if proc.returncode != 0:
            print(f"phase 21 train rc {proc.returncode}:\n    {_tail(proc)}")
        kernels = [line for line in proc.stdout.splitlines()
                   if "[trainer] model" in line]
        print("phase 21 train: " + (kernels[0] if kernels else "no model "
                                    "line"))
        checks["train: kernels on"] = any("kernels on" in line
                                          for line in kernels)
        ckpt = work / "ckpt" / "sheet_normals"
        checks["train: a checkpoint an epoch"] = all(
            (ckpt / str(e) / "state.pt").is_file()
            for e in range(TRAINER_EPOCHS))
        checks["train: final weights"] = (
            work / "sheet_normals_final.pt").is_file()
        gif = work / "sheet_normals_debug.gif"
        frames = 0
        if gif.is_file():
            from PIL import Image
            with Image.open(gif) as im:
                frames = im.n_frames
                im.seek(frames - 1)
                im.convert("RGB")       # decodes the last frame
        print(f"phase 21 train: debug GIF {gif.name} "
              + (f"{gif.stat().st_size} bytes, {frames} frames (a z-slice "
                 f"each of {patch[0]})" if gif.is_file() else "missing"))
        checks["train: the debug GIF, a frame a z-slice"] = \
            frames == patch[0]
        metrics = work / "logs" / "sheet_normals_metrics.jsonl"
        got = _jsonl_losses(metrics) if metrics.is_file() else {}
        same = finite = bool(got) and len(trainer_history) == TRAINER_EPOCHS
        for h in trainer_history:
            mine = got.get(h["epoch"], {})
            theirs = {k: v for k, v in h.items() if k.endswith("_loss")}
            finite = finite and all(np.isfinite(v) for v in mine.values())
            same = same and mine == theirs and bool(mine)
            print(f"phase 21 train epoch {h['epoch'] + 1}: " + " ".join(
                f"{k} {v!r}" for k, v in sorted(mine.items()))
                + f" (phase 7: {'the same bits' if mine == theirs else theirs})")
        checks["train: finite losses"] = finite
        checks["train: losses bit-equal to phase 7's run"] = same

        # inference, then the same file in this process
        proc = run_cli("infer", "infer", ["--config_path", str(task)])
        checks["infer: rc 0"] = proc.returncode == 0
        if proc.returncode != 0:
            print(f"phase 21 infer rc {proc.returncode}:\n    {_tail(proc)}")
        store = work / "out" / "predictions.zarr"
        cfg["inference_config"]["output_path"] = str(work / "in_process")
        t0 = time.perf_counter()
        engine = ZarrInferenceEngine(config_dict=cfg, device=None)
        here = engine.infer()
        seconds["infer in process"] = time.perf_counter() - t0
        equal = {}
        for name in cfg["inference_config"]["output_targets"]:
            try:
                a = open_zarr(str(store / f"{name}_final")).read_all()
                b = open_zarr(os.path.join(here, f"{name}_final")).read_all()
                equal[name] = a.dtype == b.dtype and np.array_equal(a, b)
            except (OSError, ValueError) as exc:
                equal[name] = f"unreadable ({exc})"
        print(f"phase 21 infer: the CLI's finals against the engine in "
              f"this process ({engine.last_mode} pass): {equal}")
        checks["infer: finals bit-equal to the in-process engine"] = all(
            v is True for v in equal.values())

        # the probes
        proc = run_cli("rerun", "infer", ["--config_path", str(task)])
        checks["rerun: stops at the overwrite guard"] = (
            proc.returncode not in (0, None)
            and "FileExistsError" in proc.stderr)
        first = run_cli("postprocess_only", "infer", [
            "--config_path", str(task), "--postprocess_only"])
        second = run_cli("postprocess_only + write_layers", "infer", [
            "--config_path", str(task), "--postprocess_only",
            "--write_layers"])
        checks["postprocess_only twice: already finalized"] = (
            first.returncode == 0 and second.returncode == 0
            and "already finalized; skipping" in second.stdout)
        slices = {name: len(list((work / "out" / "z_slices" / name)
                                 .glob("*.jpg")))
                  for name in cfg["inference_config"]["output_targets"]}
        print(f"phase 21 write_layers: JPEGs by target {slices} for "
              f"{volume[0]} z-slices")
        checks["write_layers: a JPEG per z-slice and target"] = all(
            n == volume[0] for n in slices.values())
        proc, debug_proc = beside.result()
        checks["legacy tr_params: names the five sections"] = (
            proc.returncode not in (0, None) and all(
                k in proc.stderr for k in ("tr_setup", "tr_config",
                                           "model_config", "dataset_config",
                                           "inference_config")))
        proc = debug_proc
        tiffs = sorted(p.name for p in (debug / "debug_dir").glob("*.tif"))
        # a TIFF a sample for the image and for each target
        want_tiffs = CLI_DEBUG_SAMPLES * (
            1 + len(cfg["dataset_config"]["targets"]))
        print(f"phase 21 debug_dataloader: rc {proc.returncode}, "
              f"{len(tiffs)} TIFFs ({tiffs[:3]}...)")
        checks["debug_dataloader: TIFFs, no training"] = (
            proc.returncode == 0 and len(tiffs) == want_tiffs
            and "exiting before training" in proc.stdout
            and not (debug / "sheet_normals_final.pt").exists())
    finally:
        pool.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 21 [{smi}] seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    print("phase 21 checks: " + ", ".join(
        f"{k}: {'ok' if v else 'FAILED'}" for k, v in checks.items()))
    print(f"phase 21 (CLIs): {time.perf_counter() - t_phase:.1f} s")
    return [f"phase 21: {k}" for k, v in checks.items() if not v]


# ---------------------------------------------------------------------------
# phase 22: private buckets, s3 and gs, on an emulator that checks the
# signatures and tokens with its own code
# ---------------------------------------------------------------------------

FIXTURES = os.path.join(ROOT, "tests", "data", "remote_auth")
# AWS's published example credentials, which the golden requests carry
BUCKET_KEY = "AKIDEXAMPLE"
BUCKET_SECRET = "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY"
BUCKET_LIST_PAGE = 100      # keys a list page: the continuation path runs
BUCKET_MEET_S = 30.0        # a "slow-" bucket's first read waits for a 2nd
CAS_ROUNDS = 20
BUCKET_ENGINE_CUT = "(160, 256, 256) of phase 8's (256, 512, 512)"


def emulator_module():
    """``tests/bucket_emulator.py``: the S3 + GCS emulator, standard
    library only, that the CPU tests run too."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import bucket_emulator
    return bucket_emulator


@contextlib.contextmanager
def bucket_emulator(work):
    """``tests/bucket_emulator.py`` in a child process, strict (anonymous
    requests refused, SigV4 checked with its own code, bearer tokens only
    those it granted for a JWT that verifies against the golden key), fed
    the example S3 credentials; yields its base URL, stops it after."""
    manifest = json.loads(open(os.path.join(FIXTURES, "manifest.json"),
                               encoding="utf-8").read())
    sa = json.loads(open(os.path.join(
        FIXTURES, manifest["jwt"]["service_account_file"]),
        encoding="utf-8").read())
    conf = os.path.join(work, "emulator.json")
    with open(conf, "w", encoding="utf-8") as f:
        json.dump({"aws": {BUCKET_KEY: BUCKET_SECRET},
                   "jwt_n": manifest["jwt"]["public_n"],
                   "jwt_e": manifest["jwt"]["public_e"],
                   "jwt_iss": sa["client_email"], "strict": True,
                   "page": BUCKET_LIST_PAGE, "meet_s": BUCKET_MEET_S}, f)
    proc = subprocess.Popen([sys.executable, "-u",
                             emulator_module().__file__, conf],
                            stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        if not line.startswith("PORT "):
            raise RuntimeError(f"the bucket emulator did not start: {line!r}")
        yield f"http://127.0.0.1:{int(line.split()[1])}"
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()


def bucket_env(url, work):
    """The environment of phase 22's clients: the example S3 credentials,
    the test service account (the golden key) for gs, every store and
    token endpoint on the emulator; no file of this machine's user."""
    manifest = json.loads(open(os.path.join(FIXTURES, "manifest.json"),
                               encoding="utf-8").read())
    sa = json.loads(open(os.path.join(
        FIXTURES, manifest["jwt"]["service_account_file"]),
        encoding="utf-8").read())
    sa["private_key"] = open(os.path.join(
        FIXTURES, manifest["jwt"]["key_file"]), encoding="utf-8").read()
    sa_path = os.path.join(work, "service_account.json")
    with open(sa_path, "w", encoding="utf-8") as f:
        json.dump(sa, f)
    os.makedirs(os.path.join(work, "gcloud"), exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("AWS_", "GOOGLE_", "GCE_", "CLOUDSDK_"))}
    env.update(AWS_ACCESS_KEY_ID=BUCKET_KEY,
               AWS_SECRET_ACCESS_KEY=BUCKET_SECRET,
               AWS_CONFIG_FILE=os.devnull,
               AWS_SHARED_CREDENTIALS_FILE=os.devnull,
               GOOGLE_APPLICATION_CREDENTIALS=sa_path,
               CLOUDSDK_CONFIG=os.path.join(work, "gcloud"),
               GCE_METADATA_ROOT=url[len("http://"):],
               TENSORSTORE_GCS_HTTP_URL=url)
    return env


def point_at(url):
    """Points the port's s3 endpoint and token endpoint at ``url``, as the
    CPU tests do."""
    from mt3d_resenc_unet_torch.data import remote_auth, zio
    zio.s3_endpoint = lambda bucket, region=None: f"{url}/{bucket}"
    remote_auth.GOOGLE_TOKEN_URL = f"{url}/token"
    remote_auth._providers.clear()


def golden_replay():
    """Phase 22a: tensorstore's recorded requests signed again by the port
    (``remote_auth.sign_s3``) and checked by the emulator's ``sigv4_ok``;
    the golden JWT signed again and checked by its ``jwt_claims_ok``.
    Returns the failures."""
    import datetime
    from mt3d_resenc_unet_torch.data import remote_auth
    emu = emulator_module()
    manifest = json.loads(open(os.path.join(FIXTURES, "manifest.json"),
                               encoding="utf-8").read())
    failures, n = [], 0
    for case in manifest["s3"]:
        c = case["credentials"]
        creds = remote_auth.AwsCredentials(c["access_key"], c["secret_key"],
                                           c.get("session_token"))
        for r in case["requests"]:
            h = r["headers"]
            names = h["authorization"].split("SignedHeaders=")[1].split(
                ",")[0].split(";")
            path, _, query = r["target"].partition("?")
            when = datetime.datetime.strptime(
                h["x-amz-date"], "%Y%m%dT%H%M%SZ").replace(
                tzinfo=datetime.timezone.utc)
            region = h["authorization"].split("/")[2]
            mine = remote_auth.sign_s3(
                r["method"], path, query, {k: h[k] for k in names},
                h["x-amz-content-sha256"], creds, region, when)
            n += 1
            if mine != h["authorization"]:
                failures.append(f"22a: {case['name']} {r['method']} "
                                f"{r['target']}: the port's signature differs")
            if not emu.sigv4_ok(r["method"], r["target"], h,
                                r["body_sha256"],
                                {c["access_key"]: c["secret_key"]}):
                failures.append(f"22a: {case['name']} {r['method']} "
                                f"{r['target']}: the emulator refuses it")
    jwt = manifest["jwt"]
    sa = json.loads(open(os.path.join(FIXTURES, jwt["service_account_file"]),
                         encoding="utf-8").read())
    sa["private_key"] = open(os.path.join(FIXTURES, jwt["key_file"]),
                             encoding="utf-8").read()
    t0 = time.perf_counter()
    mine = remote_auth.service_account_jwt(sa, jwt["iat"])
    rs256_ms = 1e3 * (time.perf_counter() - t0)
    if mine != f"{jwt['signing_input']}.{jwt['signature']}":
        failures.append("22a: the port's JWT differs from the golden one")
    if emu.jwt_claims_ok(mine, int(jwt["public_n"], 16), jwt["public_e"],
                         sa["client_email"]) is None:
        failures.append("22a: the emulator refuses the golden JWT")
    print(f"phase 22a: {n} golden S3 requests (GET, HEAD, PUT .zarray and "
          f"chunks, list, DELETE; without and with a session token) and "
          f"the golden JWT signed again by the port: "
          f"{'all equal' if not failures else failures[:3]}; RS256 in "
          f"pure Python {rs256_ms:.1f} ms")
    return failures


def _stats(url):
    import urllib.request
    with urllib.request.urlopen(f"{url}/_stats", timeout=30) as resp:
        return collections.Counter(json.loads(resp.read()))


def bucket_copy(src, dst):
    """``src`` written whole into ``dst`` by the port, its chunks and
    compressor kept; returns (raw bytes, seconds of the write)."""
    from mt3d_resenc_unet_torch.data.zio import create_zarr, open_zarr
    vol = open_zarr(src)
    data = vol.read_all()
    t0 = time.perf_counter()
    create_zarr(dst, vol.shape, vol.dtype, vol.chunks,
                compressor=vol.store.compressor,
                delete_existing=True)[...] = data
    return data.nbytes, time.perf_counter() - t0


def cas_writer_main(argv) -> int:
    """``chip_smoke.py --cas-writer URL PATH HALF ROUNDS``: phase 22e's
    writer: ROUNDS times, its half of the one chunk of PATH written and
    read back."""
    url, path, half, rounds = argv[0], argv[1], int(argv[2]), int(argv[3])
    point_at(url)
    from mt3d_resenc_unet_torch.data.zio import open_zarr
    vol = open_zarr(path, writable=True)
    mine = np.s_[4 * half:4 * half + 4]
    for r in range(1, rounds + 1):
        vol[mine] = r + 100 * half
        if not (vol[mine] == r + 100 * half).all():
            print(f"RESULT lost: half {half} round {r}", flush=True)
            return 1
    print(f"RESULT ok: half {half}", flush=True)
    return 0


def bucket_phase(patch, train_data, volume):
    """Phase 22: private buckets. Returns the failures."""
    import shutil
    from pathlib import Path
    from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
    from mt3d_resenc_unet_torch.data.zio import create_zarr, open_zarr
    from mt3d_resenc_unet_torch.infer.engine import ZarrInferenceEngine
    from mt3d_resenc_unet_torch.models.network import ResEncUNet
    from mt3d_resenc_unet_torch.ops import _build
    from mt3d_resenc_unet_torch.tools.synthetic_data import \
        write_sheet_dataset
    from mt3d_resenc_unet_torch.tools.zarr_crop import cut_zarr_bounding_box
    from mt3d_resenc_unet_torch.train.checkpoint import save_params
    failures = golden_replay()
    smi = card()
    t_phase = time.perf_counter()
    work = Path(WORK_DIR).absolute() / "buckets"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    saved_env = dict(os.environ)
    checks, rates = {}, []
    try:
        with bucket_emulator(str(work)) as url:
            os.environ.clear()
            os.environ.update(bucket_env(url, str(work)))
            point_at(url)
            # refusals: an anonymous request, a wrong secret
            import http.client
            host, port = url[len("http://"):].split(":")
            conn = http.client.HTTPConnection(host, int(port), timeout=30)
            conn.request("GET", "/smoke/none")
            checks["anonymous S3 GET refused (403)"] = \
                conn.getresponse().status == 403
            conn.close()
            os.environ["AWS_SECRET_ACCESS_KEY"] = "not-the-secret"
            try:
                open_zarr("s3://smoke/none.zarr")
                checks["a wrong secret refused"] = False
            except OSError as exc:
                checks["a wrong secret refused"] = "HTTP 403" in str(exc) \
                    and "not-the-secret" not in str(exc)
            os.environ["AWS_SECRET_ACCESS_KEY"] = BUCKET_SECRET

            # (b) phase 7's dataset from s3 and gs
            paths = write_sheet_dataset(work / "data", train_data, seed=SEED)
            remote = {}
            for scheme in ("s3", "gs"):
                remote[scheme] = {"ref_label": paths["ref_label"]}
                for name in ("input", "sheet", "normals"):
                    dst = f"{scheme}://smoke/data/{name}.zarr"
                    nbytes, dt = bucket_copy(paths[name], dst)
                    remote[scheme][name] = dst
                    rates.append((f"{scheme} write {name}", nbytes, dt))
                t0 = time.perf_counter()
                back = open_zarr(remote[scheme]["input"]).read_all()
                rates.append((f"{scheme} read input", back.nbytes,
                              time.perf_counter() - t0))
                checks[f"{scheme}: the image reads back bit-equal"] = \
                    np.array_equal(back, open_zarr(paths["input"]).read_all())
            local = first_samples(work, paths, patch, "local")
            for scheme in ("s3", "gs"):
                got = first_samples(work, remote[scheme], patch,
                                    f"from {scheme}://")
                checks[f"(b) first {SAME_SAMPLES} samples from {scheme}:// "
                       "bit-equal to the local read"] = equal_samples(local,
                                                                      got)

            # (c) zarr_crop local -> s3 -> gs against a local crop, twice
            # at most 128 a side from (16, 32, 48): 2 x 2 x 2 chunks at
            # phase 7's size, so the tools leave no write unawaited
            box = [b for lo, n in zip((16, 32, 48), train_data)
                   for b in (lo, min(n, lo + 128))]
            want = None
            for rnd in (1, 2):                     # the 2nd deletes the 1st
                cut_zarr_bounding_box(paths["input"], str(work / "crop.zarr"),
                                      *box)
                cut_zarr_bounding_box(paths["input"], "s3://smoke/crop.zarr",
                                      *box)
                ext = open_zarr("s3://smoke/crop.zarr").shape
                cut_zarr_bounding_box("s3://smoke/crop.zarr",
                                      "gs://smoke/crop.zarr",
                                      0, ext[0], 0, ext[1], 0, ext[2])
                want = open_zarr(str(work / "crop.zarr")).read_all()
                got = open_zarr("gs://smoke/crop.zarr")
                checks[f"(c) crop local -> s3 -> gs bit-equal to the local "
                       f"crop (run {rnd})"] = (
                    np.array_equal(got.read_all(), want)
                    and got.store.compressor["cname"] == "zstd")
            print(f"phase 22c: crop {want.shape} of the image, Blosc "
                  f"{got.store.compressor}")

            # (d) the engine's device pass with its input from s3
            plan = plan_from_autoconfig(
                patch, 1, [TaskHead("sheet", 1, "sigmoid"),
                           TaskHead("normals", 3, "none")],
                model_name="flagship")
            ckpt = work / "flagship.pt"
            save_params(ckpt, ResEncUNet(plan, seed=SEED).state_dict())
            img = work / "image.zarr"
            create_zarr(str(img), volume, np.uint8, patch)[...] = \
                np.random.default_rng(SEED + 2).integers(0, 256, volume,
                                                         dtype=np.uint8)
            bucket_copy(str(img), "s3://smoke/engine/image.zarr")
            finals = {}
            for label, src in (("local", str(img)),
                               ("s3", "s3://smoke/engine/image.zarr")):
                cfg = engine_config(ckpt, src, work / f"out_{label}", patch,
                                    True)
                _build.clear_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine = ZarrInferenceEngine(config_dict=cfg, device=None)
                store = engine.infer()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                launches = dict(_build.LAUNCHES)
                print(f"phase 22d engine, input {label} [{smi}]: pass "
                      f"{engine.last_mode} on {volume} ({BUCKET_ENGINE_CUT})"
                      f" in {dt:.2f} s, phases " + ", ".join(
                          f"{k} {v:.3f} s"
                          for k, v in engine.last_phases.items())
                      + f"; launches {launches}")
                checks[f"(d) {label}: the device pass"] = \
                    engine.last_mode == "device"
                forward = FORWARD + ("norm_act_raw_stats", "norm_act_tail")
                checks[f"(d) {label}: forward kernels launched, no "
                       "backward one"] = all(
                    launches.get(k, 0) > 0 if k in forward
                    else launches.get(k, 0) == 0
                    for k in CONV_KERNELS + TAIL_KERNELS)
                checks[f"(d) {label}: within 60 s"] = dt <= 60
                finals[label] = {
                    t: open_zarr(os.path.join(store, f"{t}_final")).read_all()
                    for t in ("sheet", "normals")}
            checks["(d) finals from s3 bit-equal to the local input's"] = all(
                np.array_equal(finals["local"][t], finals["s3"][t])
                for t in finals["local"])

            stats = _stats(url)
            checks["the token granted once (cached), none refused"] = (
                stats["grants"] == 1 and stats["refused_grants"] == 0)

            # (e) two processes write the halves of one chunk
            for scheme in ("s3", "gs"):
                path = f"{scheme}://slow-cas/{scheme}.zarr"
                create_zarr(path, (8, 8, 8), np.uint8, (8, 8, 8))
                before = _stats(url)["conflicts"]
                procs = [subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--cas-writer", url, path, str(half), str(CAS_ROUNDS)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True) for half in (0, 1)]
                outs = [p.communicate(timeout=DIST_TIMEOUT_S) for p in procs]
                conflicts = _stats(url)["conflicts"] - before
                got = open_zarr(path).read_all()
                ok = (all(p.returncode == 0 for p in procs)
                      and (got[:4] == CAS_ROUNDS).all()
                      and (got[4:] == 100 + CAS_ROUNDS).all())
                print(f"phase 22e {scheme}: two processes x {CAS_ROUNDS} "
                      f"rounds on halves of one chunk: both halves kept "
                      f"{ok}, {conflicts} writes overtaken (412) and "
                      "redone" + ("" if ok else
                                  f"; {[o[1][-500:] for o in outs]}"))
                checks[f"(e) {scheme}: both halves kept, 412s seen"] = \
                    ok and conflicts > 0
            stats = _stats(url)
        print(f"phase 22 emulator: {stats['requests']} requests, "
              f"{stats['refused']} refused, {stats['grants']} token grants "
              f"(this process 1, each writer of (e) 1), "
              f"{stats['refused_grants']} grants refused, "
              f"{stats['conflicts']} conditional writes overtaken")
        # (f) loopback rates, this host's
        for label, nbytes, dt in rates:
            print(f"phase 22f host rate [{smi}; {_host_cpu()}; loopback, "
                  f"the emulator in a child process]: {label} "
                  f"{nbytes / 1e6:.1f} MB raw in {dt:.3f} s, "
                  f"{nbytes / 1e6 / dt:.1f} MB/s")
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
        shutil.rmtree(work, ignore_errors=True)
    print("phase 22 checks: " + ", ".join(
        f"{k}: {'ok' if v else 'FAILED'}" for k, v in checks.items()))
    print(f"phase 22 (buckets): {time.perf_counter() - t_phase:.1f} s")
    return failures + [f"phase 22: {k}" for k, v in checks.items() if not v]


@contextlib.contextmanager
def http_root(root):
    """Serves the directory ``root`` over HTTP/1.1 on 127.0.0.1 (a free
    port) from a child process (``chip_smoke.py --serve``), so that a read
    rate is the client's cost alone and shares no interpreter lock with the
    server; yields the base URL, stops the child after."""
    proc = subprocess.Popen([sys.executable, "-u", os.path.abspath(__file__),
                             "--serve", str(root)], stdout=subprocess.PIPE,
                            text=True)
    try:
        line = proc.stdout.readline()
        if not line.startswith("PORT "):
            raise RuntimeError(f"the http server did not start: {line!r}")
        yield f"http://127.0.0.1:{int(line.split()[1])}"
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()


def serve_main(root) -> int:
    """``chip_smoke.py --serve ROOT``: serve ``ROOT`` over HTTP/1.1 on
    127.0.0.1, without Nagle's algorithm (as object stores serve), until
    terminated; prints ``PORT n`` first."""
    import functools
    import http.server

    class Quiet(http.server.SimpleHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def log_message(self, *args):
            pass

    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Quiet, directory=root))
    print(f"PORT {httpd.server_address[1]}", flush=True)
    httpd.serve_forever()
    return 0


def read_rates(local, url, label):
    """The whole array read through ``open_zarr`` from the local path and
    from its URL (the port's HTTP store, one connection a pool thread):
    MB/s of decoded bytes each, printed; returns whether both reads are
    bit-equal."""
    from mt3d_resenc_unet_torch.data.zio import open_zarr
    out = {}
    for kind, path in (("local", local), ("http", url)):
        t0 = time.perf_counter()
        out[kind] = open_zarr(path).read_all()
        out[kind + "_s"] = time.perf_counter() - t0
    mb = out["local"].nbytes / 1e6
    same = np.array_equal(out["local"], out["http"])
    print(f"remote read {label} [{_host_cpu()}]: {mb:.1f} MB decoded, local "
          f"{mb / out['local_s']:.1f} MB/s, over http {mb / out['http_s']:.1f}"
          f" MB/s; bit-equal {same}")
    return same


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
    if sys.argv[1:2] == ["--serve"]:
        sys.exit(serve_main(sys.argv[2]))
    if sys.argv[1:2] == ["--cas-writer"]:
        sys.exit(cas_writer_main(sys.argv[2:]))
    sys.exit(main())
