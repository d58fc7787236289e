#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100): builds the
port's CUDA kernels, holds each against its plain PyTorch version at the
flagship's shapes, runs the full-width flagship forward against the plain
fp32 path, serves a volume through ``predict_volume``, runs the full-width
flagship training step through the kernels against the plain fp32 path,
holds the fused instance-norm op against its plain version, and trains the
flagship through the port's ``Trainer`` on a synthetic zarr dataset.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build the kernels from ``mt3d_resenc_unet_torch/ops/csrc`` (one nvcc
     per source, all at once), print the registers, shared memory and
     spills ``-Xptxas -v`` reports (per entry for the two tensor-core
     sources) and the card's name and power limit;
  2. kernel vs plain on the card at the flagship's shapes (N=2): the conv
     at stride 1 (C=32 @128^3, 64 @64^3, 256 @16^3, 512 @8^3 and @4^3, each
     in the plain / stats / pre+stats / add-in+stats modes), at stride 2
     (32->64, 64->128, with stats) and the upsample (128->64, 64->32). Plain
     versions run in fp32 with TF32 off. Printed per case: the max abs
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
     (N=2): conv dx at stride 1 in the plain / corr / corr+post modes and at
     stride 2 with corr, conv dW in the plain / pre / corr / pre+corr modes
     and at stride 2 with corr, upsample dx and dW; printed per case: the
     error relative to the plain output's max abs, the [sum du*x; sum du]
     error where emitted, median ms of kernel, plain and library
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
     ms and bound per training step;
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
     settings without squeeze-excitation, for 2 epochs of 6 steps and 2
     validation steps, then resumed from its checkpoint to a 3rd epoch: the
     resume must start at epoch 3 with the optimizer count at 12 and the
     parameters and momenta bit-equal to the saved ones; every launch
     counter is zeroed before and all nine conv and upsample kernels must
     have launched. Printed per epoch: losses, patches/s, t_fetch, t_step,
     the checkpoint's size and save time, and the trainer's patches/s next
     to phase 5b's step-alone rate.
Then one JSON line of the thirteen kernels (launches, error, and ms,
plain_ms, library_ms and bound_ms summed over each kernel's cases) and,
last, the device line.

Imports torch and the port only: nothing of JAX or of the JAX package.
"""

import collections
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_TOL = 1e-2      # max |kernel - plain| / max |plain|, bf16 outputs
STATS_TOL = 1e-3       # relative error of the fp32 [sum; sumsq]
# bf16 kernels vs the fp32 plain path through the whole network; measured
# 3.6e-3 and 0.99994 on an H100 at seed 0, so both limits keep >5x headroom
SHEET_TOL = 2e-2       # max |p_bf16 - p_fp32| of the sheet probability
NORMALS_MIN_COS = 0.999  # mean cosine of bf16 vs fp32 normals
# the training step, bf16 through the kernels vs fp32 plain, same weights
# and batch: limits set with >=5x headroom over the values measured on an
# H100 (NVIDIA H100 80GB HBM3, 700 W) at seed 0, written beside each
TRAIN_LOSS_TOL = 1e-4      # rel. diff of the first step's total loss; 4.6e-6
TRAIN_GNORM_TOL = 5e-3     # rel. diff of the first step's grad_norm; 4.1e-4
TRAIN_MIN_COS = 0.85       # gradient cosine per top-level module; 0.974
TRAIN_STEPS = 4
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
DW_MODES = ("plain", "pre", "corr", "pre_corr")
PATCH = (128, 128, 128)
VOLUME = (160, 256, 256)
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
    "conv3d_k3_s2": f"{_CS}/conv3d_k3.cu",
    "upsample2x": f"{_CS}/upsample2x.cu",
    "conv3d_k3_dx_s1": f"{_CS}/conv3d_k3_dx.cu",
    "conv3d_k3_dx_s2": f"{_CS}/conv3d_k3_dx.cu",
    "conv3d_k3_dw_s1": f"{_CS}/conv3d_k3_dw_s1.cu",
    "conv3d_k3_dw_s2": f"{_CS}/conv3d_k3_dw.cu",
    "upsample2x_dx": f"{_CS}/upsample2x_bwd.cu",
    "upsample2x_dw": f"{_CS}/upsample2x_bwd.cu",
    **{name: f"{_CS}/norm_act.cu" for name in NORM_KERNELS},
}


def median_ms(fn, reps=7, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def conv_flops(n, ci, co, extent, stride):
    return 2 * 27 * ci * co * n * (extent // stride) ** 3


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
    s1 = 2 * (halo * c3.S1_KC * 2 + 27 * c3.S1_KC * c3.S1_CT * 2)
    dw_x = math.prod(b + 2 for b in c3.DW_BRICK) * c3.DW_CT * 2
    dw_g = math.prod(c3.DW_BRICK) * c3.DW_CT * 2
    print(f"  dynamic shared memory per block: conv3d_k3_s1 {s1} B, with "
          f"pre {s1 + halo * c3.S1_KC * 2} B; conv3d_k3_dw_s1 "
          f"{2 * (dw_x + dw_g)} B, with corr {2 * (dw_x + 2 * dw_g)} B")
    for source in ("conv3d_k3_s1", "conv3d_k3_dw_s1"):
        entry = None
        for line in logs[source].splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and ("spill" in line or "registers" in line):
                usage = line.split(":", 1)[-1].strip()
                print(f"  {source} {entry[:60]}: {usage}")


def kernel_cases(dev, gen, conv_cases, s2_cases, up_cases):
    """Phase 2. Returns (per-case records, failures). Each record holds the
    kernel's and the plain version's median ms, the bf16 library call's
    (``library_ms``: cuDNN through F.conv3d / F.conv_transpose3d on the
    same tensors viewed as channels-last NCDHW, weights laid out for it
    before timing) and the bound."""
    import torch.nn.functional as F
    from mt3d_resenc_unet_torch.ops.conv3d import conv3d_k3, conv3d_k3_plain
    from mt3d_resenc_unet_torch.ops.upsample import upsample2x, upsample_plain

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    records, failures = [], []
    todo = [(s, ci, co, e, m) for s, ci, co, e in conv_cases
            for m in CONV_MODES]
    todo += [(s, ci, co, e, "stats") for s, ci, co, e in s2_cases]
    n = 2
    lib_ms = {}
    for stride, ci, co, extent, mode in todo:
        x = randn(n, extent, extent, extent, ci).bfloat16()
        w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).bfloat16()
        eo = extent // stride
        kw = dict(emit_stats=mode != "plain")
        if mode == "pre_stats":
            kw["pre"] = torch.stack(
                [torch.rand(n, ci, generator=gen) * 1.5 + 0.5,
                 torch.randn(n, ci, generator=gen)], 1).to(dev)
        if mode == "addin_stats":
            kw["add_to"] = randn(n, eo, eo, eo, co).bfloat16()
        got = conv3d_k3(x, w, stride, **kw)
        want = conv3d_k3_plain(x, w, stride, **kw)
        torch.cuda.synchronize()
        if mode == "plain":
            got, want = (got, None), (want, None)
        err = rel_err(got[0], want[0])
        s_err = stats_err(got[1], want[1]) if got[1] is not None else None
        ms = median_ms(lambda: conv3d_k3(x, w, stride, **kw))
        plain_ms = median_ms(lambda: conv3d_k3_plain(x, w, stride, **kw))
        key = (stride, ci, co, extent)
        if key not in lib_ms:    # one library call per shape: the conv alone
            xl, wl = _ncdhw(x), _lib_conv_w(w)
            lib = F.conv3d(xl, wl, stride=stride, padding=1)
            # the first case of a shape is its plain or stats mode, whose
            # output is the conv alone
            print(f"  library conv3d {ci}->{co} @{extent}^3 s{stride}: err "
                  f"{rel_err(lib.permute(0, 2, 3, 4, 1), want[0]):.3e} "
                  "vs plain")
            lib_ms[key] = median_ms(
                lambda: F.conv3d(xl, wl, stride=stride, padding=1))
            del xl, wl, lib
        nbytes = 2 * (x.numel() + w.numel() + n * eo ** 3 * co * (
            2 if "addin" in mode else 1)) + (8 * n * ci if "pre" in mode
                                             else 0) + (8 * n * co if mode
                                                        != "plain" else 0)
        b_ms, b_by = bound(conv_flops(n, ci, co, extent, stride), nbytes)
        name = f"conv3d_k3_s{stride}"
        records.append(dict(kernel=name, shape=(ci, co, extent), mode=mode,
                            case=f"{ci}->{co} @{extent}^3 {mode}",
                            max_abs_err=err, stats_err=s_err, ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms[key],
                            bound_ms=b_ms, bound_by=b_by,
                            tflops=conv_flops(n, ci, co, extent, stride)
                            / ms / 1e9))
        if not err <= KERNEL_TOL or (s_err is not None
                                     and not s_err <= STATS_TOL):
            failures.append(f"{name} {ci}->{co} @{extent}^3 {mode}: "
                            f"err {err} stats {s_err}")
        del x, w, kw, got, want
    for ci, co, extent in up_cases:
        x = randn(n, extent, extent, extent, ci).bfloat16()
        wf = randn(2, 2, 2, ci, co, scale=(8 * co) ** -0.5).bfloat16()
        got, want = upsample2x(x, wf), upsample_plain(x, wf)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        xl, wu = _ncdhw(x), _lib_up_w(wf)
        lib = F.conv_transpose3d(xl, wu, stride=2)
        print(f"  library conv_transpose3d {ci}->{co} @{extent}^3: err "
              f"{rel_err(lib.permute(0, 2, 3, 4, 1), want):.3e} vs plain")
        flops = 2 * 8 * ci * co * n * extent ** 3
        b_ms, b_by = bound(flops, 2 * (x.numel() + wf.numel() + got.numel()))
        ms = median_ms(lambda: upsample2x(x, wf))
        records.append(dict(kernel="upsample2x", shape=(ci, co, extent),
                            mode="plain", case=f"{ci}->{co} @{extent}^3",
                            max_abs_err=err, stats_err=None, ms=ms,
                            plain_ms=median_ms(lambda: upsample_plain(x, wf)),
                            library_ms=median_ms(
                                lambda: F.conv_transpose3d(xl, wu, stride=2)),
                            bound_ms=b_ms, bound_by=b_by,
                            tflops=flops / ms / 1e9))
        if not err <= KERNEL_TOL:
            failures.append(f"upsample2x {ci}->{co} @{extent}^3: err {err}")
        del x, wf, got, want, xl, wu, lib
    return records, failures


def flagship_models(dev, patch):
    import dataclasses
    from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
    from mt3d_resenc_unet_torch.models.network import ResEncUNet, count_params
    plan = plan_from_autoconfig(
        patch, 1,
        [TaskHead("sheet", 1, "sigmoid"), TaskHead("normals", 3, "none")],
        model_name="flagship", use_pallas_conv=True)
    fast = ResEncUNet(plan, dtype=torch.bfloat16, seed=SEED).to(dev)
    plain = ResEncUNet(dataclasses.replace(plan, use_pallas_conv=False),
                       dtype=torch.float32, seed=SEED).to(dev)
    plain.load_state_dict(fast.state_dict())
    print(f"flagship plan: features {plan.features_per_stage} blocks "
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)

    t0 = time.perf_counter()
    rc = run(dev, CONV_CASES, S2_CASES, UP_CASES, PATCH, VOLUME,
             TRAIN_STEPS, NORM_CASES, TRAIN_DATA)
    print(f"phases 2-7: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return rc


def run(dev, conv_cases, s2_cases, up_cases, patch, volume,
        train_steps, norm_cases, train_data) -> int:
    """Phases 2-7 and the result lines; the case lists and sizes are
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
    torch.cuda.empty_cache()

    # 5b, 5c. the flagship training step
    step_rate, step_shapes, fails = training(dev, fast, plain, patch,
                                             train_steps)
    failures += fails
    step_table(records, step_shapes, train_steps)
    del fast, plain
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
    train_launches, fails = trainer_phase(patch, train_data, step_rate)
    failures += fails
    launches = {**{k: train_launches.get(k, 0) for k in CONV_KERNELS},
                **{k: norm_launches.get(k, 0) for k in NORM_KERNELS}}
    failures += [f"kernels line: {k} has no launches"
                 for k, v in launches.items() if v <= 0]

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


def backward_cases(dev, gen, conv_cases, s2_cases, up_cases):
    """Phase 5a. Returns (per-case records, failures). ``library_ms`` is
    the bf16 cuDNN call of the same function: ``torch.nn.grad.conv3d_input``
    / ``conv3d_weight`` for the conv, ``aten.convolution_backward`` of the
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

    records, failures = [], []
    todo = [(s, ci, co, e, "dx", m) for s, ci, co, e in conv_cases
            for m in DX_MODES]
    todo += [(s, ci, co, e, "dw", m) for s, ci, co, e in conv_cases
             for m in DW_MODES]
    todo += [(s, ci, co, e, op, "corr") for s, ci, co, e in s2_cases
             for op in ("dx", "dw")]
    n = 2
    lib_ms = {}
    for stride, ci, co, extent, op, mode in todo:
        eo = extent // stride
        x = randn(n, extent, extent, extent, ci).bfloat16()
        w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).bfloat16()
        gy = randn(n, eo, eo, eo, co).bfloat16()
        kw = {}
        if "corr" in mode:
            kw.update(y=randn(n, eo, eo, eo, co).bfloat16(),
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
        ms, plain_ms = median_ms(fn), median_ms(ref)
        key = (op, stride, ci, co, extent)
        if key not in lib_ms:    # the first case of a shape is its plain mode
            xl, wl, gl = _ncdhw(x), _lib_conv_w(w), _ncdhw(gy)
            out = lib()
            if op == "dx":
                out = out.permute(0, 2, 3, 4, 1)
            else:
                out = out.permute(2, 3, 4, 1, 0)
            print(f"  library {op} {ci}->{co} @{extent}^3 s{stride}: err "
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
        case = f"{ci}->{co} @{extent}^3 {mode}"
        records.append(dict(kernel=name, shape=(ci, co, extent), mode=mode,
                            case=case, max_abs_err=err, dst_err=dst_err,
                            ms=ms, plain_ms=plain_ms, library_ms=lib_ms[key],
                            bound_ms=b_ms, bound_by=b_by,
                            tflops=flops / ms / 1e9))
        if not err <= KERNEL_TOL or (dst_err is not None
                                     and not dst_err <= DST_TOL):
            failures.append(f"{name} {case}: err {err} dst {dst_err}")
        del x, w, gy, kw, got, want, fn, ref
    for ci, co, extent in up_cases:
        x = randn(n, extent, extent, extent, ci).bfloat16()
        wf = randn(2, 2, 2, ci, co, scale=(8 * co) ** -0.5).bfloat16()
        gy = randn(n, 2 * extent, 2 * extent, 2 * extent, co).bfloat16()
        xl, wu, gl = _ncdhw(x), _lib_up_w(wf), _ncdhw(gy)

        def conv_bwd(mask):
            return torch.ops.aten.convolution_backward(
                gl, xl, wu, None, [2] * 3, [0] * 3, [1] * 3, True, [0] * 3, 1,
                mask)

        flops = 2 * 8 * ci * co * n * extent ** 3
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
            ms, plain_ms = median_ms(fn), median_ms(ref)
            case = f"{ci}->{co} @{extent}^3"
            nbytes = 2 * gy.numel() + out_bytes + (
                2 * wf.numel() if name == "upsample2x_dx" else 2 * x.numel())
            b_ms, b_by = bound(flops, nbytes)
            records.append(dict(kernel=name, shape=(ci, co, extent),
                                mode="plain", case=case, max_abs_err=err,
                                dst_err=None, ms=ms, plain_ms=plain_ms,
                                library_ms=median_ms(lib), bound_ms=b_ms,
                                bound_by=b_by, tflops=flops / ms / 1e9))
            if not err <= KERNEL_TOL:
                failures.append(f"{name} {case}: err {err}")
            del got, want
        del x, wf, gy, xl, wu, gl
    return records, failures


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


def train_path(model, batch, steps, label):
    """Runs ``steps`` training steps from the model's current weights;
    returns (per-step metrics, median step ms, peak bytes, first-step
    gradients flattened per top-level module)."""
    from mt3d_resenc_unet_torch.train.losses import build_task_losses
    from mt3d_resenc_unet_torch.train.step import (build_optimizer,
                                                   cosine_epoch_schedule,
                                                   make_train_step)
    loss_fns = build_task_losses({
        "sheet": {"loss_fn": "BCEDiceLoss",
                  "loss_kwargs": {"alpha": 0.5, "beta": 0.5}},
        "normals": {"loss_fn": "MaskedCosineLoss"}})
    opt = build_optimizer(model.parameters(), "AdamW",
                          cosine_epoch_schedule(1e-3, 500, 250),
                          weight_decay=1e-4, grad_clip_norm=3.0)
    step = make_train_step(model, loss_fns, {"sheet": 1.0, "normals": 1.0})
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
            grads = {name: torch.cat([p.grad.flatten()
                                      for p in mod.parameters()
                                      if p.grad is not None])
                     for name, mod in model.named_children()}
        print(f"  {label} step {i}: " + " ".join(
            f"{k} {v:.6f}" for k, v in metrics[-1].items())
            + f"  {times[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated()
    del opt, step
    model.zero_grad(set_to_none=True)
    model.eval()
    return metrics, statistics.median(times[1:] or times), peak, grads


def training(dev, fast, plain, patch, steps):
    """Phases 5b and 5c. Returns (the kernel path's patches/s,
    failures)."""
    from mt3d_resenc_unet_torch.ops import _build
    from mt3d_resenc_unet_torch.utils.flops import (H100_PEAK_BF16_TFLOPS,
                                                     mfu, train_step_flops)
    n = 2
    failures = []
    batch = flagship_batch(dev, patch, n)
    plain.load_state_dict(fast.state_dict())
    _build.clear_counts()
    got = train_path(fast, batch, steps, "kernels bf16")
    launches = dict(_build.LAUNCHES)
    shapes = dict(_build.LAUNCH_SHAPES)
    torch.cuda.empty_cache()
    want = train_path(plain, batch, steps, "plain fp32")
    print(f"training launches {launches}")
    flops = train_step_flops(fast.plan, patch)
    for (metrics, ms, peak, _), label in ((got, "kernels bf16"),
                                          (want, "plain fp32")):
        tflops, frac = mfu(n / (ms / 1e3), flops)
        print(f"train step {label}: {ms:.1f} ms median, "
              f"{n / (ms / 1e3):.3f} patches/s, {tflops:.2f} model TFLOP/s, "
              f"MFU {frac:.4f} of {H100_PEAK_BF16_TFLOPS} TFLOP/s bf16, "
              f"peak memory {peak / 2 ** 30:.2f} GiB")
        for i, m in enumerate(metrics):
            if not all(np.isfinite(v) for v in m.values()):
                failures.append(f"train {label} step {i}: non-finite {m}")
    m0, p0 = got[0][0], want[0][0]
    loss_diff = abs(m0["total_loss"] - p0["total_loss"]) / abs(
        p0["total_loss"])
    gn_diff = abs(m0["grad_norm"] - p0["grad_norm"]) / p0["grad_norm"]
    print(f"train first step: total loss rel diff {loss_diff:.3e} "
          f"(limit {TRAIN_LOSS_TOL}), grad_norm rel diff {gn_diff:.3e} "
          f"(limit {TRAIN_GNORM_TOL})")
    if not (loss_diff <= TRAIN_LOSS_TOL and gn_diff <= TRAIN_GNORM_TOL):
        failures.append(f"train: loss diff {loss_diff} grad_norm diff "
                        f"{gn_diff}")
    for name, g in got[3].items():
        cos = float(torch.nn.functional.cosine_similarity(
            g, want[3][name], dim=0))
        print(f"train first-step gradient cosine {name}: {cos:.6f} "
              f"(limit {TRAIN_MIN_COS})")
        if not cos >= TRAIN_MIN_COS:
            failures.append(f"train: gradient cosine {name} {cos}")
    for name in CONV_KERNELS:
        if launches.get(name, 0) <= 0:
            failures.append(f"training: kernel {name} was never launched")
    return n / (got[1] / 1e3), shapes, failures


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


def sheet_normals_config(work, volume_paths, patch, max_epoch):
    """``tasks/sheet_normals.yaml``'s settings as a dict (the card has no
    pyyaml), cut to a few steps, on the synthetic dataset, without
    squeeze-excitation (the port raises for it)."""
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
                      "max_epoch": max_epoch, "compute_dtype": "bfloat16"},
        "model_config": {},
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


def trainer_phase(patch, train_data, step_rate):
    """Phase 7. Returns (launch counts of the two trainer runs, failures)."""
    import os
    import shutil
    from pathlib import Path
    from mt3d_resenc_unet_torch.ops import _build
    from mt3d_resenc_unet_torch.tools.synthetic_data import \
        write_sheet_dataset
    from mt3d_resenc_unet_torch.train.checkpoint import CheckpointManager
    from mt3d_resenc_unet_torch.train.trainer import Trainer
    failures = []
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
            work, paths, patch, TRAINER_EPOCHS), verbose=False).train()
        history = first["history"]
        del first
        torch.cuda.empty_cache()
        cfg = sheet_normals_config(work, paths, patch, TRAINER_EPOCHS + 1)
        cfg["tr_setup"]["checkpoint_path"] = str(work / "ckpt" /
                                                 "sheet_normals")
        second = ResumeProbe(config_dict=cfg, verbose=False).train()
        history += second["history"]
        del second
        launches = dict(_build.LAUNCHES)
        print(f"trainer: {time.perf_counter() - t0:.1f} s for "
              f"{TRAINER_EPOCHS} + 1 epochs; launches {launches}")
    finally:
        os.chdir(cwd)
    torch.cuda.empty_cache()

    for h in history:
        losses = {k: v for k, v in h.items() if k.endswith("_loss")}
        print(f"trainer epoch {h['epoch'] + 1}: " + " ".join(
            f"{k} {v:.6f}" for k, v in losses.items())
            + f"  {h['train/patches_per_sec']:.3f} patches/s, t_fetch "
            f"{h['train/t_fetch_s']:.2f} s, t_step {h['train/t_step_s']:.2f} s"
            + (f", checkpoint {h['ckpt/bytes'] / 2 ** 30:.3f} GiB saved in "
               f"{h['ckpt/seconds']:.2f} s" if "ckpt/bytes" in h else ""))
        if not all(np.isfinite(v) for v in losses.values()):
            failures.append(f"trainer epoch {h['epoch'] + 1}: non-finite "
                            f"{losses}")
    if [h["epoch"] for h in history] != list(range(TRAINER_EPOCHS + 1)):
        failures.append(f"trainer: epochs {[h['epoch'] for h in history]}")
    steady = history[1:]
    rate = sum(h["train/patches_per_sec"] for h in steady) / len(steady)
    fetch = sum(h["train/t_fetch_s"] for h in steady)
    step = sum(h["train/t_step_s"] for h in steady)
    print(f"trainer epochs 2-{len(history)}: {rate:.3f} patches/s against "
          f"{step_rate:.3f} for the step alone (phase 5b); t_fetch is "
          f"{fetch / (fetch + step):.1%} of fetch + step")

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
    print(f"trainer resume: start epoch {probe.get('epoch', -1) + 1}, "
          f"optimizer count {probe.get('count')} (want {want_count}), params "
          f"bit-equal {same_params}, momenta bit-equal {same_momenta}")
    if not (probe.get("epoch") == TRAINER_EPOCHS
            and probe.get("count") == want_count and same_params
            and same_momenta):
        failures.append("trainer: the resume did not restore the state")
    for name in CONV_KERNELS:
        if launches.get(name, 0) <= 0:
            failures.append(f"trainer: kernel {name} was never launched")
    shutil.rmtree(work, ignore_errors=True)
    return launches, failures


if __name__ == "__main__":
    sys.exit(main())
