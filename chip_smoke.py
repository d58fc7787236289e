#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100): builds the
port's CUDA kernels, holds each against its plain PyTorch version at the
flagship's shapes, runs the full-width flagship forward against the plain
fp32 path, serves a volume through ``predict_volume``, and runs the
full-width flagship training step through the kernels against the plain
fp32 path.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. build the kernels from ``mt3d_resenc_unet_torch/ops/csrc`` (one nvcc
     per source, all at once) and print the card's name and power limit;
  2. kernel vs plain on the card at the flagship's shapes (N=2): the conv
     at stride 1 (C=32 @128^3, 64 @64^3, 256 @16^3, 512 @8^3, each in the
     plain / stats / pre+stats / add-in+stats modes), at stride 2 (32->64,
     64->128, with stats) and the upsample (128->64, 64->32). Plain versions
     run in fp32 with TF32 off. Printed per case: the max abs error relative
     to the plain output's max abs, the stats' relative error, and the
     median ms of kernel and plain;
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
     error where emitted, median ms of kernel and plain and the kernel's
     TFLOP/s. (b) TRAIN_STEPS steps of the flagship training step (batch 2
     of 128^3, BCEDice + MaskedCosine, clip 3, AdamW on the cosine epoch
     schedule) through the kernels in bf16 and on the plain fp32 path from
     the same weights and a batch made from the seed with numpy (bench.py):
     per-step losses, the relative difference of the first step's
     grad_norm, the cosine of the two first-step gradients per top-level
     module, step ms, patches/s, model TFLOP/s, MFU against the card's bf16
     dense peak, and peak memory. (c) Every launch counter is zeroed before
     (b) and all nine kernels must have launched in it.
Then one JSON line of the kernels and, last, the device line.

Imports torch and the port only: nothing of JAX or of the JAX package.
"""

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
# (stride, ci, co, extent) of the conv cases and (ci, co, extent) of the
# upsample cases: the flagship's kernel shapes at N=2
CONV_CASES = [(1, 32, 32, 128), (1, 64, 64, 64), (1, 256, 256, 16),
              (1, 512, 512, 8)]
CONV_MODES = ("plain", "stats", "pre_stats", "addin_stats")
S2_CASES = [(2, 32, 64, 128), (2, 64, 128, 64)]
UP_CASES = [(128, 64, 32), (64, 32, 64)]
DX_MODES = ("plain", "corr", "corr_post")
DW_MODES = ("plain", "pre", "corr", "pre_corr")
PATCH = (128, 128, 128)
VOLUME = (160, 256, 256)

_PC = "mt3d_resenc_unet_tpu/ops/pallas_conv.py"
_PU = "mt3d_resenc_unet_tpu/ops/pallas_upsample.py"
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
}
FORWARD = ("conv3d_k3_s1", "conv3d_k3_s2", "upsample2x")
_CS = "mt3d_resenc_unet_torch/ops/csrc"
SOURCES = {
    "conv3d_k3_s1": f"{_CS}/conv3d_k3.cu",
    "conv3d_k3_s2": f"{_CS}/conv3d_k3.cu",
    "upsample2x": f"{_CS}/upsample2x.cu",
    "conv3d_k3_dx_s1": f"{_CS}/conv3d_k3_dx.cu",
    "conv3d_k3_dx_s2": f"{_CS}/conv3d_k3_dx.cu",
    "conv3d_k3_dw_s1": f"{_CS}/conv3d_k3_dw.cu",
    "conv3d_k3_dw_s2": f"{_CS}/conv3d_k3_dw.cu",
    "upsample2x_dx": f"{_CS}/upsample2x_bwd.cu",
    "upsample2x_dw": f"{_CS}/upsample2x_bwd.cu",
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


def kernel_cases(dev, gen, conv_cases, s2_cases, up_cases):
    """Phase 2. Returns (per-case records, failures)."""
    from mt3d_resenc_unet_torch.ops.conv3d import conv3d_k3, conv3d_k3_plain
    from mt3d_resenc_unet_torch.ops.upsample import upsample2x, upsample_plain

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    records, failures = [], []
    todo = [(s, ci, co, e, m) for s, ci, co, e in conv_cases
            for m in CONV_MODES]
    todo += [(s, ci, co, e, "stats") for s, ci, co, e in s2_cases]
    n = 2
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
        name = f"conv3d_k3_s{stride}"
        records.append(dict(kernel=name, case=f"{ci}->{co} @{extent}^3 "
                            f"{mode}", max_abs_err=err, stats_err=s_err,
                            ms=ms, plain_ms=plain_ms))
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
        records.append(dict(kernel="upsample2x", case=f"{ci}->{co} "
                            f"@{extent}^3", max_abs_err=err, stats_err=None,
                            ms=median_ms(lambda: upsample2x(x, wf)),
                            plain_ms=median_ms(lambda: upsample_plain(x, wf))))
        if not err <= KERNEL_TOL:
            failures.append(f"upsample2x {ci}->{co} @{extent}^3: err {err}")
        del x, wf, got, want
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
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)}")
    for name, log in logs.items():
        usage = sorted({line.split(":", 1)[-1].strip()
                        for line in log.splitlines()
                        if "registers" in line or "spill" in line})
        print(f"  {name}: " + "; ".join(usage))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)

    return run(dev, CONV_CASES, S2_CASES, UP_CASES, PATCH, VOLUME,
               TRAIN_STEPS)


def run(dev, conv_cases, s2_cases, up_cases, patch, volume,
        train_steps) -> int:
    """Phases 2-5 and the result lines; the case lists and sizes are
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
              f"  {r['ms']:.3f} ms  plain {r['plain_ms']:.3f} ms")
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
    _build.LAUNCHES.clear()
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
              f"{r['tflops']:.1f} TFLOP/s")
    torch.cuda.empty_cache()

    # 5b, 5c. the flagship training step
    launches, fails = training(dev, fast, plain, patch, train_steps)
    failures += fails

    if failures:
        print("FAILED:\n  " + "\n  ".join(failures))
        return 1
    kernels = []
    for name in REPLACES:
        mine = [r for r in records if r["kernel"] == name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=sum(r["ms"] for r in mine),
            plain_ms=sum(r["plain_ms"] for r in mine)))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def backward_cases(dev, gen, conv_cases, s2_cases, up_cases):
    """Phase 5a. Returns (per-case records, failures)."""
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
        else:
            fn = lambda: conv3d_k3_dw(x, gy, stride, **kw)
            ref = lambda: conv3d_k3_dw_plain(x, gy, stride, **kw)
        got, want = fn(), ref()
        torch.cuda.synchronize()
        dst_err = None
        if isinstance(got, tuple):
            dst_err = rel_err(got[1], want[1])
            got, want = got[0], want[0]
        err = rel_err(got, want)
        ms, plain_ms = median_ms(fn), median_ms(ref)
        flops = 2 * n * eo ** 3 * 27 * ci * co
        name = f"conv3d_k3_{op}_s{stride}"
        case = f"{ci}->{co} @{extent}^3 {mode}"
        records.append(dict(kernel=name, case=case, max_abs_err=err,
                            dst_err=dst_err, ms=ms, plain_ms=plain_ms,
                            tflops=flops / ms / 1e9))
        if not err <= KERNEL_TOL or (dst_err is not None
                                     and not dst_err <= DST_TOL):
            failures.append(f"{name} {case}: err {err} dst {dst_err}")
        del x, w, gy, kw, got, want, fn, ref
    for ci, co, extent in up_cases:
        x = randn(n, extent, extent, extent, ci).bfloat16()
        wf = randn(2, 2, 2, ci, co, scale=(8 * co) ** -0.5).bfloat16()
        gy = randn(n, 2 * extent, 2 * extent, 2 * extent, co).bfloat16()
        for name, fn, ref in (
                ("upsample2x_dx", lambda: upsample2x_dx(gy, wf),
                 lambda: upsample2x_dx_plain(gy, wf)),
                ("upsample2x_dw", lambda: upsample2x_dw(x, gy),
                 lambda: upsample2x_dw_plain(x, gy))):
            got, want = fn(), ref()
            torch.cuda.synchronize()
            err = rel_err(got, want)
            ms, plain_ms = median_ms(fn), median_ms(ref)
            case = f"{ci}->{co} @{extent}^3"
            records.append(dict(kernel=name, case=case, max_abs_err=err,
                                dst_err=None, ms=ms, plain_ms=plain_ms,
                                tflops=2 * n * extent ** 3 * 8 * ci * co
                                / ms / 1e9))
            if not err <= KERNEL_TOL:
                failures.append(f"{name} {case}: err {err}")
            del got, want
        del x, wf, gy
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
    """Phases 5b and 5c. Returns (launch counts of the kernel path's
    steps, failures)."""
    from mt3d_resenc_unet_torch.ops import _build
    from mt3d_resenc_unet_torch.utils.flops import (H100_PEAK_BF16_TFLOPS,
                                                     mfu, train_step_flops)
    n = 2
    failures = []
    batch = flagship_batch(dev, patch, n)
    plain.load_state_dict(fast.state_dict())
    _build.LAUNCHES.clear()
    got = train_path(fast, batch, steps, "kernels bf16")
    launches = dict(_build.LAUNCHES)
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
    for name in REPLACES:
        if launches.get(name, 0) <= 0:
            failures.append(f"training: kernel {name} was never launched")
    return launches, failures


if __name__ == "__main__":
    sys.exit(main())
