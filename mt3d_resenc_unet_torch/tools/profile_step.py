"""Where the time of the flagship training step goes on one NVIDIA GPU.

    python -m mt3d_resenc_unet_torch.tools.profile_step [--steps 2]
        [--squeeze-excitation]

Builds the flagship plan (128^3 patch, 6 stages, sheet + normals heads,
torch-default weights from seed 0; with ``--squeeze-excitation`` the
network of ``tasks/sheet_normals.yaml``) in bf16 through the kernels, runs two
warm-up steps of the training step (batch 2, BCEDice + MaskedCosine, clip 3,
AdamW), then TIMED steps without the profiler (the median step's wall
ms, patches/s and MFU, as ``chip_smoke.py`` phase 5b measures them, and the
peak device memory), then traces ``--steps`` steps with ``torch.profiler``
and prints the device time and launches per step in groups (the port's
kernels by row of PERF.md's kernel table, stride 1 and 2 apart, the
norm-act kernels' step modes apart from the op: the norm tail forward and
backward and the raw statistics; cuDNN/GEMM of the plain classes,
elementwise, reductions, the optimizer), the 25 kernels that take the
most device time, and the device's busy share of the wall time. The
script reads only the package's public entry points, so a copy of it
profiles an older checkout of the package the same way. The precision is
``core.config.set_precision``'s, as the trainer and ``chip_smoke.py`` set
it; the plain-torch classes run in bf16 with fp32
accumulation (ops/lowp.py), so the cuDNN / GEMM group should show no fp32
convolution or GEMM. Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TIMED = 6   # steps timed without the profiler, after the warm-up

# the port's kernels by row of PERF.md's kernel table, then the rest
GROUPS = (
    ("row 1 conv3d_k3_s1", r"conv3d_k3_s1_"),
    ("row 2 conv3d_k3_dx_s1", r"conv3d_k3_dx_s1_"),
    ("row 3 conv3d_k3_dw_s1", r"conv3d_k3_dw_s1_"),
    ("row 4 conv3d_k3_s2", r"conv3d_k3_s2_"),
    ("row 5 conv3d_k3_dw_s2", r"conv3d_k3_dw_s2_"),
    ("row 6 conv3d_k3_dx_s2", r"conv3d_k3_dx_s2_"),
    ("row 7 upsample2x", r"upsample2x_ndhwc"),
    ("row 8 upsample2x_dx", r"upsample2x_dx_ndhwc"),
    ("row 9 upsample2x_dw", r"upsample2x_dw_ndhwc"),
    # the norm-act kernels' step modes apart from the op
    ("row 11 mode c, tail backward: norm_act_tail_bwd", r"norm_act_tail_bwd"),
    ("row 10 mode b, tail forward: norm_act_tail", r"norm_act_tail<"),
    ("row 10 mode a, raw statistics: norm_act_raw_stats",
     r"norm_act_raw_stats"),
    ("rows 10-11 norm_act", r"norm_act_"),
    ("optimizer (AdamW, clip)", r"multi_tensor|foreach|fused_adam"),
    ("cuDNN / GEMM (plain classes, 1x1, seg)",
     r"conv|gemm|cudnn|cutlass|xmma|sm90|sm80|wgrad|dgrad|implicit"),
    ("reductions", r"reduce|norm_kernel"),
    ("elementwise, casts, copies", r"elementwise|copy|fill|cat|index|where"),
)


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, name, None)
        if value is not None:
            return float(value)
    return 0.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--squeeze-excitation", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    from ..core.config import set_precision
    from ..core.plan import TaskHead, plan_from_autoconfig
    from ..models.network import ResEncUNet
    from ..ops import _build
    from ..train.losses import build_task_losses
    from ..train.step import (build_optimizer, cosine_epoch_schedule,
                              make_train_step)
    from ..utils.flops import mfu, train_step_flops

    set_precision()
    dev = torch.device("cuda", 0)
    _build.build_all()
    patch, n = (128, 128, 128), 2
    plan = plan_from_autoconfig(
        patch, 1, [TaskHead("sheet", 1, "sigmoid"),
                   TaskHead("normals", 3, "none")],
        model_name="flagship", use_pallas_conv=True,
        squeeze_excitation=args.squeeze_excitation)
    model = ResEncUNet(plan, dtype=torch.bfloat16, seed=0).to(dev)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in {
        "image": rng.random((n,) + patch + (1,), np.float32),
        "sheet": (rng.random((n,) + patch + (1,)) > 0.5).astype(np.float32),
        "normals": rng.standard_normal((n,) + patch + (3,)).astype(
            np.float32)}.items()}
    opt = build_optimizer(model.parameters(), "AdamW",
                          cosine_epoch_schedule(1e-3, 500, 250),
                          weight_decay=1e-4, grad_clip_norm=3.0)
    step = make_train_step(model, build_task_losses({
        "sheet": {"loss_fn": "BCEDiceLoss"},
        "normals": {"loss_fn": "MaskedCosineLoss"}}),
        {"sheet": 1.0, "normals": 1.0})
    for _ in range(2):
        step(opt, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        step(opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    ms = statistics.median(times)
    tflops, frac = mfu(n / (ms / 1e3), train_step_flops(plan, patch))
    print(f"{TIMED} steps without the profiler: median {ms:.1f} ms wall ("
          + ", ".join(f"{t:.1f}" for t in times) + f"), "
          f"{n / (ms / 1e3):.3f} patches/s, {tflops:.2f} model TFLOP/s, "
          f"MFU {frac:.4f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    # device events, without the GPU-side spans of annotations
    # ("Optimizer.step#AdamW.step"), which cover kernels counted already
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Optimizer.", "ProfilerStep"))]
    total_ms = sum(_device_us(e) for e in kernels) / 1e3 / args.steps
    groups = collections.Counter()
    calls = collections.Counter()
    for e in kernels:
        label = next((g for g, pat in GROUPS
                      if re.search(pat, e.key, re.IGNORECASE)), "other")
        groups[label] += _device_us(e) / 1e3 / args.steps
        calls[label] += e.count // args.steps
    print(f"{torch.cuda.get_device_name(0)}: step {wall_ms:.1f} ms wall, "
          f"{total_ms:.1f} ms device time, busy {total_ms / wall_ms:.1%}")
    for label, ms in groups.most_common():
        print(f"  {label:50s} {ms:8.2f} ms {ms / total_ms:6.1%} "
              f"{calls[label]:6d} launches")
    print("top kernels by device time per step:")
    for e in sorted(kernels, key=_device_us, reverse=True)[:25]:
        print(f"  {_device_us(e) / 1e3 / args.steps:8.2f} ms "
              f"{e.count // args.steps:5d}x  {e.key[:110]}")
    # every library kernel, by name, so their operand types can be read
    lib = GROUPS[-3]
    print(f"every kernel of '{lib[0]}':")
    for e in sorted(kernels, key=_device_us, reverse=True):
        if next((g for g, pat in GROUPS if re.search(pat, e.key, re.I)),
                None) == lib[0]:
            print(f"  {_device_us(e) / 1e3 / args.steps:8.2f} ms "
                  f"{e.count // args.steps:5d}x  {e.key[:160]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
