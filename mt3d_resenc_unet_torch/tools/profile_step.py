"""Where the time of the flagship training step goes on one NVIDIA GPU.

    python -m mt3d_resenc_unet_torch.tools.profile_step [--steps 2]

Builds the flagship plan (128^3 patch, 6 stages, sheet + normals heads,
torch-default weights from seed 0) in bf16 through the kernels, runs two
warm-up steps of the training step (batch 2, BCEDice + MaskedCosine, clip 3,
AdamW), then traces ``--steps`` steps with ``torch.profiler`` and prints the
device time per step in groups (the port's kernels by row of PERF.md's
kernel table, stride 1 and 2 apart; cuDNN/GEMM of
the plain classes, elementwise, reductions, the optimizer), the 25 kernels
that take the most device time, and the device's busy share of the wall
time. TF32 is off for cuDNN and matmuls, as ``chip_smoke.py`` times the
step, so the plain-torch classes run in full fp32. Needs a CUDA device;
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import re
import sys
import time

import numpy as np
import torch

# the port's kernels by row of PERF.md's kernel table, then the rest
GROUPS = (
    ("row 1 conv3d_k3_s1", r"conv3d_k3_s1_|conv3d_k3_ndhwc<1"),
    ("row 2 conv3d_k3_dx_s1", r"conv3d_k3_dx_s1|conv3d_k3_dx_ndhwc<1"),
    ("row 3 conv3d_k3_dw_s1", r"conv3d_k3_dw_s1|conv3d_k3_dw_ndhwc<1"),
    ("row 4 conv3d_k3_s2", r"conv3d_k3_ndhwc<2"),
    ("row 5 conv3d_k3_dw_s2", r"conv3d_k3_dw_ndhwc<2"),
    ("row 6 conv3d_k3_dx_s2", r"conv3d_k3_dx_ndhwc<2"),
    ("row 7 upsample2x", r"upsample2x_ndhwc"),
    ("row 8 upsample2x_dx", r"upsample2x_dx_ndhwc"),
    ("row 9 upsample2x_dw", r"upsample2x_dw_ndhwc"),
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
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    from ..core.plan import TaskHead, plan_from_autoconfig
    from ..models.network import ResEncUNet
    from ..ops import _build
    from ..train.losses import build_task_losses
    from ..train.step import (build_optimizer, cosine_epoch_schedule,
                              make_train_step)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build_all()
    patch, n = (128, 128, 128), 2
    plan = plan_from_autoconfig(
        patch, 1, [TaskHead("sheet", 1, "sigmoid"),
                   TaskHead("normals", 3, "none")],
        model_name="flagship", use_pallas_conv=True)
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
        print(f"  {label:40s} {ms:8.2f} ms {ms / total_ms:6.1%} "
              f"{calls[label]:6d} launches")
    print("top kernels by device time per step:")
    for e in sorted(kernels, key=_device_us, reverse=True)[:25]:
        print(f"  {_device_us(e) / 1e3 / args.steps:8.2f} ms "
              f"{e.count // args.steps:5d}x  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
