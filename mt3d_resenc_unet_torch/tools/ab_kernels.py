"""Times the stride-2 forward and dW kernels (rows 4 and 5 of PERF.md's
kernel table) of several checkouts of the port on one NVIDIA GPU, in turns,
so that a before / after comparison is made inside one call on one card.

    python -m mt3d_resenc_unet_torch.tools.ab_kernels ROOT [ROOT ...]

Each ROOT is the root of a checkout (``.`` for this one; another commit
unpacked with ``git archive`` into a git-ignored directory). Each runs in a
process of its own, in the order given (parent, change, change, parent),
importing the package from ROOT and building its kernels there. Printed
per ROOT: the card's name and power limit, then per case (the flagship's
stride-2 shapes at N=2, in the modes of the training step: the forward
with statistics, dW with the correction; and the forward with the pre-op)
the median ms of 20 launches after 3 warm-up launches. Needs a CUDA
device; exits non-zero without one or when a ROOT's run fails.
"""

from __future__ import annotations

import subprocess
import sys

# (what, ci, co, input extent, mode)
CASES = [("fwd", 32, 64, 128, "stats"), ("fwd", 64, 128, 64, "stats"),
         ("fwd", 32, 64, 128, "pre_stats"),
         ("dw", 32, 64, 128, "corr"), ("dw", 64, 128, 64, "corr")]

_CHILD = r"""
import statistics, subprocess, sys
import torch
from mt3d_resenc_unet_torch.ops import _build
from mt3d_resenc_unet_torch.ops.conv3d import conv3d_k3, conv3d_k3_dw
_build.build_all()
dev = torch.device("cuda", 0)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip().splitlines()[0])
gen = torch.Generator().manual_seed(0)
n = 2
for what, ci, co, e, mode in CASES:
    eo = e // 2
    x = torch.randn(n, e, e, e, ci, generator=gen).to(dev).bfloat16()
    w = (torch.randn(3, 3, 3, ci, co, generator=gen)
         * (27 * ci) ** -0.5).to(dev).bfloat16()
    gy = torch.randn(n, eo, eo, eo, co, generator=gen).to(dev).bfloat16()
    y = torch.randn(n, eo, eo, eo, co, generator=gen).to(dev).bfloat16()
    gs = (torch.randn(n, 2, co, generator=gen) * 0.1).to(dev)
    pre = torch.stack([torch.rand(n, ci, generator=gen) + 0.5,
                       torch.randn(n, ci, generator=gen)], 1).to(dev)
    if what == "fwd":
        kw = {"pre": pre} if "pre" in mode else {}
        fn = lambda: conv3d_k3(x, w, 2, emit_stats=True, **kw)
    else:
        fn = lambda: conv3d_k3_dw(x, gy, 2, y=y, gs=gs)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    print(f"{what} {ci}->{co} @{e}^3 {mode}: {statistics.median(times):.4f} ms")
"""


def main(argv=None) -> int:
    roots = sys.argv[1:] if argv is None else argv
    if not roots:
        print(__doc__)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    code = f"CASES = {CASES!r}\n{_CHILD}"
    rc = 0
    for root in roots:
        print(f"== {root}", flush=True)
        done = subprocess.run([sys.executable, "-c", code], cwd=root)
        rc = rc or done.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
