"""Times the conv and upsample kernels of several checkouts of the port on
one NVIDIA GPU, in turns, so that a before / after comparison is made
inside one call on one card.

    python -m mt3d_resenc_unet_torch.tools.ab_kernels [--only WHAT,...] ROOT [ROOT ...]

Each ROOT is the root of a checkout (``.`` for this one; another commit
unpacked with ``git archive`` into a git-ignored directory). Each runs in a
process of its own, in the order given (parent, change, change, parent),
importing the package from ROOT and building its kernels there. Printed
per ROOT: the card's name and power limit, then per case the median over 5
runs of the ms per launch of a run of 20 launches back to back (so a short
kernel is not charged the host's time to enqueue it), after 3 warm-up
launches. The cases (N=2, the flagship's
shapes in the training step's modes): rows 1-3 of PERF.md's kernel table
(the stride-1 forward with stats, pre-op + stats and add-in + stats at
128^3 x 32 and 64^3 x 64, and at the split shapes 16^3 x 256 and 8^3 x
512; dx with the correction and with the pre-op backward at every
flagship shape, the split ones included; dW with the correction and with
the pre-op), rows 4-6 (the stride-2 forward with stats and with the
pre-op, dW and dx with the correction) and rows 7-9 (the upsample's
forward, dx and dW at 128->64 from 32^3 and 64->32 from 64^3). ``--only``
keeps the cases whose first field is one of WHAT (fwd, dx, dw, up, up_dx,
up_dw). Needs a
CUDA device; exits non-zero without one or when a ROOT's run fails.
"""

from __future__ import annotations

import subprocess
import sys

# (what, stride, ci, co, input extent, mode); for the upsample (what, 2,
# ci, co, coarse extent, "plain")
CASES = [("fwd", 1, 32, 32, 128, "stats"), ("fwd", 1, 32, 32, 128, "pre_stats"),
         ("fwd", 1, 64, 64, 64, "addin_stats"),
         ("fwd", 1, 256, 256, 16, "pre_stats"),
         ("fwd", 1, 512, 512, 8, "addin_stats"),
         ("dx", 1, 32, 32, 128, "corr"), ("dx", 1, 32, 32, 128, "corr_post"),
         ("dx", 1, 64, 64, 64, "corr"), ("dx", 1, 64, 64, 64, "corr_post"),
         ("dx", 1, 256, 256, 16, "corr"),
         ("dx", 1, 256, 256, 16, "corr_post"),
         ("dx", 1, 512, 512, 8, "corr"), ("dx", 1, 512, 512, 8, "corr_post"),
         ("dx", 1, 512, 512, 4, "corr"), ("dx", 1, 512, 512, 4, "corr_post"),
         ("dw", 1, 32, 32, 128, "corr"), ("dw", 1, 32, 32, 128, "pre_corr"),
         ("dw", 1, 64, 64, 64, "pre_corr"), ("dw", 1, 512, 512, 8, "corr"),
         ("fwd", 2, 32, 64, 128, "stats"), ("fwd", 2, 64, 128, 64, "stats"),
         ("fwd", 2, 32, 64, 128, "pre_stats"),
         ("dw", 2, 32, 64, 128, "corr"), ("dw", 2, 64, 128, 64, "corr"),
         ("dx", 2, 32, 64, 128, "corr"), ("dx", 2, 64, 128, 64, "corr"),
         ("up", 2, 128, 64, 32, "plain"), ("up", 2, 64, 32, 64, "plain"),
         ("up_dx", 2, 128, 64, 32, "plain"), ("up_dx", 2, 64, 32, 64, "plain"),
         ("up_dw", 2, 128, 64, 32, "plain"), ("up_dw", 2, 64, 32, 64, "plain")]

_CHILD = r"""
import statistics, subprocess, sys
import torch
from mt3d_resenc_unet_torch.ops import _build
from mt3d_resenc_unet_torch.ops.conv3d import conv3d_k3, conv3d_k3_dw, conv3d_k3_dx
from mt3d_resenc_unet_torch.ops.upsample import (upsample2x, upsample2x_dw,
                                                 upsample2x_dx)
_build.build_all()
dev = torch.device("cuda", 0)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip().splitlines()[0])
n = 2
for what, s, ci, co, e, mode in CASES:
    gen = torch.Generator().manual_seed(0)
    if what.startswith("up"):
        x = torch.randn(n, e, e, e, ci, generator=gen).to(dev).bfloat16()
        wf = (torch.randn(2, 2, 2, ci, co, generator=gen)
              * (8 * co) ** -0.5).to(dev).bfloat16()
        gy = torch.randn(n, 2 * e, 2 * e, 2 * e, co,
                         generator=gen).to(dev).bfloat16()
        fn = {"up": lambda: upsample2x(x, wf),
              "up_dx": lambda: upsample2x_dx(gy, wf),
              "up_dw": lambda: upsample2x_dw(x, gy)}[what]
    else:
        eo = e // s
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
            if "addin" in mode:
                kw["add_to"] = y
            fn = lambda: conv3d_k3(x, w, s, emit_stats=True, **kw)
        elif what == "dx":
            kw = {"x": x, "pre": pre} if "post" in mode else {}
            fn = lambda: conv3d_k3_dx(gy, w, s, y, gs, size=x.shape[1:4], **kw)
        else:
            kw = {"pre": pre} if "pre" in mode else {}
            fn = lambda: conv3d_k3_dw(x, gy, s, y=y, gs=gs, **kw)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 20)
    print(f"{what} s{s} {ci}->{co} @{e}^3 {mode}: "
          f"{statistics.median(times):.4f} ms", flush=True)
    del x, gy, fn
    torch.cuda.empty_cache()
"""


def main(argv=None) -> int:
    roots = list(sys.argv[1:] if argv is None else argv)
    cases = CASES
    if roots and roots[0] == "--only":
        only = set(roots[1].split(",")) if len(roots) > 1 else set()
        cases = [c for c in CASES if c[0] in only]
        roots = roots[2:]
    if not roots or not cases:
        print(__doc__)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    code = f"CASES = {cases!r}\n{_CHILD}"
    rc = 0
    for root in roots:
        print(f"== {root}", flush=True)
        done = subprocess.run([sys.executable, "-c", code], cwd=root)
        rc = rc or done.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
