"""Times the conv and upsample kernels of several checkouts of the port on
one NVIDIA GPU, in turns, so that a before / after comparison is made
inside one call on one card.

    python -m mt3d_resenc_unet_torch.tools.ab_kernels [--dtype D] [--only WHAT,...] ROOT [ROOT ...]
    python -m mt3d_resenc_unet_torch.tools.ab_kernels --digest ROOT [ROOT ...]

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
128^3 x 32 and 64^3 x 64, and at the split shapes 16^3 x 256, 8^3 x 512
and 4^3 x 512; dx with the correction and with the pre-op backward at every
flagship shape, the split ones included; dW in every mode at 128^3 x 32
and 64^3 x 64, with the correction and with it and the pre-op at the
others), rows 4-6 (the stride-2 forward with stats and with the
pre-op, dW and dx with the correction) and rows 7-9 (the upsample's
forward, dx and dW at 128->64 from 32^3 and 64->32 from 64^3). ``--only``
keeps the cases whose first field is one of WHAT (fwd, dx, dw, up, up_dx,
up_dw). ``--dtype`` (bfloat16, float16 or float32; default bfloat16) is
the dtype of every case's tensors, and so of the kernels timed. Inputs
are drawn on the card from seed 0, the same in every ROOT.

``--digest`` runs, instead of timing, each case of ``chip_smoke.py``'s
phases 2, 2h, 2f and 5a once (DIGEST_CASES at each of DIGEST_DTYPES: every
mode of every flagship shape, the fp16 cotangents at 2e-7 of 5a's
``corr_small`` too) and prints the sha256 of each output's bytes; then,
per case, whether every ROOT gave the same bytes, a count per dtype and
kernel row, and exits non-zero where they differ.
Needs a CUDA device; exits non-zero without one or when a ROOT's run
fails.
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
         ("fwd", 1, 512, 512, 4, "stats"),
         ("dx", 1, 32, 32, 128, "corr"), ("dx", 1, 32, 32, 128, "corr_post"),
         ("dx", 1, 64, 64, 64, "corr"), ("dx", 1, 64, 64, 64, "corr_post"),
         ("dx", 1, 256, 256, 16, "corr"),
         ("dx", 1, 256, 256, 16, "corr_post"),
         ("dx", 1, 512, 512, 8, "corr"), ("dx", 1, 512, 512, 8, "corr_post"),
         ("dx", 1, 512, 512, 4, "corr"), ("dx", 1, 512, 512, 4, "corr_post"),
         ("dw", 1, 32, 32, 128, "plain"), ("dw", 1, 32, 32, 128, "pre"),
         ("dw", 1, 32, 32, 128, "corr"), ("dw", 1, 32, 32, 128, "pre_corr"),
         ("dw", 1, 64, 64, 64, "plain"), ("dw", 1, 64, 64, 64, "pre"),
         ("dw", 1, 64, 64, 64, "corr"), ("dw", 1, 64, 64, 64, "pre_corr"),
         ("dw", 1, 256, 256, 16, "corr"), ("dw", 1, 256, 256, 16, "pre_corr"),
         ("dw", 1, 512, 512, 8, "corr"), ("dw", 1, 512, 512, 8, "pre_corr"),
         ("dw", 1, 512, 512, 4, "corr"), ("dw", 1, 512, 512, 4, "pre_corr"),
         ("fwd", 2, 32, 64, 128, "stats"), ("fwd", 2, 64, 128, 64, "stats"),
         ("fwd", 2, 32, 64, 128, "pre_stats"),
         ("dw", 2, 32, 64, 128, "corr"), ("dw", 2, 64, 128, 64, "corr"),
         ("dx", 2, 32, 64, 128, "corr"), ("dx", 2, 64, 128, 64, "corr"),
         ("up", 2, 128, 64, 32, "plain"), ("up", 2, 64, 32, 64, "plain"),
         ("up_dx", 2, 128, 64, 32, "plain"), ("up_dx", 2, 64, 32, 64, "plain"),
         ("up_dw", 2, 128, 64, 32, "plain"), ("up_dw", 2, 64, 32, 64, "plain")]

# chip_smoke.py's phase 2 and 5a cases (its CONV_CASES, S2_CASES and
# UP_CASES in CONV_MODES, DX_MODES, DW_MODES, S2_DX_MODES)
_S1 = [(32, 32, 128), (64, 64, 64), (256, 256, 16), (512, 512, 8),
       (512, 512, 4)]
_S2 = [(32, 64, 128), (64, 128, 64)]
DIGEST_CASES = (
    [("fwd", 1, ci, co, e, m) for ci, co, e in _S1
     for m in ("plain", "stats", "pre_stats", "addin_stats")]
    + [("fwd", 2, ci, co, e, "stats") for ci, co, e in _S2]
    + [("up", 2, 128, 64, 32, "plain"), ("up", 2, 64, 32, 64, "plain")]
    + [("dx", 1, ci, co, e, m) for ci, co, e in _S1
       for m in ("plain", "corr", "corr_post")]
    + [("dw", 1, ci, co, e, m) for ci, co, e in _S1
       for m in ("plain", "pre", "corr", "pre_corr")]
    + [("dx", 2, ci, co, e, m) for ci, co, e in _S2
       for m in ("corr", "corr_post")]
    + [("dw", 2, ci, co, e, "corr") for ci, co, e in _S2]
    + [(w, 2, ci, co, e, "plain") for w in ("up_dx", "up_dw")
       for ci, co, e in ((128, 64, 32), (64, 32, 64))])
# the dtypes of the digest's cases: the bf16 kernels (phases 2 and 5a),
# their fp16 instantiations (2h, 5a) with 5a's fp16 corr_small cases (the
# first shape's dx and dW from cotangents at 2e-7), the fp32 kernels (2f,
# 5a)
DIGEST_DTYPES = ("bfloat16", "float16", "float32")
F16_SMALL = 2e-7

_CHILD = r"""
import hashlib, statistics, subprocess, sys
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
F16_SMALL = %r

def randn(*shape):
    return torch.randn(*shape, generator=gen, device=dev)


for what, s, ci, co, e, mode, dt in CASES:
    gen = torch.Generator(device=dev).manual_seed(0)
    dt = getattr(torch, dt)
    small = F16_SMALL if mode == "corr_small" else 1.0
    if what.startswith("up"):
        x = randn(n, e, e, e, ci).to(dt)
        wf = (randn(2, 2, 2, ci, co) * (8 * co) ** -0.5).to(dt)
        gy = randn(n, 2 * e, 2 * e, 2 * e, co).to(dt)
        fn = {"up": lambda: upsample2x(x, wf),
              "up_dx": lambda: upsample2x_dx(gy, wf),
              "up_dw": lambda: upsample2x_dw(x, gy)}[what]
    else:
        eo = e // s
        x = randn(n, e, e, e, ci).to(dt)
        w = (randn(3, 3, 3, ci, co) * (27 * ci) ** -0.5).to(dt)
        gy = (randn(n, eo, eo, eo, co) * small).to(dt)
        y = randn(n, eo, eo, eo, co).to(dt)
        gs = randn(n, 2, co) * (0.1 * small)
        pre = torch.stack([torch.rand(n, ci, generator=gen, device=dev)
                           + 0.5, randn(n, ci)], 1)
        kw = {"pre": pre} if "pre" in mode else {}
        if what == "fwd":
            if "addin" in mode:
                kw["add_to"] = y
            fn = lambda: conv3d_k3(x, w, s, emit_stats=mode != "plain", **kw)
        else:
            if "corr" in mode:
                kw.update(y=y, gs=gs)
            if what == "dx":
                if "post" in mode:
                    kw.update(x=x, pre=pre)
                fn = lambda: conv3d_k3_dx(gy, w, s, size=x.shape[1:4], **kw)
            else:
                fn = lambda: conv3d_k3_dw(x, gy, s, **kw)
    if DIGEST:
        out = fn()
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        digest = [hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                                 .numpy().tobytes()).hexdigest()[:16]
                  for t in outs]
        print(f"DIGEST {dt} {what} s{s} {ci}->{co} @{e}^3 {mode}: "
              + " ".join(digest), flush=True)
        del x, gy, fn, out, outs
        torch.cuda.empty_cache()
        continue
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
    print(f"{dt} {what} s{s} {ci}->{co} @{e}^3 {mode}: "
          f"{statistics.median(times):.4f} ms", flush=True)
    del x, gy, fn
    torch.cuda.empty_cache()
"""


def main(argv=None) -> int:
    roots = list(sys.argv[1:] if argv is None else argv)
    dtype = "bfloat16"
    if roots[:1] == ["--dtype"] and len(roots) > 1:
        dtype, roots = roots[1], roots[2:]
    cases = [c + (dtype,) for c in CASES]
    digest = bool(roots) and roots[0] == "--digest"
    if digest:
        roots = roots[1:]
        cases = [c + (d,) for d in DIGEST_DTYPES for c in DIGEST_CASES]
        cases += [("dx", 1, 32, 32, 128, "corr_small", "float16"),
                  ("dw", 1, 32, 32, 128, "corr_small", "float16")]
    elif roots and roots[0] == "--only":
        only = set(roots[1].split(",")) if len(roots) > 1 else set()
        cases = [c for c in cases if c[0] in only]
        roots = roots[2:]
    if not roots or not cases or dtype not in DIGEST_DTYPES:
        print(__doc__)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    code = (f"CASES = {cases!r}\nDIGEST = {digest}\n"
            + _CHILD.replace("F16_SMALL = %r", f"F16_SMALL = {F16_SMALL!r}"))
    rc = 0
    digests = {}
    for root in roots:
        print(f"== {root}", flush=True)
        done = subprocess.run([sys.executable, "-c", code], cwd=root,
                              stdout=subprocess.PIPE, text=True)
        print(done.stdout, end="", flush=True)
        rc = rc or done.returncode
        for line in done.stdout.splitlines():
            if line.startswith("DIGEST "):
                case, _, hashes = line[7:].partition(": ")
                digests.setdefault(case, []).append(hashes)
    if digest:
        same = {c: len(h) == len(roots) and len(set(h)) == 1
                for c, h in digests.items()}
        for case, ok in same.items():
            print(f"bit-equal across the roots: {ok}  {case}")
        groups = {}
        for case, ok in same.items():
            key = " ".join(case.split()[:3])   # dtype, kernel, stride
            groups.setdefault(key, []).append(ok)
        for key, oks in groups.items():
            print(f"bit-equal across the roots: {sum(oks)} of {len(oks)}  "
                  f"{key}")
        print(f"bit-equal across the roots: {sum(same.values())} of "
              f"{len(cases)} cases")
        rc = rc or int(sum(same.values()) != len(cases))
    return rc


if __name__ == "__main__":
    sys.exit(main())
