"""Counts instructions in the compiled code of the port's CUDA kernels.

    python -m mt3d_resenc_unet_torch.tools.sass_stats [SOURCE ...]

Builds each ``ops/csrc/<SOURCE>.cu`` (default: ``conv3d_k3_f32_fwd``) as
the wrappers do, disassembles its library with the toolkit's ``cuobjdump
-sass`` and prints, per kernel entry, the count of each instruction class
in COUNTED (fp64 MMAs, shared-memory loads and stores, fp32 -> fp64
conversions, async copies, barriers) and the shared-memory loads and
conversions per MMA, beside the registers and spills of ``nvcc -Xptxas
-v``. A count is of instructions in the code, not of executions: a loop
body counts once. Needs the CUDA toolkit (``nvcc``, ``cuobjdump``).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

# instruction class -> SASS opcode prefix
COUNTED = {"DMMA": "DMMA", "LDS": "LDS", "STS": "STS",
           "F2F.F64.F32": "F2F.F64.F32", "LDGSTS": "LDGSTS", "BAR": "BAR.SYNC"}


def counts(sass: str) -> dict:
    """{entry: {class: count}} of a ``cuobjdump -sass`` listing."""
    out, entry = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            entry = m.group(1)
            out[entry] = dict.fromkeys(COUNTED, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if entry and m:
            op = m.group(1)
            for name, prefix in COUNTED.items():
                if op.startswith(prefix):
                    out[entry][name] += 1
    return out


def main(argv=None) -> int:
    from torch.utils.cpp_extension import CUDA_HOME

    from mt3d_resenc_unet_torch.ops import _build
    sources = list(sys.argv[1:] if argv is None else argv) or [
        "conv3d_k3_f32_fwd"]
    if CUDA_HOME is None:
        print("sass_stats: no CUDA toolkit", file=sys.stderr)
        return 1
    tool = os.path.join(CUDA_HOME, "bin", "cuobjdump")
    for source in sources:
        _build.load(source)
        lib = str(_build._target(source))
        sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, check=True).stdout
        usage = {}
        entry = None
        for line in _build.build_log(source).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and ("registers" in line or "spill" in line):
                usage.setdefault(entry, []).append(
                    line.split(":", 1)[-1].strip())
        for name, c in counts(sass).items():
            per = (f", per DMMA: LDS {c['LDS'] / c['DMMA']:.2f}, F2F "
                   f"{c['F2F.F64.F32'] / c['DMMA']:.2f}" if c["DMMA"] else "")
            print(f"{source} {name[:70]}: "
                  + ", ".join(f"{k} {v}" for k, v in c.items()) + per)
            for u in usage.get(name, []):
                print(f"    {u}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
