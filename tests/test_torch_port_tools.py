"""The port's tools on the CPU: ``tools/profile_step.py`` must put the
device time of every kernel entry of ``ops/csrc/*.cu`` under its own row of
PERF.md's kernel table, and only there."""

import re

import pytest

from mt3d_resenc_unet_torch.ops import _build
from mt3d_resenc_unet_torch.tools import profile_step

_ENTRY = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(\w+)\s*\(")
# the row labels' kernel names ("row 7 upsample2x" -> "upsample2x")
_ROWS = {label.split()[-1]: label for label, _ in profile_step.GROUPS
         if label.startswith("row")}


def _group(name: str) -> str:
    return next((g for g, pat in profile_step.GROUPS
                 if re.search(pat, name, re.IGNORECASE)), "other")


@pytest.mark.parametrize("source", _build.SOURCES)
def test_profile_groups_take_each_kernel_entry_to_its_row(source):
    entries = _ENTRY.findall((_build.CSRC / f"{source}.cu").read_text())
    assert entries
    for entry in entries:
        # as the profiler names a template instance of the entry
        name = f"void (anonymous namespace)::{entry}<128, 64, 4>(int)"
        owner = max((k for k in _ROWS if entry.startswith(k)), key=len,
                    default=None)
        want = _ROWS[owner] if owner else "rows 10-11 norm_act"
        assert _group(name) == want, entry
