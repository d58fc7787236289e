"""Standalone overlap finalization + quantization for an existing
predictions store (reference: scripts/standalone_inf_average.py:7-138):
averages sum/count (or skips averaging for vector sums), renormalizes
normals, and casts to the final uint8/uint16 datasets — runnable without a
model or checkpoint, e.g. to resume an interrupted inference run.

    python -m mt3d_resenc_unet_torch.tools.standalone_finalize \
        --store out/predictions.zarr --targets sheet:1 normals:3

The port of ``mt3d_resenc_unet_tpu/tools/standalone_finalize.py``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..infer.engine import export_z_slices, finalize_overlaps, quantize_final


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--store", required=True,
                   help="predictions.zarr directory with {tgt}_sum/_count")
    p.add_argument("--targets", required=True, nargs="+",
                   help="target specs as name:channels, e.g. sheet:1 normals:3")
    p.add_argument("--skip_average", action="store_true",
                   help="skip sum/count averaging (vector-sum mode)")
    p.add_argument("--write_layers", default=None,
                   help="also export per-Z JPEGs to this directory")
    args = p.parse_args(argv)

    targets = {}
    for spec in args.targets:
        name, _, ch = spec.partition(":")
        targets[name] = {"channels": int(ch or 1)}

    finalize_overlaps(args.store, targets, skip_average=args.skip_average)
    quantize_final(args.store, targets)
    if args.write_layers:
        export_z_slices(args.store, targets, args.write_layers)
    print(f"finalized {list(targets)} in {args.store}")


if __name__ == "__main__":
    main()
