"""Inference CLI of the port (the flags of the JAX package's inference.py):

    python -m mt3d_resenc_unet_torch.infer --config_path tasks/X.yaml \
        [--write_layers] [--postprocess_only] [--resume] [--device {cuda,cpu}] \
        [--dist_backend {nccl,gloo}]

It runs on the card (``--device cuda``, the default) and raises where
there is none; ``--device cpu`` runs it on the CPU. Several processes
(torchrun, or JAX's ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES``
/ ``JAX_PROCESS_ID``) form one process group first
(``parallel.distributed.initialize``: NCCL on the card, gloo on the CPU
or with ``--dist_backend gloo``, which two ranks sharing one card need).
Reading a YAML file needs pyyaml; where it is missing, build
``ZarrInferenceEngine(config_dict=...)`` from Python instead.
"""

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser(
        description="Sliding-window zarr inference for the multi-task "
                    "3D ResEnc U-Net with PyTorch.")
    parser.add_argument("--config_path", type=str, required=True,
                        help="Path to your config file (same one used "
                             "for training).")
    parser.add_argument("--write_layers", action="store_true",
                        help="Write per-Z JPEG slices of the final outputs.")
    parser.add_argument("--postprocess_only", action="store_true",
                        help="Skip the model pass; only average/quantize "
                             "existing sum/count arrays.")
    parser.add_argument("--resume", action="store_true",
                        help="Continue an interrupted model pass from its "
                             "tile watermark instead of aborting on an "
                             "existing store.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Where to run (default: the CUDA card).")
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"),
                        default=None,
                        help="Process-group backend of a multi-process "
                             "run (default: nccl on the card, gloo on "
                             "the CPU).")
    args = parser.parse_args(argv)

    from ..parallel.distributed import initialize
    initialize(backend=args.dist_backend
               or ("gloo" if args.device == "cpu" else None))

    from .engine import ZarrInferenceEngine
    engine = ZarrInferenceEngine(
        config_file=args.config_path,
        write_layers=args.write_layers,
        postprocess_only=args.postprocess_only,
        resume=args.resume,
        device=args.device,
    )
    return engine.infer()


if __name__ == "__main__":
    main()
