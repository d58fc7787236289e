"""Training CLI of the port (the flags of the JAX package's train.py):

    python -m mt3d_resenc_unet_torch.train --config_path tasks/X.yaml \
        [--debug_dataloader] [--verbose] [--device {cuda,cpu}] \
        [--dist_backend {nccl,gloo}]

It trains on the card (``--device cuda``, the default) and raises where
there is none; ``--device cpu`` runs it on the CPU. Several processes
(torchrun, or JAX's ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES``
/ ``JAX_PROCESS_ID``) form one process group first
(``parallel.distributed.initialize``: NCCL on the card, gloo on the CPU
or with ``--dist_backend gloo``, which two ranks sharing one card need).
The task file is read by the port's own YAML reader
(``core/yaml_load.py``): no pyyaml is needed.
"""

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(
        description="Train a multi-task 3D ResEnc U-Net with PyTorch.")
    parser.add_argument("--config_path", type=str, required=True,
                        help="Path to your YAML config file.")
    parser.add_argument("--debug_dataloader", action="store_true",
                        help="Dump 25 dataset samples as TIFFs and exit.")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Where to train (default: the CUDA card).")
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"),
                        default=None,
                        help="Process-group backend of a multi-process "
                             "run (default: nccl on the card, gloo on "
                             "the CPU).")
    args = parser.parse_args(argv)

    from ..parallel.distributed import initialize
    initialize(backend=args.dist_backend
               or ("gloo" if args.device == "cpu" else None))

    from .trainer import Trainer
    trainer = Trainer(args.config_path, verbose=args.verbose,
                      debug_dataloader=args.debug_dataloader,
                      device=args.device)
    return trainer.train()


if __name__ == "__main__":
    main()
