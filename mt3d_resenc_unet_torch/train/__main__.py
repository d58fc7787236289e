"""Training CLI of the port (the flags of the JAX package's train.py):

    python -m mt3d_resenc_unet_torch.train --config_path tasks/X.yaml \
        [--debug_dataloader] [--verbose]

Reading a YAML file needs pyyaml; where it is missing, build
``Trainer(config_dict=...)`` from Python instead.
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
    args = parser.parse_args(argv)

    from .trainer import Trainer
    trainer = Trainer(args.config_path, verbose=args.verbose,
                      debug_dataloader=args.debug_dataloader)
    return trainer.train()


if __name__ == "__main__":
    main()
