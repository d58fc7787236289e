"""Checkpoints on ``torch.save`` with the reference's three load modes.

The port of ``mt3d_resenc_unet_tpu/train/checkpoint.py`` (Orbax there;
reference: train.py:146-168, 249-265, 339 and inference.py:39-44):

* per-epoch checkpoints ``<ckpt_out_base>/<model_name>/<epoch>/state.pt``
  with keep-newest-N garbage collection (orbax ``max_to_keep``);
* full resume: a state is ``{"params": model.state_dict() (fp32),
  "opt_state": the torch optimizer's state_dict, "step": Optimizer.count,
  "epoch": int}``. ``step`` is the schedule position (train/step.py
  ``Optimizer.count``): a resume without it would restart the cosine
  schedule, which is why the JAX trainer restores ``step`` too;
* ``load_weights_only`` fine-tune mode (params only, fresh optimizer);
* non-strict loading (``merge_params_nonstrict``) over the flax-named keys
  the port's ``state_dict`` shares with the JAX parameter tree
  (tools/from_jax.py).

Files are read with ``torch.load(weights_only=True)``, which unpickles
tensors and plain containers only, and written through a temporary file
renamed into place, so a cut-off save leaves no half-written state.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

STATE_FILE = "state.pt"


def _save(obj: Any, path: Path) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: Path) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def _epochs(directory: Path):
    if not directory.is_dir():
        return []
    return sorted(int(p.name) for p in directory.iterdir()
                  if p.name.isdigit() and (p / STATE_FILE).is_file())


class CheckpointManager:
    """Per-epoch training states under ``<directory>/<model_name>/``,
    keeping the newest ``keep``."""

    def __init__(self, directory, model_name: str, keep: int = 10):
        self.directory = Path(directory).absolute() / model_name
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def save(self, epoch: int, state: Mapping[str, Any]) -> Path:
        """state: {'params', 'opt_state', 'step', 'epoch'}; returns the
        file written."""
        step_dir = self.directory / str(int(epoch))
        step_dir.mkdir(exist_ok=True)
        path = step_dir / STATE_FILE
        _save(dict(state), path)
        if self.keep > 0:
            for old in _epochs(self.directory)[:-self.keep]:
                shutil.rmtree(self.directory / str(old))
        return path

    def latest_epoch(self) -> Optional[int]:
        epochs = _epochs(self.directory)
        return epochs[-1] if epochs else None

    def restore(self, epoch: Optional[int] = None) -> Dict[str, Any]:
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"No checkpoints in {self.directory}")
        return _load(self.directory / str(epoch) / STATE_FILE)

    def close(self) -> None:
        """Nothing stays open between saves (the orbax manager's close)."""


def _resolve(path) -> Path:
    """A manager root (its newest epoch), an epoch dir, or a file."""
    path = Path(path).absolute()
    epochs = _epochs(path)
    if epochs:
        return path / str(epochs[-1]) / STATE_FILE
    if (path / STATE_FILE).is_file():
        return path / STATE_FILE
    if not path.is_file():
        raise FileNotFoundError(f"no checkpoint at {path}")
    return path


def _is_state(obj) -> bool:
    return isinstance(obj, dict) and {"params", "opt_state"} <= set(obj)


def restore_flexible(path, params_only_ok: bool = False) -> Dict[str, Any]:
    """A training state from a manager root, an epoch dir or a state file.
    With ``params_only_ok`` a params-only dump (the final weights,
    reference: train.py:339) is accepted too, as a state with no optimizer
    state (``opt_state`` None, ``step`` 0, ``epoch`` -1)."""
    obj = _load(_resolve(path))
    if _is_state(obj):
        return obj
    if not params_only_ok:
        raise ValueError(f"{path} holds parameters only, not a training "
                         "state; set load_weights_only to fine-tune from it")
    return {"params": obj, "opt_state": None, "step": 0, "epoch": -1}


def load_params_any(path) -> Dict[str, torch.Tensor]:
    """The parameters of any layout this module writes: a manager root, an
    epoch dir, a state file or a params dump."""
    obj = _load(_resolve(path))
    return obj["params"] if _is_state(obj) else obj


def save_params(path, params: Mapping[str, torch.Tensor]) -> None:
    """Standalone final-weights dump (reference: train.py:339)."""
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    _save({k: v.detach().cpu() for k, v in params.items()}, path)


def load_params(path) -> Dict[str, torch.Tensor]:
    return _load(Path(path).absolute())


def merge_params_nonstrict(fresh: Mapping[str, torch.Tensor],
                           loaded: Mapping[str, torch.Tensor]
                           ) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """Overlay ``loaded`` onto ``fresh`` wherever a key exists and the shape
    matches (torch ``load_state_dict(strict=False)`` with a shape check,
    reference: inference.py:41-44). Counts restored, kept-fresh and
    shape-mismatched entries."""
    stats = {"restored": 0, "kept_fresh": 0, "shape_mismatch": 0}
    out = {}
    for key, fval in fresh.items():
        lval = loaded.get(key)
        if lval is not None and tuple(lval.shape) == tuple(fval.shape):
            out[key] = lval.to(dtype=fval.dtype, device=fval.device)
            stats["restored"] += 1
        else:
            out[key] = fval
            stats["kept_fresh" if lval is None else "shape_mismatch"] += 1
    return out, stats
