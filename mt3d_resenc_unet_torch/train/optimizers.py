"""Config-driven optimizer factory.

The port of ``mt3d_resenc_unet_tpu/train/optimizers.py::create_optimizer``
(reference: training/optimizers/optimizer.py:5-76): a torch optimizer by
name, after optional global-norm clipping, as an :class:`Optimizer` of
``train/step.py``. It covers the names torch has an optimizer for; the
optax-only ones (lamb, lars, lion, novograd, fromage, yogi, sm3) raise. The
trainer's default path is ``step.build_optimizer`` (AdamW / SGD-nesterov).
Torch's optimizers keep their own conventions (e.g. where eps enters), so
only AdamW and SGD are held against optax in the tests.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

import torch

from .step import Optimizer, Schedule

_TORCH = {
    "adam": torch.optim.Adam,
    "adamw": torch.optim.AdamW,
    "adamax": torch.optim.Adamax,
    "sgd": torch.optim.SGD,
    "rmsprop": torch.optim.RMSprop,
    "adagrad": torch.optim.Adagrad,
    "nadam": torch.optim.NAdam,
    "radam": torch.optim.RAdam,
}
_OPTAX_ONLY = ("adafactor", "fromage", "lamb", "lars", "lion", "novograd",
               "sm3", "yogi")


def create_optimizer(params: Iterable[torch.nn.Parameter], name: str,
                     learning_rate: Schedule, weight_decay: float = 0.0,
                     grad_clip_norm: Optional[float] = None,
                     **kwargs: Any) -> Optimizer:
    """Build a torch optimizer by name. ``learning_rate`` is a schedule of
    the update count. SGD defaults to momentum 0.9 with nesterov, as the
    JAX factory does; AdamW's decay is decoupled, the others add
    ``weight_decay * p`` to the gradient."""
    n = name.lower()
    if n in _OPTAX_ONLY:
        raise NotImplementedError(f"optimizer '{name}' has no torch "
                                  "counterpart in the port")
    if n not in _TORCH:
        raise ValueError(f"Unknown optimizer '{name}'. "
                         f"Known: {sorted(_TORCH)}")
    if n == "sgd":
        kwargs.setdefault("momentum", 0.9)
        kwargs.setdefault("nesterov", True)
    opt = _TORCH[n](list(params), lr=learning_rate(0),
                    weight_decay=weight_decay, **kwargs)
    return Optimizer(opt, learning_rate, grad_clip_norm)
