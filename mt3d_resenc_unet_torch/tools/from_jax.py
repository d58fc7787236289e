"""Carry a JAX parameter tree over to the torch port.

The port's modules carry the flax names (``encoder.stage0.block0.conv1.conv
.kernel``) and keep every kernel in the JAX layout ((kd, kh, kw, ci, co) for
convs, (*k, ci, co) for transposed convs), so the bridge is a flatten plus
a dtype: no transposes and no weight flips. The port permutes at the call
where plain PyTorch wants its own layout.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested mapping of numpy-convertible arrays (a flax ``params`` tree,
    or ``{"params": tree}``) -> torch ``state_dict`` of fp32 tensors."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, Mapping):
            for key, value in node.items():
                walk(f"{prefix}.{key}" if prefix else str(key), value)
        else:
            out[prefix] = torch.from_numpy(
                np.array(node, dtype=np.float32, copy=True))

    walk("", tree)
    return out
