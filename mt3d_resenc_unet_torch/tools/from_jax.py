"""Carry a JAX parameter tree, or a whole JAX training state, over to the
torch port.

The port's modules carry the flax names (``encoder.stage0.block0.conv1.conv
.kernel``) and keep every kernel in the JAX layout ((kd, kh, kw, ci, co) for
convs, (*k, ci, co) for transposed convs), so the bridge is a flatten plus
a dtype: no transposes and no weight flips. The port permutes at the call
where plain PyTorch wants its own layout.

:func:`state_from_jax` turns a JAX ``TrainState``'s parameters, optax state
and step (numpy trees) into the port's checkpoint state
(``train/checkpoint.py``), so that a JAX run resumes in the port. The
optimizer state is keyed by parameter name; the trainer's restore turns it
into the index-keyed ``state_dict`` of the optimizer it builds
(``train/checkpoint.py::opt_state_by_index``). The JAX side (read an orbax
checkpoint with the JAX package's ``CheckpointManager``, then ``np.savez``)
is in the README; :func:`unflatten` reads that file's keys back into a
tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..train.checkpoint import OPT_STATE_BY_NAME


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


def unflatten(flat: Mapping[str, Any], sep: str = "/") -> Dict[str, Any]:
    """``{"a/b/c": array}`` (the keys of the README's ``np.savez`` of a JAX
    state) -> a nested dict."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(sep)
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _children(node) -> Optional[Dict[str, Any]]:
    """The named children of a tree node: a mapping, a namedtuple (an optax
    state), or a list/tuple by position; None for a leaf."""
    if isinstance(node, Mapping):
        return dict(node)
    if hasattr(node, "_asdict"):
        return dict(node._asdict())
    if isinstance(node, (list, tuple)):
        return {str(i): v for i, v in enumerate(node)}
    return None


def _find(node, fields) -> Optional[Dict[str, Any]]:
    """The first node of the tree (depth first) with all of ``fields``."""
    kids = _children(node)
    if kids is None:
        return None
    if all(f in kids for f in fields):
        return kids
    for child in kids.values():
        found = _find(child, fields)
        if found is not None:
            return found
    return None


def state_from_jax(params: Mapping[str, Any], opt_state: Any, step: int,
                   name: str = "AdamW", epoch: int = -1) -> Dict[str, Any]:
    """A JAX training state (numpy trees, as ``jax.device_get`` or an orbax
    restore gives them) -> the port's checkpoint state ``{"params",
    "opt_state", "step", "epoch"}``.

    ``name`` is the config's optimizer: AdamW / Adam (the optax
    ``ScaleByAdamState``'s ``count``, ``mu``, ``nu`` become torch's
    ``step``, ``exp_avg``, ``exp_avg_sq``: the same rule, JAX step.py's
    ``build_optimizer``) or SGD (the nesterov ``trace`` becomes torch's
    ``momentum_buffer``: torch's ``buf = m*buf + g`` and update ``g +
    m*buf`` are optax's). ``step`` is the number of updates, the port's
    ``Optimizer.count``. Any other name raises."""
    sd = params_from_jax(params)
    kind = name.lower()
    if kind in ("adamw", "adam"):
        adam = _find(opt_state, ("count", "mu", "nu"))
        if adam is None:
            raise ValueError("no optax ScaleByAdamState (count, mu, nu) in "
                             "the optimizer state")
        count = torch.tensor(float(np.asarray(adam["count"])))
        mu, nu = params_from_jax(adam["mu"]), params_from_jax(adam["nu"])
        state = {n: {"step": count.clone(), "exp_avg": mu[n],
                     "exp_avg_sq": nu[n]} for n in sd}
    elif kind == "sgd":
        trace = _find(opt_state, ("trace",))
        if trace is None:
            raise ValueError("no optax TraceState (trace) in the optimizer "
                             "state")
        buf = params_from_jax(trace["trace"])
        state = {n: {"momentum_buffer": buf[n]} for n in sd}
    else:
        raise NotImplementedError(
            f"optimizer {name!r}: the JAX state bridge carries AdamW, Adam "
            "and SGD; start the other rules' state afresh "
            "(load_weights_only)")
    return {"params": sd,
            "opt_state": {"state": state, OPT_STATE_BY_NAME: True},
            "step": int(step), "epoch": int(epoch)}
