"""Carry a JAX parameter tree, or a whole JAX training state, over to the
torch port.

The port's modules carry the flax names (``encoder.stage0.block0.conv1.conv
.kernel``) and keep every kernel in the JAX layout ((kd, kh, kw, ci, co) for
convs, (*k, ci, co) for transposed convs), so the bridge is a flatten: no
transposes and no weight flips, and every leaf keeps its dtype (fp32, or
bf16 / fp16 under a ``param_dtype``). The port permutes at the call
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


def leaf_from_jax(node) -> torch.Tensor:
    """One numpy-convertible leaf -> a torch tensor of its dtype where it is
    bf16 or fp16 (a ``param_dtype`` tree), else fp32. A bf16 leaf (an
    ml_dtypes array) goes through fp32, which holds it exactly: torch reads
    no ml_dtypes array."""
    arr = np.asarray(node)
    if arr.dtype == np.float16:
        return torch.from_numpy(arr.copy())
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))


def _per_name(tree) -> Dict[str, Any]:
    """A tree shaped as the parameters (the parameters, or an optax state
    field) -> its leaves by dotted name, each a tensor
    (:func:`leaf_from_jax`), or a list of tensors where the leaf is a list
    (sm3's per-dimension accumulators; :func:`unflatten` gives one as keys
    "0", "1", ...)."""
    out: Dict[str, Any] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, Mapping) and node and set(node) == {
                str(i) for i in range(len(node))}:
            node = [node[str(i)] for i in range(len(node))]   # unflatten's
        if isinstance(node, Mapping):
            for key, value in node.items():
                walk(f"{prefix}.{key}" if prefix else str(key), value)
        elif isinstance(node, (list, tuple)):
            out[prefix] = [leaf_from_jax(v) for v in node]
        else:
            out[prefix] = leaf_from_jax(node)

    walk("", tree)
    return out


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested mapping of numpy-convertible arrays (a flax ``params`` tree,
    or ``{"params": tree}``) -> torch ``state_dict``, each tensor in its
    leaf's dtype (:func:`leaf_from_jax`)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    return _per_name(tree)


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
                   name: str = "AdamW", epoch: int = -1,
                   **kwargs: Any) -> Dict[str, Any]:
    """A JAX training state (numpy trees, as ``jax.device_get`` or an orbax
    restore gives them) -> the port's checkpoint state ``{"params",
    "opt_state", "step", "epoch"}``, for any of the 16 names of the JAX
    factory (``name``, with the optax keywords ``kwargs`` the optimizer was
    built with: they decide which fields optax keeps).

    The state of each parameter stays in optax's layout: its fields by
    their optax names (``mu``, ``nu``, ``trace``, ``sum_of_squares``,
    ``v_row`` / ``v_col`` or ``v``, ``ema``; sm3's lists) and ``step``,
    optax's ``count`` (``step`` where the rule keeps none). The trainer's
    restore hands it to the optimizer it built, which names the fields its
    own way (``train/optimizers.py::state_for``). ``step`` is the number of
    updates, the port's ``Optimizer.count``. Every tensor keeps its leaf's
    dtype."""
    from ..train.optimizers import NAMES, optax_fields
    sd = params_from_jax(params)
    kind = name.lower()
    if kind not in NAMES:
        raise ValueError(f"Unknown optimizer {name!r}")
    count_node = _find(opt_state, ("count",))
    count = int(np.asarray(count_node["count"])) if count_node else int(step)
    found: Dict[str, Dict[str, Any]] = {}
    state = {}
    for n, p in sd.items():
        st = {"step": count}
        for field in optax_fields(kind, p, **kwargs):
            if field not in found:
                node = _find(opt_state, (field,))
                if node is None:
                    raise ValueError(f"{name}: the optimizer state lacks "
                                     f"optax's {field!r}")
                found[field] = _per_name(node[field])
            st[field] = found[field][n]
        state[n] = st
    return {"params": sd,
            "opt_state": {"state": state, OPT_STATE_BY_NAME: True},
            "step": int(step), "epoch": int(epoch)}
