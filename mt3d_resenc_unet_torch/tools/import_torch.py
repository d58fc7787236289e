"""Import reference PyTorch checkpoints into the port's state dict.

A copy of ``mt3d_resenc_unet_tpu/tools/import_torch.py``: the same key
patterns and kernel permutations build the flax-named tree, and
``tools/from_jax.py::params_from_jax`` flattens it into the port's names
(``encoder.stage0.block0.conv1.conv.kernel``), whose kernels keep the JAX
layouts. What the JAX docstring says of the mapping holds here:

Maps the reference ``NetworkFromConfig`` state_dict
(reference module structure: build_network_from_config.py:235-277,
encoder.py:81-134, decoder.py:68-135, resblocks.py:71-104,
simple_conv_blocks.py:43-69) onto our Flax tree, permuting conv kernels from
torch's (O, I, kD, kH, kW) to channels-last (kD, kH, kW, I, O) and transposed
convs from (I, O, kD, kH, kW) to (kD, kH, kW, I, O). InstanceNorm is
affine-free in the reference default, so it contributes no parameters.

Key correspondences:
  shared_encoder.stem.convs.0.conv.*          -> encoder/stem/conv0/conv
  shared_encoder.stages.{s}.blocks.{b}.conv1.conv.*   -> encoder/stage{s}/block{b}/conv1/conv
  ...conv2.conv.*                              -> .../conv2/conv
  ...skip.{k}.conv.* (1x1 projection)          -> .../skip/proj/conv
  ...squeeze_excitation.fc1/fc2 (conv1x1)      -> .../se/reduce|expand (Dense)
  task_decoders.{t}.transpconvs.{s}.*          -> decoder_{t}/up{s}
  task_decoders.{t}.stages.{s}.convs.{c}.conv.* -> decoder_{t}/stage{s}/conv{c}/conv
  task_decoders.{t}.stages.{s}.blocks.{b}....   -> decoder_{t}/stage{s}/block{b}/...
  task_decoders.{t}.seg_layers.{s}.*           -> decoder_{t}/seg{s}
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..train.checkpoint import save_params
from .from_jax import params_from_jax


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: np.ndarray):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """(O, I, *k) -> (*k, I, O)"""
    nd = w.ndim - 2
    return np.transpose(w, tuple(range(2, 2 + nd)) + (1, 0))


def _transp_kernel(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose (I, O, *k) -> flax (*k, I, O), spatially flipped.

    torch's conv_transpose computes y[k*i + d] = x[i] @ W[d] while flax
    ``nn.ConvTranspose`` (and our ``UpsampleConv``) apply the kernel
    spatially flipped: y[k*i + d] = x[i] @ W[k-1-d]. Without the flip,
    imported reference checkpoints produce spatially reversed upsampling
    (verified numerically against torch.nn.functional.conv_transpose3d in
    tests/test_import_torch.py)."""
    nd = w.ndim - 2
    arr = np.transpose(w, tuple(range(2, 2 + nd)) + (0, 1))
    return np.flip(arr, axis=tuple(range(nd)))


_PATTERNS = [
    # encoder stem
    (re.compile(r"shared_encoder\.stem\.convs\.(\d+)\.conv\.(weight|bias)"),
     lambda m: ("encoder", "stem", f"conv{m.group(1)}", "conv"), "conv"),
    # encoder residual blocks
    (re.compile(r"shared_encoder\.stages\.(\d+)(?:\.\d+)?\.blocks\.(\d+)"
                r"\.(conv1|conv2|conv3)\.conv\.(weight|bias)"),
     lambda m: ("encoder", f"stage{m.group(1)}", f"block{m.group(2)}",
                m.group(3), "conv"), "conv"),
    # encoder plain-conv stages
    (re.compile(r"shared_encoder\.stages\.(\d+)(?:\.\d+)?\.convs\.(\d+)"
                r"\.conv\.(weight|bias)"),
     lambda m: ("encoder", f"stage{m.group(1)}", f"conv{m.group(2)}", "conv"),
     "conv"),
    # encoder skip projection (skip.<k> Sequential position varies with
    # stride; the ConvDropoutNormReLU inside always exposes `.conv`)
    (re.compile(r"shared_encoder\.stages\.(\d+)(?:\.\d+)?\.blocks\.(\d+)"
                r"\.skip\.\d+\.conv\.(weight|bias)"),
     lambda m: ("encoder", f"stage{m.group(1)}", f"block{m.group(2)}",
                "skip", "proj", "conv"), "conv"),
    # squeeze-excitation (timm SqueezeExcite: fc1 / fc2 1x1 convs)
    (re.compile(r"shared_encoder\.stages\.(\d+)(?:\.\d+)?\.blocks\.(\d+)"
                r"\.squeeze_excitation\.fc1\.(weight|bias)"),
     lambda m: ("encoder", f"stage{m.group(1)}", f"block{m.group(2)}",
                "se", "reduce"), "dense"),
    (re.compile(r"shared_encoder\.stages\.(\d+)(?:\.\d+)?\.blocks\.(\d+)"
                r"\.squeeze_excitation\.fc2\.(weight|bias)"),
     lambda m: ("encoder", f"stage{m.group(1)}", f"block{m.group(2)}",
                "se", "expand"), "dense"),
    # decoder transpconvs
    (re.compile(r"task_decoders\.([^.]+)\.transpconvs\.(\d+)\.(weight|bias)"),
     lambda m: (f"decoder_{m.group(1)}", f"up{m.group(2)}"), "transp"),
    # decoder conv stages
    (re.compile(r"task_decoders\.([^.]+)\.stages\.(\d+)\.convs\.(\d+)"
                r"\.conv\.(weight|bias)"),
     lambda m: (f"decoder_{m.group(1)}", f"stage{m.group(2)}",
                f"conv{m.group(3)}", "conv"), "conv"),
    # decoder residual stages
    (re.compile(r"task_decoders\.([^.]+)\.stages\.(\d+)\.blocks\.(\d+)"
                r"\.(conv1|conv2|conv3)\.conv\.(weight|bias)"),
     lambda m: (f"decoder_{m.group(1)}", f"stage{m.group(2)}",
                f"block{m.group(3)}", m.group(4), "conv"), "conv"),
    (re.compile(r"task_decoders\.([^.]+)\.stages\.(\d+)\.blocks\.(\d+)"
                r"\.skip\.\d+\.conv\.(weight|bias)"),
     lambda m: (f"decoder_{m.group(1)}", f"stage{m.group(2)}",
                f"block{m.group(3)}", "skip", "proj", "conv"), "conv"),
    # seg layers
    (re.compile(r"task_decoders\.([^.]+)\.seg_layers\.(\d+)\.(weight|bias)"),
     lambda m: (f"decoder_{m.group(1)}", f"seg{m.group(2)}"), "conv"),
]


def convert_tree(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Reference torch state_dict -> nested flax-named tree (numpy arrays;
    the JAX tool's ``convert_state_dict``)."""
    params: Dict[str, Any] = {}
    unmatched = []
    for key, value in state_dict.items():
        key = key.removeprefix("_orig_mod.")  # torch.compile wrapper prefix
        arr = np.asarray(value.detach().cpu().numpy()
                         if hasattr(value, "detach") else value)
        matched = False
        for pattern, path_fn, kind in _PATTERNS:
            m = pattern.fullmatch(key)
            if m is None:
                continue
            is_bias = key.endswith("bias")
            base = path_fn(m)
            if kind == "conv":
                leaf = "bias" if is_bias else "kernel"
                arr2 = arr if is_bias else _conv_kernel(arr)
            elif kind == "transp":
                leaf = "bias" if is_bias else "kernel"
                arr2 = arr if is_bias else _transp_kernel(arr)
            else:  # dense from 1x1 conv: (O, I, 1, 1, 1) -> (I, O)
                leaf = "bias" if is_bias else "kernel"
                arr2 = arr if is_bias else arr.reshape(arr.shape[0], arr.shape[1]).T
            _set(params, base + (leaf,), arr2.astype(np.float32))
            matched = True
            break
        if not matched:
            unmatched.append(key)
    if unmatched:
        print(f"[import_torch] {len(unmatched)} unmatched keys "
              f"(e.g. {unmatched[:5]})")
    return params


def convert_state_dict(state_dict: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """Reference torch state_dict -> the port's ``state_dict`` (fp32)."""
    return params_from_jax(convert_tree(state_dict))


def import_checkpoint(pth_path: str, out_path: str
                      ) -> Dict[str, torch.Tensor]:
    """Load a reference .pth (either a full {'model': ...} checkpoint —
    reference train.py:249-254 — or a bare state_dict) and save the port's
    parameters with ``train/checkpoint.py::save_params`` (``torch.save``),
    which the trainer's ``checkpoint_path`` and the engine read."""
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    params = convert_state_dict(state_dict)
    if out_path:
        save_params(out_path, params)
    return params


def main():  # pragma: no cover
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pth", required=True, help="reference .pth checkpoint")
    p.add_argument("--out", required=True,
                   help="output params file (torch.save)")
    a = p.parse_args()
    params = import_checkpoint(a.pth, a.out)
    n = sum(x.numel() for x in params.values())
    print(f"imported {n:,} params -> {a.out}")


if __name__ == "__main__":  # pragma: no cover
    main()
