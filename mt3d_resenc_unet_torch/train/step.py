"""Training and eval steps: multi-task loss, gradient accumulation,
global-norm clipping, AdamW or SGD, cosine epoch schedule.

The port of ``mt3d_resenc_unet_tpu/train/step.py`` (reference:
train.py:175-240). PyTorch runs eagerly, so a step is a Python function:
forward and backward per microbatch, then one clipped optimizer update.
Mixed precision is the model's: bf16 activations over fp32 parameters (the
model casts its weights at each call), so gradients and the optimizer state
are fp32 and no GradScaler is needed. Left out, as XLA-only devices: the
packed ``_vec`` metric, the strong-int32 step and buffer donation.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch

from .losses import Loss, MaskedCosineLoss

Schedule = Callable[[int], float]
AugmentFn = Callable[[Dict[str, torch.Tensor], torch.Generator],
                     Dict[str, torch.Tensor]]


def cosine_epoch_schedule(initial_lr: float, max_epoch: int,
                          steps_per_epoch: int) -> Schedule:
    """lr(step) = 0.5 * lr0 * (1 + cos(pi * epoch / max_epoch)),
    epoch-quantized to match torch CosineAnnealingLR stepped per epoch
    (reference: train.py:87-91, 336)."""

    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, max_epoch)
        return 0.5 * initial_lr * (1.0 + math.cos(math.pi * epoch / max_epoch))

    return schedule


class Optimizer:
    """Global-norm clip, then a torch optimizer whose learning rate follows
    ``schedule`` of the number of updates so far (the optax chain
    ``clip_by_global_norm -> adamw/sgd`` with a schedule).
    :meth:`step` returns the global norm of the gradients before the clip
    (``optax.global_norm(grads)`` in the JAX step)."""

    def __init__(self, opt: torch.optim.Optimizer, schedule: Schedule,
                 grad_clip_norm: Optional[float]):
        self.opt = opt
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        params = [p for group in self.opt.param_groups
                  for p in group["params"] if p.grad is not None]
        if self.grad_clip_norm:
            norm = torch.nn.utils.clip_grad_norm_(params, self.grad_clip_norm)
        else:
            norm = torch.nn.utils.get_total_norm([p.grad for p in params])
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1
        return norm


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    optimizer_name: str, schedule: Schedule,
                    weight_decay: float = 0.0,
                    grad_clip_norm: float = 3.0) -> Optimizer:
    """AdamW (default: betas 0.9/0.999, eps 1e-8, decoupled decay) or
    SGD with nesterov and momentum 0.9 (decay added to the gradient), after
    global-norm clipping at ``grad_clip_norm`` (reference: train.py:69-84,
    227). torch's AdamW scales p by ``1 - lr*wd`` before the Adam update
    where optax adds ``wd*p`` to it; both give ``p - lr*(u + wd*p)``."""
    params = list(params)
    lr0 = schedule(0)
    if optimizer_name.lower() == "sgd":
        opt = torch.optim.SGD(params, lr=lr0, momentum=0.9, nesterov=True,
                              weight_decay=weight_decay)
    else:
        opt = torch.optim.AdamW(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    return Optimizer(opt, schedule, grad_clip_norm)


def decode_wire(batch: Mapping[str, torch.Tensor],
                normal_keys: Tuple[str, ...] = ("normals",),
                upcast_bf16: bool = False) -> Dict[str, torch.Tensor]:
    """Decode a compact 'wire format' batch on the device, bit for bit as
    the JAX step does (u8/255, u16/65535, normals (u - 32767.5)/32767.5, in
    fp32; reference codecs: dataloading/dataset.py:125-131,147-155). Float
    tensors pass through."""
    out = {}
    for k, v in batch.items():
        if v.dtype == torch.uint16 and k in normal_keys:
            out[k] = (v.float() - 32767.5) / 32767.5
        elif v.dtype == torch.uint16:
            out[k] = v.float() / 65535.0
        elif v.dtype == torch.uint8:
            out[k] = v.float() / 255.0
        elif upcast_bf16 and v.dtype == torch.bfloat16:
            out[k] = v.float()
        else:
            out[k] = v
    return out


def _downsample_target(t: torch.Tensor, factor: Tuple[int, ...]) -> torch.Tensor:
    """Strided subsampling of a target for deep supervision, for
    channel-last dense targets ``(N, *spatial, C)`` and channel-less integer
    index targets ``(N, *spatial)``."""
    idx = (slice(None),) + tuple(slice(None, None, f) for f in factor)
    if t.dim() == len(factor) + 2:
        idx = idx + (slice(None),)
    return t[idx]


def multitask_loss(outputs: Mapping[str, object],
                   targets: Mapping[str, torch.Tensor],
                   loss_fns: Mapping[str, Loss],
                   task_weights: Mapping[str, float]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of per-task losses (reference: train.py:208-218). A
    deep-supervision list (highest resolution first) is combined with
    halving weights (1, 1/2, 1/4, ...) normalized to sum 1."""
    total = None
    per_task: Dict[str, torch.Tensor] = {}
    for name, fn in loss_fns.items():
        out, tgt = outputs[name], targets[name]
        if isinstance(out, (list, tuple)):
            ws = [0.5 ** i for i in range(len(out))]
            ws = [w / sum(ws) for w in ws]
            loss = 0.0
            for w, o in zip(ws, out):
                spatial = o.shape[1:-1]
                tgt_spatial = (tgt.shape[1:-1] if tgt.dim() == o.dim()
                               else tgt.shape[1:])
                factor = tuple(t // s for t, s in zip(tgt_spatial, spatial))
                t_ds = (_downsample_target(tgt, factor)
                        if any(f != 1 for f in factor) else tgt)
                loss = loss + w * fn(o, t_ds)
        else:
            loss = fn(out, tgt)
        loss = loss * task_weights.get(name, 1.0)
        per_task[name] = loss
        total = loss if total is None else total + loss
    return total, per_task


def make_train_step(model: torch.nn.Module, loss_fns: Mapping[str, Loss],
                    task_weights: Mapping[str, float],
                    grad_accum_steps: int = 1,
                    generator: Optional[torch.Generator] = None,
                    augment_fn: Optional[AugmentFn] = None):
    """Build ``train_step(optimizer, batch) -> metrics``.

    The batch holds 'image' plus one entry per task, each with leading
    dimension ``grad_accum_steps * microbatch``. Microbatch k is the
    INTERLEAVED slice ``samples[k::grad_accum_steps]``, as in the JAX step.
    The gradients, per-task losses and total are the means over the
    microbatches. Metrics are 0-d tensors on the model's device (no host
    sync): the per-task losses, ``total_loss`` and ``grad_norm`` (the global
    norm before the clip). ``generator``: the ``torch.Generator`` on the
    model's device from which dropout and DropPath draw (the JAX step's
    ``TrainState.rng``); a plan without them needs none.

    ``augment_fn(batch, generator) -> batch`` (e.g.
    ``data/augment_device.py::make_device_augment``) runs on each
    microbatch right after its wire decode and before the forward, drawing
    from ``generator``, which it then requires: each microbatch draws its
    own parameters, as the JAX step folds the microbatch index into its
    rng."""
    if augment_fn is not None and generator is None:
        raise ValueError("augment_fn draws from the step's generator; "
                         "pass generator=")
    loss_fns = dict(loss_fns)
    task_weights = dict(task_weights)
    normal_keys = tuple(k for k in loss_fns if k.lower() == "normals")
    accum = grad_accum_steps

    def train_step(optimizer: Optimizer,
                   batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        total_sum = None
        task_sums: Dict[str, torch.Tensor] = {}
        for k in range(accum):
            micro = decode_wire({key: v[k::accum] for key, v in batch.items()},
                                normal_keys)
            if augment_fn is not None:
                micro = augment_fn(micro, generator)
            outputs = model(micro["image"], generator=generator)
            targets = {key: v for key, v in micro.items() if key != "image"}
            total, per_task = multitask_loss(outputs, targets, loss_fns,
                                             task_weights)
            (total / accum).backward()
            total = total.detach()
            total_sum = total if total_sum is None else total_sum + total
            for name, value in per_task.items():
                value = value.detach()
                task_sums[name] = (value if name not in task_sums
                                   else task_sums[name] + value)
        metrics = {name: value / accum for name, value in task_sums.items()}
        metrics["total_loss"] = total_sum / accum
        metrics["grad_norm"] = optimizer.step()
        return metrics

    return train_step


def make_eval_step(model: torch.nn.Module, loss_fns: Mapping[str, Loss]):
    """Build ``eval_step(batch) -> metrics``: unweighted per-task losses on
    eval-mode LOGITS (the activations suppressed, so losses see what they
    see in training; reference: train.py:268-297), plus hard dice for a
    one-channel head and masked cosine for a 3-channel ``normals`` head."""
    loss_fns = dict(loss_fns)
    normal_keys = tuple(k for k in loss_fns if k.lower() == "normals")

    @torch.no_grad()
    def eval_step(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        batch = decode_wire(batch, normal_keys)
        outputs = model(batch["image"], apply_activations=False)
        metrics: Dict[str, torch.Tensor] = {}
        total = None
        for name, fn in loss_fns.items():
            out = outputs[name]
            if isinstance(out, (list, tuple)):
                out = out[0]    # deep supervision: the full resolution
            tgt = batch[name]
            loss = fn(out, tgt)
            metrics[name] = loss
            total = loss if total is None else total + loss
            if name.lower() == "normals" and out.shape[-1] == 3:
                metrics[f"{name}_cosine"] = 1.0 - MaskedCosineLoss()(out, tgt)
            elif out.shape[-1] == 1:
                pred = (out > 0).float()   # sigmoid(x) > 0.5
                t = (tgt > 0.5).float()
                metrics[f"{name}_dice"] = 2.0 * (pred * t).sum() / torch.clamp(
                    pred.sum() + t.sum(), min=1e-8)
        metrics["total_loss"] = total
        return metrics

    return eval_step


def make_predict_step(model: torch.nn.Module):
    """Build ``predict(image) -> {task: prediction}``: the eval-mode forward
    with each task's activation applied, and for deep supervision the
    full-resolution head only (JAX step.py:321-332; reference model forward
    in eval: build_network_from_config.py:321-323)."""

    @torch.no_grad()
    def predict(image: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.eval()
        image = decode_wire({"image": image})["image"]
        outs = model(image)
        return {k: (v[0] if isinstance(v, (list, tuple)) else v)
                for k, v in outs.items()}

    return predict
