"""Multi-task loss library in PyTorch, channels-last.

The port of ``mt3d_resenc_unet_tpu/train/losses.py`` (reference:
training/losses/losses.py:1-333 and the torch builtins wired in
train.py:47-56) for NDHWC tensors:

  BCEDiceLoss, DiceLoss, GeneralizedDiceLoss, BCEWithLogitsLoss, BCELoss,
  CrossEntropyLoss, MSELoss, BCEWithLogitsLossLabelSmoothing,
  BCEWithLogitsLossZSmooth, MaskedCosineLoss, plus the masking / skip-channel
  wrappers.

All reductions run in fp32 whatever the input dtype. Every loss is a plain
callable ``loss(pred, target) -> scalar`` that autograd differentiates.
Each reduces over the batch through sums (a mean is a sum over a count):
inside ``parallel.distributed.global_batch`` those sums are taken over
every rank's samples, so a multi-process step computes the loss of the
global batch, as the jitted JAX step does over its sharded batch. The
epsilons and defaults are the JAX package's (``_EPS_DICE``, the 0.1 label
smoothing inside ``BCEDiceLoss``, ``MaskedCosineLoss.mag_threshold``);
``BCEDiceLoss`` has working defaults (alpha=beta=0.5) where the reference
crashes without kwargs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..parallel.distributed import batch_shards, global_sum

Loss = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_EPS_DICE = 1e-6


def _f32(*xs):
    return tuple(x.float() for x in xs)


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    """The sum or the mean over the (global) batch of an elementwise loss."""
    total = global_sum(loss.sum())
    if reduction == "mean":
        return total / (loss.numel() * batch_shards())
    return total


def label_smooth(target: torch.Tensor, smooth_factor: float) -> torch.Tensor:
    """Binary label smoothing 1 -> 1-f, 0 -> f (reference: losses.py:7-15)."""
    return target * (1.0 - smooth_factor) + (1.0 - target) * smooth_factor


def _flatten_channels_first(x: torch.Tensor) -> torch.Tensor:
    """(N, *spatial, C) -> (C, N * prod(spatial)): the channel-major flatten
    of the dice computations (reference: losses.py:321-333)."""
    return torch.movedim(x, -1, 0).reshape(x.shape[-1], -1)


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise BCE-with-logits."""
    logits, targets = _f32(logits, targets)
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _probs(pred: torch.Tensor, normalization: str) -> torch.Tensor:
    if normalization == "sigmoid":
        return torch.sigmoid(pred)
    if normalization == "softmax":
        return torch.softmax(pred, dim=-1)
    return pred


def compute_per_channel_dice(probs: torch.Tensor, target: torch.Tensor,
                             weight: Optional[torch.Tensor] = None,
                             epsilon: float = _EPS_DICE) -> torch.Tensor:
    """V-Net-style per-channel dice 2*(p.t)/(p^2+t^2)
    (reference: losses.py:17-43)."""
    probs, target = _f32(probs, target)
    p = _flatten_channels_first(probs)
    t = _flatten_channels_first(target)
    intersect, pp, tt = global_sum(torch.stack(
        [(p * t).sum(dim=-1), (p * p).sum(dim=-1), (t * t).sum(dim=-1)]))
    if weight is not None:
        intersect = weight * intersect
    denominator = pp + tt
    return 2.0 * intersect / torch.clamp(denominator, min=epsilon)


@dataclasses.dataclass(frozen=True)
class DiceLoss:
    """1 - mean per-channel dice, logits normalized by sigmoid/softmax
    (reference: losses.py:93-138)."""

    normalization: str = "sigmoid"  # sigmoid | softmax | none
    smooth_factor: float = 0.0
    weight: Optional[tuple] = None

    def __call__(self, pred, target):
        pred, target = _f32(pred, target)
        probs = _probs(pred, self.normalization)
        if self.smooth_factor > 0.0:
            target = label_smooth(target, self.smooth_factor)
        w = (torch.tensor(self.weight, dtype=torch.float32,
                          device=pred.device)
             if self.weight is not None else None)
        return 1.0 - compute_per_channel_dice(probs, target, weight=w).mean()


@dataclasses.dataclass(frozen=True)
class GeneralizedDiceLoss:
    """GDL with inverse-volume class weights (reference: losses.py:141-173)."""

    normalization: str = "sigmoid"
    epsilon: float = 1e-6

    def __call__(self, pred, target):
        pred, target = _f32(pred, target)
        p = _flatten_channels_first(_probs(pred, self.normalization))
        t = _flatten_channels_first(target)
        if p.shape[0] == 1:
            p = torch.cat([p, 1.0 - p], dim=0)
            t = torch.cat([t, 1.0 - t], dim=0)
        w, intersect, both = global_sum(torch.stack(
            [t.sum(dim=-1), (p * t).sum(dim=-1), (p + t).sum(dim=-1)]))
        w = (1.0 / torch.clamp(w * w, min=self.epsilon)).detach()
        intersect = intersect * w
        denominator = torch.clamp(both * w, min=self.epsilon)
        return 1.0 - 2.0 * intersect.sum() / denominator.sum()


@dataclasses.dataclass(frozen=True)
class BCEWithLogitsLoss:
    reduction: str = "mean"

    def __call__(self, pred, target):
        return _reduce(sigmoid_binary_cross_entropy(pred, target),
                       self.reduction)


@dataclasses.dataclass(frozen=True)
class BCELoss:
    """BCE on probabilities (inputs already in [0,1])."""

    reduction: str = "mean"
    eps: float = 1e-12

    def __call__(self, pred, target):
        pred, target = _f32(pred, target)
        p = torch.clamp(pred, self.eps, 1.0 - self.eps)
        loss = -(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))
        return _reduce(loss, self.reduction)


def expand_as_one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer class labels ``(N, *spatial)`` or ``(N, *spatial, 1)`` ->
    one-hot ``(N, *spatial, num_classes)`` float32, channels-last
    (reference: builders/utils.py expand_as_one_hot, which emits NCDHW).
    A label outside ``[0, num_classes)`` gives an all-zero row, as
    ``jax.nn.one_hot`` does."""
    if labels.dim() and labels.shape[-1] == 1:
        labels = labels[..., 0]
    labels = labels.long()
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).float()


@dataclasses.dataclass(frozen=True)
class CrossEntropyLoss:
    """Softmax cross entropy over the channel axis.

    Targets may be dense (soft or one-hot, same shape as ``pred``) or integer
    class indices with a trailing singleton channel / no channel axis, as
    torch's ``nn.CrossEntropyLoss`` takes index targets (reference wires it
    at train.py:47-56). The integer dtype decides index-vs-dense."""

    reduction: str = "mean"

    def __call__(self, pred, target):
        pred = pred.float()
        if (not torch.is_floating_point(target)
                or target.shape != pred.shape):
            target = expand_as_one_hot(target, pred.shape[-1])
        else:
            target = target.float()
        loss = -(target * F.log_softmax(pred, dim=-1)).sum(dim=-1)
        return _reduce(loss, self.reduction)


@dataclasses.dataclass(frozen=True)
class MSELoss:
    reduction: str = "mean"

    def __call__(self, pred, target):
        pred, target = _f32(pred, target)
        return _reduce(torch.square(pred - target), self.reduction)


@dataclasses.dataclass(frozen=True)
class BCEWithLogitsLossLabelSmoothing:
    """BCE with smoothed targets y*(1-2a)+a (reference: losses.py:217-238)."""

    smoothing: float = 0.1
    reduction: str = "mean"

    def __call__(self, pred, target):
        target = (target.float() * (1.0 - 2.0 * self.smoothing)
                  + self.smoothing).detach()
        return _reduce(sigmoid_binary_cross_entropy(pred, target),
                       self.reduction)


@dataclasses.dataclass(frozen=True)
class BCEWithLogitsLossZSmooth:
    """Label smoothing growing linearly from the center Z slice outward
    (reference: losses.py:240-304). Tensors are (N, D, H, W, C); D is Z."""

    center_smoothing: float = 0.1
    edge_smoothing: float = 0.4
    reduction: str = "mean"

    def __call__(self, pred, target):
        pred, target = _f32(pred, target)
        d = pred.shape[1]
        mid = (d - 1) / 2.0
        dist = (torch.arange(d, dtype=torch.float32, device=pred.device)
                - mid).abs()
        max_dist = max(d // 2, 1)
        alpha = self.center_smoothing + (
            self.edge_smoothing - self.center_smoothing) * dist / max_dist
        alpha = alpha.reshape(1, d, 1, 1, 1)
        smoothed = (target * (1.0 - 2.0 * alpha) + alpha).detach()
        return _reduce(sigmoid_binary_cross_entropy(pred, smoothed),
                       self.reduction)


@dataclasses.dataclass(frozen=True)
class MaskedCosineLoss:
    """1 - mean cosine similarity between unit-normalized predictions and
    target normals, masked to voxels with nonzero target magnitude
    (reference: losses.py:187-215). Channel axis is last: (N,D,H,W,3)."""

    mag_threshold: float = 1e-6
    eps: float = 1e-8

    def __call__(self, pred, target):
        pred, target = _f32(pred, target)
        target_mag = torch.linalg.vector_norm(target, dim=-1)
        mask = (target_mag > self.mag_threshold).float()
        pred_mag = torch.clamp(
            torch.linalg.vector_norm(pred, dim=-1, keepdim=True),
            min=self.eps)
        pred_unit = pred / pred_mag
        # cosine_similarity(pred_unit, target): both magnitudes clamped
        tgt_mag = torch.clamp(target_mag, min=self.eps)
        cos = (pred_unit * target).sum(dim=-1) / tgt_mag
        agree, count = global_sum(torch.stack([(cos * mask).sum(),
                                               mask.sum()]))
        return 1.0 - agree / (count + self.eps)


@dataclasses.dataclass(frozen=True)
class BCEDiceLoss:
    """alpha * BCE(label-smoothed 0.1) + beta * Dice
    (reference: losses.py:307-318)."""

    alpha: float = 0.5
    beta: float = 0.5

    def __call__(self, pred, target):
        bce = BCEWithLogitsLossLabelSmoothing(smoothing=0.1)(pred, target)
        dice = DiceLoss()(pred, target)
        return self.alpha * bce + self.beta * dice


@dataclasses.dataclass(frozen=True)
class MaskingLossWrapper:
    """Zero out loss where target == ignore_index
    (reference: losses.py:46-66)."""

    loss: Loss
    ignore_index: float

    def __call__(self, pred, target):
        mask = (target != self.ignore_index).to(pred.dtype).detach()
        return self.loss(pred * mask, target * mask)


@dataclasses.dataclass(frozen=True)
class LossOnLabelWrapper:
    """Restrict the loss to labeled voxels (any target channel nonzero):
    both pred and target are zeroed outside the mask, so unlabeled voxels
    contribute a constant, zero-gradient term (the ``loss_only_on_label``
    the reference declares in its YAML but never wires,
    tasks/example.yaml:26)."""

    loss: Loss

    def __call__(self, pred, target):
        labeled = target.float().abs().sum(dim=-1, keepdim=True) > 0
        mask = labeled.to(pred.dtype).detach()
        return self.loss(pred * mask, target * mask.to(target.dtype))


@dataclasses.dataclass(frozen=True)
class SkipLastTargetChannelWrapper:
    """Drop the last target channel before computing the loss
    (reference: losses.py:69-90). Channel axis is last."""

    loss: Loss

    def __call__(self, pred, target):
        if target.shape[-1] <= 1:
            raise ValueError("Target has a singleton channel dim; cannot skip")
        return self.loss(pred, target[..., :-1])


LOSS_FN_MAP: Dict[str, Callable[..., Loss]] = {
    "BCEDiceLoss": BCEDiceLoss,
    "BCEWithLogitsLossLabelSmoothing": BCEWithLogitsLossLabelSmoothing,
    "BCEWithLogitsLossZSmooth": BCEWithLogitsLossZSmooth,
    "BCEWithLogitsLoss": BCEWithLogitsLoss,
    "BCELoss": BCELoss,
    "CrossEntropyLoss": CrossEntropyLoss,
    "MSELoss": MSELoss,
    "MaskedCosineLoss": MaskedCosineLoss,
    "DiceLoss": DiceLoss,
    "GeneralizedDiceLoss": GeneralizedDiceLoss,
}


def build_task_losses(tasks: Dict[str, dict],
                      ignore_label: Optional[float] = None,
                      loss_only_on_label: bool = False) -> Dict[str, Loss]:
    """Per-task loss construction from config (reference: train.py:43-66),
    with optional ignore-label masking and labeled-region restriction."""
    losses: Dict[str, Loss] = {}
    for name, info in tasks.items():
        loss_name = info.get("loss_fn", "BCEDiceLoss")
        if loss_name not in LOSS_FN_MAP:
            raise ValueError(
                f"Loss function {loss_name} not found in LOSS_FN_MAP. "
                f"Known: {sorted(LOSS_FN_MAP)}")
        kwargs = info.get("loss_kwargs", {}) or {}
        loss = LOSS_FN_MAP[loss_name](**kwargs)
        if ignore_label is not None:
            loss = MaskingLossWrapper(loss, float(ignore_label))
        if loss_only_on_label:
            loss = LossOnLabelWrapper(loss)
        losses[name] = loss
    return losses
