"""Device-side augmentation: the stochastic sample pipeline inside the
training step.

The port of ``mt3d_resenc_unet_tpu/data/augment_device.py`` (reference:
dataloading/dataset.py:176-209 intensity stack + CoarseDropout3D;
training/transforms/geometric/geometry.py:5-148 normals-aware flips and
rot90). With ``tr_config.augment_on_device`` the dataset ships unaugmented
wire bytes and ``train/step.py`` runs :func:`make_device_augment`'s
``augment`` on each decoded microbatch, on its device, in plain torch ops
on (B, D, H, W, C) tensors.

The draws are split from the arithmetic. :func:`draw_params` draws every
random quantity from the caller's ``torch.Generator`` (never the global
RNG) into an :class:`AugParams`; :func:`apply` runs the stages of the JAX
``augment`` in its order, with its selects and its roundings: each stage
computes in fp32 (the (B,1,1,1,1) parameter tensors promote a bf16 image)
and casts back to the image's dtype. Semantics as in JAX: the stage gates,
picks and per-op parameters are per sample; the blur type and its kernel
parameters and the rot90 choice are per call (one call per microbatch);
flips are per sample. The draws themselves differ from JAX's threefry
stream by construction; the tests feed both packages the same numbers.

:func:`apply` reads the three per-call choices (blur type, rot90 gate and
pick) to the host once, since they pick which ops run; everything else
stays on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .augment import (ADVANCED_BLUR_SIGMA, BRIGHTNESS_LIMIT, CONTRAST_LIMIT,
                      DEFOCUS_RADIUS, GAUSS_NOISE_STD,
                      ILLUMINATION_INTENSITY, MULT_NOISE_RANGE,
                      _ROT_PLANES, _rotate_components)

_NORMAL_KEYS = ("normals",)
MOTION_SIZE = 7          # the motion kernel's support, lengths 3, 5 or 7
ADVANCED_SUPPORT = 4     # the advanced blur's 9x9 support
BLUR_TYPES = ("motion", "defocus", "downscale", "advanced")


@dataclasses.dataclass(frozen=True)
class DeviceAugConfig:
    """Probabilities mirror AugmentationPipeline (data/augment.py),
    which mirrors the reference (dataloading/dataset.py:176-201)."""

    p_intensity_1: float = 0.3   # brightness/contrast | illumination
    p_intensity_2: float = 0.35  # mult noise | gauss noise
    p_blur: float = 0.4          # motion | defocus | downscale | advanced
    p_cutout: float = 0.5
    p_flip_axis: float = 0.5
    p_flip_transform: float = 0.5
    p_rot90: float = 0.25
    cutout_fill: float = 0.5
    cutout_holes: Tuple[int, int] = (1, 4)
    cutout_extent: Tuple[float, float] = (0.1, 0.4)
    normal_keys: Tuple[str, ...] = _NORMAL_KEYS


@dataclasses.dataclass(frozen=True)
class AugParams:
    """Every random quantity of one call, as tensors on one device. Per
    sample: (B,) gates (bool) and parameters (fp32); per call: 0-d."""

    # stage 1: brightness/contrast (pick) | illumination
    gate_1: torch.Tensor
    pick_1: torch.Tensor
    alpha: torch.Tensor          # 1 + contrast
    beta: torch.Tensor           # brightness
    illum_axis: torch.Tensor     # (B,) int64 in {0, 1, 2}
    illum_strength: torch.Tensor
    illum_direction: torch.Tensor  # (B,) -1.0 or 1.0
    # stage 2: multiplicative (pick) | gaussian noise
    gate_2: torch.Tensor
    pick_2: torch.Tensor
    mult_factor: torch.Tensor
    noise_std: torch.Tensor
    noise: torch.Tensor          # (B, D, H, W, C) fp32 standard normal
    # stage 3: blur
    gate_blur: torch.Tensor
    blur_type: torch.Tensor      # 0-d int64, an index into BLUR_TYPES
    motion_half: torch.Tensor    # 0-d int64 in {1, 2, 3}
    motion_angle: torch.Tensor   # 0-d fp32 in [0, pi)
    defocus_r: torch.Tensor      # 0-d int64 in DEFOCUS_RADIUS
    blur_sy: torch.Tensor        # 0-d fp32 in ADVANCED_BLUR_SIGMA
    blur_sx: torch.Tensor
    # cutout
    gate_cutout: torch.Tensor
    hole_count: torch.Tensor     # (B,) int64
    hole_start: torch.Tensor     # (B, max_holes, 3) fp32, whole voxels
    hole_size: torch.Tensor      # (B, max_holes, 3) fp32, whole voxels
    # geometry
    flip: torch.Tensor           # (B, 3) bool, spatial axes (Z, Y, X)
    rot_gate: torch.Tensor       # 0-d bool
    rot_pick: torch.Tensor       # 0-d int64 in [0, 3 * len(choices))

    def to(self, device) -> "AugParams":
        return AugParams(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})


# ----------------------------------------------------------------------
# draws
# ----------------------------------------------------------------------

def draw_params(generator: torch.Generator, b: int,
                spatial: Tuple[int, int, int], cfg: DeviceAugConfig,
                channels: int = 1) -> AugParams:
    """Draws one call's parameters for a batch of ``b`` samples of
    ``spatial`` extent and ``channels`` image channels, on the generator's
    device, as the JAX ``augment`` draws them (uniforms as
    ``lo + u * (hi - lo)`` in fp32, gates as ``u < p``)."""
    dev = generator.device

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def uniform(shape, lo, hi):
        return rand(*shape) * (hi - lo) + lo

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=generator, device=dev)

    max_holes = cfg.cutout_holes[1]
    ext = uniform((b, max_holes, 3), *cfg.cutout_extent)
    size = torch.tensor(spatial, dtype=torch.float32, device=dev)
    hole_size = torch.clamp(torch.floor(size * ext), min=1.0)
    hole_start = torch.floor(rand(b, max_holes, 3) * torch.clamp(
        size - hole_size + 1.0, min=1.0))
    fgate = rand(b, 1) < cfg.p_flip_transform
    choices = _square_rot_choices((b,) + tuple(spatial))
    return AugParams(
        gate_1=rand(b) < cfg.p_intensity_1, pick_1=rand(b) < 0.5,
        alpha=1.0 + uniform((b,), *CONTRAST_LIMIT),
        beta=uniform((b,), *BRIGHTNESS_LIMIT),
        illum_axis=randint(0, 3, b),
        illum_strength=uniform((b,), *ILLUMINATION_INTENSITY),
        illum_direction=torch.where(rand(b) < 0.5, -1.0, 1.0),
        gate_2=rand(b) < cfg.p_intensity_2, pick_2=rand(b) < 0.5,
        mult_factor=uniform((b,), *MULT_NOISE_RANGE),
        noise_std=uniform((b,), *GAUSS_NOISE_STD),
        noise=torch.randn((b,) + tuple(spatial) + (channels,),
                          generator=generator, device=dev),
        gate_blur=rand(b) < cfg.p_blur,
        blur_type=randint(0, len(BLUR_TYPES)),
        motion_half=randint(1, (MOTION_SIZE - 1) // 2 + 1),
        motion_angle=uniform((), 0.0, math.pi),
        defocus_r=randint(DEFOCUS_RADIUS[0], DEFOCUS_RADIUS[1] + 1),
        blur_sy=uniform((), *ADVANCED_BLUR_SIGMA),
        blur_sx=uniform((), *ADVANCED_BLUR_SIGMA),
        gate_cutout=rand(b) < cfg.p_cutout,
        hole_count=randint(cfg.cutout_holes[0], cfg.cutout_holes[1] + 1, b),
        hole_start=hole_start, hole_size=hole_size,
        flip=(rand(b, 3) < cfg.p_flip_axis) & fgate,
        rot_gate=rand() < cfg.p_rot90,
        rot_pick=randint(0, 3 * max(1, len(choices))),
    )


# ----------------------------------------------------------------------
# intensity stages (image only)
# ----------------------------------------------------------------------

def _per_sample(x: torch.Tensor) -> torch.Tensor:
    """A (B,) tensor shaped for broadcast against (B, D, H, W, C)."""
    return x.reshape(-1, 1, 1, 1, 1)


def _linspace(n: int, device) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n)`` bit for bit: -(1 - s) + s with
    s = i / (n - 1), and the endpoint exactly 1."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    s = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    return torch.cat([-(1.0 - s) + s, torch.ones(1, device=device)])


def _brightness_contrast(img, p: AugParams):
    out = img * _per_sample(p.alpha) + _per_sample(p.beta)
    return torch.clamp(out, 0.0, 1.0).to(img.dtype)


def _illumination(img, p: AugParams):
    """Linear multiplicative ramp along a per-sample spatial axis."""
    d, h, w = img.shape[1:4]
    dev = img.device
    ramps = (_linspace(d, dev).reshape(1, d, 1, 1, 1),
             _linspace(h, dev).reshape(1, 1, h, 1, 1),
             _linspace(w, dev).reshape(1, 1, 1, w, 1))
    ax = _per_sample(p.illum_axis)
    ramp = sum(torch.where(ax == i, r, 0.0) for i, r in enumerate(ramps))
    scale = _per_sample(p.illum_strength) * _per_sample(p.illum_direction)
    out = img * (1.0 + scale * ramp)
    return torch.clamp(out, 0.0, 1.0).to(img.dtype)


def _mult_noise(img, p: AugParams):
    out = img * _per_sample(p.mult_factor)
    return torch.clamp(out, 0.0, 1.0).to(img.dtype)


def _gauss_noise(img, p: AugParams):
    out = img.float() + _per_sample(p.noise_std) * p.noise
    return torch.clamp(out, 0.0, 1.0).to(img.dtype)


def intensity_1(img, p: AugParams):
    """Stage 1: brightness/contrast where picked, else illumination, on
    the gated samples."""
    stage = torch.where(_per_sample(p.pick_1), _brightness_contrast(img, p),
                        _illumination(img, p))
    return torch.where(_per_sample(p.gate_1), stage, img)


def intensity_2(img, p: AugParams):
    """Stage 2: multiplicative noise where picked, else gaussian noise."""
    stage = torch.where(_per_sample(p.pick_2), _mult_noise(img, p),
                        _gauss_noise(img, p))
    return torch.where(_per_sample(p.gate_2), stage, img)


# ----------------------------------------------------------------------
# blur family: one 2-D kernel per call, applied to every Z slice
# ----------------------------------------------------------------------

def reflect_index(n: int, pad: int, device=None) -> torch.Tensor:
    """Indices of ``jnp.pad(..., mode="reflect")`` along an axis of ``n``
    with ``pad`` on each side, for any pad (numpy reflects again where
    the pad reaches past the edge; ``F.pad`` refuses pad >= n)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _apply_kernel_2d(img, kern):
    """img (B, D, H, W, C), kern (k, k) -> the reflect-padded depthwise
    2-D cross-correlation over every (H, W) slice, in fp32 (JAX:
    ``lax.conv_general_dilated`` with ``feature_group_count=C``)."""
    b, d, h, w, c = img.shape
    k = kern.shape[-1]
    pad = (k - 1) // 2
    x = img.float().reshape(b * d, h, w, c).permute(0, 3, 1, 2)
    x = x[:, :, reflect_index(h, pad, img.device)]
    x = x[:, :, :, reflect_index(w, pad, img.device)]
    weight = kern.float().expand(c, 1, k, k)
    out = F.conv2d(x, weight, groups=c)
    return out.permute(0, 2, 3, 1).reshape(b, d, h, w, c).to(img.dtype)


def motion_kernel(half, angle) -> torch.Tensor:
    """The (7, 7) line kernel of length ``2 * half + 1`` at ``angle``: a
    binary hit mask (samples that round onto one cell count once),
    normalized, as the host ``motion_blur`` / albumentations MotionBlur."""
    dev = angle.device
    c = (MOTION_SIZE - 1) / 2.0
    t = torch.arange(-c, c + 1, dtype=torch.float32, device=dev)
    active = torch.abs(t) <= half
    yy = torch.clamp(torch.round(c + t * torch.sin(angle)), 0, MOTION_SIZE - 1)
    xx = torch.clamp(torch.round(c + t * torch.cos(angle)), 0, MOTION_SIZE - 1)
    ii = torch.arange(MOTION_SIZE, dtype=torch.float32, device=dev)
    hit = ((yy[:, None, None] == ii[None, :, None])
           & (xx[:, None, None] == ii[None, None, :])
           & active[:, None, None])
    kern = hit.any(dim=0).float()
    return kern / torch.clamp(kern.sum(), min=1.0)


def defocus_kernel(r) -> torch.Tensor:
    """The normalized disk of radius ``r`` on the largest radius's
    (21, 21) support."""
    rad = DEFOCUS_RADIUS[1]
    ax = torch.arange(-rad, rad + 1, dtype=torch.float32, device=r.device)
    disk = (ax[:, None] ** 2 + ax[None, :] ** 2) <= r * r
    kern = disk.float()
    return kern / kern.sum()


def advanced_kernel(sy, sx) -> torch.Tensor:
    """The normalized (9, 9) Gaussian with independent sigmas."""
    ax = torch.arange(-ADVANCED_SUPPORT, ADVANCED_SUPPORT + 1,
                      dtype=torch.float32, device=sy.device)
    kern = torch.exp(-(ax[:, None] ** 2 / (2 * (sy * sy))
                       + ax[None, :] ** 2 / (2 * (sx * sx))))
    return kern / kern.sum()


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """The (n_in, n_out) weights of ``jax.image.resize``'s linear kernel
    along one axis (``compute_weight_mat``): a triangle at half-pixel
    centres, widened by 1 / scale when shrinking (antialias), each column
    renormalized, zero where the sample lies outside the input."""
    inv = 1.0 / (n_out / n_in)     # as JAX derives it from the scale
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / max(inv, 1.0)
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * torch.finfo(torch.float32).eps,
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_hw(x, h: int, w: int):
    """``jax.image.resize(x, (B, D, h, w, C), "linear")`` of an fp32
    (B, D, H, W, C) tensor: the per-axis weights applied as two matmuls
    (an axis whose extent does not change is left as it is)."""
    _, _, h0, w0, _ = x.shape
    if h != h0:
        x = torch.einsum("bdhwc,hH->bdHwc", x,
                         _resize_weights(h0, h, x.device))
    if w != w0:
        x = torch.einsum("bdhwc,wW->bdhWc", x,
                         _resize_weights(w0, w, x.device))
    return x


def _downscale(img):
    """Fixed 0.25 scale: the exact 4x4 box mean at multiple-of-4 extents
    (INTER_AREA at 1/4), else the antialiased linear resize down, and the
    linear resize back up (host analog: downscale)."""
    b, d, h, w, c = img.shape
    x = img.float()
    if h % 4 or w % 4:
        small = resize_hw(x, max(1, h // 4), max(1, w // 4))
    else:
        small = x.reshape(b, d, h // 4, 4, w // 4, 4, c).mean(dim=(3, 5))
    return resize_hw(small, h, w).to(img.dtype)


def blur(img, p: AugParams, blur_type: int):
    """Stage 3: the call's blur type on the gated samples."""
    kind = BLUR_TYPES[blur_type]
    if kind == "downscale":
        out = _downscale(img)
    else:
        kern = {"motion": lambda: motion_kernel(p.motion_half,
                                                p.motion_angle),
                "defocus": lambda: defocus_kernel(p.defocus_r),
                "advanced": lambda: advanced_kernel(p.blur_sy, p.blur_sx),
                }[kind]()
        out = _apply_kernel_2d(img, kern)
    return torch.where(_per_sample(p.gate_blur), out, img)


# ----------------------------------------------------------------------
# cutout (CoarseDropout3D; reference: dataset.py:193-201)
# ----------------------------------------------------------------------

def cutout_mask(hole_count, hole_start, hole_size, spatial) -> torch.Tensor:
    """Boolean (B, D, H, W) union of each sample's first ``hole_count``
    boxes [start, start + size) per axis."""
    b, max_holes = hole_start.shape[:2]
    box = None
    for a, n in enumerate(spatial):
        shape = [1, 1, 1, 1, 1]
        shape[a + 2] = n
        ii = torch.arange(n, dtype=torch.float32,
                          device=hole_start.device).reshape(shape)
        lo = hole_start[:, :, a].reshape(b, max_holes, 1, 1, 1)
        hi = (hole_start[:, :, a] + hole_size[:, :, a]).reshape(
            b, max_holes, 1, 1, 1)
        in_axis = (ii >= lo) & (ii < hi)
        box = in_axis if box is None else box & in_axis
    active = torch.arange(max_holes, device=hole_start.device)[None, :] \
        < hole_count[:, None]
    return torch.any(box & active.reshape(b, max_holes, 1, 1, 1), dim=1)


def cutout(img, p: AugParams, cfg: DeviceAugConfig):
    """The cutout stage: the boxes filled with ``cfg.cutout_fill`` on the
    gated samples."""
    mask = cutout_mask(p.hole_count, p.hole_start, p.hole_size,
                       img.shape[1:4])
    fill = torch.tensor(cfg.cutout_fill, dtype=img.dtype, device=img.device)
    out = torch.where(mask[..., None], fill, img)
    return torch.where(_per_sample(p.gate_cutout), out, img)


# ----------------------------------------------------------------------
# geometric: per-sample flips, per-call rot90 (normals-aware)
# ----------------------------------------------------------------------

def flip_batch(data: Dict[str, torch.Tensor], flags: torch.Tensor,
               normal_keys=_NORMAL_KEYS) -> Dict[str, torch.Tensor]:
    """Per-sample flips. ``flags`` (B, 3) bools for the spatial axes
    (Z, Y, X); normals components negate per the host table (Z->nz,
    Y->ny, X->nx; data/augment.py::flip_with_normals)."""
    b = flags.shape[0]
    out = {}
    for k, arr in data.items():
        v = arr
        for axis in range(3):
            f = flags[:, axis].reshape((b,) + (1,) * (arr.dim() - 1))
            v = torch.where(f, torch.flip(v, dims=(axis + 1,)), v)
        if k in normal_keys and arr.dim() == 5 and arr.shape[-1] == 3:
            # axis -> component: 0(Z)->nz(2), 1(Y)->ny(1), 2(X)->nx(0)
            sign = torch.where(flags.flip(1), -1.0, 1.0).to(v.dtype)
            v = v * sign[:, None, None, None, :]
        out[k] = v
    return out


def rot90_tree(data: Dict[str, torch.Tensor], axis: str, k: int,
               normal_keys=_NORMAL_KEYS) -> Dict[str, torch.Tensor]:
    """``np.rot90(arr, k, axes=plane)`` on every tensor (batch axis
    leading) with the normals component permutation of
    data/augment.py::rot90_with_normals."""
    a0, a1 = _ROT_PLANES[axis]
    out = {}
    for key, arr in data.items():
        v = torch.rot90(arr, k, dims=(a0 + 1, a1 + 1))
        if key in normal_keys and arr.dim() == 5 and arr.shape[-1] == 3:
            v = torch.stack(_rotate_components(v[..., 0], v[..., 1],
                                               v[..., 2], axis, k), dim=-1)
        out[key] = v
    return out


def _square_rot_choices(shape) -> Tuple[str, ...]:
    """Axes whose rotation plane is square for this batch shape."""
    return tuple(a for a, (i, j) in _ROT_PLANES.items()
                 if shape[i + 1] == shape[j + 1])


def geometry(batch: Dict[str, torch.Tensor], p: AugParams,
             cfg: DeviceAugConfig, rot_gate: bool,
             rot_pick: int) -> Dict[str, torch.Tensor]:
    """Per-sample flips of every tensor, then the call's rot90."""
    batch = flip_batch(batch, p.flip, cfg.normal_keys)
    choices = _square_rot_choices(batch["image"].shape)
    if choices and cfg.p_rot90 > 0 and rot_gate:
        batch = rot90_tree(batch, choices[rot_pick // 3], rot_pick % 3 + 1,
                           cfg.normal_keys)
    return batch


# ----------------------------------------------------------------------
# composed pipeline
# ----------------------------------------------------------------------

def apply(batch: Dict[str, torch.Tensor], params: AugParams,
          cfg: DeviceAugConfig) -> Dict[str, torch.Tensor]:
    """The JAX ``augment`` with these draws: intensity 1, intensity 2,
    blur, cutout on the image, then flips and rot90 on every tensor.
    ``batch`` is the decoded batch ('image' plus task targets, all
    (B, *spatial, C)); a batch that is not 3-D passes through."""
    img = batch["image"]
    if img.dim() != 5:
        return batch
    blur_type, rot_gate, rot_pick = torch.stack(
        [params.blur_type, params.rot_gate.long(), params.rot_pick]).tolist()
    img = intensity_1(img, params)
    img = intensity_2(img, params)
    img = blur(img, params, blur_type)
    img = cutout(img, params, cfg)
    return geometry({**batch, "image": img}, params, cfg, bool(rot_gate),
                    rot_pick)


def make_device_augment(cfg: Optional[DeviceAugConfig] = None
                        ) -> Callable[[Dict[str, torch.Tensor],
                                       torch.Generator],
                                      Dict[str, torch.Tensor]]:
    """Returns ``augment(batch, generator) -> batch``: :func:`apply` after
    :func:`draw_params` from ``generator``, for ``make_train_step``'s
    ``augment_fn``."""
    cfg = cfg or DeviceAugConfig()

    def augment(batch: Dict[str, torch.Tensor],
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
        img = batch["image"]
        if img.dim() != 5:
            return batch
        params = draw_params(generator, img.shape[0], tuple(img.shape[1:4]),
                             cfg, channels=img.shape[-1])
        return apply(batch, params, cfg)

    return augment
