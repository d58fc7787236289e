"""Host-side augmentation stack in NumPy (per-sample, thread-parallel).

A copy of ``mt3d_resenc_unet_tpu/data/augment.py``. ``cv2`` stays
optional, as there: without it the 2-D filters and the downscale run on
``scipy.ndimage`` (slower per slice, same op set and probabilities).

Capability parity with the reference's pipeline:

* intensity augmentations on the image only, mirroring the albumentations
  stack (reference: dataloading/dataset.py:176-209): OneOf(brightness/contrast,
  illumination) p=0.3; OneOf(multiplicative noise, gaussian noise) p=0.35;
  OneOf(motion blur, defocus, downscale, advanced blur) p=0.4; 3-D coarse
  dropout p=0.5 with fill 0.5, 1-4 holes of 10-40%% extent per axis.
* normals-aware geometric augmentations — random flips and 90-degree
  rotations that also transform the normal-vector components — with the
  semantics of the reference's (unwired) transforms
  (reference: training/transforms/geometric/geometry.py:5-148). Unlike the
  reference, these ARE wired into the dataset (SURVEY.md §2.1 flags them as a
  core capability left unconnected).

Layout: all arrays are channels-last — (Z, Y, X) or (Z, Y, X, C); normals
channels are ordered (nx, ny, nz) with x the fastest spatial axis, matching
the reference's CZYX component convention transposed to channels-last.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

from scipy import ndimage as ndi


# ----------------------------------------------------------------------
# intensity transforms (image only, float volume roughly in [0, 1])
# ----------------------------------------------------------------------

# The reference composes each transform with albumentations DEFAULT
# parameters (dataset.py:176-191 passes no kwargs). The ranges below mirror
# the albumentations-2.x defaults the reference therefore runs with; any
# deliberate divergence is called out on the function. Pinned by
# tests/test_augment.py::test_parameter_ranges_pinned.

# albumentations RandomBrightnessContrast defaults:
# brightness_limit=0.2, contrast_limit=0.2
BRIGHTNESS_LIMIT = (-0.2, 0.2)
CONTRAST_LIMIT = (-0.2, 0.2)
# albumentations Illumination defaults: intensity_range=(0.01, 0.2)
ILLUMINATION_INTENSITY = (0.01, 0.2)
# albumentations MultiplicativeNoise defaults: multiplier=(0.9, 1.1),
# elementwise=False (one factor per image)
MULT_NOISE_RANGE = (0.9, 1.1)
# albumentations GaussNoise defaults: std_range=(0.2, 0.44) RELATIVE to the
# value range — far stronger than useful for CT slices; we deliberately use
# (0.01, 0.05) absolute on [0,1] data (divergence, documented)
GAUSS_NOISE_STD = (0.01, 0.05)
# albumentations MotionBlur default blur_limit=7 -> odd kernels in [3, 7]
MOTION_BLUR_KERNELS = (3, 5, 7)
# albumentations Defocus defaults: radius=(3, 10)
DEFOCUS_RADIUS = (3, 10)
# albumentations Downscale defaults: scale_range=(0.25, 0.25)
DOWNSCALE_RANGE = (0.25, 0.25)
# albumentations AdvancedBlur defaults: sigma_x/y range (0.2, 1.0)
# (we apply the Gaussian directly instead of a truncated kernel)
ADVANCED_BLUR_SIGMA = (0.2, 1.0)


def brightness_contrast(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    alpha = 1.0 + rng.uniform(*CONTRAST_LIMIT)   # contrast
    beta = rng.uniform(*BRIGHTNESS_LIMIT)        # brightness
    return np.clip(x * alpha + beta, 0.0, 1.0)


def illumination(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Smooth multiplicative gradient along a random axis (the linear mode of
    albumentations Illumination)."""
    axis = int(rng.integers(0, 3))
    strength = rng.uniform(*ILLUMINATION_INTENSITY)
    n = x.shape[axis]
    ramp = np.linspace(-strength, strength, n, dtype=np.float32)
    if rng.random() < 0.5:
        ramp = ramp[::-1]
    shape = [1, 1, 1]
    shape[axis] = n
    return np.clip(x * (1.0 + ramp.reshape(shape)), 0.0, 1.0)


def multiplicative_noise(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    factor = rng.uniform(*MULT_NOISE_RANGE)
    return np.clip(x * factor, 0.0, 1.0)


def gaussian_noise(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    std = rng.uniform(*GAUSS_NOISE_STD)
    return np.clip(x + rng.normal(0.0, std, size=x.shape).astype(np.float32),
                   0.0, 1.0)


def _filter2d_slices(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Apply a 2-D kernel to every Z slice."""
    out = np.empty_like(x)
    if _HAS_CV2:
        for z in range(x.shape[0]):
            out[z] = cv2.filter2D(x[z], -1, kernel)
    else:
        for z in range(x.shape[0]):
            out[z] = ndi.convolve(x[z], kernel, mode="reflect")
    return out


def motion_blur(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    k = int(MOTION_BLUR_KERNELS[int(rng.integers(0, len(MOTION_BLUR_KERNELS)))])
    kernel = np.zeros((k, k), np.float32)
    angle = rng.uniform(0, np.pi)
    c = (k - 1) / 2
    for i in range(k):
        t = i - c
        yy = int(round(c + t * np.sin(angle)))
        xx = int(round(c + t * np.cos(angle)))
        kernel[np.clip(yy, 0, k - 1), np.clip(xx, 0, k - 1)] = 1.0
    kernel /= kernel.sum()
    return _filter2d_slices(x, kernel)


def defocus(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    radius = int(rng.integers(DEFOCUS_RADIUS[0], DEFOCUS_RADIUS[1] + 1))
    k = 2 * radius + 1
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    kernel = ((yy ** 2 + xx ** 2) <= radius ** 2).astype(np.float32)
    kernel /= kernel.sum()
    return _filter2d_slices(x, kernel)


def downscale(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    scale = rng.uniform(*DOWNSCALE_RANGE)
    h, w = x.shape[1], x.shape[2]
    nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
    out = np.empty_like(x)
    if _HAS_CV2:
        for z in range(x.shape[0]):
            small = cv2.resize(x[z], (nw, nh), interpolation=cv2.INTER_AREA)
            out[z] = cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)
    else:
        zoom = (nh / h, nw / w)
        for z in range(x.shape[0]):
            small = ndi.zoom(x[z], zoom, order=1)
            out[z] = ndi.zoom(small, (h / small.shape[0], w / small.shape[1]), order=1)
            out[z] = out[z][:h, :w]
    return out


def advanced_blur(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    sy = rng.uniform(*ADVANCED_BLUR_SIGMA)
    sx = rng.uniform(*ADVANCED_BLUR_SIGMA)
    return ndi.gaussian_filter(x, sigma=(0.0, sy, sx), mode="reflect")


def coarse_dropout_3d(x: np.ndarray, rng: np.random.Generator,
                      fill: float = 0.5,
                      num_holes: Tuple[int, int] = (1, 4),
                      extent: Tuple[float, float] = (0.1, 0.4)) -> np.ndarray:
    """Volumetric cutout (reference: dataset.py:193-201 CoarseDropout3D)."""
    out = x.copy()
    d, h, w = x.shape[:3]
    for _ in range(int(rng.integers(num_holes[0], num_holes[1] + 1))):
        hd = max(1, int(d * rng.uniform(*extent)))
        hh = max(1, int(h * rng.uniform(*extent)))
        hw = max(1, int(w * rng.uniform(*extent)))
        z0 = int(rng.integers(0, max(1, d - hd + 1)))
        y0 = int(rng.integers(0, max(1, h - hh + 1)))
        x0 = int(rng.integers(0, max(1, w - hw + 1)))
        out[z0:z0 + hd, y0:y0 + hh, x0:x0 + hw] = fill
    return out


# ----------------------------------------------------------------------
# normals-aware geometric transforms
# ----------------------------------------------------------------------

_NORMAL_KEYS = ("normals",)


def flip_with_normals(data: Dict[str, np.ndarray], axis: int,
                      normal_keys=_NORMAL_KEYS) -> Dict[str, np.ndarray]:
    """Flip all arrays along spatial axis (0=Z, 1=Y, 2=X) and negate the
    matching normal component: Z->nz, Y->ny, X->nx
    (reference semantics: geometry.py:36-67, adapted to channels-last)."""
    comp = {0: 2, 1: 1, 2: 0}[axis]
    out = {}
    for k, arr in data.items():
        flipped = np.flip(arr, axis=axis).copy()
        if k in normal_keys and arr.ndim == 4:
            flipped[..., comp] = -flipped[..., comp]
        out[k] = flipped
    return out


# rot90 component remapping tables: (axis, k) -> function of (nx, ny, nz).
# Derived from right-handed 90-degree rotations of the (x, y, z) vector basis
# consistent with np.rot90 on the corresponding spatial plane
# (reference semantics: geometry.py:119-140).
def _rotate_components(nx, ny, nz, axis: str, k: int):
    if axis == "z":
        if k == 1:
            return ny, -nx, nz
        if k == 2:
            return -nx, -ny, nz
        return -ny, nx, nz
    if axis == "y":
        if k == 1:
            return nz, ny, -nx
        if k == 2:
            return -nx, ny, -nz
        return -nz, ny, nx
    # axis == 'x'
    if k == 1:
        return nx, nz, -ny
    if k == 2:
        return nx, -ny, -nz
    return nx, -nz, ny


_ROT_PLANES = {"z": (1, 2), "y": (0, 2), "x": (0, 1)}  # spatial axes (Z,Y,X)


def rot90_with_normals(data: Dict[str, np.ndarray], axis: str, k: int,
                       normal_keys=_NORMAL_KEYS) -> Dict[str, np.ndarray]:
    """Rotate all arrays k*90 degrees about the given axis and permute normal
    components accordingly."""
    plane = _ROT_PLANES[axis]
    out = {}
    for key, arr in data.items():
        rot = np.rot90(arr, k=k, axes=plane).copy()
        if key in normal_keys and arr.ndim == 4:
            nx = rot[..., 0].copy()
            ny = rot[..., 1].copy()
            nz = rot[..., 2].copy()
            rx, ry, rz = _rotate_components(nx, ny, nz, axis, k)
            rot[..., 0], rot[..., 1], rot[..., 2] = rx, ry, rz
        out[key] = rot
    return out


# ----------------------------------------------------------------------
# composed (single-copy) geometric application
# ----------------------------------------------------------------------
#
# flip_with_normals / rot90_with_normals above are the semantic definition
# (and the unit-test surface); applying them sequentially costs one full
# strided copy of EVERY array per op — measured ~0.3 s per 128^3 copy, the
# dominant cost of the whole sample path. The pipeline instead composes all
# sampled ops into one (axis permutation, reversal flags, signed 3x3
# component matrix) and applies them with a single copy per array.

def _compose_canonical(p1, f1, p2, f2):
    """Compose canonical transforms (transpose perm then reverse flagged
    axes): t1 applied first, then t2."""
    return ([p1[p2[o]] for o in range(3)],
            [f1[p2[o]] ^ f2[o] for o in range(3)])


def _flip_canonical(axis: int):
    f = [False, False, False]
    f[axis] = True
    return list(range(3)), f


def _rot90_canonical(axis: str, k: int):
    """np.rot90(m, k, axes=_ROT_PLANES[axis]) as a canonical transform.
    One rot90 step about (a0, a1) is transpose(swap(a0, a1)) + reverse a0."""
    a0, a1 = _ROT_PLANES[axis]
    perm, flip = list(range(3)), [False] * 3
    step_p = list(range(3))
    step_p[a0], step_p[a1] = a1, a0
    step_f = [False] * 3
    step_f[a0] = True
    for _ in range(k % 4):
        perm, flip = _compose_canonical(perm, flip, step_p, step_f)
    return perm, flip


def _flip_comp_matrix(axis: int) -> np.ndarray:
    m = np.eye(3, dtype=np.float32)
    m[{0: 2, 1: 1, 2: 0}[axis]] *= -1.0
    return m


def _rot90_comp_matrix(axis: str, k: int) -> np.ndarray:
    k = k % 4
    if k == 0:
        return np.eye(3, dtype=np.float32)
    m = np.zeros((3, 3), dtype=np.float32)
    for j in range(3):
        e = [0.0, 0.0, 0.0]
        e[j] = 1.0
        m[:, j] = _rotate_components(e[0], e[1], e[2], axis, k)
    return m


def apply_geometric_ops(data: Dict[str, np.ndarray], ops,
                        normal_keys=_NORMAL_KEYS) -> Dict[str, np.ndarray]:
    """Apply a sequence of [("flip", axis) | ("rot90", axis, k)] ops with one
    copy per array. Equivalent to chaining flip_with_normals /
    rot90_with_normals (asserted by tests/test_augment.py)."""
    perm, flip = list(range(3)), [False] * 3
    comp = np.eye(3, dtype=np.float32)
    for op in ops:
        if op[0] == "flip":
            p2, f2 = _flip_canonical(op[1])
            comp = _flip_comp_matrix(op[1]) @ comp
        else:
            p2, f2 = _rot90_canonical(op[1], op[2])
            comp = _rot90_comp_matrix(op[1], op[2]) @ comp
        perm, flip = _compose_canonical(perm, flip, p2, f2)
    src = np.argmax(np.abs(comp), axis=1)
    sign = comp[np.arange(3), src].astype(np.float32)

    out = {}
    sl = tuple(slice(None, None, -1) if f else slice(None) for f in flip)
    for key, arr in data.items():
        p = tuple(perm) + tuple(range(3, arr.ndim))
        v = arr.transpose(p)[sl]
        if key in normal_keys and arr.ndim == 4:
            if arr.dtype == np.uint16:
                # wire mode: normals stay uint16-ENCODED (u = (n+1)*32767.5,
                # zio.py codec) through the host path; component negation is
                # exact in encoded space: encode(-n) = 65535 - encode(n)
                v = np.ascontiguousarray(v[..., src])
                for j in np.nonzero(sign < 0)[0]:
                    np.subtract(np.uint16(65535), v[..., j], out=v[..., j])
                out[key] = v
            else:
                # signed component permutation fused into the gather copy
                v = v[..., src] * sign
                out[key] = np.ascontiguousarray(v, dtype=np.float32)
        else:
            out[key] = np.ascontiguousarray(v)
    return out


# ----------------------------------------------------------------------
# composed pipeline
# ----------------------------------------------------------------------

@dataclasses.dataclass
class AugmentationPipeline:
    """Stochastic pipeline applied per sample.

    Probabilities mirror the reference (dataset.py:176-201); geometric
    transforms are additive capability (p_flip/p_rot90 default 0.5/0.25,
    matching the defaults of the reference's unwired geometry classes).
    """

    p_intensity_1: float = 0.3   # brightness/contrast | illumination
    p_intensity_2: float = 0.35  # mult noise | gauss noise
    p_blur: float = 0.4          # motion | defocus | downscale | advanced
    p_cutout: float = 0.5
    p_flip_axis: float = 0.5
    p_flip_transform: float = 0.5
    p_rot90: float = 0.25
    enable_geometric: bool = True
    normal_keys: Tuple[str, ...] = _NORMAL_KEYS

    def __call__(self, data: Dict[str, np.ndarray],
                 rng: np.random.Generator) -> Dict[str, np.ndarray]:
        img = np.asarray(data["image"])
        squeeze = img.ndim == 4 and img.shape[-1] == 1
        # lazy decode: in wire mode the image arrives as its stored integer
        # dtype and only pays the float conversion when an intensity op
        # actually fires (P(no op) ~ 0.14 at the default gates); the rng draw
        # order is IDENTICAL to eager application
        vol = None

        def _vol():
            nonlocal vol
            if vol is None:
                from .zio import normalize_to_unit
                x = (img if img.dtype == np.float32
                     else normalize_to_unit(img, img.dtype))
                vol = np.asarray(x[..., 0] if squeeze else x, np.float32)
            return vol

        if rng.random() < self.p_intensity_1:
            fn = brightness_contrast if rng.random() < 0.5 else illumination
            vol = fn(_vol(), rng)
        if rng.random() < self.p_intensity_2:
            fn = multiplicative_noise if rng.random() < 0.5 else gaussian_noise
            vol = fn(_vol(), rng)
        if rng.random() < self.p_blur:
            fn = (motion_blur, defocus, downscale, advanced_blur)[int(rng.integers(0, 4))]
            vol = fn(_vol(), rng)
        if rng.random() < self.p_cutout:
            vol = coarse_dropout_3d(_vol(), rng)

        data = dict(data)
        if vol is not None:
            data["image"] = vol[..., None] if squeeze else vol

        if self.enable_geometric:
            # sample the op sequence with the SAME rng draw order as the
            # sequential implementation, then apply all ops in one pass
            ops = []
            if rng.random() < self.p_flip_transform:
                for axis in (0, 1, 2):
                    if rng.random() < self.p_flip_axis:
                        ops.append(("flip", axis))
            if rng.random() < self.p_rot90:
                # only rotate in planes where the two axes have equal extent
                # (rot90 of a non-square plane would change the patch shape)
                img_shape = data["image"].shape
                choices = [a for a, (i, j) in _ROT_PLANES.items()
                           if img_shape[i] == img_shape[j]]
                if choices:
                    axis = choices[int(rng.integers(0, len(choices)))]
                    k = int(rng.integers(1, 4))
                    ops.append(("rot90", axis, k))
            if ops:
                data = apply_geometric_ops(data, ops, self.normal_keys)
        return data
