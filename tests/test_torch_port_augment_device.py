"""The port's device augmentation (``data/augment_device.py``) against the
JAX package's, on the CPU.

The JAX ``make_device_augment`` draws from a threefry key; the port draws
from a ``torch.Generator``. To hold the arithmetic, the tests replay the
JAX ``augment``'s key splits (``jax_params``) and hand the port the very
numbers JAX drew, as an ``AugParams``:

* flips and rot90 (every axis and k) and the cutout mask from the same
  boxes: bit-equal (they move or select values);
* the downscale at multiple-of-4 and other extents: within FP32_TOL;
* the motion, defocus and advanced-blur kernels from JAX's own draws, read
  as the blur of a one-voxel impulse: within KERNEL_TOL;
* the whole ``apply`` against ``make_device_augment(cfg)(batch, key)``:
  fp32 images within FP32_TOL, bf16 images within one bf16 ulp, targets
  bit-equal; with every probability 0 (the identity), every probability 1
  with each blur type, and the defaults, at 8^3 (smaller than the defocus
  pad of 10, where ``jnp.pad`` reflects again), (8, 12, 12) and the
  non-multiple-of-4 (7, 10, 10).

Then the port's own draws: gate frequencies at p, per-microbatch draws in
``make_train_step(augment_fn=...)``, and ``Trainer`` with
``augment_on_device: true``, whose dataset does not augment on the host.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.data import augment_device as jad
from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_autoconfig
from mt3d_resenc_unet_torch.data import augment_device as tad
from mt3d_resenc_unet_torch.models.network import ResEncUNet
from mt3d_resenc_unet_torch.tools.synthetic_data import write_sheet_dataset
from mt3d_resenc_unet_torch.train import step as ts
from mt3d_resenc_unet_torch.train.losses import build_task_losses
from mt3d_resenc_unet_torch.train.trainer import Trainer

FP32_TOL = 1e-5      # max abs, images in [0, 1]
KERNEL_TOL = 1e-6    # max abs of a kernel's taps
BF16_ULPS = 1        # bf16 images: within one ulp of the larger value
ALL_ON = dict(p_intensity_1=1.0, p_intensity_2=1.0, p_blur=1.0, p_cutout=1.0,
              p_flip_axis=1.0, p_flip_transform=1.0, p_rot90=1.0)
ALL_OFF = {k: 0.0 for k in ALL_ON}


def _batch(shape, seed=0, dtype=np.float32):
    """(B, D, H, W) -> image (C=1), sheet and unit normals, from numpy."""
    rng = np.random.default_rng(seed)
    vec = rng.standard_normal(shape + (3,)).astype(np.float32)
    vec /= np.maximum(np.linalg.norm(vec, axis=-1, keepdims=True), 1e-6)
    return {"image": rng.random(shape + (1,), np.float32).astype(dtype),
            "sheet": (rng.random(shape + (1,)) > 0.5).astype(np.float32),
            "normals": vec}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in batch.items()}


def _np(t):
    return t.float().numpy()


def _cutout_boxes(key, b, spatial, holes, extent):
    """The boxes JAX ``_cutout_mask`` draws from ``key``: (count (B,),
    start (B, holes, 3), size (B, holes, 3))."""
    kn, kb = jax.random.split(key)
    n = jax.random.randint(kn, (b, 1), holes[0], holes[1] + 1)
    keys = jax.random.split(kb, 2 * len(spatial))
    starts, sizes = [], []
    for a, size in enumerate(spatial):
        ext = jax.random.uniform(keys[2 * a], (b, holes[1]), jnp.float32,
                                 *extent)
        hs = jnp.maximum(1, jnp.floor(size * ext))
        start = jnp.floor(jax.random.uniform(keys[2 * a + 1], (b, holes[1]))
                          * jnp.maximum(1.0, size - hs + 1.0))
        starts.append(np.asarray(start, np.float32))
        sizes.append(np.asarray(hs, np.float32))
    return (torch.from_numpy(np.asarray(n)[:, 0].astype(np.int64)),
            torch.from_numpy(np.stack(starts, -1)),
            torch.from_numpy(np.stack(sizes, -1)))


def jax_params(key, shape, cfg) -> tad.AugParams:
    """The numbers JAX ``make_device_augment(cfg)(batch, key)`` draws for
    an image of ``shape``, replayed split for split (augment_device.py
    ``augment`` and its stages), as the port's ``AugParams``."""
    b, spatial = shape[0], tuple(shape[1:4])
    keys = jax.random.split(key, 12)

    def t(x, dtype=None):
        x = torch.from_numpy(np.array(x))
        return x if dtype is None else x.to(dtype)

    def u(k, s, lo, hi):
        return t(jax.random.uniform(k, s, jnp.float32, lo, hi))

    def bern(k, p, s):
        return t(jax.random.bernoulli(k, float(p), s))

    ka, kb = jax.random.split(keys[2])
    k1, k2, k3 = jax.random.split(keys[2], 3)
    n1, n2 = jax.random.split(keys[5])
    m1, m2 = jax.random.split(keys[8])
    count, start, size = _cutout_boxes(keys[10], b, spatial,
                                       cfg.cutout_holes, cfg.cutout_extent)
    gk = jax.random.split(keys[11], 4)
    choices = jad._square_rot_choices(shape)
    rotates = bool(choices) and cfg.p_rot90 > 0
    fgate = np.asarray(jax.random.bernoulli(gk[0], float(cfg.p_flip_transform),
                                            (b, 1)))
    flags = np.asarray(jax.random.bernoulli(gk[1], float(cfg.p_flip_axis),
                                            (b, 3))) & fgate
    return tad.AugParams(
        gate_1=bern(keys[0], cfg.p_intensity_1, (b,)),
        pick_1=bern(keys[1], 0.5, (b,)),
        alpha=1.0 + u(ka, (b,), *jad.CONTRAST_LIMIT),
        beta=u(kb, (b,), *jad.BRIGHTNESS_LIMIT),
        illum_axis=t(jax.random.randint(k1, (b,), 0, 3), torch.int64),
        illum_strength=u(k2, (b,), *jad.ILLUMINATION_INTENSITY),
        illum_direction=t(jnp.where(jax.random.uniform(k3, (b,)) < 0.5,
                                    -1.0, 1.0), torch.float32),
        gate_2=bern(keys[3], cfg.p_intensity_2, (b,)),
        pick_2=bern(keys[4], 0.5, (b,)),
        mult_factor=u(keys[5], (b,), *jad.MULT_NOISE_RANGE),
        noise_std=u(n1, (b,), *jad.GAUSS_NOISE_STD),
        noise=t(jax.random.normal(n2, shape, jnp.float32)),
        gate_blur=bern(keys[6], cfg.p_blur, (b,)),
        blur_type=t(jax.random.randint(keys[7], (), 0, 4), torch.int64),
        motion_half=t(jax.random.randint(m1, (), 1, 4), torch.int64),
        motion_angle=u(m2, (), 0.0, np.pi),
        defocus_r=t(jax.random.randint(keys[8], (), jad.DEFOCUS_RADIUS[0],
                                       jad.DEFOCUS_RADIUS[1] + 1),
                    torch.int64),
        blur_sy=u(m1, (), *jad.ADVANCED_BLUR_SIGMA),
        blur_sx=u(m2, (), *jad.ADVANCED_BLUR_SIGMA),
        gate_cutout=bern(keys[9], cfg.p_cutout, (b,)),
        hole_count=count, hole_start=start, hole_size=size,
        flip=t(flags),
        rot_gate=(bern(gk[2], cfg.p_rot90, ()) if rotates
                  else torch.tensor(False)),
        rot_pick=(t(jax.random.randint(gk[3], (), 0, 3 * len(choices)),
                    torch.int64) if rotates else torch.tensor(0)),
    )


def _key_with_blur(kind, start=0):
    """The first key (from ``start``) whose draw picks blur ``kind``."""
    want = tad.BLUR_TYPES.index(kind)
    for seed in range(start, start + 200):
        key = jax.random.key(seed)
        if int(jax.random.randint(jax.random.split(key, 12)[7], (), 0,
                                  4)) == want:
            return key
    raise AssertionError(kind)


def _bf16_ulp(x):
    """The bf16 ulp of each |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)


# ---------------------------------------------------------------- geometric

@pytest.mark.parametrize("axis", [0, 1, 2, "all"])
def test_flip_batch_matches_jax(axis):
    batch = _batch((4, 6, 7, 8))
    flags = np.zeros((4, 3), bool)
    if axis == "all":
        flags = np.random.default_rng(1).random((4, 3)) < 0.5
        flags[0] = True
    else:
        flags[0, axis] = True          # sample 0 flipped, the rest not
    want = jad._flip_batch(_to_jax(batch), jnp.asarray(flags))
    got = tad.flip_batch(_to_torch(batch), torch.from_numpy(flags))
    for k in batch:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("axis", ["z", "y", "x"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_rot90_tree_matches_jax(axis, k):
    batch = _batch((2, 6, 6, 6))
    want = jad._rot90_tree(_to_jax(batch), axis, k)
    got = tad.rot90_tree(_to_torch(batch), axis, k)
    for name in batch:
        np.testing.assert_array_equal(_np(got[name]), np.asarray(want[name]),
                                      err_msg=name)


@pytest.mark.parametrize("spatial", [(8, 8, 8), (7, 10, 13)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cutout_mask_matches_jax(spatial, seed):
    key = jax.random.key(seed)
    want = jad._cutout_mask(key, 4, spatial, (1, 4), (0.1, 0.4))
    count, start, size = _cutout_boxes(key, 4, spatial, (1, 4), (0.1, 0.4))
    got = tad.cutout_mask(count, start, size, spatial)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any()


@pytest.mark.parametrize("n", [1, 2, 5, 8, 21])
@pytest.mark.parametrize("pad", [0, 3, 10, 30])
def test_reflect_index_is_numpy_reflect(n, pad):
    x = np.arange(n)
    np.testing.assert_array_equal(tad.reflect_index(n, pad).numpy(),
                                  np.pad(x, pad, mode="reflect"))


# ------------------------------------------------------------------- blur

@pytest.mark.parametrize("shape", [(2, 3, 16, 20, 1), (2, 3, 10, 14, 2),
                                   (1, 2, 3, 5, 1)])
def test_downscale_matches_jax(shape):
    img = np.random.default_rng(0).random(shape, np.float32)
    want = jad._downscale(jnp.asarray(img), None, shape[0])
    got = tad._downscale(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), 0,
                               FP32_TOL)


@pytest.mark.parametrize("kind", ["motion", "defocus", "advanced"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_blur_kernels_match_jax(kind, seed):
    """A one-voxel impulse at the centre of a 23^2 slice blurs into the
    kernel itself (mirrored), so the two outputs compare the kernels."""
    img = np.zeros((1, 1, 23, 23, 1), np.float32)
    img[0, 0, 11, 11, 0] = 1.0
    key = jax.random.split(_key_with_blur(kind, 100 * seed), 12)[8]
    fn = {"motion": jad._motion_blur, "defocus": jad._defocus,
          "advanced": jad._advanced_blur}[kind]
    want = np.asarray(fn(jnp.asarray(img), key, 1))
    p = jax_params(_key_with_blur(kind, 100 * seed), img.shape,
                   jad.DeviceAugConfig())
    kern = {"motion": lambda: tad.motion_kernel(p.motion_half,
                                                p.motion_angle),
            "defocus": lambda: tad.defocus_kernel(p.defocus_r),
            "advanced": lambda: tad.advanced_kernel(p.blur_sy, p.blur_sx),
            }[kind]()
    got = tad._apply_kernel_2d(torch.from_numpy(img), kern).numpy()
    np.testing.assert_allclose(got, want, 0, KERNEL_TOL)
    assert abs(float(kern.sum()) - 1.0) < 1e-6 and want.max() > 0


# --------------------------------------------------------------- pipeline

def _cases():
    cases = [("identity", ALL_OFF, 0), ("defaults", {}, 5),
             ("defaults", {}, 6), ("defaults", {}, 7)]
    cases += [(f"all on, {kind}", ALL_ON, kind) for kind in tad.BLUR_TYPES]
    return cases


_JAX_AUGMENT = {}


def _jax_augment(cfg):
    """One jitted JAX augment per config: its compile (~4 s, every
    lax.switch branch) is shared by the keys of a shape and dtype."""
    if cfg not in _JAX_AUGMENT:
        _JAX_AUGMENT[cfg] = jax.jit(jad.make_device_augment(cfg))
    return _JAX_AUGMENT[cfg]


@pytest.mark.parametrize("shape, dtype", [
    ((2, 8, 8, 8), "float32"), ((2, 8, 8, 8), "bfloat16"),
    ((3, 8, 12, 12), "float32"), ((2, 7, 10, 10), "float32"),
    ((2, 7, 10, 10), "bfloat16")])
@pytest.mark.parametrize("case", _cases(), ids=lambda c: f"{c[0]}-{c[2]}")
def test_apply_matches_make_device_augment(case, shape, dtype):
    label, probs, key = case
    cfg = jad.DeviceAugConfig(**probs)
    key = _key_with_blur(key) if isinstance(key, str) else jax.random.key(key)
    batch = _batch(shape, seed=3)
    jbatch = _to_jax(batch)
    if dtype == "bfloat16":
        jbatch["image"] = jbatch["image"].astype(jnp.bfloat16)
    want = _jax_augment(cfg)(jbatch, key)
    params = jax_params(key, jbatch["image"].shape, cfg)
    tcfg = tad.DeviceAugConfig(**probs)
    got = tad.apply(_to_torch(jbatch), params, tcfg)
    assert got["image"].dtype == (torch.bfloat16 if dtype == "bfloat16"
                                  else torch.float32)
    g = _np(got["image"])
    w = np.asarray(want["image"], np.float32)
    if dtype == "bfloat16":
        ulps = np.abs(g - w) / _bf16_ulp(np.maximum(np.abs(g), np.abs(w)))
        assert np.nanmax(np.where(g == w, 0, ulps)) <= BF16_ULPS, label
    else:
        assert np.abs(g - w).max() <= FP32_TOL, (label, np.abs(g - w).max())
    for k in ("sheet", "normals"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=f"{label} {k}")
    if label == "identity":
        for k in batch:
            np.testing.assert_array_equal(_np(got[k]),
                                          np.asarray(jbatch[k], np.float32))


def test_make_device_augment_is_apply_after_draw_params():
    batch = _to_torch(_batch((2, 8, 8, 8)))
    cfg = tad.DeviceAugConfig(**ALL_ON)
    got = tad.make_device_augment(cfg)(batch, torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(4)
    want = tad.apply(batch, tad.draw_params(gen, 2, (8, 8, 8), cfg), cfg)
    for k in batch:
        assert torch.equal(got[k], want[k]), k
    flat = {"image": torch.rand(2, 8, 8, 1)}    # 2-D batches pass through
    assert tad.make_device_augment()(flat, gen)["image"] is flat["image"]


# -------------------------------------------------------------- the draws

def test_gate_frequencies_follow_p():
    """Over 400 draws of 8 samples each gate fires at its p within 5
    standard deviations; the per-call rot90 gate too (400 draws)."""
    cfg = tad.DeviceAugConfig()
    gen = torch.Generator().manual_seed(0)
    draws = [tad.draw_params(gen, 8, (4, 4, 4), cfg) for _ in range(400)]
    gates = {"gate_1": cfg.p_intensity_1, "gate_2": cfg.p_intensity_2,
             "gate_blur": cfg.p_blur, "gate_cutout": cfg.p_cutout,
             "pick_1": 0.5, "pick_2": 0.5, "rot_gate": cfg.p_rot90}
    for name, p in gates.items():
        x = torch.stack([getattr(d, name) for d in draws]).float()
        sd = (p * (1 - p) / x.numel()) ** 0.5
        assert abs(float(x.mean()) - p) < 5 * sd, (name, float(x.mean()))
    flips = torch.stack([d.flip for d in draws]).float()
    p = cfg.p_flip_axis * cfg.p_flip_transform
    assert abs(float(flips.mean()) - p) < 5 * (p * (1 - p) / 1200) ** 0.5
    kinds = torch.stack([d.blur_type for d in draws])
    assert sorted(set(kinds.tolist())) == [0, 1, 2, 3]
    r = torch.stack([d.defocus_r for d in draws])
    assert int(r.min()) == 3 and int(r.max()) == 10
    counts = torch.stack([d.hole_count for d in draws])
    assert int(counts.min()) == 1 and int(counts.max()) == 4


def test_train_step_draws_per_microbatch():
    """``make_train_step(augment_fn=...)`` with 2 accumulated microbatches
    augments each after its decode with its own draws from the step's
    generator: the draws equal a replay of the generator, and over 4 steps
    the two microbatches of a step draw different blur types."""
    patch = (16, 16, 16)
    model = ResEncUNet(plan_from_autoconfig(
        patch, 1, [TaskHead("sheet", 1, "sigmoid"),
                   TaskHead("normals", 3, "none")],
        base_features=4, max_features=8, use_pallas_conv=False), seed=0)
    losses = build_task_losses({"sheet": {"loss_fn": "BCEDiceLoss"},
                                "normals": {"loss_fn": "MaskedCosineLoss"}})
    cfg = tad.DeviceAugConfig()
    seen = []

    def augment_fn(micro, generator):
        assert micro["image"].dtype == torch.float32   # decoded
        img = micro["image"]
        params = tad.draw_params(generator, img.shape[0],
                                 tuple(img.shape[1:4]), cfg)
        seen.append(params)
        return tad.apply(micro, params, cfg)

    gen = torch.Generator().manual_seed(7)
    step = ts.make_train_step(model, losses, {"sheet": 1.0, "normals": 1.0},
                              grad_accum_steps=2, augment_fn=augment_fn,
                              generator=gen)
    opt = ts.build_optimizer(model.parameters(), "AdamW",
                             ts.cosine_epoch_schedule(1e-3, 10, 1))
    rng = np.random.default_rng(0)
    shape = (4,) + patch
    batch = {"image": rng.integers(0, 256, shape + (1,), dtype=np.uint8),
             "sheet": rng.integers(0, 2, shape + (1,), dtype=np.uint8) * 255,
             "normals": rng.integers(0, 65536, shape + (3,)).astype(
                 np.uint16)}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(4):
        metrics = step(opt, batch)
        assert np.isfinite(float(metrics["total_loss"]))
    assert len(seen) == 8
    replay = torch.Generator().manual_seed(7)
    for params in seen:
        again = tad.draw_params(replay, 2, patch, cfg)
        assert torch.equal(params.noise, again.noise)
        assert torch.equal(params.blur_type, again.blur_type)
    types = [int(p.blur_type) for p in seen]
    assert any(types[i] != types[i + 1] for i in range(0, 8, 2)), types
    with pytest.raises(ValueError, match="generator"):
        ts.make_train_step(model, losses, {}, augment_fn=augment_fn)


def _trainer_config(tmp_path, patch, max_epoch):
    volumes = write_sheet_dataset(tmp_path / "vols", (40, 48, 48), seed=3,
                                  chunks=(16, 16, 16))
    return {
        "tr_setup": {"model_name": "aug", "autoconfigure": False,
                     "tr_val_split": 0.8, "seed": 0,
                     "ckpt_out_base": str(tmp_path / "ckpts"),
                     "tensorboard_log_dir": str(tmp_path / "logs")},
        "tr_config": {"optimizer": "SGD", "initial_lr": 1e-2,
                      "weight_decay": 1e-4, "patch_size": list(patch),
                      "batch_size": 2, "max_steps_per_epoch": 2,
                      "max_val_steps_per_epoch": 1, "max_epoch": max_epoch,
                      "num_dataloader_workers": 2,
                      "compute_dtype": "float32",
                      "augment_on_device": True},
        "model_config": {
            "basic_encoder_block": "BasicBlockD",
            "basic_decoder_block": "ConvBlock",
            "bottleneck_block": "BasicBlockD",
            "features_per_stage": [8, 16], "num_stages": 2,
            "n_blocks_per_stage": [1, 1], "n_conv_per_stage_decoder": [1],
            "kernel_sizes": [3, 3], "strides": [1, 2]},
        "dataset_config": {
            "min_bbox_percent": 0.97, "min_labeled_ratio": 0.15,
            "use_cache": False, "in_channels": 1, "volume_paths": [volumes],
            "targets": {
                "sheet": {"channels": 1, "activation": "sigmoid",
                          "loss_fn": "BCEDiceLoss"},
                "normals": {"channels": 3, "activation": "none",
                            "loss_fn": "MaskedCosineLoss"}}},
        "inference_config": {},
    }


def test_trainer_augments_on_the_device(tmp_path, monkeypatch):
    """``augment_on_device: true``: two epochs at a 32^3 patch through
    ``Trainer`` on the CPU; the dataset ships unaugmented samples, the
    step's augment_fn runs once per microbatch, validation unaugmented."""
    cfg = _trainer_config(tmp_path, (32, 32, 32), 2)
    monkeypatch.chdir(tmp_path)
    calls = []
    real = tad.make_device_augment

    class Probe(Trainer):
        def _configure_dataset(self):
            ds = super()._configure_dataset()
            assert ds.augment is False
            return ds

    def counting(aug_cfg):
        assert aug_cfg.normal_keys == ("normals",)
        augment = real(aug_cfg)

        def wrapped(batch, generator):
            calls.append(batch["image"].shape[0])
            return augment(batch, generator)
        return wrapped

    monkeypatch.setattr(tad, "make_device_augment", counting)
    out = Probe(config_dict=copy.deepcopy(cfg), verbose=False,
                device="cpu").train()
    assert [h["epoch"] for h in out["history"]] == [0, 1]
    for h in out["history"]:
        assert np.isfinite(h["train/sheet_loss"])
        assert np.isfinite(h["val/sheet_loss"])
    assert calls == [2] * 4       # 2 epochs x 2 steps, batch 2, no validation


def test_cli_trains_with_device_augmentation(tmp_path, monkeypatch):
    """``python -m mt3d_resenc_unet_torch.train`` with ``augment_on_device:
    true`` on the CPU when asked for it (one epoch at 16^3)."""
    import yaml
    from mt3d_resenc_unet_torch.train.__main__ import main
    cfg = _trainer_config(tmp_path, (16, 16, 16), 1)
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = main(["--config_path", str(path), "--device", "cpu"])
    assert [h["epoch"] for h in out["history"]] == [0]
    assert np.isfinite(out["history"][0]["train/sheet_loss"])
