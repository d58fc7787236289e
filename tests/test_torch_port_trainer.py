"""The torch port's Trainer against the JAX package's, on the CPU, at 16^3
with a small manual 2-stage plan (no squeeze-excitation) in float32.

* Both trainers run two epochs of three SGD steps at lr 0.1 on the same
  synthetic zarr dataset (wire format, host augmentation on, same seed),
  the port from the JAX trainer's initial parameters (``_build_model``
  overridden with ``params_from_jax``). Each epoch's mean train and
  validation losses agree within 1e-4 relative, and the parameters' change
  over the run within 1e-3 relative L2: the batches are bit-identical (the
  data tests show it) and the forward and backward are the same fp32 math
  summed in another order (the step test holds one step to 1e-5). The
  updates are large enough to be seen: they move the validation losses,
  measured on the same unaugmented batches in both epochs, by far more
  than the tolerance, and the parameters by over 1% of their norm, so a
  trainer that skipped, repeated or mis-scheduled an update would fail.
* Resume restores the parameters, the optimizer state, the optimizer
  count (the schedule position) and the epoch; ``auto_resume`` finds the
  newest checkpoint; weights-only leaves a fresh optimizer; the non-strict
  merge counts restored, fresh and mismatched entries; keep-N GC keeps the
  newest N epochs.
* ``python -m mt3d_resenc_unet_torch.train --config_path cfg.yaml`` runs one
  epoch in-process through ``main``.
"""

import copy
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.core.config import ConfigManager as JConfig
from mt3d_resenc_unet_tpu.models.network import ResEncUNet as JaxUNet
from mt3d_resenc_unet_tpu.train.trainer import Trainer as JTrainer
from mt3d_resenc_unet_torch.tools.from_jax import params_from_jax
from mt3d_resenc_unet_torch.tools.synthetic_data import write_sheet_dataset
from mt3d_resenc_unet_torch.train import checkpoint as ck
from mt3d_resenc_unet_torch.train.__main__ import main
from mt3d_resenc_unet_torch.train.trainer import BaseTrainer, Trainer

LOSS_RTOL = 1e-4
DELTA_RTOL = 1e-3   # relative L2 of the parameters' change over the run


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    return write_sheet_dataset(tmp_path_factory.mktemp("vols"), (32, 40, 40),
                               seed=3, chunks=(16, 16, 16))


def _config(tmp_path, volumes, max_epoch=1, **tr_setup):
    return {
        "tr_setup": {"model_name": "tiny", "autoconfigure": False,
                     "tr_val_split": 0.8, "seed": 0,
                     "ckpt_out_base": str(tmp_path / "ckpts"),
                     "tensorboard_log_dir": str(tmp_path / "logs"),
                     **tr_setup},
        "tr_config": {"optimizer": "SGD", "initial_lr": 1e-3,
                      "weight_decay": 1e-4, "patch_size": [16, 16, 16],
                      "batch_size": 2, "max_steps_per_epoch": 3,
                      "max_val_steps_per_epoch": 2, "max_epoch": max_epoch,
                      "num_dataloader_workers": 2, "compute_dtype": "float32",
                      "mesh_shape": [1]},
        "model_config": {
            "basic_encoder_block": "BasicBlockD",
            "basic_decoder_block": "ConvBlock",
            "bottleneck_block": "BasicBlockD",
            "features_per_stage": [16, 32], "num_stages": 2,
            "n_blocks_per_stage": [1, 1], "n_conv_per_stage_decoder": [1],
            "kernel_sizes": [3, 3], "strides": [1, 2]},
        "dataset_config": {
            "min_bbox_percent": 0.97, "min_labeled_ratio": 0.15,
            "use_cache": False, "in_channels": 1, "volume_paths": [volumes],
            "targets": {
                "sheet": {"channels": 1, "activation": "sigmoid",
                          "loss_fn": "BCEDiceLoss",
                          "loss_kwargs": {"alpha": 0.5, "beta": 0.5}},
                "normals": {"channels": 3, "activation": "none",
                            "loss_fn": "MaskedCosineLoss"}}},
        "inference_config": {},
    }


def _jax_init_params(cfg):
    """The JAX trainer's initial parameters (trainer.py:119-129)."""
    plan = JConfig(config_dict=cfg).build_plan()
    model = JaxUNet(plan=plan, dtype=jnp.float32, param_dtype=jnp.float32)
    sample = jnp.zeros((1,) + tuple(plan.patch_size) + (plan.in_channels,))
    return jax.jit(lambda k: model.init({"params": k}, sample,
                                        train=False))(
        jax.random.key(cfg["tr_setup"]["seed"]))["params"]


def test_epoch_losses_match_the_jax_trainer(tmp_path, volumes, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _config(tmp_path, volumes, max_epoch=2)
    cfg["tr_config"]["initial_lr"] = 0.1
    out = JTrainer(config_dict=copy.deepcopy(cfg), verbose=False).train()
    want = out["history"]
    want_params = params_from_jax(jax.tree.map(np.asarray,
                                               out["state"].params))
    init = params_from_jax(jax.tree.map(np.asarray, _jax_init_params(cfg)))

    class FromJax(Trainer):
        def _build_model(self, plan):
            model = super()._build_model(plan)
            model.load_state_dict(init)
            return model

    cfg["tr_setup"]["ckpt_out_base"] = str(tmp_path / "port_ckpts")
    got = FromJax(config_dict=cfg, verbose=False, device="cpu").train()
    assert [h["epoch"] for h in got["history"]] == [0, 1]
    for w, g in zip(want, got["history"]):
        keys = [k for k in w if k.endswith("_loss")]
        assert {"train/sheet_loss", "train/normals_loss",
                "val/sheet_loss", "val/normals_loss"} <= set(keys)
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                       err_msg=f"epoch {w['epoch']} {k}")
        assert g["train/t_fetch_s"] >= 0 and g["train/t_step_s"] > 0
    # the same validation batches before and after the second epoch's steps
    for k in ("val/sheet_loss", "val/normals_loss"):
        assert abs(want[1][k] - want[0][k]) > 100 * LOSS_RTOL * abs(want[0][k])

    got_params = got["model"].state_dict()
    assert sorted(got_params) == sorted(want_params)
    diff = moved = norm = 0.0
    for k, v in init.items():
        d_want = want_params[k].double() - v.double()
        d_got = got_params[k].double() - v.double()
        diff += float(((d_got - d_want) ** 2).sum())
        moved += float((d_want ** 2).sum())
        norm += float((v.double() ** 2).sum())
    assert moved > 1e-4 * norm               # over 1% of the norm
    assert (diff / moved) ** 0.5 < DELTA_RTOL


def test_resume_and_auto_resume_continue_the_count(tmp_path, volumes,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    first = Trainer(config_dict=_config(tmp_path, volumes, max_epoch=2),
                    verbose=False, device="cpu").train()
    assert [h["epoch"] for h in first["history"]] == [0, 1]
    assert first["optimizer"].count == 6
    root = tmp_path / "ckpts" / "tiny"
    saved = ck.restore_flexible(root)
    assert saved["epoch"] == 1 and saved["step"] == 6
    # an explicit checkpoint_path, then auto_resume from the newest epoch
    cfg = _config(tmp_path, volumes, max_epoch=3, checkpoint_path=str(root))
    out = Trainer(config_dict=cfg, verbose=False, device="cpu").train()
    assert [h["epoch"] for h in out["history"]] == [2]
    assert out["optimizer"].count == 9
    cfg = _config(tmp_path, volumes, max_epoch=4, auto_resume=True)
    out = Trainer(config_dict=cfg, verbose=False, device="cpu").train()
    assert [h["epoch"] for h in out["history"]] == [3]
    assert out["optimizer"].count == 12
    assert ck.CheckpointManager(tmp_path / "ckpts", "tiny").latest_epoch() == 3


def test_restore_puts_back_params_optimizer_count_and_epoch(tmp_path,
                                                            volumes,
                                                            monkeypatch):
    monkeypatch.chdir(tmp_path)
    Trainer(config_dict=_config(tmp_path, volumes, max_epoch=1),
            verbose=False, device="cpu").train()
    root = tmp_path / "ckpts" / "tiny"
    saved = ck.CheckpointManager(tmp_path / "ckpts", "tiny").restore()
    seen = {}

    class Probe(Trainer):
        def _restore(self, path, model, opt):
            epoch = super()._restore(path, model, opt)
            seen.update(epoch=epoch, count=opt.count,
                        params={k: v.clone()
                                for k, v in model.state_dict().items()},
                        opt=copy.deepcopy(opt.opt.state_dict()))
            return epoch

    cfg = _config(tmp_path, volumes, max_epoch=2, checkpoint_path=str(root))
    Probe(config_dict=cfg, verbose=False, device="cpu").train()
    assert seen["epoch"] == 1 and seen["count"] == 3
    assert sorted(seen["params"]) == sorted(saved["params"])
    for k, v in saved["params"].items():
        assert torch.equal(seen["params"][k], v), k
    got, want = seen["opt"]["state"], saved["opt_state"]["state"]
    assert sorted(got) == sorted(want) and len(want) > 0
    for i in want:
        assert torch.equal(got[i]["momentum_buffer"],
                           want[i]["momentum_buffer"])

    seen.clear()
    final = tmp_path / "tiny_final.pt"     # the run above wrote it
    dump = ck.load_params(final)
    cfg = _config(tmp_path / "ft", volumes, max_epoch=1,
                  checkpoint_path=str(final), load_weights_only=True)
    Probe(config_dict=cfg, verbose=False, device="cpu").train()
    assert seen["epoch"] == 0 and seen["count"] == 0
    assert seen["opt"]["state"] == {}
    for k, v in dump.items():
        assert torch.equal(seen["params"][k], v), k
    with pytest.raises(ValueError, match="parameters only"):
        ck.restore_flexible(final)


def test_keep_n_and_nonstrict_merge(tmp_path):
    mgr = ck.CheckpointManager(tmp_path, "m", keep=2)
    for epoch in range(4):
        mgr.save(epoch, {"params": {"w": torch.full((2,), float(epoch))},
                         "opt_state": {}, "step": epoch, "epoch": epoch})
    assert sorted(p.name for p in (tmp_path / "m").iterdir()) == ["2", "3"]
    assert mgr.latest_epoch() == 3 and mgr.restore()["step"] == 3
    assert float(ck.load_params_any(tmp_path / "m")["w"][0]) == 3.0
    assert float(ck.load_params_any(tmp_path / "m" / "2")["w"][0]) == 2.0

    fresh = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(4)}
    loaded = {"a": torch.ones(2, dtype=torch.float64), "b": torch.ones(5),
              "d": torch.ones(1)}
    merged, stats = ck.merge_params_nonstrict(fresh, loaded)
    assert stats == {"restored": 1, "kept_fresh": 1, "shape_mismatch": 1}
    assert merged["a"].dtype == torch.float32 and float(merged["a"][0]) == 1
    assert float(merged["b"][0]) == 0 and float(merged["c"][0]) == 0


def test_cli_trains_one_epoch(tmp_path, volumes, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _config(tmp_path, volumes)
    cfg["tr_setup"]["profile_dir"] = str(tmp_path / "prof")
    cfg["tr_config"]["max_steps_per_epoch"] = 7
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = main(["--config_path", str(path), "--device", "cpu"])
    assert [h["epoch"] for h in out["history"]] == [0]
    assert np.isfinite(out["history"][0]["train/sheet_loss"])
    assert (tmp_path / "ckpts" / "tiny" / "0" / ck.STATE_FILE).is_file()
    assert (tmp_path / "tiny_final.pt").is_file()
    assert (tmp_path / "prof" / "train_steps.json").is_file()
    assert BaseTrainer is Trainer

    assert main(["--config_path", str(path), "--debug_dataloader",
                 "--device", "cpu"]) == {}
    assert len(list((tmp_path / "debug_dir").glob("sample000_*.tif"))) == 3


def test_cli_trains_one_epoch_without_pyyaml(tmp_path, volumes, monkeypatch):
    """``test_cli_trains_one_epoch`` with ``yaml`` blocked from import: the
    CLI reads its task file with the port's own reader."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    test_cli_trains_one_epoch(tmp_path, volumes, monkeypatch)


def test_debug_tiffs_hold_the_same_pixels_through_cv2_and_pil(
        tmp_path, monkeypatch):
    """``--debug_dataloader``'s TIFFs: cv2 (what the card's machine has)
    and PIL write the same pages, read back through PIL; with neither
    importable the export raises."""
    from PIL import Image
    from mt3d_resenc_unet_torch.train import visualization as vis
    rng = np.random.default_rng(0)
    samples = [{"image": rng.random((4, 6, 5, 1), np.float32),
                "normals": rng.random((4, 6, 5, 3), np.float32) * 2 - 1,
                "sheet": rng.random((4, 6, 5), np.float32)}]

    def pages(path):
        img = Image.open(path)
        out = []
        for k in range(img.n_frames):
            img.seek(k)
            out.append(np.asarray(img))
        return out

    vis.export_data_dict_as_tif(samples, 1, str(tmp_path / "cv2"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    vis.export_data_dict_as_tif(samples, 1, str(tmp_path / "pil"))
    for key in samples[0]:
        name = f"sample000_{key}.tif"
        a, b = pages(tmp_path / "cv2" / name), pages(tmp_path / "pil" / name)
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.uint8
            np.testing.assert_array_equal(x, y)
    monkeypatch.setattr(vis, "_HAS_PIL", False)
    with pytest.raises(RuntimeError, match="neither cv2 nor PIL"):
        vis.export_data_dict_as_tif(samples, 1, str(tmp_path / "none"))


def test_trainer_without_a_card_raises_unless_asked_for_the_cpu(
        tmp_path, volumes, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(tmp_path, volumes)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(config_dict=cfg, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(config_dict=cfg, verbose=False, device="cuda")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config_path", str(path)])
    trainer = Trainer(config_dict=cfg, verbose=False, device="cpu")
    assert trainer.device == torch.device("cpu")
    assert not trainer._build_plan().use_pallas_conv
