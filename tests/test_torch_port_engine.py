"""The torch port's zarr inference engine against the JAX package's, on the
CPU, at 16^3 patches over a seeded 32^3 uint8 volume with a 2-stage manual
plan in float32 (sheet + normals heads).

* The port against the JAX engine: the rolling pass and the device pass
  (``device_accumulate: True``) of each engine run once per module, from
  the same parameters (``params_from_jax``). The finalized ``{tgt}_sum``
  agrees within 1e-4 relative / 1e-5 absolute (fp32 on both sides, summed
  in another order), and the quantized finals within 1 code (a value
  within rounding of a code boundary truncates either way).
* The port against itself: tiled against rolling within 2e-4 (as the JAX
  tiled test), kill and resume bit-identical to an uninterrupted tiled
  run, a rolling store refuses to resume, the overwrite guard in every
  pass, ``--postprocess_only`` idempotent, ``write_sums``, uint16 input,
  the dispatch predicate and the fallback from a device pass out of
  memory, the standalone finalizer, the CLI and the device resolution.
"""

import os
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from mt3d_resenc_unet_tpu.core.config import ConfigManager as JConfig
from mt3d_resenc_unet_tpu.data.zio import open_zarr as jax_open
from mt3d_resenc_unet_tpu.infer import engine as jax_engine
from mt3d_resenc_unet_tpu.infer.engine import \
    ZarrInferenceEngine as JaxEngine
from mt3d_resenc_unet_tpu.models.network import ResEncUNet as JaxUNet
from mt3d_resenc_unet_tpu.train.checkpoint import \
    save_params as jax_save_params
from mt3d_resenc_unet_torch.data.zio import create_zarr, open_zarr
from mt3d_resenc_unet_torch.infer import engine as eng
from mt3d_resenc_unet_torch.infer.__main__ import main as cli_main
from mt3d_resenc_unet_torch.infer.engine import (ZarrInferenceEngine,
                                                 ZarrInferenceHandler,
                                                 should_device_accumulate)
from mt3d_resenc_unet_torch.tools import standalone_finalize
from mt3d_resenc_unet_torch.tools.from_jax import params_from_jax
from mt3d_resenc_unet_torch.train.checkpoint import save_params

SHAPE = (32, 32, 32)
PATCH = [16, 16, 16]
TARGETS = {"sheet": {"channels": 1, "activation": "sigmoid"},
           "normals": {"channels": 3, "activation": "none"}}
SUM_RTOL, SUM_ATOL = 1e-4, 1e-5
# at overlap 0.5 the rolling slab of the 32^3 volume is (1+1 + 3+1) planes
# of (2*16 + 8) rows of 32 x 32 f32 = 983 kB; 400 kB forces tiles of a
# 32-z x 16-row band (24 B a voxel: 393 kB), two of them
TILE_BUDGET = 400_000
TILE_BUDGET_GB = TILE_BUDGET / 2 ** 30


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("engine")
    vol = np.random.default_rng(5).integers(0, 256, SHAPE, dtype=np.uint8)
    img = str(tmp / "img.zarr")
    create_zarr(img, SHAPE, np.uint8, (16, 16, 16), compressor=None)[...] = vol
    img16 = str(tmp / "img16.zarr")
    create_zarr(img16, SHAPE, np.uint16, (16, 16, 16),
                compressor=None)[...] = vol.astype(np.uint16) * 257 + 3

    def cfg(out, device_mode=False, write_sums=False, ckpt="port.pt",
            budget_gb=8.0, input_path=img, overlap=0.5):
        return {
            "tr_setup": {"model_name": "engine", "autoconfigure": False},
            "tr_config": {"patch_size": PATCH, "batch_size": 4,
                          "compute_dtype": "float32", "mesh_shape": [1]},
            "model_config": {
                "basic_encoder_block": "BasicBlockD",
                "basic_decoder_block": "ConvBlock",
                "bottleneck_block": "BasicBlockD",
                "features_per_stage": [8, 16], "num_stages": 2,
                "n_blocks_per_stage": [1, 1],
                "n_conv_per_stage_decoder": [1],
                "kernel_sizes": [3, 3], "strides": [1, 2]},
            "dataset_config": {"in_channels": 1, "volume_paths": [],
                               "targets": TARGETS},
            "inference_config": {
                "checkpoint_path": str(tmp / ckpt),
                "input_path": input_path,
                "output_path": str(tmp / out) if not os.path.isabs(str(out))
                else str(out),
                "overlap": overlap, "patch_size": PATCH, "batch_size": 3,
                "normalization": "standardize", "gaussian_blend": True,
                "device_accumulate": device_mode, "write_sums": write_sums,
                "host_ram_budget_gb": budget_gb,
                "num_dataloader_workers": 2,
                "output_targets": ["sheet", "normals"]},
        }

    plan = JConfig(config_dict=cfg("x")).build_plan()
    model = JaxUNet(plan=plan, dtype=jnp.float32)
    params = jax.device_get(jax.jit(lambda: model.init(
        {"params": jax.random.key(2)}, jnp.zeros((1, *PATCH, 1)),
        train=False))()["params"])
    jax_save_params(str(tmp / "jax_params"), params)
    save_params(tmp / "port.pt", params_from_jax(params))
    return tmp, cfg


def _model_pass(engine, package, opener):
    """The model pass alone; its raw sums are read back before the
    package's own finalize and quantize run on the store."""
    store = os.path.join(engine.mgr.infer_output_path, "predictions.zarr")
    targets = engine.mgr.infer_output_targets
    engine._run_model_pass(store, targets)
    raw = {n: opener(os.path.join(store, f"{n}_sum")).read_all()
           for n in TARGETS}
    package.finalize_overlaps(store, targets)
    package.quantize_final(store, targets)
    return store, raw


@pytest.fixture(scope="module")
def jax_stores(setup):
    """The JAX engine's rolling and device passes (the device pass with its
    sums persisted), and its device pass with finals only."""
    tmp, cfg = setup
    out = {mode: _model_pass(JaxEngine(config_dict=cfg(
        f"jax_{mode}", device_mode=mode == "device", write_sums=True,
        ckpt="jax_params")), jax_engine, jax_open)
        for mode in ("rolling", "device")}
    out["device_finals"] = JaxEngine(config_dict=cfg(
        "jax_device_finals", device_mode=True, ckpt="jax_params")).infer()
    return out


@pytest.fixture(scope="module")
def port_stores(setup):
    tmp, cfg = setup
    out = {}
    for mode in ("rolling", "device"):
        engine = ZarrInferenceEngine(config_dict=cfg(
            f"port_{mode}", device_mode=mode == "device", write_sums=True),
            device="cpu")
        out[mode] = _model_pass(engine, eng, open_zarr)
        assert engine.last_mode == mode
    engine = ZarrInferenceEngine(config_dict=cfg("port_device_finals",
                                                 device_mode=True),
                                 device="cpu")
    out["device_finals"] = engine.infer()
    assert engine.last_mode == "device"
    return out


def _read(store, name, opener=open_zarr):
    return opener(os.path.join(store, name)).read_all()


def _assert_finals_within_one_code(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1, f"max code difference {diff.max()}"


@pytest.mark.parametrize("mode", ["rolling", "device"])
@pytest.mark.parametrize("target", ["sheet", "normals"])
def test_sums_and_finals_match_jax_engine(jax_stores, port_stores, mode,
                                          target):
    """Raw sums and counts within 1e-4 / 1e-5. The finalized normals are
    unit vectors, whose direction error is the raw error over the sum's
    magnitude: they are held scaled back by the JAX sum's magnitude, in
    the raw sums' tolerance."""
    (store, raw), (jstore, jraw) = port_stores[mode], jax_stores[mode]
    assert raw[target].shape == jraw[target].shape
    np.testing.assert_allclose(raw[target], jraw[target], SUM_RTOL, SUM_ATOL)
    np.testing.assert_allclose(_read(store, f"{target}_count"),
                               _read(jstore, f"{target}_count", jax_open),
                               SUM_RTOL, SUM_ATOL)
    got = _read(store, f"{target}_sum")
    want = _read(jstore, f"{target}_sum", jax_open)
    assert got.dtype == np.float32 and got.shape == want.shape
    if target == "normals":
        scale = np.linalg.norm(jraw[target], axis=0)
        got, want = got * scale, want * scale
    np.testing.assert_allclose(got, want, SUM_RTOL, SUM_ATOL)
    _assert_finals_within_one_code(
        _read(store, f"{target}_final"),
        _read(jstore, f"{target}_final", jax_open))


@pytest.mark.parametrize("target", ["sheet", "normals"])
def test_device_finals_match_jax_engine(jax_stores, port_stores, target):
    """Finals quantized on the device (no sums persisted) against the JAX
    device pass's."""
    store = port_stores["device_finals"]
    assert not os.path.isdir(os.path.join(store, f"{target}_sum"))
    for marker in (f".finalized_{target}", ".finalized"):
        with open(os.path.join(store, marker)) as f:
            assert f.read() == "finalized on device\n"
    _assert_finals_within_one_code(
        _read(store, f"{target}_final"),
        _read(jax_stores["device_finals"], f"{target}_final", jax_open))


def test_finalized_normals_have_unit_length(port_stores):
    for mode in ("rolling", "device"):
        v = _read(port_stores[mode][0], "normals_sum")
        np.testing.assert_allclose(np.linalg.norm(v, axis=0), 1.0, atol=1e-5)
    q = _read(port_stores["device_finals"], "normals_final")
    assert q.dtype == np.uint16
    v = q.astype(np.float32) / 32767.5 - 1.0
    np.testing.assert_allclose(np.linalg.norm(v, axis=0), 1.0, atol=1e-3)


def test_tiled_matches_rolling_and_respects_budget(setup, port_stores):
    tmp, cfg = setup
    engine = ZarrInferenceEngine(config_dict=cfg(
        "port_tiled", budget_gb=TILE_BUDGET_GB), device="cpu")
    store = engine.infer()
    assert engine.last_mode == "tiled"
    assert 0 < engine.max_slab_bytes <= TILE_BUDGET
    assert os.path.exists(os.path.join(store, ".model_pass_progress.json"))
    for ds in ("sheet_sum", "sheet_count", "sheet_final", "normals_sum",
               "normals_final"):
        np.testing.assert_allclose(
            _read(store, ds).astype(np.float32),
            _read(port_stores["rolling"][0], ds).astype(np.float32),
            atol=2e-4, err_msg=ds)


def test_rolling_budget_covers_actual_peak(setup, tmp_path):
    """The static slab estimate that selects rolling against tiled bounds
    the peak that the rolling accumulator allocated."""
    tmp, cfg = setup
    engine = ZarrInferenceEngine(config_dict=cfg(tmp_path / "hov",
                                                 overlap=0.6), device="cpu")
    engine.infer()
    est = engine._rolling_slab_bytes(engine.mgr.infer_output_targets, SHAPE,
                                     tuple(PATCH), 0.6)
    assert 0 < engine.max_slab_bytes <= est


def test_resume_bit_identical(setup, tmp_path, capsys):
    tmp, cfg = setup
    ref = ZarrInferenceEngine(config_dict=cfg(
        tmp_path / "ref", budget_gb=TILE_BUDGET_GB), device="cpu").infer()

    class Kill(Exception):
        pass

    seen = []

    def killer(tile):
        seen.append(tile)
        raise Kill()

    killed = ZarrInferenceEngine(config_dict=cfg(
        tmp_path / "res", budget_gb=TILE_BUDGET_GB), device="cpu")
    killed.tile_callback = killer
    with pytest.raises(Kill):
        killed.infer()
    assert len(seen) == 1
    resumed = ZarrInferenceEngine(config_dict=cfg(
        tmp_path / "res", budget_gb=TILE_BUDGET_GB), device="cpu",
        resume=True)
    capsys.readouterr()
    store = resumed.infer()
    assert resumed.last_mode == "tiled"
    # the resumed pass runs only the tile the cut one left
    log = capsys.readouterr().out
    assert "resuming: 1/2 tiles already complete" in log
    assert log.count("[infer] tile z[") == 1
    for ds in ("sheet_sum", "sheet_count", "sheet_final", "normals_sum",
               "normals_count", "normals_final"):
        np.testing.assert_array_equal(_read(store, ds), _read(ref, ds),
                                      err_msg=ds)


def test_rolling_store_cannot_resume(setup, port_stores):
    tmp, cfg = setup
    with pytest.raises(RuntimeError, match="rolling-mode"):
        ZarrInferenceEngine(config_dict=cfg("port_rolling"), device="cpu",
                            resume=True).infer()


@pytest.mark.parametrize("out,kw", [
    ("port_rolling", {}), ("port_device_finals", {"device_mode": True}),
    ("port_tiled", {"budget_gb": TILE_BUDGET_GB})])
def test_overwrite_guard(setup, port_stores, out, kw):
    tmp, cfg = setup
    if out == "port_tiled" and not os.path.isdir(tmp / out):
        ZarrInferenceEngine(config_dict=cfg(out, **kw), device="cpu").infer()
    with pytest.raises(FileExistsError):
        ZarrInferenceEngine(config_dict=cfg(out, **kw), device="cpu").infer()


def test_postprocess_only_is_idempotent(setup, tmp_path, capsys):
    tmp, cfg = setup
    c = cfg(tmp_path / "pp")
    store = ZarrInferenceEngine(config_dict=c, device="cpu").infer()
    sums = {n: _read(store, f"{n}_sum") for n in TARGETS}
    finals = {n: _read(store, f"{n}_final") for n in TARGETS}
    for _ in range(2):
        engine = ZarrInferenceEngine(config_dict=c, device="cpu",
                                     postprocess_only=True)
        engine.infer()
        assert engine.last_mode is None
        assert "already finalized; skipping" in capsys.readouterr().out
        for n in TARGETS:
            np.testing.assert_array_equal(_read(store, f"{n}_sum"), sums[n])
            np.testing.assert_array_equal(_read(store, f"{n}_final"),
                                          finals[n])
    # with the markers gone the postprocess averages the averaged sums again
    # (the reference's fault that the markers prevent)
    os.remove(os.path.join(store, ".finalized"))
    os.remove(os.path.join(store, ".finalized_sheet"))
    ZarrInferenceEngine(config_dict=c, device="cpu",
                        postprocess_only=True).infer()
    assert not np.array_equal(_read(store, "sheet_sum"), sums["sheet"])


def test_device_write_sums_matches_device_finals(port_stores):
    """write_sums persists the device's raw sums and counts and leaves the
    finals to the host's finalize and quantize, whose codes agree with the
    device's own within 1."""
    store = port_stores["device"][0]
    for suffix in ("sum", "count", "final"):
        for n in TARGETS:
            assert os.path.isdir(os.path.join(store, f"{n}_{suffix}"))
    with open(os.path.join(store, ".finalized_sheet")) as f:
        assert f.read() == "overlap averaging applied\n"
    for n in TARGETS:
        _assert_finals_within_one_code(
            _read(store, f"{n}_final"),
            _read(port_stores["device_finals"], f"{n}_final"))


def test_uint16_input_device_matches_rolling(setup, tmp_path):
    """uint16 samples decode on the device as the host decodes them."""
    tmp, cfg = setup
    img16 = str(tmp / "img16.zarr")
    stores = {mode: ZarrInferenceEngine(config_dict=cfg(
        tmp_path / mode, device_mode=mode == "device", write_sums=True,
        input_path=img16), device="cpu").infer()
        for mode in ("rolling", "device")}
    for ds in ("sheet_sum", "normals_sum", "sheet_count"):
        np.testing.assert_allclose(_read(stores["device"], ds),
                                   _read(stores["rolling"], ds),
                                   SUM_RTOL, SUM_ATOL, err_msg=ds)


def test_device_out_of_memory_falls_back_to_a_host_pass(setup, tmp_path,
                                                         monkeypatch, capsys):
    """Accumulators that do not fit the card send the engine to the host
    passes (the forward stays on the device), saying so."""
    tmp, cfg = setup

    def oom(self, store_path, targets):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(ZarrInferenceEngine, "_run_model_pass_device", oom)
    engine = ZarrInferenceEngine(config_dict=cfg(tmp_path / "oom",
                                                 device_mode=True),
                                 device="cpu")
    store = engine.infer()
    assert engine.last_mode == "rolling"
    assert "device accumulation out of memory" in capsys.readouterr().out
    for n in TARGETS:
        assert os.path.isdir(os.path.join(store, f"{n}_final"))


def test_device_accumulate_dispatch_gating():
    base = dict(resume=False, process_count=1, n_local_devices=1,
                backend="cuda", accum_bytes=1 << 30, budget_bytes=2 << 30)
    assert should_device_accumulate("auto", **base)
    assert not should_device_accumulate(
        "auto", **{**base, "n_local_devices": 8})
    assert not should_device_accumulate("auto", **{**base, "backend": "cpu"})
    assert not should_device_accumulate("auto", **{**base, "backend": "tpu"})
    assert not should_device_accumulate(
        "auto", **{**base, "accum_bytes": 3 << 30})
    assert not should_device_accumulate("auto", **{**base, "resume": True})
    assert not should_device_accumulate(
        "auto", **{**base, "process_count": 2})
    assert not should_device_accumulate(False, **base)
    assert should_device_accumulate(
        True, **{**base, "backend": "cpu", "accum_bytes": 3 << 30})
    assert not should_device_accumulate(True, **{**base, "resume": True})


def test_standalone_finalize(setup, port_stores, tmp_path):
    """A model pass alone leaves raw sums; the standalone finalizer turns
    them into the finals that ``infer`` writes."""
    tmp, cfg = setup
    engine = ZarrInferenceEngine(config_dict=cfg(tmp_path / "sa"),
                                 device="cpu")
    store = str(tmp_path / "sa" / "predictions.zarr")
    engine._run_model_pass(store, engine.mgr.infer_output_targets)
    assert not os.path.exists(os.path.join(store, ".finalized"))
    standalone_finalize.main(["--store", store, "--targets", "sheet:1",
                              "normals:3"])
    assert os.path.exists(os.path.join(store, ".finalized"))
    for n in TARGETS:
        np.testing.assert_array_equal(
            _read(store, f"{n}_final"),
            _read(port_stores["rolling"][0], f"{n}_final"))


def test_cli_runs_on_cpu_and_writes_layers(setup, tmp_path):
    tmp, cfg = setup
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg(tmp_path / "cli")))
    store = cli_main(["--config_path", str(path), "--device", "cpu",
                      "--write_layers"])
    assert store == str(tmp_path / "cli" / "predictions.zarr")
    for n in TARGETS:
        assert open_zarr(os.path.join(store, f"{n}_final")).dtype == (
            np.uint16 if n == "normals" else np.uint8)
        slices = os.listdir(tmp_path / "cli" / "z_slices" / n)
        assert len(slices) == SHAPE[0]
    with pytest.raises(FileExistsError):
        cli_main(["--config_path", str(path), "--device", "cpu"])


def test_cli_runs_without_pyyaml(setup, tmp_path, monkeypatch):
    """``test_cli_runs_on_cpu_and_writes_layers`` with ``yaml`` blocked
    from import: the CLI reads its task file with the port's own reader."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    test_cli_runs_on_cpu_and_writes_layers(setup, tmp_path)


def test_engine_needs_a_card_unless_asked_for_the_cpu(setup, monkeypatch):
    tmp, cfg = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ZarrInferenceEngine(config_dict=cfg("never"))
    assert ZarrInferenceHandler is ZarrInferenceEngine
    assert ZarrInferenceEngine(config_dict=cfg("never"),
                               device="cpu").device.type == "cpu"


def test_device_decode_matches_host_normalization():
    """The device path's decode + standardize against the host path's
    normalize_to_unit + standardize, uint8 and uint16."""
    rng = np.random.default_rng(0)
    for dtype, hi in ((np.uint8, 256), (np.uint16, 65536)):
        raw = rng.integers(0, hi, (2, 6, 7, 8)).astype(dtype)
        got = eng._decode(eng._upload(raw, torch.device("cpu")),
                          np.dtype(dtype), True)[..., 0].numpy()
        want = np.stack([eng.standardize(eng.normalize_to_unit(r, r.dtype))
                         for r in raw])
        np.testing.assert_allclose(got, want, 1e-5, 1e-5)
