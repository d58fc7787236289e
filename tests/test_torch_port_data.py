"""The torch port's config, zarr IO, patch miner, dataset and pipeline
against the JAX package, on the CPU. Everything here is numpy on both
sides, so the comparisons are exact (bit for bit) unless stated.

* config: every ``tasks/*.yaml`` builds the same plan in both packages;
  ``use_pallas_conv`` auto is ``torch.cuda.is_available()`` in the port;
* zio: a store the port's numpy writer makes is read by the JAX package's
  tensorstore ``open_zarr`` and the reverse, edge chunks included;
  ``normalize_to_unit`` and the normals codec equal the JAX tables for every
  u8 and u16 code, and ``decode(65535 - u) == -decode(u)`` bit for bit;
* patches: the same mined list on a seeded label volume (even and odd
  patch sizes);
* dataset: the same samples, wire and non-wire, augmentation on, same
  seed; in wire mode a float image is compared after the port's bf16 cast
  in the pipeline's pin step against the JAX package's ``ml_dtypes`` cast;
* pipeline: batch order, the bf16 cast, producer errors re-raised.
"""

import dataclasses
import glob
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from mt3d_resenc_unet_tpu.core.config import ConfigManager as JConfig
from mt3d_resenc_unet_tpu.data import dataset as jds
from mt3d_resenc_unet_tpu.data import patches as jpatches
from mt3d_resenc_unet_tpu.data import pipeline as jpipe
from mt3d_resenc_unet_tpu.data import zio as jzio
from mt3d_resenc_unet_torch.core import yaml_load
from mt3d_resenc_unet_torch.core.config import ConfigManager
from mt3d_resenc_unet_torch.data import dataset as tds
from mt3d_resenc_unet_torch.data import patches as tpatches
from mt3d_resenc_unet_torch.data import pipeline as tpipe
from mt3d_resenc_unet_torch.data import zio as tzio
from mt3d_resenc_unet_torch.tools.synthetic_data import write_sheet_dataset

TASKS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                      "tasks", "*.yaml")))


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("path", TASKS, ids=os.path.basename)
def test_config_builds_the_jax_plan(path):
    want = JConfig(path).build_plan()
    got = ConfigManager(path).build_plan("cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _cfg_dict(**tr_config):
    with open(TASKS[0]) as f:
        cfg = yaml.safe_load(f)
    cfg["tr_config"].update(tr_config)
    return cfg


def test_use_pallas_conv_auto_follows_cuda(monkeypatch):
    """Auto follows the device given, not whether a card is present."""
    cfg = _cfg_dict(use_pallas_conv=None)
    mgr = ConfigManager(config_dict=cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert not mgr.build_plan("cpu").use_pallas_conv
    assert mgr.build_plan("cuda").use_pallas_conv
    assert mgr.build_plan().use_pallas_conv          # the card by default
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not mgr.build_plan(torch.device("cpu")).use_pallas_conv
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.build_plan()
    cfg["tr_config"]["use_pallas_conv"] = False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert not ConfigManager(config_dict=cfg).build_plan().use_pallas_conv


def test_config_dict_needs_no_yaml_and_device_augment_raises(monkeypatch):
    cfg = _cfg_dict()
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert ConfigManager(config_dict=cfg).train_patch_size
    # a task file is read by the port's own reader: no pyyaml either
    from_file = ConfigManager(TASKS[0])
    assert from_file.model_config == ConfigManager(
        config_dict=yaml_load.safe_load(Path(TASKS[0]).read_text())
    ).model_config
    # device augmentation is ported: the flag is read, nothing raises
    assert ConfigManager(
        config_dict=_cfg_dict(augment_on_device=True)).augment_on_device
    assert not ConfigManager(config_dict=cfg).augment_on_device


# --------------------------------------------------------------------- zio

def test_port_written_store_reads_in_jax_and_back(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.integers(0, 65536, (37, 50, 23, 3), dtype=np.uint16)
    v = tzio.create_zarr(str(tmp_path / "a.zarr"), a.shape, a.dtype,
                         (16, 16, 16, 3), compressor=None)
    v[...] = a
    v[3:5, 40:50, 0, 1] = 7          # a partial write into edge chunks
    a[3:5, 40:50, 0, 1] = 7
    j = jzio.open_zarr(str(tmp_path / "a.zarr"))
    np.testing.assert_array_equal(j[...], a)
    np.testing.assert_array_equal(j[30:37, 49:50, 5:23, :], a[30:, 49:, 5:])

    b = rng.integers(0, 256, (40, 33, 70), dtype=np.uint8)
    jv = jzio.create_zarr(str(tmp_path / "b.zarr"), b.shape, b.dtype,
                          (16, 16, 32), compressor=None)
    jv[...] = b
    jv[0:16, 0:16, 0:32] = 0          # an all-fill chunk may not be written
    b[0:16, 0:16, 0:32] = 0
    p = tzio.open_zarr(str(tmp_path / "b.zarr"))
    assert (p.shape, p.dtype, p.chunks) == (b.shape, b.dtype, (16, 16, 32))
    np.testing.assert_array_equal(p.read_all(), b)
    np.testing.assert_array_equal(p[..., 5, 10:60], b[..., 5, 10:60])
    np.testing.assert_array_equal(tzio.to_ram(p)[3:9], b[3:9])
    assert tzio.zarr_exists(str(tmp_path / "b.zarr"))
    assert not tzio.zarr_exists(str(tmp_path / "none.zarr"))
    assert tzio.volume_nbytes(p) == b.nbytes


def test_compressed_store_needs_tensorstore(tmp_path, monkeypatch):
    """A Blosc store opens without tensorstore (the port's codec), Blosc
    snappy included; a store that tensorstore cannot read either (filters)
    raises, and the error says so (the port has no tensorstore path)."""
    path = str(tmp_path / "c.zarr")
    jzio.create_zarr(path, (8, 8, 8), np.uint8, (4, 4, 4))[...] = 3
    assert int(tzio.open_zarr(path)[...].sum()) == 3 * 512
    snappy = str(tmp_path / "s.zarr")
    jzio.create_zarr(snappy, (8, 8, 8), np.uint8, (4, 4, 4),
                     compressor={"id": "blosc", "cname": "snappy"})[...] = 5
    filtered = tmp_path / "f.zarr"
    filtered.mkdir()
    (filtered / ".zarray").write_text(json.dumps({
        "shape": [4], "chunks": [4], "dtype": "|u1", "compressor": None,
        "fill_value": 0, "filters": [{"id": "delta", "dtype": "|u1"}],
        "order": "C", "zarr_format": 2}))
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    assert int(tzio.open_zarr(path)[...].sum()) == 3 * 512
    assert int(tzio.open_zarr(snappy)[...].sum()) == 5 * 512
    with pytest.raises(ValueError, match="tensorstore.*cannot read it"):
        tzio.open_zarr(str(filtered))


def test_unit_tables_and_normals_codec_bit_for_bit():
    u8 = np.arange(256, dtype=np.uint8)
    u16 = np.arange(65536, dtype=np.uint16)
    for codes in (u8, u16):
        got = tzio.normalize_to_unit(codes, codes.dtype)
        want = jzio.normalize_to_unit(codes, codes.dtype)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    dec = tzio.decode_normals(u16, u16.dtype)
    np.testing.assert_array_equal(
        dec.view(np.uint32), jzio.decode_normals(u16, u16.dtype).view(
            np.uint32))
    # negation is exact in encoded space (zio.py:259-267)
    np.testing.assert_array_equal(
        tzio.decode_normals(65535 - u16, u16.dtype).view(np.uint32),
        (-dec).view(np.uint32))
    # the encoder (v + 1) * 32767.5, clipped; both ends and outside
    v = np.concatenate([np.linspace(-1.2, 1.2, 4001, dtype=np.float32),
                        np.float32([-1, 0, 1])])
    np.testing.assert_array_equal(tzio.encode_normals_u16(v),
                                  jzio.encode_normals_u16(v))
    assert tzio.NORMALS_SCALE == jzio.NORMALS_SCALE == 32767.5
    assert tzio.encode_normals_u16(np.float32([-1, 1])).tolist() == [0, 65535]


# ----------------------------------------------------------------- patches

@pytest.mark.parametrize("patch", [(8, 8, 8), (7, 9, 8)])
def test_miner_finds_the_jax_patches(tmp_path, patch):
    rng = np.random.default_rng(1)
    lbl = np.zeros((30, 34, 28), np.uint8)
    lbl[3:26, 5:30, 2:25] = (rng.random((23, 25, 23)) > 0.4) * 255
    lbl[10:14] = 0
    v = tzio.create_zarr(str(tmp_path / "l.zarr"), lbl.shape, lbl.dtype,
                         (8, 16, 16), compressor=None)
    v[...] = lbl
    got = tpatches.find_valid_patches(v, patch, 0.8, 0.3, verbose=False)
    want = jpatches.find_valid_patches(jzio.RamVolume(lbl, "l"), patch, 0.8,
                                       0.3, verbose=False)
    assert got == want and len(got) > 3
    cache = tpatches.PatchCache(tmp_path / "cache", "m", patch)
    cache.save(got)
    assert cache.load() == got
    assert cache.path == jpatches.PatchCache(tmp_path / "cache", "m",
                                             patch).path


# ----------------------------------------------------------------- dataset

@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    root = tmp_path_factory.mktemp("sheets")
    return write_sheet_dataset(root, (40, 48, 48), seed=2,
                               chunks=(16, 16, 32))


def _data_cfg(volumes, ram):
    return {
        "tr_setup": {"model_name": "ds", "seed": 0},
        "tr_config": {"patch_size": [16, 16, 16]},
        "model_config": {},
        "dataset_config": {
            "min_bbox_percent": 0.97, "min_labeled_ratio": 0.15,
            "use_cache": False, "ram_cache_volumes": ram,
            "volume_paths": [volumes],
            "targets": {"sheet": {"channels": 1},
                        "normals": {"channels": 3}}},
        "inference_config": {},
    }


@pytest.mark.parametrize("wire,ram", [(False, True), (True, False)])
def test_dataset_samples_match_jax_bit_for_bit(volumes, wire, ram):
    cfg = _data_cfg(volumes, ram)
    got_ds = tds.ZarrPatchDataset(ConfigManager(config_dict=cfg), seed=5,
                                  wire=wire)
    want_ds = jds.ZarrPatchDataset(JConfig(config_dict=cfg), seed=5,
                                   wire=wire)
    assert got_ds.all_valid_patches == want_ds.all_valid_patches
    assert len(got_ds) > 20
    for ds in (got_ds, want_ds):
        ds.set_seed(11)
    floats = 0
    for idx in range(0, len(got_ds), 3):
        got, want = got_ds[idx], want_ds[idx]
        assert sorted(got) == sorted(want)
        for k in want:
            g, w = got[k], want[k]
            if wire and k == "image" and g.dtype == np.float32:
                # the port casts in the pin step; JAX casts here
                floats += 1
                g = _pinned(g, "image").view(torch.int16).numpy()
                w = np.asarray(w).view(np.int16)
            assert g.dtype == w.dtype and g.shape == w.shape, (idx, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{idx} {k}")
    if wire:
        assert floats > 0           # some samples took an intensity op


def _pinned(a, key):
    batches = tpipe.device_prefetch([{key: a[None]}], "cpu",
                                    bf16_keys=(key,))
    (batch,) = list(batches)
    assert batch[key].dtype == torch.bfloat16
    return batch[key][0]


# ---------------------------------------------------------------- pipeline

class _Indexed:
    def __init__(self, fail_at=None):
        self.fail_at = fail_at

    def __getitem__(self, idx):
        if idx == self.fail_at:
            raise KeyError(f"sample {idx} is broken")
        return {"i": np.array([idx], np.int64),
                "image": np.full((2, 2), idx, np.float32) / 3}


@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_order_matches_jax(drop_last):
    idx = [5, 3, 9, 1, 7, 2, 8]
    got = list(tpipe.batch_iterator(_Indexed(), idx, 2, num_threads=3,
                                    drop_last=drop_last))
    want = list(jpipe.batch_iterator(_Indexed(), idx, 2, num_threads=3,
                                     drop_last=drop_last))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["i"], w["i"])
    assert tpipe.train_val_split(23, 0.9, seed=4) == \
        jpipe.train_val_split(23, 0.9, seed=4)


def test_device_prefetch_order_cast_and_errors():
    host = tpipe.batch_iterator(_Indexed(), list(range(8)), 2, num_threads=2)
    out = list(tpipe.device_prefetch(host, "cpu", bf16_keys=("image",)))
    assert [b["i"].flatten().tolist() for b in out] == [[0, 1], [2, 3],
                                                        [4, 5], [6, 7]]
    assert out[0]["i"].dtype == torch.int64
    assert out[1]["image"].dtype == torch.bfloat16
    torch.testing.assert_close(out[1]["image"][0],
                               torch.full((2, 2), 2 / 3).bfloat16())
    host = tpipe.batch_iterator(_Indexed(fail_at=5), list(range(8)), 2,
                                num_threads=2)
    seen = []
    with pytest.raises(KeyError, match="sample 5"):
        for b in tpipe.device_prefetch(host, "cpu"):
            seen.append(b["i"].flatten().tolist())
    assert seen == [[0, 1], [2, 3]]


def test_device_prefetch_stops_its_producer_when_left_early():
    host = tpipe.batch_iterator(_Indexed(), list(range(40)), 2, num_threads=2)
    it = tpipe.device_prefetch(host, "cpu", prefetch=1)
    assert next(it)["i"].flatten().tolist() == [0, 1]
    it.close()
    deadline = time.monotonic() + 10
    while host.gi_frame is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert host.gi_frame is None      # the producer closed the batch source
