"""The port's multi-process inference on the CPU: two gloo processes run the
engine's tiled pass over one shared store, bit-equal to one process.

As tests/test_infer_multihost.py holds the JAX engine: a 40^3 u8 volume,
patch 16^3, features [8, 16], and a host-RAM budget of BUDGET_BYTES,
whose y-band (29 rows) is not a multiple of the stores' 16-row chunks, so
the two ranks' adjacent tiles write disjoint parts of shared chunks. The
tiles split round-robin, the per-rank watermarks hold disjoint non-empty
tile sets, ``*_sum``, ``*_count`` and ``*_final`` are bit-equal to a
single-process tiled pass, and only rank 0 finalizes.

The writer alone: ZIO_WRITERS processes write disjoint parts of one chunk
row by row (ZIO_ROWS partial writes each, every one a read-modify-write of
the chunk file); every row of every part must hold its value, which a
lost update would zero.
"""

import json
import os

import numpy as np
import pytest

import torch_port_dist_worker as worker
from mt3d_resenc_unet_torch.core.plan import TaskHead, plan_from_manual_config
from mt3d_resenc_unet_torch.data.zio import create_zarr, open_zarr
from mt3d_resenc_unet_torch.models.network import ResEncUNet
from mt3d_resenc_unet_torch.train.checkpoint import save_params

BUDGET_BYTES = 300_000
PATCH = (16, 16, 16)
MODEL = dict(basic_encoder_block="BasicBlockD", basic_decoder_block="ConvBlock",
             bottleneck_block="BasicBlockD", features_per_stage=[8, 16],
             num_stages=2, n_blocks_per_stage=[1, 1],
             n_conv_per_stage_decoder=[1], kernel_sizes=3, strides=[1, 2])
ZIO_ROWS = 300
ZIO_WRITERS = 4


def _band(shape, patch, budget, chans=2):
    """The tiled pass's y-band (infer/engine.py::_run_model_pass_tiled)."""
    tz = min(shape[0], 2 * patch[0])
    return max(patch[1], min(shape[1], budget // (chans * 4 * tz * shape[2])))


def _config(img, ckpt, out):
    return {
        "tr_setup": {"model_name": "mh", "autoconfigure": False},
        "tr_config": {"patch_size": list(PATCH), "batch_size": 4,
                      "compute_dtype": "float32"},
        "model_config": MODEL,
        "dataset_config": {
            "in_channels": 1,
            "targets": {"sheet": {"channels": 1, "activation": "sigmoid"}},
            "volume_paths": []},
        "inference_config": {
            "checkpoint_path": ckpt, "input_path": img, "output_path": out,
            "overlap": 0.25, "patch_size": list(PATCH), "batch_size": 4,
            "normalization": "none",
            "host_ram_budget_gb": BUDGET_BYTES / 2 ** 30},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp_infer")
    vol = np.random.default_rng(11).integers(0, 255, (40, 40, 40)).astype(
        np.uint8)
    img = str(tmp / "img.zarr")
    create_zarr(img, vol.shape, vol.dtype, (20, 20, 20),
                compressor=None)[...] = vol
    plan = plan_from_manual_config(MODEL, PATCH, 1,
                                   [TaskHead("sheet", 1, "sigmoid")])
    ckpt = str(tmp / "params.pt")
    save_params(ckpt, ResEncUNet(plan, seed=7).state_dict())
    out = {}
    for world in (1, 2):
        out[world] = worker.launch(
            "engine", world, {"config": _config(img, ckpt,
                                                str(tmp / f"out{world}"))},
            tmp, f"engine{world}")
    return out


def test_the_band_is_not_a_chunk_multiple():
    band = _band((40, 40, 40), PATCH, BUDGET_BYTES)
    assert band == 29 and band % PATCH[1]


def test_both_runs_take_the_tiled_pass(runs):
    assert [r["mode"] for r in runs[1]] == ["tiled"]
    assert [r["mode"] for r in runs[2]] == ["tiled", "tiled"]
    assert [r["rank"] for r in runs[2]] == [0, 1]


def test_tiles_are_split_disjointly_with_a_watermark_each(runs):
    store = runs[2][0]["store"]
    tiles = []
    for rank in (0, 1):
        with open(os.path.join(store,
                               f".model_pass_progress.p{rank}.json")) as f:
            done = {tuple(t) for t in json.load(f)["tiles_done"]}
        assert done, f"rank {rank} completed no tiles"
        tiles.append(done)
    assert not tiles[0] & tiles[1]
    with open(os.path.join(runs[1][0]["store"],
                           ".model_pass_progress.json")) as f:
        single = {tuple(t) for t in json.load(f)["tiles_done"]}
    assert tiles[0] | tiles[1] == single


@pytest.mark.parametrize("name", ["sheet_sum", "sheet_count", "sheet_final"])
def test_two_processes_are_bit_equal_to_one(runs, name):
    a = open_zarr(os.path.join(runs[1][0]["store"], name)).read_all()
    b = open_zarr(os.path.join(runs[2][0]["store"], name)).read_all()
    assert a.shape == (40, 40, 40)
    np.testing.assert_array_equal(a, b)


def test_concurrent_partial_chunk_writes_lose_no_update(tmp_path):
    path = str(tmp_path / "shared.zarr")
    create_zarr(path, (ZIO_ROWS, 64), np.int32, (ZIO_ROWS, 64),
                compressor=None)
    worker.launch("zio", ZIO_WRITERS, {"path": path}, tmp_path, "zio")
    got = open_zarr(path).read_all()
    part = 64 // ZIO_WRITERS
    for rank in range(ZIO_WRITERS):
        want = 1 + np.arange(ZIO_ROWS) + 1000 * rank
        np.testing.assert_array_equal(
            got[:, rank * part:(rank + 1) * part],
            np.broadcast_to(want[:, None], (ZIO_ROWS, part)),
            err_msg=f"writer {rank}")
