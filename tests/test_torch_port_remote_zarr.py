"""The port's remote zarr stores (``data/zio.py``'s http(s), s3 / gs and
``memory://`` key-value stores) against the JAX package's tensorstore ones,
on the CPU, over a ``http.server.ThreadingHTTPServer`` on 127.0.0.1 in the
test process (no outside network).

* For every codec and dtype of ``tests/test_torch_port_zarr_codec.py``
  (Blosc zstd / lz4 / lz4hc / blosclz / zlib with each shuffle, zstd, zlib,
  gzip, bz2, none x u8 / u16 / f32), a store written by the JAX package's
  tensorstore writer and one written by the port, each with chunks never
  written (404s: the fill value) and partial edge chunks: the port's
  ``open_zarr(url)`` reads bit-equal to the JAX package's ``open_zarr(url)``
  on the same server and to the local read, with tensorstore unused.
* A chunk that answers 500, or a body cut short of its ``Content-Length``,
  raises with the URL in the message; a write raises (read-only, as
  tensorstore's http kvstore); a group opens its level "0" as in JAX; one
  thread's reads keep one connection; ``ZarrPatchDataset`` (with and
  without ``ram_cache_volumes``) gives the same samples over the URLs as
  over the paths, and the engine's device pass the same finals.
* ``memory://`` behaves as the JAX package's: ``create_zarr`` returns a
  writable array of its own, which ``open_zarr`` and ``zarr_exists`` never
  find.
* ``s3://`` and ``gs://`` open the bucket stores at their HTTPS
  endpoints, writable (no request is made; their reads and writes are
  ``tests/test_torch_port_remote_auth.py``'s).
"""

import collections
import copy
import functools
import http.server
import json
import os
import threading
import urllib.parse
from pathlib import Path

import numpy as np
import pytest

from mt3d_resenc_unet_tpu.data import zio as jzio
from mt3d_resenc_unet_torch.data import zio as tzio

from test_torch_port_zarr_codec import (BLOSC, CHUNKS, DTYPES, OTHERS, SHAPE,
                                        _label, _volume)


class _Handler(http.server.SimpleHTTPRequestHandler):
    """Files under the served directory, kept-alive (HTTP/1.1); a path
    under ``/fail500/`` answers 500 for every key but ``.zarray``, and one
    under ``/short/`` sends 10 bytes fewer than its ``Content-Length``
    says. Each request's client address is recorded."""

    protocol_version = "HTTP/1.1"
    clients = collections.Counter()

    def log_message(self, *args):
        pass

    def do_GET(self):
        _Handler.clients[self.client_address] += 1
        name = self.path.rsplit("/", 1)[-1]
        if self.path.startswith("/fail500/") and name != ".zarray":
            self.send_response(500)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        if self.path.startswith("/short/") and name != ".zarray":
            path = self.translate_path(self.path)
            if not os.path.isfile(path):
                self.send_error(404)
                return
            data = Path(path).read_bytes()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(data[:-10])
            self.close_connection = True
            return
        super().do_GET()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("served")
    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(_Handler, directory=str(root)))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield root, f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def _write(zio, path, data, comp, fill=3):
    vol = zio.create_zarr(path, SHAPE, data.dtype, CHUNKS, compressor=comp,
                          fill_value=fill)
    vol[0:8, 0:16] = data[0:8, 0:16]
    vol[2:10, 5:21, 3:19] = data[2:10, 5:21, 3:19]


def _no_tensorstore(monkeypatch):
    """The port reads every store itself: it keeps no tensorstore path
    (``tests/test_torch_port_yaml.py`` holds that no module imports it)."""
    assert not any("tensorstore" in name for name in vars(tzio))


# snappy over a URL once (bit shuffle); its shuffles are the codec tests'
REMOTE = [c for c in BLOSC + OTHERS
          if not (c and c.get("cname") == "snappy" and c["shuffle"] != 2)]


@pytest.mark.parametrize("comp", REMOTE, ids=_label)
def test_url_reads_equal_jax_and_local(server, monkeypatch, comp):
    root, url = server
    _no_tensorstore(monkeypatch)
    for dtype in DTYPES:
        data = _volume(SHAPE, dtype)
        want = np.full(SHAPE, 3, dtype)
        want[0:8, 0:16] = data[0:8, 0:16]
        want[2:10, 5:21, 3:19] = data[2:10, 5:21, 3:19]
        for side, zio in (("port", tzio), ("jax", jzio)):
            name = f"{side}_{_label(comp)}_{np.dtype(dtype).name}.zarr"
            _write(zio, str(root / name), data, comp)
            local = tzio.open_zarr(str(root / name)).read_all()
            got = tzio.open_zarr(f"{url}/{name}")
            assert got.shape == SHAPE and got.chunks == CHUNKS
            got_all = got.read_all()
            jax_all = jzio.open_zarr(f"{url}/{name}").read_all()
            for arr in (local, got_all, jax_all):
                assert arr.dtype == want.dtype
                np.testing.assert_array_equal(arr, want, err_msg=name)
            np.testing.assert_array_equal(got[1:9, 3:17, 2:5],
                                          want[1:9, 3:17, 2:5])
            assert got.read_async((9, slice(4, 7), 18)).result().tolist() \
                == want[9, 4:7, 18].tolist()
            assert tzio.zarr_exists(f"{url}/{name}")


def test_missing_chunks_read_the_fill_value(server):
    root, url = server
    vol = tzio.create_zarr(str(root / "sparse.zarr"), SHAPE, np.uint16,
                           CHUNKS, fill_value=7)
    vol[0:4, 0:8, 0:8] = 1
    chunks = sorted(p.name for p in (root / "sparse.zarr").iterdir())
    assert chunks == [".zarray", "0.0.0"]
    want = np.full(SHAPE, 7, np.uint16)
    want[0:4, 0:8, 0:8] = 1
    for zio in (tzio, jzio):
        np.testing.assert_array_equal(
            zio.open_zarr(f"{url}/sparse.zarr").read_all(), want)
    assert not tzio.zarr_exists(f"{url}/no-such.zarr")
    assert not jzio.zarr_exists(f"{url}/no-such.zarr")
    with pytest.raises(FileNotFoundError, match="no-such"):
        tzio.open_zarr(f"{url}/no-such.zarr")


@pytest.mark.parametrize("kind,match", [("fail500", "HTTP 500"),
                                        ("short", "cut short")])
def test_server_errors_raise_with_the_url(server, kind, match):
    root, url = server
    (root / kind).mkdir(exist_ok=True)
    _write(tzio, str(root / kind / "a.zarr"), _volume(SHAPE, np.uint8), None)
    vol = tzio.open_zarr(f"{url}/{kind}/a.zarr")
    with pytest.raises(OSError, match=match) as err:
        vol[0:4, 0:8, 0:8]
    assert f"{url}/{kind}/a.zarr/0.0.0" in str(err.value)


def test_writes_raise(server):
    root, url = server
    _write(tzio, str(root / "ro.zarr"), _volume(SHAPE, np.uint8), None)
    vol = tzio.open_zarr(f"{url}/ro.zarr", writable=True)
    with pytest.raises(OSError, match="read-only"):
        vol[0:4, 0:8, 0:8] = 1
    with pytest.raises(OSError, match="read-only"):
        vol.write_async((0, 0, 0), 1).result()
    with pytest.raises(OSError, match="read-only"):
        tzio.create_zarr(f"{url}/new.zarr", SHAPE, np.uint8, CHUNKS)
    for remote in ("s3://bucket/x.zarr", "gs://bucket/x.zarr"):
        assert tzio._kv(remote).writable      # buckets take writes
    assert (root / "ro.zarr" / "0.0.0").is_file()
    assert not (root / "new.zarr").exists()


def test_group_opens_level_zero(server):
    root, url = server
    group = root / "group.zarr"
    group.mkdir()
    (group / ".zgroup").write_text(json.dumps({"zarr_format": 2}))
    data = _volume(SHAPE, np.uint8)
    _write(tzio, str(group / "0"), data, tzio.DEFAULT_COMPRESSOR)
    got = tzio.open_zarr(f"{url}/group.zarr")
    assert got.path == f"{url}/group.zarr/0"
    np.testing.assert_array_equal(
        got.read_all(), jzio.open_zarr(f"{url}/group.zarr").read_all())


def test_one_thread_keeps_one_connection(server):
    root, url = server
    data = _volume(SHAPE, np.uint8)
    _write(tzio, str(root / "conn.zarr"), data, None)
    vol = tzio.open_zarr(f"{url}/conn.zarr")
    _Handler.clients.clear()
    for z in range(0, SHAPE[0], CHUNKS[0]):      # one chunk a read
        vol[z, 0, 0]
    assert sum(_Handler.clients.values()) == 3
    assert len(_Handler.clients) == 1


@pytest.fixture(scope="module")
def served_dataset(server):
    """A synthetic sheet dataset under the served root, written once."""
    from mt3d_resenc_unet_torch.tools.synthetic_data import \
        write_sheet_dataset
    return write_sheet_dataset(server[0] / "sheets", (40, 48, 48), seed=2,
                               chunks=(16, 16, 32))


@pytest.mark.parametrize("ram", [False, True])
def test_dataset_samples_equal_over_urls(server, served_dataset, ram):
    from mt3d_resenc_unet_torch.core.config import ConfigManager
    from mt3d_resenc_unet_torch.data.dataset import ZarrPatchDataset
    root, url = server
    paths = served_dataset
    urls = {k: (v.replace(str(root), url) if k != "ref_label" else v)
            for k, v in paths.items()}
    assert urls["input"].startswith("http://")
    sets = []
    for vols in (paths, urls):
        cfg = {"tr_setup": {"model_name": "ds", "seed": 0},
               "tr_config": {"patch_size": [16, 16, 16]},
               "model_config": {},
               "dataset_config": {
                   "min_bbox_percent": 0.97, "min_labeled_ratio": 0.15,
                   "use_cache": False, "ram_cache_volumes": ram,
                   "volume_paths": [vols],
                   "targets": {"sheet": {"channels": 1},
                               "normals": {"channels": 3}}},
               "inference_config": {}}
        ds = ZarrPatchDataset(ConfigManager(config_dict=cfg), seed=5)
        ds.set_seed(11)
        sets.append(ds)
    local, remote = sets
    assert local.all_valid_patches == remote.all_valid_patches
    assert len(local) > 20
    for idx in range(0, len(local), 4):
        a, b = local[idx], remote[idx]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{idx} {k}")


def test_engine_reads_its_input_over_a_url(server, tmp_path):
    """The engine's device pass on a served input writes the same finals,
    bit for bit, as on the local path."""
    import torch
    from mt3d_resenc_unet_torch.core.config import ConfigManager
    from mt3d_resenc_unet_torch.infer.engine import ZarrInferenceEngine
    from mt3d_resenc_unet_torch.models.network import ResEncUNet
    from mt3d_resenc_unet_torch.train.checkpoint import save_params
    root, url = server
    vol = np.random.default_rng(5).integers(0, 256, (32, 32, 32), np.uint8)
    tzio.create_zarr(str(root / "img.zarr"), vol.shape, np.uint8,
                     (16, 16, 16))[...] = vol
    cfg = {
        "tr_setup": {"model_name": "engine", "autoconfigure": False},
        "tr_config": {"patch_size": [16, 16, 16], "batch_size": 4,
                      "compute_dtype": "float32", "mesh_shape": [1]},
        "model_config": {
            "basic_encoder_block": "BasicBlockD",
            "basic_decoder_block": "ConvBlock",
            "bottleneck_block": "BasicBlockD",
            "features_per_stage": [8, 16], "num_stages": 2,
            "n_blocks_per_stage": [1, 1], "n_conv_per_stage_decoder": [1],
            "kernel_sizes": [3, 3], "strides": [1, 2]},
        "dataset_config": {"in_channels": 1, "volume_paths": [],
                           "targets": {
                               "sheet": {"channels": 1,
                                         "activation": "sigmoid"},
                               "normals": {"channels": 3,
                                           "activation": "none"}}},
        "inference_config": {
            "checkpoint_path": str(tmp_path / "w.pt"), "overlap": 0.5,
            "patch_size": [16, 16, 16], "batch_size": 3,
            "normalization": "standardize", "device_accumulate": True,
            "num_dataloader_workers": 2,
            "output_targets": ["sheet", "normals"]}}
    plan = ConfigManager(config_dict=cfg).build_plan("cpu")
    save_params(tmp_path / "w.pt", ResEncUNet(plan, seed=4).state_dict())
    finals = []
    for name, src in (("local", str(root / "img.zarr")),
                      ("url", f"{url}/img.zarr")):
        c = copy.deepcopy(cfg)
        c["inference_config"].update(input_path=src,
                                     output_path=str(tmp_path / name))
        engine = ZarrInferenceEngine(config_dict=c, device="cpu")
        store = engine.infer()
        assert engine.last_mode == "device"
        finals.append({t: tzio.open_zarr(f"{store}/{t}_final").read_all()
                       for t in ("sheet", "normals")})
    for t in ("sheet", "normals"):
        assert finals[0][t].size
        np.testing.assert_array_equal(finals[0][t], finals[1][t])
    del torch


def test_memory_stores_behave_as_jax(monkeypatch):
    _no_tensorstore(monkeypatch)
    data = _volume(SHAPE, np.float32)
    for zio in (tzio, jzio):
        vol = zio.create_zarr("memory://m.zarr", SHAPE, np.float32, CHUNKS,
                              fill_value=2)
        vol[1:9, 2:20] = data[1:9, 2:20]
        want = np.full(SHAPE, 2, np.float32)
        want[1:9, 2:20] = data[1:9, 2:20]
        np.testing.assert_array_equal(vol[...] if zio is jzio
                                      else vol.read_all(), want)
        other = zio.create_zarr("memory://m.zarr", SHAPE, np.float32,
                                CHUNKS, fill_value=2)
        assert float(np.asarray(other[1, 2, 3])) == 2.0
        with pytest.raises(ValueError, match="NOT_FOUND"):
            zio.open_zarr("memory://m.zarr")
        assert not zio.zarr_exists("memory://m.zarr")


@pytest.mark.parametrize("remote,want", [
    ("s3://bucket/a/b.zarr", "https://bucket.s3.amazonaws.com/a/b.zarr"),
    ("s3://bucket/", "https://bucket.s3.amazonaws.com"),
    ("gs://bucket/a/b.zarr/",
     "https://storage.googleapis.com/storage/v1/b/bucket/o/a%2Fb.zarr"),
    ("https://host:8443/x.zarr/", "https://host:8443/x.zarr"),
])
def test_s3_and_gs_map_to_public_https(monkeypatch, remote, want):
    """The HTTPS URL of each store's objects, before any request (s3's
    region not asked yet, no connection open): s3 and gs writable, http(s)
    read-only."""
    monkeypatch.delenv("TENSORSTORE_GCS_HTTP_URL", raising=False)
    kv = tzio._kv(remote)
    if isinstance(kv, tzio._S3KV):
        got = "/".join(filter(None, [tzio.s3_endpoint(kv.bucket),
                                     kv.prefix]))
        assert kv.region is None
    elif isinstance(kv, tzio._GcsKV):
        got = (kv.origin + kv.objects + "/"
               + urllib.parse.quote(kv.prefix, safe=""))
        assert kv.https and getattr(kv.local, "conn", None) is None
    else:
        got = kv.url
        assert isinstance(kv, tzio._HttpKV) and kv.https
        assert getattr(kv.local, "conn", None) is None
    assert got == want
    assert kv.writable == remote.startswith(("s3://", "gs://"))
