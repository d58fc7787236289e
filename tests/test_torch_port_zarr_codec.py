"""The port's zarr chunk codec (``data/codec.py``, ``data/csrc/zcodec.cpp``)
and local store (``data/zio.py``) against tensorstore (the JAX package's
``open_zarr`` / ``create_zarr``) and ``zstandard``, on the CPU.

* every golden chunk of ``tests/data/zarr_codec/`` (written by tensorstore
  and by ``zstandard``) decodes to its manifest's sha256;
* the C++ byte and bit shuffles against the numpy ``*_plain`` versions,
  bit for bit, at sizes that are not multiples of 8 * typesize;
* the port's stores and the JAX package's read each other bit for bit for
  every Blosc codec x shuffle x dtype and every other compressor, with
  partial edge chunks, missing chunks and partial writes, and ``.zarray``
  dict-equal; a ``dimension_separator: "/"`` store; a trailing channel
  axis;
* round trips and a corrupt-input fuzz under ``hypothesis`` (every
  malformed chunk raises ``ValueError``, none crashes the process);
* with ``tensorstore`` blocked from import, in a subprocess: every local
  compressor created, written, partly written and read, and the port's
  engine (device and rolling passes) on its default Blosc stores, whose
  finals the JAX package reads equal to the same run's uncompressed ones.
"""

import hashlib
import json
import subprocess
import sys
import threading
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import zstandard
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mt3d_resenc_unet_tpu.data import zio as jzio
from mt3d_resenc_unet_torch.data import codec
from mt3d_resenc_unet_torch.data import zio as tzio

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "zarr_codec"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())

BLOSC = [{"id": "blosc", "cname": cname, "clevel": 5, "shuffle": shuffle}
         for cname in ("zstd", "lz4", "lz4hc", "blosclz", "zlib", "snappy")
         for shuffle in (0, 1, 2)]
OTHERS = [{"id": "zstd", "level": 1}, {"id": "zstd", "level": 9},
          {"id": "zlib", "level": 5}, {"id": "gzip", "level": 5},
          {"id": "bz2", "level": 1}, None]
DTYPES = (np.uint8, np.uint16, np.float32)
SHAPE, CHUNKS = (10, 21, 19), (4, 8, 8)


def _label(comp):
    if comp is None:
        return "none"
    return "-".join([comp["id"]] + [str(comp[k]) for k in sorted(comp)
                                     if k != "id"])


def _volume(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.arange(n) for n in shape[:3]), indexing="ij")
    base = np.sin(x / 4.0) * np.cos(y / 5.0) + 0.3 * z
    if len(shape) == 4:
        base = base[..., None] + np.arange(shape[3])
    noise = rng.integers(0, 4, shape)
    if np.dtype(dtype).kind == "f":
        return (base * 10 + noise * 0.001).astype(dtype)
    return (base * 20 + 60 + noise).astype(dtype)


def _meta(path):
    return json.loads((Path(path) / ".zarray").read_text())


# ----------------------------------------------------------- fixtures

def test_manifest_lists_every_fixture():
    files = {p.name for p in FIXTURES.iterdir()} - {"manifest.json"}
    assert files == {e["file"] for e in MANIFEST}
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 512 * 1024
    cnames = {e["compressor"].get("cname") for e in MANIFEST}
    assert {"zstd", "lz4", "lz4hc", "blosclz", "zlib", "snappy"} <= cnames
    for e in MANIFEST:
        assert set(e) >= {"file", "compressor", "dtype", "shape", "sha256"}


@pytest.mark.parametrize("entry", MANIFEST, ids=[e["file"] for e in MANIFEST])
def test_fixture_decodes_to_its_sha256(entry):
    data = (FIXTURES / entry["file"]).read_bytes()
    nbytes = int(np.prod(entry["shape"])) * np.dtype(entry["dtype"]).itemsize
    raw = codec.decode_chunk(entry["compressor"], data, nbytes)
    assert hashlib.sha256(raw).hexdigest() == entry["sha256"]


# ----------------------------------------------------------- shuffles

@pytest.mark.parametrize("typesize", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n", [0, 7, 64, 1000, 4104, 12294])
def test_cpp_shuffles_match_plain(n, typesize):
    block = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    for cpp, plain in ((codec.shuffle, codec.shuffle_plain),
                       (codec.unshuffle, codec.unshuffle_plain),
                       (codec.bitshuffle, codec.bitshuffle_plain),
                       (codec.bitunshuffle, codec.bitunshuffle_plain)):
        assert cpp(block, typesize) == plain(block, typesize), cpp.__name__
    assert codec.unshuffle(codec.shuffle(block, typesize), typesize) == block
    assert codec.bitunshuffle(codec.bitshuffle(block, typesize),
                              typesize) == block


# ------------------------------------------- stores against tensorstore

@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("comp", BLOSC + OTHERS, ids=_label)
def test_port_and_jax_stores_read_each_other(tmp_path, comp, dtype):
    """Both directions, bit for bit: a partial region written whole, a
    second write that covers chunks in part, chunks never written (the
    fill value) and partial edge chunks; ``.zarray`` dict-equal."""
    data = _volume(SHAPE, dtype)
    stores = {}
    for side, zio in (("port", tzio), ("jax", jzio)):
        path = str(tmp_path / f"{side}.zarr")
        vol = zio.create_zarr(path, SHAPE, dtype, CHUNKS, compressor=comp,
                              fill_value=3)
        vol[0:8, 0:16] = data[0:8, 0:16]
        vol[2:10, 5:21, 3:19] = data[2:10, 5:21, 3:19]
        stores[side] = path
    want = np.full(SHAPE, 3, dtype)
    want[0:8, 0:16] = data[0:8, 0:16]
    want[2:10, 5:21, 3:19] = data[2:10, 5:21, 3:19]
    assert _meta(stores["port"]) == _meta(stores["jax"])
    for path in stores.values():
        for zio in (tzio, jzio):
            got = zio.open_zarr(path).read_all()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert tzio.open_zarr(stores["port"])[9, 4:7, 18].tolist() == \
        want[9, 4:7, 18].tolist()


def test_slash_separator_store(tmp_path):
    import tensorstore as ts
    path = str(tmp_path / "slash.zarr")
    data = _volume((9, 17, 12), np.uint16)
    meta = {"shape": list(data.shape), "chunks": [4, 8, 8], "dtype": "<u2",
            "compressor": dict(tzio.DEFAULT_COMPRESSOR), "fill_value": 0,
            "dimension_separator": "/"}
    store = ts.open({"driver": "zarr", "kvstore": {"driver": "file",
                                                   "path": path},
                     "metadata": meta}, create=True).result()
    store[...].write(data).result()
    assert (Path(path) / "1" / "1" / "1").is_file()
    vol = tzio.open_zarr(path, writable=True)
    np.testing.assert_array_equal(vol.read_all(), data)
    data[3:7, 5:11, 2:9] = 7
    vol[3:7, 5:11, 2:9] = 7
    np.testing.assert_array_equal(
        np.asarray(store[...].read().result()), data)


def test_channels_last_normals_store(tmp_path):
    data = _volume((9, 12, 10, 3), np.uint16)
    for writer, reader in ((tzio, jzio), (jzio, tzio)):
        path = str(tmp_path / f"{writer.__name__}.zarr")
        vol = writer.create_zarr(path, data.shape, np.uint16, (4, 8, 8, 3))
        vol[...] = data
        vol[2:5, 1:3] = data[2:5, 1:3] // 2
        want = data.copy()
        want[2:5, 1:3] //= 2
        np.testing.assert_array_equal(reader.open_zarr(path).read_all(),
                                      want)


# ---------------------------------------------------- codec properties

@pytest.mark.parametrize("level", [1, 3, 9, 19, 22])
def test_zstd_frames_decode_with_zstandard(level):
    raw = _volume((20, 40, 41), np.uint16, seed=level).tobytes()
    for checksum in (False, True):
        frame = codec.zstd_compress(raw, level, checksum)
        assert len(frame) < len(raw)
        assert zstandard.ZstdDecompressor().decompress(frame) == raw
        assert codec.zstd_decompress(frame, len(raw)) == raw


_COMPRESSORS = BLOSC + [dict(c, clevel=1) for c in BLOSC[:3]] + OTHERS


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.one_of(st.binary(max_size=3000),
                      st.builds(lambda b, k: b * k,
                                st.binary(min_size=1, max_size=40),
                                st.integers(1, 200))),
       comp=st.sampled_from(_COMPRESSORS),
       typesize=st.sampled_from([1, 2, 4]))
def test_round_trips(data, comp, typesize):
    data = data[:len(data) // typesize * typesize]
    enc = codec.encode_chunk(comp, data, typesize)
    assert codec.decode_chunk(comp, enc, len(data)) == data
    if comp is not None and comp["id"] == "zstd":
        assert zstandard.ZstdDecompressor().decompress(
            enc, max_output_size=len(data) + 1) == data


def _valid_chunks():
    raw = _volume((8, 24, 20), np.uint16).tobytes()
    out = [(c, codec.encode_chunk(c, raw, 2), len(raw))
           for c in (tzio.DEFAULT_COMPRESSOR, BLOSC[4], BLOSC[8], BLOSC[14],
                     BLOSC[16], {"id": "zstd", "level": 3, "checksum": True})]
    for name in ("blosc_blosclz_s1_uint16.bin", "blosc_lz4_s1_edge_uint16.bin",
                 "blosc_zlib_s2_float32.bin", "zstd_l19_c1_s1_uint16.bin",
                 "zstd_l3_multiblock_uint16.bin",
                 "blosc_snappy_s1_uint16.bin"):
        e = next(e for e in MANIFEST if e["file"] == name)
        out.append((e["compressor"], (FIXTURES / name).read_bytes(),
                    int(np.prod(e["shape"])) * np.dtype(e["dtype"]).itemsize))
    return out


VALID = _valid_chunks()


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(case=st.integers(0, len(VALID) - 1), data=st.data())
def test_corrupt_chunks_raise_value_error(case, data):
    """A changed byte raises ``ValueError`` or decodes to a chunk of the
    right size (a literal byte carries no redundancy); a truncated chunk
    always raises. Nothing reads or writes out of bounds: a fault would
    end this process."""
    comp, chunk, nbytes = VALID[case]
    buf = bytearray(chunk)
    for _ in range(data.draw(st.integers(1, 4))):
        i = data.draw(st.integers(0, len(buf) - 1))
        buf[i] = data.draw(st.integers(0, 255))
    try:
        raw = codec.decode_chunk(comp, bytes(buf), nbytes)
    except ValueError:
        pass
    else:
        assert len(raw) == nbytes
    cut = data.draw(st.integers(0, len(chunk) - 1))
    with pytest.raises(ValueError):
        codec.decode_chunk(comp, chunk[:cut], nbytes)


def test_low_level_decoders_reject_garbage():
    rng = np.random.default_rng(0)
    for _ in range(200):
        junk = rng.integers(0, 256, int(rng.integers(1, 300)),
                            np.uint8).tobytes()
        for fn in (codec.zstd_decompress, codec.lz4_decompress,
                   codec.blosclz_decompress, codec.zlib_decompress,
                   codec.snappy_decompress):
            try:
                out = fn(junk, 4096)
            except ValueError:
                continue
            assert len(out) <= 4096


def test_snappy_blocks_round_trip_and_malformed_ones_raise():
    """The Snappy block codec alone: round trips over literals of every
    length class and copies of every offset class, then the malformed
    streams: truncated, a stated length past the output, a copy from
    before the start, an offset of 0, a literal past the input, and
    output past the stated length."""
    rng = np.random.default_rng(3)
    for raw in (b"", b"a", bytes(60), bytes(range(61)),
                rng.integers(0, 256, 70000, np.uint8).tobytes(),
                bytes(range(256)) * 300, b"ab" * 40000):
        enc = codec.snappy_compress(raw)
        assert codec.snappy_decompress(enc, len(raw)) == raw
    # length 6, a literal of 2 bytes, a 4-byte copy from 2 bytes back
    good = bytes([6, 1 << 2, ord("a"), ord("b"), 0b00000001, 2])
    assert codec.snappy_decompress(good, 6) == b"ababab"
    bad = {
        "truncated": codec.snappy_compress(bytes(range(200)) * 3)[:-7],
        "length over 32 bits": bytes([0x80, 0x80, 0x80, 0x80, 0x80, 1]),
        "stated length over the buffer": bytes([100, 0, ord("x")]),
        "copy before the start": bytes([6, 1 << 2, 97, 98, 0b1, 9]),
        "offset 0": bytes([6, 1 << 2, 97, 98, 0b1, 0]),
        "literal past the input": bytes([4, 3 << 2, 97]),
        "output past its length": bytes([1, 1 << 2, 97, 98]),
        "short output": bytes([5, 1 << 2, 97, 98]),
        "copy-2 offset cut": bytes([6, 1 << 2, 97, 98, 0b10, 1]),
    }
    for name, data in bad.items():
        with pytest.raises(ValueError):
            codec.snappy_decompress(data, 8 if name.startswith("stated")
                                    else 64)


def test_fortran_order_store_read_and_written_as_tensorstore(tmp_path):
    """An F-order store (tensorstore writes the transposed chunk) read and
    written in part by the port, read back by tensorstore."""
    import tensorstore as ts
    path = str(tmp_path / "f.zarr")
    data = _volume((9, 17, 12), np.uint16)
    meta = {"shape": list(data.shape), "chunks": [4, 8, 8], "dtype": "<u2",
            "compressor": BLOSC[16], "fill_value": 0, "order": "F"}
    store = ts.open({"driver": "zarr", "kvstore": {"driver": "file",
                                                   "path": path},
                     "metadata": meta}, create=True).result()
    store[...].write(data).result()
    vol = tzio.open_zarr(path, writable=True)
    np.testing.assert_array_equal(vol.read_all(), data)
    np.testing.assert_array_equal(vol[2:7, 3, 1:11], data[2:7, 3, 1:11])
    data[3:7, 5:11, 2:9] = 7
    vol[3:7, 5:11, 2:9] = 7
    np.testing.assert_array_equal(
        np.asarray(store[...].read().result()), data)


def test_unsupported_codecs_raise(tmp_path):
    raw = bytes(range(256)) * 4
    with pytest.raises(ValueError, match="lzma"):
        codec.blosc_compress(raw, "lzma")
    frame = bytearray(codec.blosc_compress(raw, "lz4", shuffle=0))
    frame[2] = (frame[2] & 0x1F) | (5 << 5)   # no Blosc 1 stream has code 5
    with pytest.raises(ValueError, match="unsupported"):
        codec.decode_chunk({"id": "blosc", "cname": "lz4"}, bytes(frame),
                           len(raw))
    rng = np.random.default_rng(1)
    trained = zstandard.train_dictionary(2048, [
        rng.integers(0, 40, 300, np.uint8).tobytes() for _ in range(300)])
    with pytest.raises(ValueError, match="dictionary"):
        codec.zstd_decompress(zstandard.ZstdCompressor(
            dict_data=trained).compress(raw), len(raw))
    with pytest.raises(ValueError, match="unsupported zarr compressor"):
        codec.decode_chunk({"id": "lzma"}, raw, len(raw))
    with pytest.raises(ValueError, match="checksum"):
        bad = bytearray(codec.zstd_compress(raw, 3, checksum=True))
        bad[-1] ^= 1
        codec.zstd_decompress(bytes(bad), len(raw))
    path = tmp_path / "f.zarr"
    path.mkdir()
    (path / ".zarray").write_text(json.dumps({
        "shape": [4], "chunks": [4], "dtype": "|u1", "compressor": None,
        "fill_value": 0, "filters": [{"id": "delta", "dtype": "|u1"}],
        "order": "C", "zarr_format": 2}))
    with pytest.raises(ValueError, match="without filters"):
        tzio._LocalZarr(str(path), _meta(path))


# ------------------------------------------------------- local backend

def test_async_futures_and_threaded_partial_writes(tmp_path):
    """``read_async`` / ``write_async`` return futures of the pool; 16
    threads writing disjoint parts of the same compressed chunks,
    switching often, lose no update."""
    path = str(tmp_path / "a.zarr")
    vol = tzio.create_zarr(path, (16, 32, 16), np.float32, (8, 32, 16))
    futs = [vol.write_async(np.s_[z], np.full((32, 16), z, np.float32))
            for z in range(16)]
    assert all(isinstance(f, Future) for f in futs)
    for f in futs:
        f.result()
    reads = [vol.read_async(np.s_[z, 3]) for z in range(16)]
    assert [float(r.result()[0]) for r in reads] == list(range(16))

    def worker(t):
        for z in range(16):
            vol[z, 2 * t:2 * t + 2] = t + 100 * z

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    want = (np.arange(16)[:, None] * 100 + np.arange(32)[None] // 2)
    np.testing.assert_array_equal(jzio.open_zarr(path).read_all()[:, :, 0],
                                  want.astype(np.float32))


def test_library_is_built_from_the_source_alone():
    src = codec.SOURCE.read_text()
    includes = [line for line in src.splitlines()
                if line.startswith("#include")]
    assert not [i for i in includes
                if any(k in i for k in ("zstd", "lz4", "zlib", "blosc"))]
    assert codec.load() is not None
    lib = codec.library_path()
    assert lib.parent == codec.BUILD_DIR and lib.is_file()
    assert not any(f in codec.GXX_FLAGS for f in ("-lzstd", "-llz4", "-lz",
                                                  "-lblosc"))
    ldd = subprocess.run(["ldd", str(lib)], capture_output=True, text=True)
    if ldd.returncode == 0:
        linked = ldd.stdout.lower()
        assert not any(f"lib{k}" in linked
                       for k in ("zstd", "lz4", "z.so", "blosc"))


# ----------------------------------------------- without tensorstore

_BLOCKED = """
import sys
sys.modules["tensorstore"] = None
sys.path.insert(0, {root!r})
"""

_STORES = _BLOCKED + """
import json
import numpy as np
from mt3d_resenc_unet_torch.data import zio
comps = json.loads({comps!r})
for i, comp in enumerate(comps):
    for dtype in (np.uint8, np.uint16, np.float32):
        path = f"{tmp}/s{{i}}_{{np.dtype(dtype).name}}.zarr"
        data = (np.arange(10 * 21 * 19) % 251).reshape(10, 21, 19)
        data = data.astype(dtype)
        vol = zio.create_zarr(path, data.shape, dtype, (4, 8, 8),
                              compressor=comp)
        vol[...] = data
        vol[1:3, 5:9, 2:4] = 9
        data[1:3, 5:9, 2:4] = 9
        got = zio.open_zarr(path).read_all()
        assert np.array_equal(got, data), (comp, dtype)
print("ok", "tensorstore" in sys.modules and sys.modules["tensorstore"])
"""

_ENGINE = _BLOCKED + """
from mt3d_resenc_unet_torch.infer import engine as eng
cfg = {cfg}
for name, comp in (("blosc", eng.DEFAULT_COMPRESSOR), ("raw", None)):
    eng.DEFAULT_COMPRESSOR = comp
    for mode in ("device", "rolling"):
        c = json.loads(json.dumps(cfg))
        c["inference_config"]["output_path"] = f"{tmp}/{{name}}_{{mode}}"
        c["inference_config"]["device_accumulate"] = mode == "device"
        e = eng.ZarrInferenceEngine(config_dict=c, device="cpu")
        e.infer()
        assert e.last_mode == mode, e.last_mode
print("ok", sys.modules["tensorstore"])
"""


def _run_blocked(script):
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok None"


def test_local_stores_without_tensorstore(tmp_path):
    comps = json.dumps(BLOSC + OTHERS)
    _run_blocked(_STORES.format(root=str(ROOT), comps=comps,
                                tmp=str(tmp_path)))
    for i, comp in enumerate(BLOSC + OTHERS):
        path = tmp_path / f"s{i}_uint16.zarr"
        assert _meta(path)["compressor"] == tzio._normalize_compressor(comp)
        data = (np.arange(10 * 21 * 19) % 251).reshape(10, 21, 19)
        data[1:3, 5:9, 2:4] = 9
        np.testing.assert_array_equal(jzio.open_zarr(str(path)).read_all(),
                                      data.astype(np.uint16))


def test_engine_without_tensorstore(tmp_path):
    """The engine's device and rolling passes on Blosc stores, tensorstore
    blocked: the JAX package reads their finals equal to the same passes'
    uncompressed finals."""
    import jax
    import jax.numpy as jnp
    from mt3d_resenc_unet_tpu.core.config import ConfigManager
    from mt3d_resenc_unet_tpu.models.network import ResEncUNet
    from mt3d_resenc_unet_torch.tools.from_jax import params_from_jax
    from mt3d_resenc_unet_torch.train.checkpoint import save_params
    shape, patch = (24, 24, 24), [16, 16, 16]
    img = str(tmp_path / "img.zarr")
    tzio.create_zarr(img, shape, np.uint8, (16, 16, 16))[...] = \
        np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    cfg = {
        "tr_setup": {"model_name": "codec", "autoconfigure": False},
        "tr_config": {"patch_size": patch, "batch_size": 2,
                      "compute_dtype": "float32", "mesh_shape": [1]},
        "model_config": {
            "basic_encoder_block": "BasicBlockD",
            "basic_decoder_block": "ConvBlock",
            "bottleneck_block": "BasicBlockD",
            "features_per_stage": [4, 8], "num_stages": 2,
            "n_blocks_per_stage": [1, 1], "n_conv_per_stage_decoder": [1],
            "kernel_sizes": [3, 3], "strides": [1, 2]},
        "dataset_config": {"in_channels": 1, "volume_paths": [],
                           "targets": {
                               "sheet": {"channels": 1,
                                         "activation": "sigmoid"},
                               "normals": {"channels": 3,
                                           "activation": "none"}}},
        "inference_config": {
            "checkpoint_path": str(tmp_path / "port.pt"), "input_path": img,
            "output_path": "", "overlap": 0.5, "patch_size": patch,
            "batch_size": 2, "normalization": "standardize",
            "gaussian_blend": True, "device_accumulate": True,
            "host_ram_budget_gb": 8.0, "num_dataloader_workers": 1,
            "output_targets": ["sheet", "normals"]}}
    plan = ConfigManager(config_dict=cfg).build_plan()
    params = jax.device_get(ResEncUNet(plan=plan, dtype=jnp.float32).init(
        {"params": jax.random.key(3)}, jnp.zeros((1, *patch, 1)),
        train=False)["params"])
    save_params(tmp_path / "port.pt", params_from_jax(params))
    _run_blocked("import json\n" + _ENGINE.format(
        root=str(ROOT), cfg=repr(cfg), tmp=str(tmp_path)))
    for mode in ("device", "rolling"):
        for name in ("sheet", "normals"):
            blosc = tmp_path / f"blosc_{mode}" / "predictions.zarr"
            raw = tmp_path / f"raw_{mode}" / "predictions.zarr"
            final = f"{name}_final"
            assert _meta(blosc / final)["compressor"]["cname"] == "zstd"
            assert _meta(raw / final)["compressor"] is None
            got = jzio.open_zarr(str(blosc / final)).read_all()
            np.testing.assert_array_equal(
                got, jzio.open_zarr(str(raw / final)).read_all())
