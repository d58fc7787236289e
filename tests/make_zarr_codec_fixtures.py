"""Writes the golden chunk files of ``tests/data/zarr_codec/``.

Each file is one stored zarr chunk written by another encoder than the
port's: Blosc chunks by tensorstore (through the JAX package's
``create_zarr``: zstd, lz4, lz4hc, blosclz and zlib streams, shuffle 0, 1
and 2, ``|u1``, ``<u2`` and ``<f4``), and zstd frames by the ``zstandard``
package at levels 1, 5, 19 and 22, with and without a checksum and a
content size. ``manifest.json`` lists each file's compressor, dtype, shape
and the sha256 of its raw C-order bytes. The tests and ``chip_smoke.py``
decode every file with the port's codec and match the sha256.

Run from the repository root, where tensorstore and zstandard are
installed: ``JAX_PLATFORMS=cpu python tests/make_zarr_codec_fixtures.py``.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "zarr_codec"
SHAPE = (8, 16, 16)
CNAMES = ("zstd", "lz4", "lz4hc", "blosclz", "zlib")
DTYPES = ("|u1", "<u2", "<f4")


def volume(shape, dtype, rng, levels=0) -> np.ndarray:
    """Smooth structure plus a little noise, like a scan volume; with
    ``levels``, the structure takes that many values (a label-like chunk
    that stays small on disk at any size)."""
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float64) for n in shape),
                          indexing="ij")
    base = np.sin(x / 5.0) * np.cos(y / 7.0) + 0.5 * np.sin(z / 3.0)
    if levels:
        base = np.round(base * levels / 3.0) * 3.0 / levels
        return np.where(rng.random(shape) < 0.0002, 1, (base + 1.5) * 1000
                        ).astype(dtype)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return (base * 100.0 + rng.normal(0, 0.01, shape)).astype(dt)
    top = np.iinfo(dt).max
    vals = (base + 1.5) / 3.0 * top * 0.8 + rng.integers(0, 4, shape)
    return np.clip(vals, 0, top).astype(dt)


def tensorstore_chunk(work: Path, name: str, data: np.ndarray, compressor,
                      fill_value=0) -> bytes:
    """The one chunk tensorstore stores for ``data`` (array = chunk)."""
    from mt3d_resenc_unet_tpu.data.zio import create_zarr
    path = work / name
    vol = create_zarr(str(path), data.shape, data.dtype, data.shape,
                      compressor=compressor, fill_value=fill_value,
                      delete_existing=True)
    vol[...] = data
    return (path / ".".join("0" * data.ndim)).read_bytes()


def main() -> int:
    import zstandard
    rng = np.random.default_rng(20261017)
    if OUT.exists():
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    entries = []

    def add(name, stored, data, compressor, **extra):
        (OUT / name).write_bytes(stored)
        entries.append({
            "file": name, "compressor": compressor,
            "dtype": np.dtype(data.dtype).str, "shape": list(data.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(data).tobytes())
            .hexdigest(), **extra})

    work = Path(tempfile.mkdtemp())
    try:
        for cname in CNAMES:
            for shuffle in (0, 1, 2):
                for dt in DTYPES:
                    data = volume(SHAPE, dt, rng)
                    comp = {"id": "blosc", "cname": cname, "clevel": 5,
                            "shuffle": shuffle, "blocksize": 0}
                    tag = np.dtype(dt).name
                    name = f"blosc_{cname}_s{shuffle}_{tag}.bin"
                    add(name, tensorstore_chunk(work, name, data, comp), data,
                        comp, source="tensorstore")
        zstd5 = {"id": "blosc", "cname": "zstd", "clevel": 5, "shuffle": 2,
                 "blocksize": 0}
        lz4 = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1,
               "blocksize": 0}
        zeros = np.zeros(SHAPE, np.uint16)
        add("blosc_zstd_zeros_uint16.bin",
            tensorstore_chunk(work, "z", zeros, zstd5, fill_value=7), zeros,
            zstd5, source="tensorstore")
        noise = rng.integers(0, 256, SHAPE, dtype=np.uint8)
        for comp, tag in ((zstd5, "zstd"), (lz4, "lz4")):
            add(f"blosc_{tag}_random_uint8.bin",
                tensorstore_chunk(work, "r", noise, comp), noise, comp,
                source="tensorstore")
        # Several blocks, the last one shorter and not a multiple of
        # 8 * typesize: 67^3 u2 = 2 blocks of 256 KiB + 77238 bytes (a
        # short block that c-blosc leaves unshuffled); for lz4's split
        # streams, 53^3 u2 = one block of 256 KiB + 35610 bytes.
        for shape, comp, tag in (((67,) * 3, zstd5, "zstd_s2"),
                                 ((53,) * 3, lz4, "lz4_s1")):
            big = volume(shape, "<u2", rng, levels=6)
            add(f"blosc_{tag}_edge_uint16.bin",
                tensorstore_chunk(work, "e", big, comp), big, comp,
                source="tensorstore")
        big4 = volume((41, 41, 41), "<f4", rng, levels=6)
        add("blosc_zstd_s2_edge_float32.bin",
            tensorstore_chunk(work, "e4", big4, zstd5), big4, zstd5,
            source="tensorstore")
        for level in (1, 5):
            comp = {"id": "zstd", "level": level}
            data = volume(SHAPE, "<u2", rng)
            add(f"zstd_ts_l{level}_uint16.bin",
                tensorstore_chunk(work, "t", data, comp), data, comp,
                source="tensorstore")
        for level in (1, 5, 19, 22):
            for checksum in (False, True):
                for content_size in (False, True):
                    data = volume(SHAPE, "<u2", rng)
                    cctx = zstandard.ZstdCompressor(
                        level=level, write_checksum=checksum,
                        write_content_size=content_size)
                    add(f"zstd_l{level}_c{int(checksum)}_s{int(content_size)}"
                        "_uint16.bin", cctx.compress(data.tobytes()), data,
                        {"id": "zstd", "level": level}, source="zstandard",
                        checksum=checksum, content_size=content_size)
        multi = volume((40, 64, 64), "<u2", rng, levels=6)   # 3 zstd blocks
        add("zstd_l3_multiblock_uint16.bin",
            zstandard.ZstdCompressor(level=3, write_checksum=True)
            .compress(multi.tobytes()), multi, {"id": "zstd", "level": 3},
            source="zstandard", checksum=True, content_size=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    (OUT / "manifest.json").write_text(json.dumps(entries) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(entries)} chunks, {total} bytes in {OUT}")
    return 0 if total < 512 * 1024 else 1


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
