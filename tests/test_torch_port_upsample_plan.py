"""The tiling of the port's upsample backward kernels, on the CPU.

``ops/upsample.py::_up_bwd_plan`` chooses in Python how the CUDA kernels of
``csrc/upsample2x_bwd.cu`` cut their work, and ``up2_row`` says where the
kernels stage each fine cotangent row. The schedules below decode every
block's work as the kernels decode their block indices (the planner's
docstring). At both flagship shapes (N = 2) and at extents that are no
multiple of the tiles, on a card of 132 SMs and a smaller one: dx must
write every (coarse voxel, input channel) once; dW must sum every coarse
voxel once into every (parity, ci, co), each output tile owned by exactly
one block of each split; the staging map must give every fine voxel of a
tile its own row, with the 8 consecutive coarse voxels of one parity in 8
consecutive rows, and the kernels' XOR swizzle must put such 8 rows in 8
distinct shared-memory bank groups.
"""

import numpy as np
import pytest

from mt3d_resenc_unet_torch.ops import upsample as up

# (ci, co, coarse extent) of the flagship's upsamples, then odd cases
SHAPES = [(128, 64, (32,) * 3), (64, 32, (64,) * 3), (128, 64, (5, 6, 5)),
          (64, 32, (6, 7, 6)), (32, 32, (3, 4, 3)), (64, 64, (4, 9, 17)),
          (96, 32, (2, 3, 33))]
IDS = [f"{ci}-{co}@{'x'.join(map(str, e))}" for ci, co, e in SHAPES]


def _tile_voxels(t: int, n: int, size, vh: int):
    """The coarse voxels (sample, d, h, w) of tile t (vh x 16 of one (n, d),
    clipped), decoded as the kernels' ``decode``."""
    d, h, w = size
    nhg, nwg = -(-h // vh), -(-w // up.UP_VW)
    wg, t = t % nwg, t // nwg
    hg, t = t % nhg, t // nhg
    dd, s = t % d, t // d
    assert s < n
    return [(s, dd, hh, ww) for hh in range(hg * vh, min(h, hg * vh + vh))
            for ww in range(wg * up.UP_VW, min(w, wg * up.UP_VW + up.UP_VW))]


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("ci,co,size", SHAPES, ids=IDS)
def test_dx_schedule_writes_every_voxel_and_channel_once(ci, co, size, sms):
    n = 2
    plan = up._up_bwd_plan(n, size, ci, co, sms)["dx"]
    tm, tci, tiles = plan["tm"], plan["tci"], plan["tiles"]
    blocks, ci_tiles = plan["grid"]
    assert ci_tiles * tci == ci and blocks <= tiles
    assert tm % up.UP_VW == 0 and tm * tci <= 16384   # 64 sums a thread
    # the H100's 232,448 bytes of shared memory a block, where dx runs
    assert co > up.UP_DX_MAX_CO or plan["smem"] <= 232448
    counts = np.zeros((n,) + tuple(size) + (ci_tiles,), np.int32)
    for cit in range(ci_tiles):
        for b in range(blocks):
            mine = range(b * tiles // blocks, (b + 1) * tiles // blocks)
            assert len(mine), "a block without work"
            for t in mine:
                for s, d, h, w in _tile_voxels(t, n, size, tm // up.UP_VW):
                    counts[s, d, h, w, cit] += 1
    assert counts.min() == 1 and counts.max() == 1


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("ci,co,size", SHAPES, ids=IDS)
def test_dw_schedule_sums_every_voxel_into_every_output_once(ci, co, size,
                                                             sms):
    n = 2
    plan = up._up_bwd_plan(n, size, ci, co, sms)["dw"]
    tci, tco, pb = plan["tci"], plan["tco"], plan["pb"]
    tiles, splits, chunks = plan["tiles"], plan["splits"], plan["chunks"]
    assert plan["scratch"] == (splits, 8, ci, co)
    assert plan["blocks"] == tiles * splits <= max(sms, tiles)
    assert 1 <= splits <= chunks
    assert pb * tci * tco <= 16384                    # 64 sums a thread
    assert plan["smem"] <= 232448
    ntci, ntco = ci // tci, co // tco
    # per split: which block writes each (parity, ci, co) of its slice
    owner = np.zeros((splits, 8, ci, co), np.int32)
    # per (parity, ci tile, co tile): how often each coarse voxel is summed
    seen = np.zeros((8, ntci, ntco, n) + tuple(size), np.int32)
    for blk in range(plan["blocks"]):
        tile, split = blk % tiles, blk // tiles
        pg, cit, cot = tile // (ntci * ntco), tile // ntco % ntci, tile % ntco
        pars = slice(pg * pb, pg * pb + pb)
        owner[split, pars, cit * tci:(cit + 1) * tci,
              cot * tco:(cot + 1) * tco] += 1
        for c in range(split * chunks // splits,
                       (split + 1) * chunks // splits):
            for s, d, h, w in _tile_voxels(c, n, size, up.UP_DW_VH):
                seen[pars, cit, cot, s, d, h, w] += 1
    assert owner.min() == 1 and owner.max() == 1
    assert seen.min() == 1 and seen.max() == 1


def test_flagship_plans():
    p = up._up_bwd_plan(2, (64,) * 3, 64, 32, 132)
    # 64->32: one tile of all 8 parities x 64 x 32, x and gy read once
    assert (p["dw"]["tci"], p["dw"]["tco"], p["dw"]["pb"]) == (64, 32, 8)
    assert p["dw"]["tiles"] == 1 and p["dw"]["splits"] == 132
    assert (p["dx"]["tm"], p["dx"]["tci"]) == (256, 64)
    assert p["dx"]["grid"] == (132, 1)
    p = up._up_bwd_plan(2, (32,) * 3, 128, 64, 132)
    # 128->64: 4 tiles of one (a, b) each (gy read once, x 4 times)
    assert (p["dw"]["tci"], p["dw"]["tco"], p["dw"]["pb"]) == (128, 64, 2)
    assert p["dw"]["tiles"] == 4 and p["dw"]["splits"] == 33
    assert p["dw"]["scratch"] == (33, 8, 128, 64)
    assert (p["dx"]["tm"], p["dx"]["tci"]) == (128, 128)
    assert p["dx"]["grid"] == (132, 1)


def _stage_row(abl, f, hh, vh):
    """csrc/upsample2x_bwd.cu ``gy_slots``: fine w index f of coarse row hh
    of the tile's (a, b) number abl."""
    return abl * 2 * vh * up.UP_VW + ((f & 1) * vh + hh) * up.UP_VW + (f >> 1)


@pytest.mark.parametrize("vh,groups", [(up.UP_DW_VH, 4), (up.UP_DW_VH, 1),
                                       (8, 1), (16, 1)])
def test_parity_staging_map(vh, groups):
    vox = vh * up.UP_VW
    rows = {}
    for abl in range(groups):
        for hh in range(vh):
            for f in range(2 * up.UP_VW):
                c, k = f & 1, f >> 1
                row = up.up2_row(abl, c, vox, up.UP_VW, hh, k)
                assert row == _stage_row(abl, f, hh, vh)
                rows[(abl, hh, f)] = row
    # every fine voxel of the tile has its own row, rows 0 .. R - 1
    assert sorted(rows.values()) == list(range(groups * 2 * vox))
    # parity (ab, c): coarse voxel v = hh * 16 + k is row (2 ab + c) vox + v,
    # so 8 consecutive coarse voxels are 8 consecutive rows
    for abl in range(groups):
        for c in range(2):
            for v in range(vox):
                hh, k = divmod(v, up.UP_VW)
                assert rows[(abl, hh, 2 * k + c)] == (2 * abl + c) * vox + v


def _swz(r: int, j: int, p: int) -> int:
    """csrc/upsample2x_bwd.cu ``swz``: byte offset of piece j of row r."""
    s = ((j & ~3) | ((j ^ (r >> 1)) & 3)) if p & 7 else \
        ((j & ~7) | ((j ^ r) & 7))
    return (r * p + s) * 16


@pytest.mark.parametrize("pieces", [4, 8, 12, 16, 32])
def test_swizzle_spreads_eight_rows_over_the_banks(pieces):
    for r0 in range(0, 64, 2):
        for j in range(pieces):
            offs = [_swz(r, j, pieces) for r in range(r0, r0 + 8)]
            assert {o // 16 % 8 for o in offs} == set(range(8))
    for r in range(16):
        # a row's pieces stay in the row, each once
        got = sorted(_swz(r, j, pieces) for j in range(pieces))
        assert got == [(r * pieces + j) * 16 for j in range(pieces)]
