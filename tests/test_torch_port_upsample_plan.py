"""The tiling of the port's upsample kernels, on the CPU.

``ops/upsample.py::_up_fwd_plan`` and ``_up_bwd_plan`` choose in Python how
the CUDA kernels of ``csrc/upsample2x.cu`` and ``csrc/upsample2x_bwd.cu``
cut their work, and ``up2_row`` says where the kernels stage each fine
row (the forward's outputs, the backward's cotangent). The schedules below
decode every block's work as the kernels decode their block indices (the
planners' docstrings). At both flagship shapes (N = 2) and at extents that
are no multiple of the tiles, on a card of 132 SMs and a smaller one: the
forward must write every (coarse voxel, parity, output channel) of y once,
its ring must load each step for the (tile, pair, chunk) that consumes it,
and its schedule run on numbers (each tile's GEMM summed over the ring's
K chunks, staged by ``up2_row``, then the fine-row stores in the kernel's
piece order) must give ``upsample_plain``'s y; dx must write every (coarse voxel, input channel)
once; dW must sum every coarse voxel once into every (parity, ci, co), each
output tile owned by exactly one block of each split; the staging map must
give every fine voxel of a tile its own row, with the 8 consecutive coarse
voxels of one parity in 8 consecutive rows, and the kernels' XOR swizzle
must put such 8 rows, and each 8 threads' reads of the forward's staged
outputs, in 8 distinct shared-memory bank groups. The fp32 kernels' plans
(``_up_f32_fwd_plan``, ``_up_f32_dx_plan``, ``_up_f32_dw_plan``,
csrc/upsample2x_f32.cu) at the same shapes: every output written once,
every coarse voxel summed into every (parity, ci, co) of dW once, within
the shared memory, the scratch sized to the splits. The three, walked on
numbers as they index their buffers, give the plain versions, and their
fp32 slots, fp64 buffers and staged outputs are read and written across
all 32 banks.
"""

import math

import numpy as np
import pytest
import torch

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


# ---------------------------------------------------------------- forward


def _fwd_blocks(plan):
    """(co tile, tile) of every block's work, as the forward kernel decodes
    ``blockIdx``."""
    tiles, (blocks, groups) = plan["tiles"], plan["grid"]
    for ct in range(groups):
        for b in range(blocks):
            mine = range(b * tiles // blocks, (b + 1) * tiles // blocks)
            assert len(mine), "a block without work"
            for t in mine:
                yield ct, t


def _tile_box(t, n, size, vh):
    """Tile t's (sample, d, h slice, w slice), clipped to the volume, as
    the kernels' ``decode``."""
    d, h, w = size
    nhg, nwg = -(-h // vh), -(-w // up.UP_VW)
    wg, t = t % nwg, t // nwg
    hg, t = t % nhg, t // nhg
    dd, s = t % d, t // d
    assert s < n
    return (s, dd, slice(hg * vh, min(h, hg * vh + vh)),
            slice(wg * up.UP_VW, min(w, wg * up.UP_VW + up.UP_VW)))


def _fwd_store_piece(i: int, po: int):
    """csrc/upsample2x.cu: piece i of a pair's fine-row stores -> (hh, fine
    w f, 16-byte piece j); with 4 pieces a row the 8 fine voxels of each 32
    pieces go in the order (k bit 1, c, k bit 0)."""
    j, e = i % po, i // po
    if po == 4:
        b3 = e & 7
        e = (e & ~7) | (((b3 & 1) | ((b3 >> 1) & 2)) << 1) | ((b3 >> 1) & 1)
    return e // (2 * up.UP_VW), e % (2 * up.UP_VW), j


def test_fwd_flagship_plans():
    p = up._up_fwd_plan(2, (32,) * 3, 128, 64, 132)
    # 128->64: all eight parities x 64 co resident (128 KB), x read once
    assert (p["tm"], p["tco"], p["kc"], p["resident"]) == (128, 64, 128, True)
    assert p["tiles"] == 512 and p["grid"] == (132, 1)
    assert p["smem"] == 131072 + 2 * 32768 + 32768 <= 232448
    p = up._up_fwd_plan(2, (64,) * 3, 64, 32, 132)
    assert (p["tm"], p["tco"], p["kc"], p["resident"]) == (256, 32, 64, True)
    assert p["tiles"] == 2048 and p["grid"] == (132, 1)
    assert p["smem"] == 32768 + 2 * 32768 + 32768


@pytest.mark.parametrize("ci", [32, 128, 576, 608, 2048])
@pytest.mark.parametrize("co", [32, 64, 96, 512])
def test_fwd_takes_any_channels_in_fixed_shared_memory(ci, co):
    """Off the two resident shapes a ring stage is 32 channels of x and of
    one pair's weights, so the shared memory does not grow with Ci."""
    p = up._up_fwd_plan(1, (4,) * 3, ci, co, 132)
    if (ci, co) in up.UP_FWD_RESIDENT:
        return
    assert (p["tm"], p["tco"], p["kc"], p["resident"]) == (64, 32, 32, False)
    assert p["smem"] == 2 * (4096 + 4096) + 8192
    assert p["grid"][1] == co // 32 and ci % p["kc"] == 0


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("ci,co,size", SHAPES, ids=IDS)
def test_fwd_schedule_writes_every_output_once(ci, co, size, sms):
    n = 2
    plan = up._up_fwd_plan(n, size, ci, co, sms)
    tm, tco = plan["tm"], plan["tco"]
    blocks, groups = plan["grid"]
    assert tm % up.UP_VW == 0 and blocks <= plan["tiles"]
    assert groups == co // tco and co % tco == 0 and ci % plan["kc"] == 0
    assert tm * 2 * tco <= 16384                      # 64 sums a thread
    assert plan["smem"] <= 232448   # the H100's shared memory a block
    # writes of each (coarse voxel, parity, co tile): every block writes
    # all eight parities of its tiles
    counts = np.zeros((n,) + tuple(size) + (co // tco,), np.int32)
    for ct, t in _fwd_blocks(plan):
        s, d, hs, ws = _tile_box(t, n, size, tm // up.UP_VW)
        counts[s, d, hs, ws, ct] += 1
    assert counts.min() == 1 and counts.max() == 1


@pytest.mark.parametrize("ci,co,size", SHAPES[2:], ids=IDS[2:])
def test_fwd_schedule_on_numbers_matches_plain(ci, co, size):
    """Each block's tiles as the kernel runs them: for each (a, b) pair in
    turn, the tile's x (zero past the volume) times Wf[p], summed over the
    ring's K chunks of ``kc`` channels, both c staged at ``up2_row`` (rows
    of 2 * tm), then the fine-row stores in the kernel's piece order,
    skipping what lies past the volume."""
    n = 2
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n,) + tuple(size) + (ci,)).astype(np.float32)
    wf = rng.standard_normal((2, 2, 2, ci, co)).astype(np.float32)
    plan = up._up_fwd_plan(n, size, ci, co, 132)
    tm, tco, kc = plan["tm"], plan["tco"], plan["kc"]
    vh, po = tm // up.UP_VW, tco // 8
    d, h, w = size
    y = np.full((n, 2 * d, 2 * h, 2 * w, co), np.nan, np.float32)
    wp = wf.reshape(8, ci, co)
    for ct, t in _fwd_blocks(plan):
        s, dd, hs, ws = _tile_box(t, n, size, vh)
        h0, w0 = hs.start, ws.start
        xt = np.zeros((vh, up.UP_VW, ci), np.float32)
        xt[:hs.stop - h0, :ws.stop - w0] = x[s, dd, hs, ws]
        xt = xt.reshape(tm, ci)
        cos = slice(ct * tco, (ct + 1) * tco)
        for ab in range(4):
            staged = np.full((2 * tm, tco), np.nan, np.float32)
            for c in range(2):
                acc = np.zeros((tm, tco), np.float32)
                for k0 in range(0, ci, kc):
                    acc += xt[:, k0:k0 + kc] @ wp[2 * ab + c][k0:k0 + kc, cos]
                for v in range(tm):
                    hh, k = divmod(v, up.UP_VW)
                    staged[up.up2_row(0, c, tm, up.UP_VW, hh, k)] = acc[v]
            for i in range(vh * 2 * up.UP_VW * po):
                hh, f, j = _fwd_store_piece(i, po)
                k, c = f >> 1, f & 1
                if h0 + hh < h and w0 + k < w:
                    row = staged[c * tm + hh * up.UP_VW + k]
                    y[s, 2 * dd + (ab >> 1), 2 * (h0 + hh) + (ab & 1),
                      2 * (w0 + k) + c,
                      ct * tco + 8 * j:ct * tco + 8 * j + 8] = \
                        row[8 * j:8 * j + 8]
    want = up.upsample_plain(torch.from_numpy(x), torch.from_numpy(wf))
    assert not np.isnan(y).any()
    np.testing.assert_allclose(y, want.numpy(), rtol=1e-5, atol=1e-4)


def _fwd_ring_step(i: int, nch: int, resident: bool):
    """csrc/upsample2x.cu ``stage``: ring step i -> (tile, pair, chunk)
    that it loads; where resident a step is a whole tile."""
    if resident:
        return i, None, 0
    return i // (4 * nch), i // nch % 4, i % nch


@pytest.mark.parametrize("ci,co", [(128, 64), (64, 32), (32, 32), (96, 96),
                                   (640, 32)])
def test_fwd_ring_steps_follow_the_products(ci, co):
    """The kernel consumes the ring in the order of its loops (tile, pair
    (a, b), chunk), taking a step at every chunk where streamed and at the
    first pair of each tile where resident; the loads must decode each step
    to the (tile, pair, chunk) that consumes it."""
    plan = up._up_fwd_plan(1, (3, 5, 17), ci, co, 132)
    nch, res = ci // plan["kc"], plan["resident"]
    iters = 7
    step = 0
    for it in range(iters):
        for ab in range(4):
            for ch in range(nch):
                if not res or ab == 0:
                    assert _fwd_ring_step(step, nch, res) == (
                        it, None if res else ab, ch)
                    step += 1
    assert step == (iters if res else iters * 4 * nch)


@pytest.mark.parametrize("tm", [64, 128, 256])
@pytest.mark.parametrize("po", [4, 8])
def test_fwd_store_reads_spread_over_the_banks(tm, po):
    vh = tm // up.UP_VW
    pieces = [_fwd_store_piece(i, po) for i in range(vh * 2 * up.UP_VW * po)]
    # each (hh, f, j) once
    assert len(set(pieces)) == len(pieces) == vh * 2 * up.UP_VW * po
    for i0 in range(0, len(pieces), 8):
        offs = [_swz((f & 1) * tm + hh * up.UP_VW + (f >> 1), j, po)
                for hh, f, j in pieces[i0:i0 + 8]]
        assert {o // 16 % 8 for o in offs} == set(range(8))
    # a warp's 32 pieces are 512 contiguous bytes of one fine row
    for i0 in range(0, len(pieces), 32):
        spans = {(hh, f * po + j) for hh, f, j in pieces[i0:i0 + 32]}
        hhs = {hh for hh, _ in spans}
        pos = sorted(p for _, p in spans)
        assert len(hhs) == 1 and pos == list(range(pos[0], pos[0] + 32))


# ------------------------------------------------- the fp32 kernels' plans
#
# csrc/upsample2x_f32.cu: the forward's and dx's blocks (b, group) walk the
# tiles f32_tile_range(b, blocks, tiles) of m consecutive coarse voxels of
# the batch, a tile's outputs m x ncol columns (the forward's columns p * co
# + c, dx's input channels), MMA warp w holding rows (w % wgm) * 32 and
# columns (w // wgm) * 32; dW's block u = split * tiles + co tile * ntci +
# ci tile sums the steps f32_tile_range(split, splits, steps) of
# F32_DW_R coarse voxels along w, step s = (row, w range) = divmod(s, nwr).

SMEM_MAX = 232448        # the H100's dynamic shared memory a block


def _fine_of(v, p, size):
    """The fine voxel 2q + p of flat coarse voxels v, as the kernels'
    ``fine_of`` decodes them (two divisions), into the (n, 2D, 2H, 2W)
    volume."""
    _, hh, ww = size
    r, w = np.divmod(v, ww)
    nd, h = np.divmod(r, hh)
    return (((2 * nd + (p >> 2)) * 2 * hh + 2 * h + ((p >> 1) & 1)) * 2 * ww
            + 2 * w + (p & 1))


def _warps(plan):
    """(rows, columns) offsets of the 8 MMA warps in a tile."""
    wgm = 8 // (plan["ncol"] // 32)
    return [((w % wgm) * 32, (w // wgm) * 32) for w in range(8)]


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("ci,co,size", SHAPES, ids=IDS)
def test_f32_plans_write_every_output_once(ci, co, size, sms):
    """The forward writes every fine voxel's channels once (every (coarse
    voxel, parity) of every column once: the groups' columns, the warps'
    blocks of a tile and the blocks' tile ranges each cover theirs once,
    and fine_of is one to one), dx every coarse voxel's channels once, each
    within the H100's shared memory; at the flagship's shapes on 132 SMs
    all three fill at least 128 of them. dW sums every coarse voxel into
    every (parity, ci, co) once: the units' (ci, co) tiles cover the output
    once, each tile's splits the steps once, the steps the coarse voxels
    once; one block a unit in one wave, its scratch one slice a split."""
    n, vox = 2, math.prod(size)
    flagship = (ci, co, size) in ((128, 64, (32,) * 3), (64, 32, (64,) * 3))
    fwd = up._up_f32_fwd_plan(n, size, ci, co, sms)
    dx = up._up_f32_dx_plan(n, size, ci, co, sms)
    assert fwd["ncol"] * ci <= up.F32_UP_FWD_W and ci % dx["ncol"] == 0
    assert fwd["groups"] * fwd["ncol"] == 8 * co
    assert dx["groups"] * dx["ncol"] == ci
    for p in (fwd, dx):
        assert p["m"] * p["ncol"] == up.F32_UP_OUTS and p["ncol"] % 32 == 0
        assert (p["tiles"] - 1) * p["m"] < n * vox <= p["tiles"] * p["m"]
        blocks, groups = p["grid"]
        assert groups == p["groups"] and 1 <= blocks <= p["tiles"]
        assert blocks * groups <= max(sms, groups)   # one wave
        assert p["smem"] <= SMEM_MAX
        if flagship:
            assert sms < 128 or blocks * groups >= 128
        tiles = np.zeros(p["tiles"], np.int32)
        for b in range(blocks):
            first, end = up.f32_tile_range(b, blocks, p["tiles"])
            assert end > first, "a block without work"
            tiles[first:end] += 1
        assert (tiles == 1).all()
        cells = np.zeros((p["m"], p["ncol"]), np.int32)
        for r0, c0 in _warps(p):
            cells[r0:r0 + 32, c0:c0 + 32] += 1
        assert (cells == 1).all()
    # the forward's (coarse voxel, parity) -> fine voxel, one to one
    v = np.arange(n * vox, dtype=np.int64)
    fine = np.concatenate([_fine_of(v, p, size) for p in range(8)])
    assert np.array_equal(np.sort(fine), np.arange(8 * n * vox))
    dw = up._up_f32_dw_plan(n, size, ci, co, sms)
    ct, r = dw["ci_tile"], up.F32_DW_R
    assert ct == (64 if ci % 64 == 0 else 32)
    assert dw["smem"] == up.f32_dw_smem(ct) <= SMEM_MAX
    assert dw["grid"] == dw["splits"] * dw["tiles"]
    assert dw["grid"] <= max(sms, dw["tiles"])   # one wave
    if flagship:
        assert sms < 128 or dw["grid"] >= 128
    assert dw["scratch"] == (dw["splits"], 8, ci, co)
    assert dw["part_len"] == math.prod(dw["scratch"])
    assert (dw["fin_grid"] - 1) * up.F32_DW_FIN < 8 * ci * co \
        <= dw["fin_grid"] * up.F32_DW_FIN
    owner = np.zeros((ci, co), np.int32)
    for tile in range(dw["tiles"]):
        ci0 = tile % dw["ntci"] * ct
        co0 = tile // dw["ntci"] * up.F32_DW_CO
        owner[ci0:ci0 + ct, co0:co0 + up.F32_DW_CO] += 1
    assert (owner == 1).all()
    steps = np.zeros(dw["steps"], np.int32)
    for sp in range(dw["splits"]):
        first, end = up.f32_tile_range(sp, dw["splits"], dw["steps"])
        assert end > first, "a split without steps"
        steps[first:end] += 1
    assert (steps == 1).all()
    # step s = (coarse row, w range) covers every coarse voxel once
    d, h, w = size
    row, wr = np.divmod(np.arange(dw["steps"]), dw["nwr"])
    cover = np.zeros((n * d * h, w + r), np.int32)
    for k in range(r):
        np.add.at(cover, (row, wr * r + k), 1)
    assert (cover[:, :w] == 1).all() and row.max() == n * d * h - 1


def _plane(rows, kk):
    """The double offset of channel plane kk of an fp64 buffer of ``rows``
    rows (the kernels' ``plane``)."""
    return kk * (rows * 8 + 8)


def _convert(slot, rows, kc):
    """A producer's conversion of an fp32 ring slot (``rows`` x ``kc``,
    rows contiguous) into the fp64 buffer [kc / 8][rows][8], item e = (row
    e // (kc / 4), piece e % (kc / 4)): (buffer, the double offsets of each
    item's first and second 16-byte store)."""
    pr = kc // 4
    e = np.arange(rows * pr)
    r, j = e // pr, e % pr
    base = _plane(rows, j >> 1) + r * 8 + 4 * (j & 1)
    h = (e >> 2) & 1
    buf = np.full(_plane(rows, kc // 8), np.nan)
    buf[base[:, None] + np.arange(4)] = slot.reshape(-1, 4)
    return buf, base + 2 * h, base + 2 - 2 * h


# k = t and t + 4 of an m16n8k8 fragment are channels 2t and 2t + 1
_KPERM = np.array([0, 2, 4, 6, 1, 3, 5, 7])

_CFGS = ([("fwd", c) for c in (256, 128, 64, 32)]
         + [("dx", c) for c in (128, 64, 32)] + [("dw", 64), ("dw", 32)])


@pytest.mark.parametrize("kind,ncol", _CFGS,
                         ids=[f"{k}-{c}" for k, c in _CFGS])
def test_f32_up_buffers_hit_every_bank(kind, ncol):
    """The fp32 forward's and dx's shared memory at every column group: a
    quarter-warp's 16-byte conversion stores (8 consecutive items, each
    half in turn) and fragment loads (lanes (g, t) of 8p .. 8p + 7 reading
    rows g of an MMA tile at channel pair 2t) hit the 8 bank groups once,
    the staged epilogue's float2 stores (a half-warp) and float4 reads (a
    quarter-warp) 32 distinct banks; the shared memory is the sum of its
    parts. dW at ci tile ``ncol``: every 16-byte access (the copies into
    its swizzled fp32 slot, the conversions' loads and their rotated fp64
    stores, the fragment loads) hits the 8 bank groups once in each
    quarter-warp."""
    if kind == "dw":
        for offs in _dw_banks(ncol):
            assert len(offs) % 8 == 0
            for q in range(0, len(offs), 8):
                assert len({o // 16 % 8 for o in offs[q:q + 8]}) == 8
        elems = up.F32_DW_R * (ncol + 8 * up.F32_DW_CO)
        assert up.f32_dw_smem(ncol) == (up.F32_UP_BUFS * elems * 8
                                        + up.F32_UP_SLOTS * elems * 4)
        assert up.f32_dw_smem(ncol) <= SMEM_MAX
        return
    m, kc = up.F32_UP_OUTS // ncol, up.f32_up_kc(kind, ncol)
    for rows in ((m,) if kind == "fwd" else (m, ncol)):
        _, first, second = _convert(np.zeros(rows * kc), rows, kc)
        for offs in (first, second):
            for q in range(0, len(offs), 8):
                assert len({o * 8 // 16 % 8 for o in offs[q:q + 8]}) == 8
        for kk in range(kc // 8):
            for r0 in range(0, rows, 16):
                for q in range(4):
                    lanes = range(8 * q, 8 * q + 8)
                    offs = [_plane(rows, kk) + (r0 + (ln >> 2)) * 8
                            + 2 * (ln & 3) for ln in lanes]
                    assert len({o * 8 // 16 % 8 for o in offs}) == 8
    pitch = up.F32_UP_PITCH
    for mi, ni, h in np.ndindex(2, 4, 2):
        for half in range(2):
            words = [(mi * 16 + (ln >> 2) + 8 * h) * pitch + ni * 8
                     + 2 * (ln & 3) + k for ln in range(16 * half,
                                                         16 * half + 16)
                     for k in range(2)]
            assert len({wd % 32 for wd in words}) == 32
    for s in range(8):
        for q in range(4):
            words = [((ln >> 3) + 4 * s) * pitch + 4 * (ln & 7) + k
                     for ln in range(8 * q, 8 * q + 8) for k in range(4)]
            assert len({wd % 32 for wd in words}) == 32
    staged = 8 * 32 * pitch * 4
    bufs = up.F32_UP_BUFS * _plane(m, kc // 8) * 8
    if kind == "fwd":
        parts = bufs + up.F32_UP_SLOTS * m * kc * 4 + staged
        for ci in (32, up.F32_UP_FWD_W // ncol):
            assert up.f32_up_smem(kind, ncol, ci) == ncol * ci * 8 + parts
            assert up.f32_up_smem(kind, ncol, ci) <= SMEM_MAX
    else:
        bufs += up.F32_UP_BUFS * _plane(ncol, kc // 8) * 8
        assert up.f32_up_smem(kind, ncol, 64) == (
            bufs + up.F32_UP_SLOTS * (m + ncol) * kc * 4 + staged)
        assert up.f32_up_smem(kind, ncol, 64) <= SMEM_MAX


def _mma(buf_a, off_a, buf_b, off_b, r0, c0):
    """A warp's k-step as its lanes' fragment loads read it: A (32 rows
    from r0 of the plane at double off_a) x B (32 columns from c0 of the
    plane at off_b), k in fragment order."""
    a = buf_a[off_a + (r0 + np.arange(32))[:, None] * 8 + _KPERM[None, :]]
    b = buf_b[off_b + (c0 + np.arange(32))[None, :] * 8 + _KPERM[:, None]]
    return a @ b


def _staged(acc):
    """A warp's sums rounded to fp32 through its staged tile (float2
    stores of fragment pairs, float4 reads of lane pieces): rows x 32."""
    pitch = up.F32_UP_PITCH
    st = np.full(32 * pitch, np.nan, np.float32)
    st[np.arange(32)[:, None] * pitch + np.arange(32)] = acc.astype(
        np.float32)
    return st.reshape(32, pitch)[:, :32]


def _f32_up_fwd_schedule(plan, x, wf):
    """The fp32 forward as the kernel computes it under ``plan``, in fp64
    on the fp32 inputs: the resident weights, each step's x rows copied and
    converted, the warps' k-steps, the staged epilogue's fine voxels."""
    n, d, h, w, ci = x.shape
    co = wf.shape[-1]
    size, vox = (d, h, w), n * d * h * w
    m, kc, ncol = plan["m"], plan["kc"], plan["ncol"]
    xf, wr = x.reshape(vox, ci), wf.reshape(8, ci, co)
    y = np.full((8 * vox, co), np.nan, np.float32)
    pr = kc // 4
    e = np.arange(m * pr)
    r, j = e // pr, e % pr
    blocks = plan["grid"][0]
    for grp in range(plan["groups"]):
        cols = grp * ncol + np.arange(ncol)
        wres = np.empty(ci * ncol)
        for c in range(ci):
            wres[((c >> 3) * ncol + np.arange(ncol)) * 8 + (c & 7)] = \
                wr[cols // co, c, cols % co]
        for b in range(blocks):
            for tile in range(*up.f32_tile_range(b, blocks, plan["tiles"])):
                acc = np.zeros((8, 32, 32))
                for step in range(ci // kc):
                    v = tile * m + r
                    slot = np.zeros((m * pr, 4), np.float32)
                    ok = v < vox
                    slot[ok] = xf[v[ok, None], step * kc + 4 * j[ok, None]
                                  + np.arange(4)]
                    buf = _convert(slot.astype(np.float64), m, kc)[0]
                    for wi, (r0, c0) in enumerate(_warps(plan)):
                        for kk in range(kc // 8):
                            acc[wi] += _mma(
                                buf, _plane(m, kk), wres,
                                (step * kc // 8 + kk) * ncol * 8, r0, c0)
                for wi, (r0, c0) in enumerate(_warps(plan)):
                    par, co0 = divmod(grp * ncol + c0, co)
                    v = tile * m + r0 + np.arange(32)
                    ok = v < vox
                    y[_fine_of(v[ok], par, size), co0:co0 + 32] = \
                        _staged(acc[wi])[ok]
    return y.reshape(n, 2 * d, 2 * h, 2 * w, co)


def _f32_up_dx_schedule(plan, gy, wf):
    """The fp32 dx as the kernel computes it under ``plan``, in fp64 on the
    fp32 inputs: each producer row's fine voxel decoded once a tile, each
    step's gy rows (its parity's offset added) and weight rows copied and
    converted, the warps' k-steps, the staged epilogue."""
    n, d2, h2, w2, co = gy.shape
    d, h, w, ci = d2 // 2, h2 // 2, w2 // 2, wf.shape[3]
    size, vox = (d, h, w), n * d * h * w
    m, kc, ncol = plan["m"], plan["kc"], plan["ncol"]
    gf, wr = gy.reshape(-1, co), wf.reshape(8, ci, co)
    dx = np.full((vox, ci), np.nan, np.float32)
    pr = kc // 4
    ea, eb = np.arange(m * pr), np.arange(ncol * pr)
    blocks = plan["grid"][0]
    for grp in range(plan["groups"]):
        ci0 = grp * ncol
        for b in range(blocks):
            for tile in range(*up.f32_tile_range(b, blocks, plan["tiles"])):
                v = tile * m + ea // pr
                fb = np.where(v < vox, _fine_of(v, 0, size), -1)
                acc = np.zeros((8, 32, 32))
                for step in range(8 * co // kc):
                    par, cc = divmod(step, co // kc)
                    off = (((par >> 2) * 2 * h + ((par >> 1) & 1)) * 2 * w
                           + (par & 1))
                    sa = np.zeros((m * pr, 4), np.float32)
                    ok = fb >= 0
                    sa[ok] = gf[fb[ok, None] + off, cc * kc + 4 * (ea[ok, None]
                                                                   % pr)
                                + np.arange(4)]
                    sb = wr[par, ci0 + eb[:, None] // pr,
                            cc * kc + 4 * (eb[:, None] % pr) + np.arange(4)]
                    bufa = _convert(sa.astype(np.float64), m, kc)[0]
                    bufb = _convert(sb.astype(np.float64), ncol, kc)[0]
                    for wi, (r0, c0) in enumerate(_warps(plan)):
                        for kk in range(kc // 8):
                            acc[wi] += _mma(bufa, _plane(m, kk), bufb,
                                            _plane(ncol, kk), r0, c0)
                for wi, (r0, c0) in enumerate(_warps(plan)):
                    v = tile * m + r0 + np.arange(32)
                    ok = v < vox
                    dx[v[ok], ci0 + c0:ci0 + c0 + 32] = _staged(acc[wi])[ok]
    return dx.reshape(n, d, h, w, ci)


def _xpiece(v, jq, ct):
    """The float offset of x's 16-byte piece jq of voxel v in a dW slot
    (the kernel's ``xpiece``)."""
    return v * ct + 4 * (jq ^ (((v >> 1) & 3) << 1))


def _gpiece(ab, jf, cq):
    """The float offset of gy's piece cq of fine voxel jf of pair ab in a
    dW slot (the kernel's ``gpiece``)."""
    r, co = up.F32_DW_R, up.F32_DW_CO
    return (ab * 2 * r + jf) * co + 4 * (cq ^ (((jf >> 2) & 3) << 1))


def _crow(c):
    """The fp64 row of channel c in the dW's buffers (the kernel's
    ``crow``): odd quads of channels in the order 1, 0, 3, 2."""
    return c ^ ((c >> 2) & 1)


def _dw_items(ct):
    """The dW producers' items, as the kernel decodes them: the copies (x:
    voxel v, quad jq; gy: pair ab, fine voxel jf, quad cq), then the
    conversions (x: voxel pair (ks, q) x quad jq; gy: pair ab x 4 fine
    voxels (ks, q) x quad cq), each with its store rotation ``lo`` and
    its fp64 base offset (channel i of the quad at base + 8 crow(i) for
    an even quad, base + 8 (i ^ 1) for an odd one)."""
    r, co, xq = up.F32_DW_R, up.F32_DW_CO, ct // 4
    c = np.arange(r * xq)
    xc = dict(v=c // xq, jq=c % xq)
    c = np.arange(4 * 2 * r * co // 4)
    gc = dict(cq=c % 8, jf=c // 8 % (2 * r), ab=c // (16 * r))
    e = np.arange(r // 2 * xq)
    q, lo, rest = e & 3, (e >> 2) & 1, e >> 3
    jq, ks = 2 * (rest % (xq // 2)) + lo, rest // (xq // 2)
    xi = dict(q=q, lo=lo, jq=jq, ks=ks, v=2 * (4 * ks + q),
              base=(ks * ct + 4 * jq) * 8 + 2 * q)
    e = np.arange(4 * r // 2 * co // 4)
    q, lo, rest = e & 3, (e >> 2) & 1, e >> 3
    cq, ks = 2 * (rest % (co // 8)) + lo, rest // (co // 8) % (r // 8)
    ab = rest // (co // 8 * (r // 8))
    gi = dict(q=q, lo=lo, cq=cq, ks=ks, ab=ab, jf=4 * (4 * ks + q),
              base=((ks * 8 + 2 * ab) * co + 4 * cq) * 8 + 2 * q)
    return xc, gc, xi, gi


def _dw_lanes(ct):
    """Per MMA warp (ab, half): the double offsets of its lanes' 16-byte
    fragment loads in a step's fp64 buffers, as the kernel reads them:
    {(ks, ni): B}, {(ks, c, mi): (A rows g, A rows g + 8)}."""
    co, nt = up.F32_DW_CO, ct // 16
    g, t = np.arange(32) // 4, np.arange(32) % 4
    out = []
    for w in range(8):
        ab, half = w & 3, w >> 2
        bo = (half * 8 * nt + _crow(g)) * 8 + 2 * t
        ao = (2 * ab * co + _crow(g)) * 8 + 2 * t
        b = {(ks, ni): bo + (ks * ct + 8 * ni) * 8
             for ks in range(up.F32_DW_R // 8) for ni in range(nt)}
        a = {(ks, c, mi): (ao + ((ks * 8 + c) * co + 16 * mi) * 8,
                           ao + ((ks * 8 + c) * co + 16 * mi) * 8 + 64)
             for ks in range(up.F32_DW_R // 8) for c in range(2)
             for mi in range(2)}
        out.append((ab, half, a, b))
    return out


def _f32_up_dw_schedule(plan, x, gy):
    """The fp32 dW as the kernel computes it under ``plan``, in fp64 on the
    fp32 inputs: each unit's steps copied into the swizzled fp32 slot
    (zero past w), converted once into the fp64 buffers, the MMA warps'
    fragment loads and products, the unit's fp64 sums to its split's slice,
    the slices added in split order and rounded once."""
    n, d, h, w, ci = x.shape
    co = gy.shape[-1]
    r, cot, ct = up.F32_DW_R, up.F32_DW_CO, plan["ci_tile"]
    xs, gs = x.reshape(-1), gy.reshape(-1)
    xc, gc, xi, gi = _dw_items(ct)
    lanes = _dw_lanes(ct)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    four = np.arange(4)
    part = np.full(plan["scratch"], np.nan)
    for u in range(plan["grid"]):
        split, tile = divmod(u, plan["tiles"])
        ci0, co0 = tile % plan["ntci"] * ct, tile // plan["ntci"] * cot
        acc = np.zeros((8, cot, ct))
        for st in range(*up.f32_tile_range(split, plan["splits"],
                                           plan["steps"])):
            row, wr = divmod(st, plan["nwr"])
            nd, hh = divmod(row, h)
            w0 = wr * r
            sx = np.full(r * ct, np.nan, np.float32)
            sg = np.full(8 * r * cot, np.nan, np.float32)
            ok = xc["v"] < w - w0
            src = ((row * w + w0 + xc["v"]) * ci + ci0 + 4 * xc["jq"])
            sx[_xpiece(xc["v"], xc["jq"], ct)[:, None] + four] = np.where(
                ok[:, None], xs[np.where(ok, src, 0)[:, None] + four], 0)
            f = (((2 * nd + (gc["ab"] >> 1)) * 2 * h + 2 * hh
                  + (gc["ab"] & 1)) * 2 * w + 2 * w0 + gc["jf"])
            ok = gc["jf"] < 2 * (w - w0)
            src = f * co + co0 + 4 * gc["cq"]
            sg[_gpiece(gc["ab"], gc["jf"], gc["cq"])[:, None] + four] = \
                np.where(ok[:, None], gs[np.where(ok, src, 0)[:, None]
                                         + four], 0)
            x64 = np.full(r * ct, np.nan)
            g64 = np.full(r * 8 * cot, np.nan)
            u0 = sx[_xpiece(xi["v"], xi["jq"], ct)[:, None] + four]
            u1 = sx[_xpiece(xi["v"] + 1, xi["jq"], ct)[:, None] + four]
            rows = 8 * (four[None, :] ^ xi["lo"][:, None])
            x64[xi["base"][:, None] + rows] = u0
            x64[xi["base"][:, None] + rows + 1] = u1
            uu = [sg[_gpiece(gi["ab"], gi["jf"] + k, gi["cq"])[:, None]
                     + four] for k in range(4)]
            for c in range(2):
                base = (gi["base"][:, None] + c * cot * 8
                        + 8 * (four[None, :] ^ gi["lo"][:, None]))
                g64[base] = uu[c]
                g64[base + 1] = uu[2 + c]
            for ab, half, a_offs, b_offs in lanes:
                for (ks, c, mi), (lo, hi) in a_offs.items():
                    am = np.empty((16, 8))
                    am[g, t], am[g + 8, t] = g64[lo], g64[hi]
                    am[g, t + 4], am[g + 8, t + 4] = g64[lo + 1], g64[hi + 1]
                    for ni in range(ct // 16):
                        bo = b_offs[(ks, ni)]
                        bm = np.empty((8, 8))
                        bm[t, g], bm[t + 4, g] = x64[bo], x64[bo + 1]
                        n0 = half * ct // 2 + 8 * ni
                        acc[2 * ab + c, 16 * mi:16 * mi + 16,
                            n0:n0 + 8] += am @ bm
        part[split, :, ci0:ci0 + ct, co0:co0 + cot] = acc.transpose(0, 2, 1)
    total = np.zeros(part.shape[1:])
    for sp in range(plan["splits"]):
        total = total + part[sp]
    return total.astype(np.float32).reshape(2, 2, 2, ci, co)


def _dw_banks(ct):
    """The fp32 dW's shared-memory accesses at ci tile ``ct``, each as the
    byte offsets of a warp's 16-byte accesses in lane order: the cp.async
    copies into a slot, the conversions' loads from it and stores into
    the fp64 buffers (each instruction of put_pairs), the MMA warps'
    fragment loads."""
    xc, gc, xi, gi = _dw_items(ct)
    x32 = up.F32_DW_R * ct
    acc = [4 * _xpiece(xc["v"], xc["jq"], ct),
           4 * (x32 + _gpiece(gc["ab"], gc["jf"], gc["cq"])),
           4 * _xpiece(xi["v"], xi["jq"], ct),
           4 * _xpiece(xi["v"] + 1, xi["jq"], ct)]
    acc += [4 * (x32 + _gpiece(gi["ab"], gi["jf"] + k, gi["cq"]))
            for k in range(4)]
    for s in range(4):
        acc.append(8 * (xi["base"] + 8 * (s ^ xi["lo"])))
        for c in range(2):
            acc.append(8 * (gi["base"] + c * up.F32_DW_CO * 8
                            + 8 * (s ^ gi["lo"])))
    for _, _, a_offs, b_offs in _dw_lanes(ct):
        acc += [8 * o for pair in a_offs.values() for o in pair]
        acc += [8 * o for o in b_offs.values()]
    return acc


# every column group of each kernel, extents that are no multiple of the
# tiles, more tiles than blocks (sms = 2)
_F32_UP_EMU = [(64, 32, (2, 3, 5)), (128, 64, (2, 3, 3)), (96, 32, (1, 3, 5)),
               (256, 32, (1, 2, 3)), (512, 32, (1, 1, 3))]


@pytest.mark.parametrize("ci,co,size", _F32_UP_EMU,
                         ids=[f"{ci}-{co}" for ci, co, _ in _F32_UP_EMU])
def test_f32_up_schedule_on_numbers_matches_plain(ci, co, size):
    """The fp32 forward's, dx's and dW's schedules, walked on numbers as
    the kernels index them (ring steps, conversion layout, fragment loads,
    staged epilogue, fine voxels; dW's swizzled slots, fine-row
    de-interleave, splits, fp64 slices and finish order, split and not),
    give upsample_plain's y, upsample2x_dx_plain's dx and
    upsample2x_dw_plain's dW in fp64 within one fp32 rounding, every output
    written."""
    g = np.random.default_rng(7)
    n = 2
    x = g.standard_normal((n, *size, ci)).astype(np.float32)
    wf = (g.standard_normal((2, 2, 2, ci, co)) * (8 * co) ** -0.5).astype(
        np.float32)
    gy = g.standard_normal((n, *(2 * s for s in size), co)).astype(
        np.float32)
    y = _f32_up_fwd_schedule(up._up_f32_fwd_plan(n, size, ci, co, 2), x, wf)
    want = up.upsample_plain(torch.from_numpy(x).double(),
                             torch.from_numpy(wf).double()).numpy()
    assert not np.isnan(y).any()
    assert np.linalg.norm(y - want) <= 1e-7 * np.linalg.norm(want)
    dx = _f32_up_dx_schedule(up._up_f32_dx_plan(n, size, ci, co, 2), gy, wf)
    want = up.upsample2x_dx_plain(torch.from_numpy(gy).double(),
                                  torch.from_numpy(wf).double()).numpy()
    assert not np.isnan(dx).any()
    assert np.linalg.norm(dx - want) <= 1e-7 * np.linalg.norm(want)
    for sms in (2, 132):
        plan = up._up_f32_dw_plan(n, size, ci, co, sms)
        dw = _f32_up_dw_schedule(plan, x, gy)
        want = up.upsample2x_dw_plain(torch.from_numpy(x).double(),
                                      torch.from_numpy(gy).double()).numpy()
        assert not np.isnan(dw).any()
        assert np.linalg.norm(dw - want) <= 1e-7 * np.linalg.norm(want)
