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
outputs, in 8 distinct shared-memory bank groups.
"""

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
