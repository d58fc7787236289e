"""The tiling planners of the port's tensor-core convs, on the CPU.

``ops/conv3d.py`` chooses in Python how the CUDA kernels
``csrc/conv3d_k3_s1.cu`` / ``conv3d_k3_s2.cu`` (the forward),
``csrc/conv3d_k3_dx_s1.cu`` / ``conv3d_k3_dx_s2.cu`` (dx) and
``csrc/conv3d_k3_dw_s1.cu`` / ``conv3d_k3_dw_s2.cu`` (dW) cut their work:
bricks of voxels, channel tiles, the split of K across blocks and the
persistent blocks' unit ranges. ``s1_schedule``, ``s2_schedule``,
``dx_s1_schedule``, ``dx_s2_schedule`` and ``dw_schedule`` below decode
every block's work as the kernels decode their block indices (the
planners' docstrings). At every flagship shape (N = 2) and at extents that
are no multiple of the bricks, on a card of 132 SMs and a smaller one, each
(sample, voxel, output channel, input chunk) of the forward and of the
stride-1 dx (with dx's voxels and channels, K the cotangent's chunks) and
each (sample, voxel) of every (ci, co) tile of dW (all 27 taps at once)
must be covered exactly once; at stride 2 the voxels are the output's. The
stride-2 kernels' parity-split staging (``s2_row``) must put every
footprint position in its own row, and every tap's 8 consecutive output w
in 8 consecutive rows (what their ldmatrix addressing takes). The stride-2
dx must compute every (dx voxel, tap) pair with i + 1 - k even exactly
once, reading the cotangent at (i + 1 - k) / 2, and its schedule, run on
numbers, must give the plain dx. The fp32 kernels' planners at the same
shapes: the forward's (``_f32_fwd_plan``, csrc/conv3d_k3_f32_fwd.cu)
covers every (split, sample, output voxel, output channel) once and every
input chunk once per brick and tile, its persistent blocks every unit
once, in at most the 227 KB of dynamic shared memory a block may have;
the 4^3 and 8^3 shapes split K and the larger ones do not, and the split
sums, added in split order, give the conv. dx's (``_f32_dx_plan``,
csrc/conv3d_k3_f32_dx.cu): the forward's units over dx's voxels and
channels, every (split, sample, dx voxel, dx channel) in one row of one
unit (at stride 2 through the 8 parity classes of the brick's row
groups), the staged cotangent brick holding every row a tap reads, its
shared memory (``f32_dx_smem``) within 227 KB in every mode, and its
schedule, walked on numbers, giving the plain dx and [sum du*x; sum du].
dW's (``_f32_dw_plan``, csrc/conv3d_k3_f32_dw.cu): every (split, tap, ci,
co) in one unit, the splits' brick ranges covering every output voxel once
in split order, its shared memory (``f32_dw_smem``) within 227 KB in every
mode, its fragment loads and conversion stores on distinct banks
(``f32_dw_swz``), and its schedule, walked on numbers, giving the plain
dW.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from mt3d_resenc_unet_torch.ops import conv3d as c3


def s1_schedule(n: int, size, ci: int, co: int,
                sms: int) -> list:
    """Per block of the stride-1 forward kernel, its units as (sample,
    output voxel origin (d, h, w), first output channel, first Ci chunk,
    chunks), decoded as the kernel decodes them: unit u = ((split * tiles
    + tile) * n + sample) * bricks + brick, block b takes units
    [b * U / G, (b + 1) * U / G)."""
    plan = c3._s1_plan(n, size, ci, co, sms)
    nbd, nbh, nbw = c3._bricks(size, c3.S1_BRICK)
    nb, nt, cps = nbd * nbh * nbw, co // c3.S1_CT, plan["chunks"]
    units, grid = plan["units"], plan["grid"]
    out = []
    for blk in range(grid):
        mine = []
        for u in range(blk * units // grid, (blk + 1) * units // grid):
            b, r = u % nb, u // nb
            sample, r = r % n, r // n
            origin = ((b // (nbh * nbw)) * c3.S1_BRICK[0],
                      (b // nbw % nbh) * c3.S1_BRICK[1],
                      (b % nbw) * c3.S1_BRICK[2])
            mine.append((sample, origin, (r % nt) * c3.S1_CT,
                         (r // nt) * cps, cps))
        out.append(mine)
    return out


def s2_schedule(n: int, size, ci: int, co: int, sms: int,
                pre: bool) -> list:
    """Per block of the stride-2 forward kernel, its units as (sample,
    output voxel origin (d, h, w), first output channel), decoded as the
    kernel decodes them: unit u = (tile * n + sample) * bricks + brick,
    block b takes units [b * U / G, (b + 1) * U / G)."""
    plan = c3._s2_plan(n, size, ci, co, sms, pre)
    brick = plan["brick"]
    nbd, nbh, nbw = c3._bricks(c3._s2_out(size), brick)
    nb = nbd * nbh * nbw
    units, grid = plan["units"], plan["grid"]
    out = []
    for blk in range(grid):
        mine = []
        for u in range(blk * units // grid, (blk + 1) * units // grid):
            b, r = u % nb, u // nb
            mine.append((r % n, ((b // (nbh * nbw)) * brick[0],
                                 (b // nbw % nbh) * brick[1],
                                 (b % nbw) * brick[2]), (r // n) * c3.S1_CT))
        out.append(mine)
    return out


def dw_schedule(n: int, size, ci: int, co: int, sms: int,
                stride: int = 1) -> list:
    """Per block of the stride-1 (stride-2) dW kernel: (first ci, first
    co, [voxel (output voxel) bricks as (sample, origin (d, h, w))]),
    decoded as the kernel decodes them: block = split * tiles + tile, tile
    = ci tile * (co / 32) + co tile, split s takes bricks [s * B / splits,
    (s + 1) * B / splits) with brick = ((sample * nbd + bd) * nbh + bh) *
    nbw + bw."""
    if stride == 2:
        plan = c3._dw_s2_plan(n, size, ci, co, sms)
        size = c3._s2_out(size)
    else:
        plan = c3._dw_s1_plan(n, size, ci, co, sms)
    nbd, nbh, nbw = c3._bricks(size, c3.DW_BRICK)
    nco, total, splits = co // c3.DW_CT, plan["bricks"], plan["splits"]
    out = []
    for blk in range(plan["blocks"]):
        tile, split = blk % plan["tiles"], blk // plan["tiles"]
        bricks = []
        for b in range(split * total // splits, (split + 1) * total // splits):
            bricks.append((b // (nbd * nbh * nbw),
                           ((b // (nbh * nbw)) % nbd * c3.DW_BRICK[0],
                            (b // nbw) % nbh * c3.DW_BRICK[1],
                            b % nbw * c3.DW_BRICK[2])))
        out.append(((tile // nco) * c3.DW_CT, (tile % nco) * c3.DW_CT,
                    bricks))
    return out


# (ci, co, spatial extent) of the flagship's stride-1 convs, then odd cases
SHAPES = [(32, 32, (128,) * 3), (64, 64, (64,) * 3), (256, 256, (16,) * 3),
          (512, 512, (8,) * 3), (512, 512, (4,) * 3), (32, 32, (9, 10, 11)),
          (64, 96, (5, 6, 7))]
IDS = [f"{ci}-{co}@{'x'.join(map(str, e))}" for ci, co, e in SHAPES]


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("ci,co,size", SHAPES, ids=IDS)
def test_forward_schedule_covers_every_output_once(ci, co, size, sms):
    n = 2
    plan = c3._s1_plan(n, size, ci, co, sms)
    nc = ci // c3.S1_KC
    assert nc % plan["splits"] == 0
    assert plan["grid"] <= min(plan["units"], 2 * sms)
    counts = np.zeros((n,) + tuple(size) + (co // c3.S1_CT, nc), np.int32)
    blocks = s1_schedule(n, size, ci, co, sms)
    assert len(blocks) == plan["grid"]
    assert sum(len(b) for b in blocks) == plan["units"]
    bd, bh, bw = c3.S1_BRICK
    for units in blocks:
        assert units, "a block without work"
        for sample, (d0, h0, w0), co0, c0, chunks in units:
            assert chunks == nc // plan["splits"] and co0 % c3.S1_CT == 0
            counts[sample, d0:d0 + bd, h0:h0 + bh, w0:w0 + bw,
                   co0 // c3.S1_CT, c0:c0 + chunks] += 1
    assert counts.min() == 1 and counts.max() == 1


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("ci,co,size", SHAPES, ids=IDS)
def test_dw_schedule_covers_every_voxel_of_every_tile_once(ci, co, size, sms):
    n = 2
    plan = c3._dw_s1_plan(n, size, ci, co, sms)
    blocks = dw_schedule(n, size, ci, co, sms)
    assert len(blocks) == plan["tiles"] * plan["splits"]
    counts = np.zeros((ci // c3.DW_CT, co // c3.DW_CT, n) + tuple(size),
                      np.int32)
    bd, bh, bw = c3.DW_BRICK
    for ci0, co0, bricks in blocks:
        assert bricks, "a block without work"
        for sample, (d0, h0, w0) in bricks:
            counts[ci0 // c3.DW_CT, co0 // c3.DW_CT, sample,
                   d0:d0 + bd, h0:h0 + bh, w0:w0 + bw] += 1
    # every (ci, co) tile, and so every (tap, ci, co) output, sums every
    # voxel of every sample exactly once
    assert counts.min() == 1 and counts.max() == 1
    if plan["tiles"] < sms:
        assert plan["blocks"] <= sms


# (ci, co, input extent) of the flagship's stride-2 convs, then odd cases
S2_SHAPES = [(32, 64, (128,) * 3), (64, 128, (64,) * 3),
             (64, 64, (7, 8, 9)), (32, 64, (12, 13, 14)),
             (64, 128, (10, 11, 12))]
S2_IDS = [f"{ci}-{co}@{'x'.join(map(str, e))}" for ci, co, e in S2_SHAPES]


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("ci,co,size", S2_SHAPES, ids=S2_IDS)
def test_s2_forward_schedule_covers_every_output_once(ci, co, size, sms,
                                                      pre):
    n = 2
    plan = c3._s2_plan(n, size, ci, co, sms, pre)
    out = c3._s2_out(size)
    assert plan["grid"] == min(plan["units"], sms)
    assert plan["brick"] == (c3.S2_PRE_BRICK if pre else c3.S2_BRICK)
    counts = np.zeros((n,) + out + (co // c3.S1_CT,), np.int32)
    blocks = s2_schedule(n, size, ci, co, sms, pre)
    assert sum(len(b) for b in blocks) == plan["units"]
    assert plan["slots"] == plan["units"] * c3.S2_WARPS * c3.S2_SLOT
    bd, bh, bw = plan["brick"]
    for units in blocks:
        assert units, "a block without work"
        for sample, (d0, h0, w0), co0 in units:
            counts[sample, d0:d0 + bd, h0:h0 + bh, w0:w0 + bw,
                   co0 // c3.S1_CT] += 1
    assert counts.min() == 1 and counts.max() == 1


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("ci,co,size", S2_SHAPES, ids=S2_IDS)
def test_s2_dw_schedule_covers_every_output_voxel_of_every_tile_once(
        ci, co, size, sms):
    n = 2
    plan = c3._dw_s2_plan(n, size, ci, co, sms)
    out = c3._s2_out(size)
    blocks = dw_schedule(n, size, ci, co, sms, stride=2)
    assert len(blocks) == plan["tiles"] * plan["splits"] <= max(
        sms, plan["tiles"])
    counts = np.zeros((ci // c3.DW_CT, co // c3.DW_CT, n) + out, np.int32)
    bd, bh, bw = c3.DW_BRICK
    for ci0, co0, bricks in blocks:
        assert bricks, "a block without work: its scratch slice unsummed"
        for sample, (d0, h0, w0) in bricks:
            counts[ci0 // c3.DW_CT, co0 // c3.DW_CT, sample,
                   d0:d0 + bd, h0:h0 + bh, w0:w0 + bw] += 1
    assert counts.min() == 1 and counts.max() == 1


def test_s2_flagship_splits_fill_the_card():
    # 2 and 8 (ci, co) tiles: the output bricks split 66 and 16 ways
    assert c3._dw_s2_plan(2, (128,) * 3, 32, 64, 132)["splits"] == 66
    assert c3._dw_s2_plan(2, (64,) * 3, 64, 128, 132)["splits"] == 16


@pytest.mark.parametrize("bd", [c3.S2_BRICK[0], c3.S2_PRE_BRICK[0],
                                c3.DW_BRICK[0]])
def test_s2_footprint_rows(bd):
    bh, bw = c3.S2_BRICK[1:]
    fd, fh, fw = 2 * bd + 1, 2 * bh + 1, 2 * bw + 1
    rows = {}
    for rd in range(fd):
        for rh in range(fh):
            for rw in range(fw):
                row = c3.s2_row(bd, (rd & 1, rh & 1, rw & 1),
                                (rd >> 1, rh >> 1, rw >> 1))
                rows[(rd, rh, rw)] = row
    # every footprint position has its own row, and the rows are 0..R-1
    assert sorted(rows.values()) == list(range(fd * fh * fw))
    # tap k reads parity (k == 1) at m = o + (k == 2): footprint position
    # 2o + k, and its 8 consecutive w are 8 consecutive rows
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                for od in range(bd):
                    for oh in range(bh):
                        first = c3.s2_row(bd, (kd == 1, kh == 1, kw == 1),
                                          (od + (kd == 2), oh + (kh == 2),
                                           kw == 2))
                        for ow in range(bw):
                            assert rows[(2 * od + kd, 2 * oh + kh,
                                         2 * ow + kw)] == first + ow


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("ci,co,size", SHAPES, ids=IDS)
def test_forward_scratch_and_stat_slots(ci, co, size, sms):
    n = 2
    plan = c3._s1_plan(n, size, ci, co, sms, stats=True)
    assert c3._s1_plan(n, size, ci, co, sms)["scratch"] == (
        plan["splits"] * n * int(np.prod(size)) * co
        if plan["splits"] > 1 else 0)
    vox = int(np.prod(size))
    if plan["splits"] > 1:
        # one slice per split, then the finish blocks' [sum; sumsq] slots
        assert plan["scratch"] == plan["splits"] * n * vox * co + \
            n * -(-vox // c3.S1_FIN_VOX) * 2 * co
        return
    groups, grid = (co // c3.S1_CT) * n, plan["grid"]
    assert plan["scratch"] == (groups + grid) * c3.S2_WARPS * c3.S2_SLOT
    bricks = plan["units"] // groups
    slots = c3.s1_stat_slots(plan["units"], grid, bricks)
    # each slot written once, every unit of every group summed once
    assert len({s for s, *_ in slots}) == len(slots)
    assert all(s < groups + grid for s, *_ in slots)
    seen = np.zeros(plan["units"], np.int32)
    for slot, g, first, last in slots:
        assert g * bricks <= first <= last < (g + 1) * bricks
        seen[first:last + 1] += 1
    assert seen.min() == 1 and seen.max() == 1


def test_flagship_split_scratch():
    # 16^3 x 256, 8^3 and 4^3 x 512 at N=2: 2, 8 and 16 splits of 8.4 MB,
    # 2.1 MB and 0.26 MB
    for size, c, splits, mb in (((16,) * 3, 256, 2, 8.39),
                                ((8,) * 3, 512, 8, 2.10),
                                ((4,) * 3, 512, 16, 0.26)):
        plan = c3._s1_plan(2, size, c, c, 132)
        assert plan["splits"] == splits
        assert round(plan["scratch"] * 4 / splits / 1e6, 2) == mb


@pytest.mark.parametrize("units,grid,bricks", [(16384, 264, 8192),
                                               (2048, 264, 64), (64, 264, 4),
                                               (100, 7, 3), (45, 45, 1)])
def test_stat_slot_ranges_match_the_closed_form(units, grid, bricks):
    # conv3d_k3_s1_stats reads, per group g, the slots of blocks
    # [ceil((g * bricks + 1) * grid / units) - 1, ceil((g + 1) * bricks *
    # grid / units) - 1), then slot g
    groups = units // bricks
    slots = c3.s1_stat_slots(units, grid, bricks)
    for g in range(groups):
        b0 = -(-(g * bricks + 1) * grid // units) - 1
        b1 = -(-(g + 1) * bricks * grid // units) - 1
        mine = [s for s, gg, *_ in slots if gg == g]
        assert mine == [groups + b for b in range(b0, b1)] + [g]


def dx_s1_schedule(n: int, size, ci: int, co: int, sms: int) -> list:
    """Per block of the stride-1 dx kernel, its units as (sample, dx voxel
    origin (d, h, w), first dx channel, first Co chunk, chunks), decoded as
    the kernel decodes them: unit u = ((split * tiles + tile) * n + sample)
    * bricks + brick with tiles = ci / 32 and bricks of DX1_BRICK, block b
    takes units [b * U / G, (b + 1) * U / G)."""
    plan = c3._dx_s1_plan(n, size, ci, co, sms)
    nbd, nbh, nbw = c3._bricks(size, c3.DX1_BRICK)
    nb, nt, cps = nbd * nbh * nbw, ci // c3.S1_CT, plan["chunks"]
    units, grid = plan["units"], plan["grid"]
    out = []
    for blk in range(grid):
        mine = []
        for u in range(blk * units // grid, (blk + 1) * units // grid):
            b, r = u % nb, u // nb
            sample, r = r % n, r // n
            origin = ((b // (nbh * nbw)) * c3.DX1_BRICK[0],
                      (b // nbw % nbh) * c3.DX1_BRICK[1],
                      (b % nbw) * c3.DX1_BRICK[2])
            mine.append((sample, origin, (r % nt) * c3.S1_CT,
                         (r // nt) * cps, cps))
        out.append(mine)
    return out


# (ci, co, dx extent): the flagship's stride-1 dx shapes, a decoder pair's
# half, then odd cases
DX_SHAPES = SHAPES + [(96, 64, (6, 7, 9))]
DX_IDS = [f"{ci}-{co}@{'x'.join(map(str, e))}" for ci, co, e in DX_SHAPES]


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("ci,co,size", DX_SHAPES, ids=DX_IDS)
def test_dx_s1_schedule_covers_every_dx_voxel_once(ci, co, size, sms):
    n = 2
    plan = c3._dx_s1_plan(n, size, ci, co, sms)
    nc = co // c3.S1_KC
    assert nc % plan["splits"] == 0 and plan["chunks"] * plan["splits"] == nc
    assert plan["grid"] == min(plan["units"], sms)
    # K is split only where an unsplit K leaves SMs idle
    assert plan["splits"] == 1 or plan["units"] // plan["splits"] < sms
    counts = np.zeros((n,) + tuple(size) + (ci // c3.S1_CT, nc), np.int32)
    blocks = dx_s1_schedule(n, size, ci, co, sms)
    assert len(blocks) == plan["grid"]
    assert sum(len(b) for b in blocks) == plan["units"]
    bd, bh, bw = c3.DX1_BRICK
    for units in blocks:
        assert units, "a block without work"
        for sample, (d0, h0, w0), ci0, c0, chunks in units:
            counts[sample, d0:d0 + bd, h0:h0 + bh, w0:w0 + bw,
                   ci0 // c3.S1_CT, c0:c0 + chunks] += 1
    # every (sample, dx voxel, dx channel tile) takes every Co chunk once,
    # split or not
    assert counts.min() == 1 and counts.max() == 1


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("ci,co,size", DX_SHAPES, ids=DX_IDS)
def test_dx_s1_scratch_and_post_slots(ci, co, size, sms):
    n = 2
    plan = c3._dx_s1_plan(n, size, ci, co, sms, post=True)
    vox = int(np.prod(size))
    plain = c3._dx_s1_plan(n, size, ci, co, sms)
    assert plain["scratch"] == (plan["splits"] * n * vox * ci
                                if plan["splits"] > 1 else 0)
    if plan["splits"] > 1:
        # one slice of n x voxels x ci per split (the kernel's float2
        # partials at ((split * n + sample) * voxels + voxel) * ci + c),
        # then the finish blocks' [sum du*x; sum du] slots
        assert plan["scratch"] == plan["splits"] * n * vox * ci + \
            n * -(-vox // c3.S1_FIN_VOX) * 2 * ci
        assert ci <= 8 * 256
        return
    groups, grid = (ci // c3.S1_CT) * n, plan["grid"]
    assert plan["scratch"] == (groups + grid) * c3.DX1_WARPS * c3.S2_SLOT
    bricks = plan["units"] // groups
    slots = c3.s1_stat_slots(plan["units"], grid, bricks)
    # each slot written once, every unit of every (dx tile, sample) group
    # summed once: the slots conv3d_k3_dx_s1_dst reads
    assert len({s for s, *_ in slots}) == len(slots)
    assert all(s < groups + grid for s, *_ in slots)
    seen = np.zeros(plan["units"], np.int32)
    for slot, g, first, last in slots:
        assert g * bricks <= first <= last < (g + 1) * bricks
        seen[first:last + 1] += 1
    assert seen.min() == 1 and seen.max() == 1


def test_dx_s1_flagship_splits():
    # 16^3 x 256, 8^3 and 4^3 x 512 at N=2 split 2, 8 and 8 ways, 8.4 MB,
    # 2.1 MB and 0.26 MB a split
    for size, c, splits, mb in (((16,) * 3, 256, 2, 8.39),
                                ((8,) * 3, 512, 8, 2.10),
                                ((4,) * 3, 512, 8, 0.26)):
        plan = c3._dx_s1_plan(2, size, c, c, 132, post=True)
        assert plan["splits"] == splits
        vox = size[0] ** 3
        assert round(2 * vox * c * 4 / 1e6, 2) == mb
    for size, c in (((128,) * 3, 32), ((64,) * 3, 64)):
        assert c3._dx_s1_plan(2, size, c, c, 132)["splits"] == 1


def dx_s2_schedule(n: int, size, ci: int, co: int, sms: int) -> list:
    """The stride-2 dx kernel's work, decoded as it decodes it: per block
    b, units [b * U / G, (b + 1) * U / G), unit u = (tile * n + sample) *
    bricks + brick over the cotangent's extent; per unit, warp k owns MMA
    tile k // 2 (lines 2 (k // 2) and 2 (k // 2) + 1 of the brick's bd x bh
    lines, line l at (l // bh, l % bh)) of the classes DX2_CLASSES[k % 2],
    for the DX2_WARPS warps of a block.
    Yields (block, unit, warp, sample, dx channel tile origin, q (d, h, w)
    of the lane's A row, parity, tap, shift, footprint row, brick origin)
    for every row of every (class, tap) MMA."""
    plan = c3._dx_s2_plan(n, size, ci, co, sms)
    bd, bh, bw = c3.DX2_BRICK
    nbd, nbh, nbw = c3._bricks(c3._s2_out(size), c3.DX2_BRICK)
    nb = nbd * nbh * nbw
    units, grid = plan["units"], plan["grid"]
    for blk in range(grid):
        for u in range(blk * units // grid, (blk + 1) * units // grid):
            b, r = u % nb, u // nb
            sample, ci0 = r % n, (r // n) * c3.S1_CT
            q0 = ((b // (nbh * nbw)) * bd, (b // nbw % nbh) * bh,
                  (b % nbw) * bw)
            for warp in range(c3.DX2_WARPS):
                mt = warp >> 1
                for cls in c3.DX2_CLASSES[warp & 1]:
                    p = ((cls >> 2) & 1, (cls >> 1) & 1, cls & 1)
                    for k, s in c3.dx_s2_taps(p):
                        for hv in range(2):
                            line = 2 * mt + hv
                            for gr in range(bw):
                                m = (line // bh, line % bh, gr)
                                row = c3.dx_s2_row(tuple(
                                    a + b_ for a, b_ in zip(m, s)))
                                q = tuple(a + b_ for a, b_ in zip(q0, m))
                                yield (blk, u, warp, sample, ci0, q, p, k, s,
                                       row, q0)


S2_DX_SHAPES = S2_SHAPES + [(32, 32, (7, 8, 9)), (64, 32, (16, 15, 14))]
S2_DX_IDS = [f"{ci}-{co}@{'x'.join(map(str, e))}"
             for ci, co, e in S2_DX_SHAPES]


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("ci,co,size", S2_DX_SHAPES[2:], ids=S2_DX_IDS[2:])
def test_dx_s2_computes_every_even_pair_once(ci, co, size, sms):
    n = 2
    plan = c3._dx_s2_plan(n, size, ci, co, sms, post=True)
    assert plan["grid"] == min(plan["units"], sms)
    # POST: one 64-float slot per (unit, warp), what conv3d_k3_dx_s2_dst
    # reads per (tile, sample) group as a contiguous run of bricks x warps
    assert plan["slots"] == plan["units"] * c3.DX2_WARPS * c3.S2_SLOT
    # the warps' MMA tiles (two lines each) cover a class's lines once
    bd, bh, bw = c3.DX2_BRICK
    assert c3.DX2_WARPS // 2 * 2 == bd * bh and bw == 8
    out = c3._s2_out(size)
    counts = np.zeros((n,) + tuple(size) + (ci // c3.S1_CT, 3, 3, 3),
                      np.int32)
    fd, fh, fw = (b + 1 for b in c3.DX2_BRICK)
    units = set()
    for blk, u, warp, sample, ci0, q, p, k, s, row, q0 in dx_s2_schedule(
            n, size, ci, co, sms):
        units.add(u)
        i = tuple(2 * a + b for a, b in zip(q, p))
        if any(a >= e for a, e in zip(i, size)):
            continue                      # past dx's far end: not stored
        # dx voxel i takes tap k from cotangent (i + 1 - k) / 2, which the
        # footprint row holds (zero past gy's far end)
        o = tuple(q_ + s_ for q_, s_ in zip(q, s))
        assert all(2 * a == b + 1 - c for a, b, c in zip(o, i, k))
        assert all(a <= e for a, e in zip(o, out))
        assert row == c3.dx_s2_row(tuple(a - b for a, b in zip(o, q0)))
        assert 0 <= row < fd * fh * fw
        counts[(sample,) + i + (ci0 // c3.S1_CT,) + k] += 1
    assert len(units) == plan["units"]
    want = np.zeros(counts.shape, np.int32)
    for idx in np.ndindex(*size):
        for k in np.ndindex(3, 3, 3):
            if all((a + 1 - b) % 2 == 0 for a, b in zip(idx, k)):
                want[(slice(None),) + idx + (slice(None),) + k] = 1
    np.testing.assert_array_equal(counts, want)


def test_dx_s2_class_taps_partition_the_27_taps():
    taps = []
    for cls in range(8):
        p = ((cls >> 2) & 1, (cls >> 1) & 1, cls & 1)
        mine = c3.dx_s2_taps(p)
        assert len(mine) == 2 ** sum(p)
        for k, s in mine:
            # dx voxel 2q + p takes tap k from cotangent q + s
            assert all(2 * s_ == p_ + 1 - k_ for s_, p_, k_ in zip(s, p, k))
        taps += [k for k, _ in mine]
    assert sorted(taps) == sorted(np.ndindex(3, 3, 3))
    # the even and the odd warps' classes: all 8, 13 and 14 taps
    sets = c3.DX2_CLASSES
    assert sorted(sets[0] + sets[1]) == list(range(8))
    assert [sum(2 ** bin(c).count("1") for c in s) for s in sets] == [13, 14]


def test_dx_s2_footprint_rows():
    fd, fh, fw = (b + 1 for b in c3.DX2_BRICK)
    rows = {m: c3.dx_s2_row(m) for m in np.ndindex(fd, fh, fw)}
    # a bijection onto 0 .. R-1
    assert sorted(rows.values()) == list(range(fd * fh * fw))
    # at every shift, a line's 8 consecutive q_w are 8 consecutive rows
    for s in np.ndindex(2, 2, 2):
        for md in range(c3.DX2_BRICK[0]):
            for mh in range(c3.DX2_BRICK[1]):
                first = rows[(md + s[0], mh + s[1], s[2])]
                assert [rows[(md + s[0], mh + s[1], mw + s[2])]
                        for mw in range(c3.DX2_BRICK[2])] == list(
                            range(first, first + c3.DX2_BRICK[2]))


@pytest.mark.parametrize("ci,co,size", [(32, 32, (7, 8, 9)),
                                        (64, 32, (6, 5, 10))])
def test_dx_s2_schedule_on_numbers_gives_the_plain_dx(ci, co, size):
    # the kernel's staging (footprint zero past gy's end) and products,
    # run in float64 on the schedule, against the plain transposed conv
    import torch
    n = 2
    rng = np.random.default_rng(7)
    out = c3._s2_out(size)
    gy = rng.standard_normal((n,) + out + (co,))
    w = rng.standard_normal((3, 3, 3, ci, co))
    fd, fh, fw = (b + 1 for b in c3.DX2_BRICK)
    pad = np.zeros((n,) + tuple(e + b + 1 for e, b in
                               zip(out, c3.DX2_BRICK)) + (co,))
    pad[:, :out[0], :out[1], :out[2]] = gy
    dx = np.zeros((n,) + tuple(size) + (ci,))
    for blk, u, warp, sample, ci0, q, p, k, s, row, q0 in dx_s2_schedule(
            n, size, ci, co, 132):
        i = tuple(2 * a + b for a, b in zip(q, p))
        if any(a >= e for a, e in zip(i, size)):
            continue
        foot = pad[sample, q0[0]:q0[0] + fd, q0[1]:q0[1] + fh,
                   q0[2]:q0[2] + fw].reshape(-1, co)
        dx[(sample,) + i + (slice(ci0, ci0 + c3.S1_CT),)] += (
            w[k][ci0:ci0 + c3.S1_CT] @ foot[row])
    want = c3.conv3d_k3_dx_plain(torch.from_numpy(gy).float(),
                                 torch.from_numpy(w).float(), 2,
                                 size=size).double().numpy()
    np.testing.assert_allclose(dx, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("ci,co,size", S2_DX_SHAPES, ids=S2_DX_IDS)
def test_dx_s2_units_cover_every_cotangent_voxel_once(ci, co, size, sms):
    # unit u = (tile * n + sample) * bricks + brick: every (sample, q, dx
    # channel tile) once, so every dx voxel 2q + p of every class once
    n = 2
    plan = c3._dx_s2_plan(n, size, ci, co, sms)
    out = c3._s2_out(size)
    nbd, nbh, nbw = c3._bricks(out, c3.DX2_BRICK)
    nb = nbd * nbh * nbw
    assert plan["units"] == nb * n * (ci // c3.S1_CT)
    counts = np.zeros((n, ci // c3.S1_CT) + tuple(
        b * e for b, e in zip((nbd, nbh, nbw), c3.DX2_BRICK)), np.int32)
    bd, bh, bw = c3.DX2_BRICK
    grid, units = plan["grid"], plan["units"]
    for blk in range(grid):
        lo, hi = blk * units // grid, (blk + 1) * units // grid
        assert hi > lo, "a block without work"
        for u in range(lo, hi):
            b, r = u % nb, u // nb
            d0, h0, w0 = ((b // (nbh * nbw)) * bd, (b // nbw % nbh) * bh,
                          (b % nbw) * bw)
            counts[r % n, r // n, d0:d0 + bd, h0:h0 + bh, w0:w0 + bw] += 1
    assert counts.min() == 1 and counts.max() == 1
    assert counts.shape[2:] >= out


# ------------------------------------------------- the fp32 kernels' plans
#
# csrc/conv3d_k3_f32_fwd.cu and conv3d_k3_f32_dx.cu: units (split,
# channel tile, sample, brick), walked by persistent blocks.
# csrc/conv3d_k3_f32_dw.cu: units (split, co tile, ci tile) over the
# batch's output bricks of their split, walked by persistent blocks.

F32_SIZES = [(128,) * 3, (64,) * 3, (16,) * 3, (8,) * 3, (4,) * 3,
             (9, 10, 11), (5, 6, 7)]
F32_SHAPES = [(s, ci, co, e) for s, ci, co, e in (
    [(1, ci, co, e) for ci, co, e in SHAPES]
    + [(2, 32, 64, (128,) * 3), (2, 64, 128, (64,) * 3),
       (2, 32, 64, (9, 10, 11)), (2, 64, 32, (6, 7, 5))])]
F32_IDS = [f"s{s}-{ci}-{co}@{'x'.join(map(str, e))}"
           for s, ci, co, e in F32_SHAPES]
SMEM_LIMIT = 232448          # what a block may use on the H100


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("stride,ci,co,size", F32_SHAPES, ids=F32_IDS)
def test_f32_forward_plan_covers_every_output_once(stride, ci, co, size,
                                                   sms):
    """csrc/conv3d_k3_f32_fwd.cu's units, decoded as the kernel decodes
    them (conv3d.f32_fwd_unit): every (sample, output voxel, output
    channel) belongs to exactly one brick and tile of each split, the
    splits' chunk ranges cover the Ci / 8 chunks once, the persistent
    blocks' unit ranges cover the units once, and a block's shared memory
    fits the H100's 227 KB."""
    n = 2
    out = tuple((s - 1) // stride + 1 for s in size)
    plan = c3._f32_fwd_plan(n, size, ci, co, stride, sms)
    assert plan["ntiles"] * plan["bn"] == co
    assert plan["smem"] == c3.f32_fwd_smem(plan["tile"], stride)
    assert plan["smem"] <= SMEM_LIMIT
    nch = ci // c3.F32_FWD_KC
    assert plan["splits"] * plan["cps"] == nch
    assert plan["units"] == (plan["splits"] * plan["ntiles"] * n
                             * plan["bricks"])
    assert 1 <= plan["grid"] <= min(sms, plan["units"])
    owned = np.zeros((plan["splits"], n) + tuple(
        b * e for b, e in zip(plan["nb"], plan["brick"])) + (co,), np.int32)
    chunks = np.zeros((n, plan["ntiles"], plan["bricks"], nch), np.int32)
    for u in range(plan["units"]):
        t = c3.f32_fwd_unit(plan, n, u)
        (d0, h0, w0), (bd, bh, bw) = t["origin"], plan["brick"]
        c0 = t["tile"] * plan["bn"]
        owned[t["split"], t["sample"], d0:d0 + bd, h0:h0 + bh, w0:w0 + bw,
              c0:c0 + plan["bn"]] += 1
        chunks[t["sample"], t["tile"], t["brick"],
               t["chunks"][0]:t["chunks"][1]] += 1
    assert (owned == 1).all()
    assert (chunks == 1).all()
    assert owned.shape[2:5] >= out
    blocks = np.zeros(plan["units"], np.int32)
    for b in range(plan["grid"]):
        blocks[b * plan["units"] // plan["grid"]:
               (b + 1) * plan["units"] // plan["grid"]] += 1
    assert (blocks == 1).all()
    # the statistics: a slot per (sample, brick) unsplit, per (sample,
    # finish block) split
    vox = math.prod(out)
    groups = (-(-vox // c3.F32_FIN_VOX) if plan["splits"] > 1
              else plan["bricks"])
    assert plan["groups"] == groups and plan["slots"] == n * groups * 2 * co
    assert plan["part"] == (plan["splits"] * n * vox * co
                            if plan["splits"] > 1 else 0)


# the fp32 forward's plan at the flagship's shapes on 132 SMs: (tile,
# splits) -- the 4^3 and 8^3 shapes split K, 16^3 and larger do not
F32_FWD_FLAGSHIP = {(1, 32, 32, 128): (0, 1), (1, 64, 64, 64): (0, 1),
                    (1, 256, 256, 16): (0, 1), (1, 512, 512, 8): (0, 2),
                    (1, 512, 512, 4): (1, 8), (2, 32, 64, 128): (0, 1),
                    (2, 64, 128, 64): (0, 1)}


@pytest.mark.parametrize("case", list(F32_FWD_FLAGSHIP),
                         ids=[f"s{s}-{ci}-{co}@{e}" for s, ci, co, e in
                              F32_FWD_FLAGSHIP])
def test_f32_forward_plan_at_the_flagship_shapes(case):
    stride, ci, co, e = case
    plan = c3._f32_fwd_plan(2, (e,) * 3, ci, co, stride, 132)
    assert (plan["tile"], plan["splits"]) == F32_FWD_FLAGSHIP[case]
    # the card is filled: every SM a block, or one block a unit
    assert plan["grid"] == min(132, plan["units"]) >= 128


def _split_forward(x, w, stride, plan, pre=None, add_to=None):
    """The fp32 forward as the kernel computes it under ``plan``, in fp64
    on the CPU: each split's partial sum over its chunks' input channels
    (all 27 taps), the slices added in split order, rounded to fp32, then
    ADDIN and the statistics of the rounded sum."""
    kc = c3.F32_FWD_KC
    if pre is not None:
        u = x * pre[:, 0, None, None, None, :] - pre[:, 1, None, None, None, :]
        x = torch.where(u >= 0, u, u * 1e-2)
    parts = []
    for sp in range(plan["splits"]):
        c0, c1 = sp * plan["cps"] * kc, (sp + 1) * plan["cps"] * kc
        parts.append(c3.conv3d_k3_plain(x[..., c0:c1].double(),
                                        w[..., c0:c1, :].double(), stride))
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    y = total.float()
    if add_to is not None:
        y = y + add_to
    yd = y.double()
    return y, torch.stack([yd.sum(dim=(1, 2, 3)),
                           (yd * yd).sum(dim=(1, 2, 3))], 1).float()


@pytest.mark.parametrize("stride,ci,co,size", [
    (1, 64, 64, (4, 4, 4)), (1, 64, 32, (5, 3, 6)), (2, 32, 32, (7, 5, 9))])
def test_f32_forward_split_sums_cover_k_once_in_split_order(stride, ci, co,
                                                            size):
    """Where the plan splits K, the splits' partial convs over their
    chunks, added in split order and rounded once, give the conv: within
    fp32 rounding of the plain version, the add order being split order
    (the fp64 slices differ from one fp64 sum only in rounding far below
    fp32's)."""
    n = 2
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, *size, ci, generator=g)
    w = torch.randn(3, 3, 3, ci, co, generator=g) * (27 * ci) ** -0.5
    pre = torch.stack([torch.rand(n, ci, generator=g) + 0.5,
                       torch.randn(n, ci, generator=g)], 1)
    out = tuple((s - 1) // stride + 1 for s in size)
    add_to = torch.randn(n, *out, co, generator=g)
    plan = c3._f32_fwd_plan(n, size, ci, co, stride, 132)
    assert plan["splits"] > 1
    y, stats = _split_forward(x, w, stride, plan, pre, add_to)
    want, wstats = c3.conv3d_k3_plain(x.double(), w.double(), stride,
                                      pre=pre.double(),
                                      add_to=add_to.double(),
                                      emit_stats=True)
    rel = float((y.double() - want).norm() / want.norm())
    assert rel <= 1e-7
    assert torch.allclose(stats.double(), wstats, rtol=1e-6, atol=1e-4)
    # one split short, or one counted twice, is far off
    short = dict(plan, splits=plan["splits"] - 1)
    y_short, _ = _split_forward(x, w, stride, short, pre, add_to)
    assert float((y_short.double() - want).norm() / want.norm()) > 1e-2


def f32_dx_rows(plan, stride):
    """The row groups of an fp32 dx unit as csrc/conv3d_k3_f32_dx.cu walks
    them (``row_of``, ``Step``, ``Class``): a list of (brick-local dx
    voxels (r, 3), staged row each reads at tap offset 0 (r,), [(tap (k_d,
    k_h, k_w), staged row offset)]). Stride 1: every voxel of the brick,
    row (m + 2 - k) of the halo'd brick for each of the 27 taps, in the
    steps' order (d offset SUB, tap 26 - (9 SUB + i)). Stride 2: per warp
    pair p, m-tile mi and half (the warp's q_d), the 16 voxels 2q + p of
    class F32_DX_S2_CLASSES[p][mi], row q of the brick from q0, its taps
    (dx_s2_taps) at offset q + s."""
    bd, bh, bw = plan["brick"]
    if stride == 1:
        sh, sw = bh + 2, bw + 2
        m = np.array(list(np.ndindex(bd, bh, bw)))
        row0 = (m[:, 0] * sh + m[:, 1]) * sw + m[:, 2]
        taps = []
        for sub in range(3):
            for i in range(9):
                t = 26 - (9 * sub + i)
                taps.append(((t // 9, t // 3 % 3, t % 3),
                             (sub * sh + i // 3) * sw + i % 3))
        return [(m, row0, taps)]
    sh, sw = bh // 2 + 1, bw // 2 + 1
    out = []
    for pair in c3.F32_DX_S2_CLASSES:
        for cls in pair:
            par = ((cls >> 2) & 1, (cls >> 1) & 1, cls & 1)
            taps = [(k, (s[0] * sh + s[1]) * sw + s[2])
                    for k, s in c3.dx_s2_taps(par)]
            for half in range(bd // 2):
                q = np.array([(half, r >> 2, r & 3) for r in range(16)])
                out.append((2 * q + np.array(par),
                            (q[:, 0] * sh + q[:, 1]) * sw + q[:, 2], taps))
    return out


def f32_dx_staged(stride, plan, sample, gy_origin, g):
    """The cotangent brick a unit stages from g (n, Do, Ho, Wo, C): its
    rows (R, C), zero outside the volume."""
    bd, bh, bw = plan["brick"]
    ext = ((bd + 2, bh + 2, bw + 2) if stride == 1
           else (bd // 2 + 1, bh // 2 + 1, bw // 2 + 1))
    rows = np.zeros(ext + (g.shape[-1],))
    src = [slice(max(o, 0), min(o + e, s))
           for o, e, s in zip(gy_origin, ext, g.shape[1:4])]
    dst = [slice(a.start - o, a.stop - o) for a, o in zip(src, gy_origin)]
    rows[tuple(dst)] = g[(sample,) + tuple(src)]
    return rows.reshape(-1, g.shape[-1])


def f32_dx_schedule(stride, plan, size, gy, w, y=None, gs=None, x=None,
                    pre=None, slope=float(np.float32(1e-2))):
    """The fp32 dx as the kernel computes it under ``plan``, in fp64 on
    numpy arrays: each unit stages the (corrected) cotangent brick per
    chunk of 8 channels and multiplies the rows :func:`f32_dx_rows` names
    by their taps' weights into its split's slice; the slices are added in
    split order, then POST and its sums [sum du*x; sum du] (the slope an
    fp32, as the kernel and the plain version take it). Returns (dx,
    dst or None, chunks summed per (split, sample, dx voxel, dx channel,
    chunk))."""
    n, co, ci = gy.shape[0], gy.shape[-1], w.shape[3]
    g = gy if y is None else gy + gs[:, None, None, None, 0] + (
        2 * y * gs[:, None, None, None, 1])
    kc, bn = c3.F32_FWD_KC, plan["bn"]
    part = np.zeros((plan["splits"], n) + tuple(size) + (ci,))
    seen = np.zeros((plan["splits"], n) + tuple(size)
                    + (ci, co // kc), np.int32)
    groups = f32_dx_rows(plan, stride)
    for u in range(plan["units"]):
        t = c3.f32_dx_unit(plan, n, u, stride)
        c0 = t["tile"] * bn
        rows = f32_dx_staged(stride, plan, t["sample"], t["gy_origin"], g)
        for m, row0, taps in groups:
            vox = m + np.array(t["origin"])
            inside = (vox < np.array(size)).all(axis=1)
            acc = np.zeros((len(m), bn))
            for chunk in range(*t["chunks"]):
                a = rows[:, chunk * kc:(chunk + 1) * kc]
                for k, off in taps:
                    acc += a[row0 + off] @ w[k][c0:c0 + bn,
                                                chunk * kc:(chunk + 1) * kc].T
            idx = (t["split"], t["sample"]) + tuple(vox[inside].T)
            part[idx + (slice(c0, c0 + bn),)] += acc[inside]
            seen[idx + (slice(c0, c0 + bn),
                        slice(*t["chunks"]))] += 1
    dxn = part[0]
    for p in part[1:]:
        dxn = dxn + p
    if pre is None:
        return dxn, None, seen
    sc, sf = pre[:, None, None, None, 0], pre[:, None, None, None, 1]
    du = np.where(x * sc - sf >= 0, dxn, dxn * slope)
    dst = np.stack([(du * x).sum(axis=(1, 2, 3)), du.sum(axis=(1, 2, 3))], 1)
    return du * sc, dst, seen


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("stride,ci,co,size", F32_SHAPES, ids=F32_IDS)
def test_f32_dx_plan_covers_every_dx_voxel_once(stride, ci, co, size, sms):
    """csrc/conv3d_k3_f32_dx.cu's units and rows: every (split, sample, dx
    voxel, dx channel) belongs to exactly one row of one unit (at stride 2
    through the 8 parity classes of the brick's row groups, dx voxel 2q +
    p), the splits' chunk ranges cover the co / 8 chunks once per brick
    and tile, the persistent blocks' ranges cover the units once, and a
    block's shared memory is f32_dx_smem's, within the H100's 227 KB."""
    n = 2
    plan = c3._f32_dx_plan(n, size, ci, co, stride, sms)
    assert plan["ntiles"] * plan["bn"] == ci
    assert (plan["tile"] == 2) == (stride == 2)
    assert plan["smem"] == c3.f32_dx_smem(plan["tile"], False)
    assert plan["smem"] <= SMEM_LIMIT
    nch = co // c3.F32_FWD_KC
    assert plan["splits"] * plan["cps"] == nch
    assert plan["units"] == (plan["splits"] * plan["ntiles"] * n
                             * plan["bricks"])
    assert 1 <= plan["grid"] <= min(sms, plan["units"])
    groups = f32_dx_rows(plan, stride)
    m = np.concatenate([g[0] for g in groups])
    assert len(m) == math.prod(plan["brick"])
    assert len({tuple(v) for v in m}) == len(m)      # no voxel twice
    owned = np.zeros((plan["splits"], n) + tuple(
        b * e for b, e in zip(plan["nb"], plan["brick"])) + (ci,), np.int32)
    chunks = np.zeros((n, plan["ntiles"], plan["bricks"], nch), np.int32)
    for u in range(plan["units"]):
        t = c3.f32_dx_unit(plan, n, u, stride)
        c0 = t["tile"] * plan["bn"]
        vox = m + np.array(t["origin"])
        owned[(t["split"], t["sample"]) + tuple(vox.T)
              + (slice(c0, c0 + plan["bn"]),)] += 1
        chunks[t["sample"], t["tile"], t["brick"],
               t["chunks"][0]:t["chunks"][1]] += 1
    assert (owned == 1).all()
    assert (chunks == 1).all()
    assert owned.shape[2:5] >= tuple(size)
    blocks = np.zeros(plan["units"], np.int32)
    for b in range(plan["grid"]):
        blocks[b * plan["units"] // plan["grid"]:
               (b + 1) * plan["units"] // plan["grid"]] += 1
    assert (blocks == 1).all()
    vox = math.prod(size)
    groups_ = (-(-vox // c3.F32_FIN_VOX) if plan["splits"] > 1
               else plan["bricks"])
    assert plan["groups"] == groups_ and plan["slots"] == n * groups_ * 2 * ci
    assert plan["part"] == (plan["splits"] * n * vox * ci
                            if plan["splits"] > 1 else 0)


# the fp32 dx's plan at the flagship's shapes on 132 SMs (the dx of the
# conv of that shape: dx's extent and ci channels, K its co / 8 chunks):
# (tile, splits) -- split at 8^3 and 4^3 as the forward, tile 2 at stride 2
F32_DX_FLAGSHIP = {**F32_FWD_FLAGSHIP, (2, 32, 64, 128): (2, 1),
                   (2, 64, 128, 64): (2, 1)}


@pytest.mark.parametrize("case", list(F32_DX_FLAGSHIP),
                         ids=[f"s{s}-{ci}-{co}@{e}" for s, ci, co, e in
                              F32_DX_FLAGSHIP])
def test_f32_dx_plan_at_the_flagship_shapes(case):
    """The dx of each flagship conv is tiled and split as F32_DX_FLAGSHIP
    says: the 8^3 and 4^3 x 512 shapes split K, the small tile at 4^3, the
    stride-2 tile at stride 2; every SM takes a block."""
    stride, ci, co, e = case
    plan = c3._f32_dx_plan(2, (e,) * 3, ci, co, stride, 132)
    assert (plan["tile"], plan["splits"]) == F32_DX_FLAGSHIP[case]
    assert plan["grid"] == min(132, plan["units"]) >= 128


@pytest.mark.parametrize("corr", [False, True], ids=["plain", "corr"])
@pytest.mark.parametrize("tile,stride", [(0, 1), (1, 1), (2, 2)])
def test_f32_dx_smem_fits_in_every_mode(tile, stride, corr):
    """f32_dx_smem, the planner's and (checked by the C launcher) the
    kernel's dynamic shared memory, fits the H100's 232,448 bytes with and
    without CORR's y slots (POST adds none), and is the sum of its parts:
    the fp64 bricks and weight steps, the fp32 slots, the inside bits and
    the column sums."""
    t = c3.F32_DX_TILES[tile]
    kc, bn = c3.F32_FWD_KC, t["bn"]
    if stride == 1:
        rows, taps, slots = math.prod(b + 2 for b in t["brick"]), 9, 1
    else:
        rows, taps, slots = math.prod(b // 2 + 1 for b in t["brick"]), 27, 3
    parts = (2 * rows * kc * 8 + 2 * taps * bn * kc * 8
             + slots * rows * kc * 4 * (2 if corr else 1)
             + 3 * taps * bn * kc * 4 + slots * 128 * 4
             + t["wgm"] * 2 * bn * 8)
    smem = c3.f32_dx_smem(tile, corr)
    assert smem == parts <= SMEM_LIMIT
    plan = c3._f32_dx_plan(2, (4,) * 3 if tile == 1 else (9, 10, 11),
                           64 if tile == 1 else 32, 32, stride, 132, corr)
    assert plan["tile"] == tile and plan["smem"] == smem


def test_f32_dx_s2_brick_rows_serve_every_class_tap():
    """At stride 2 the staged (b/2 + 1)^3 cotangent brick from q0 = origin
    / 2 holds every row a class's taps read: dx voxel 2q + p of the brick
    takes tap k from cotangent q0 + q + s, row (q + s), inside the brick;
    the warp pairs' m-tiles take each class once and each half once, and
    the pairs' taps are 9, 6, 6, 6 (27 in all)."""
    plan = c3._f32_dx_plan(2, (9, 10, 11), 32, 32, 2, 132)
    bd, bh, bw = plan["brick"]
    ext = (bd // 2 + 1, bh // 2 + 1, bw // 2 + 1)
    rows = f32_dx_rows(plan, 2)
    assert len(rows) == 8 * (bd // 2)
    classes = [c for pair in c3.F32_DX_S2_CLASSES for c in pair]
    assert sorted(classes) == list(range(8))
    per_pair = [sum(2 ** bin(c).count("1") for c in pair)
                for pair in c3.F32_DX_S2_CLASSES]
    assert per_pair == [9, 6, 6, 6]
    covered = np.zeros((bd, bh, bw), np.int32)
    for m, row0, taps in rows:
        covered[tuple(m.T)] += 1
        for k, off in taps:
            for mv, r in zip(m, row0 + off):
                # dx voxel mv (brick-local, origin 2 q0) reads cotangent
                # (mv + 1 - k) / 2 relative to q0, at row r of the brick
                q = (mv + 1 - np.array(k)) // 2
                assert ((mv + 1 - np.array(k)) % 2 == 0).all()
                assert (q >= 0).all() and (q < np.array(ext)).all()
                assert r == (q[0] * ext[1] + q[1]) * ext[2] + q[2]
    assert (covered == 1).all()


@pytest.mark.parametrize("mode", ["plain", "corr", "corr_post"])
@pytest.mark.parametrize("stride,ci,co,size,sms", [
    (1, 32, 16, (5, 9, 11), 4), (1, 32, 16, (5, 9, 11), 132),
    (1, 64, 24, (3, 4, 2), 132), (2, 32, 16, (7, 9, 11), 4),
    (2, 32, 16, (7, 9, 11), 132)])
def test_f32_dx_schedule_on_numbers_gives_the_plain_dx(stride, ci, co,
                                                        size, sms, mode):
    """The fp32 dx's units, staged bricks and row groups, walked on fp64
    numbers (:func:`f32_dx_schedule`), give conv3d_k3_dx_plain's dx and
    dst in fp64, and with a split, every (dx voxel, channel) sums each
    chunk once, in its split; one split short is far off."""
    n = 2
    rng = np.random.default_rng(3)
    out = tuple((s - 1) // stride + 1 for s in size)
    gy = rng.standard_normal((n,) + out + (co,))
    w = rng.standard_normal((3, 3, 3, ci, co)) * (27 * ci) ** -0.5
    kw = {}
    if "corr" in mode:
        kw.update(y=rng.standard_normal((n,) + out + (co,)),
                  gs=rng.standard_normal((n, 2, co)) * 0.1)
    if "post" in mode:
        kw.update(x=rng.standard_normal((n,) + tuple(size) + (ci,)),
                  pre=np.stack([rng.random((n, ci)) + 0.5,
                                rng.standard_normal((n, ci))], 1))
    plan = c3._f32_dx_plan(n, size, ci, co, stride, sms, "corr" in mode)
    assert (plan["splits"] > 1) == (sms == 132)
    dx, dst, seen = f32_dx_schedule(stride, plan, size, gy, w, **kw)
    want = c3.conv3d_k3_dx_plain(
        torch.from_numpy(gy), torch.from_numpy(w), stride, size=size,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    if "post" in mode:
        want, wdst = want
        np.testing.assert_allclose(dst, wdst.numpy(), rtol=1e-10,
                                   atol=1e-10)
    np.testing.assert_allclose(dx, want.numpy(), rtol=1e-10, atol=1e-10)
    # each (dx voxel, channel) sums each chunk in exactly one split
    per_chunk = seen.sum(axis=0)
    assert (per_chunk == 1).all()
    cps = plan["cps"]
    for sp in range(plan["splits"]):
        mine = seen[sp][..., sp * cps:(sp + 1) * cps]
        assert (mine == 1).all()
    if plan["splits"] > 1:
        short = dict(plan, units=plan["units"] // plan["splits"]
                     * (plan["splits"] - 1))
        dx_s, _, _ = f32_dx_schedule(stride, short, size, gy, w, **kw)
        ref = want.numpy()
        assert np.linalg.norm(dx_s - ref) > 1e-2 * np.linalg.norm(ref)


def f32_dw_tap_rows(plan):
    """{tap (kd, kh, kw): the staged fp64 input row each brick voxel (in K
    order, w fastest) reads}, as warp (kd, ., .) computes it
    (``tap_row0``, ``mma_step``): row0 + (od * SH + oh) * SW + ow in the
    tap's region (conv3d.f32_dw_regions: SW its padded row length), stride
    1 the halo'd brick at offset (kd, kh, kw), stride 2 class (kd != 1, kh
    != 1, kw != 1) at offset (kd == 2, kh == 2, kw == 2)."""
    regions = c3.f32_dw_regions(plan["tile"])
    m = np.array(list(np.ndindex(*plan["brick"])))
    rows = {}
    for kd, kh, kw in np.ndindex(3, 3, 3):
        if len(regions) == 1:
            base, ext, sw, _ = regions[0]
            k = (kd, kh, kw)
        else:
            base, ext, sw, _ = regions[4 * (kd != 1) + 2 * (kh != 1)
                                       + (kw != 1)]
            k = (int(kd == 2), int(kh == 2), int(kw == 2))
        row0 = base + (k[0] * ext[1] + k[1]) * sw + k[2]
        rows[(kd, kh, kw)] = row0 + (m[:, 0] * ext[1] + m[:, 1]) * sw + m[:, 2]
    return rows


def f32_dw_staged(plan, stride, sample, origin, xin, g, c):
    """A step's staged rows: the input footprint (each region's real rows
    at their padded positions, channels ``c`` of xin; the padding rows
    NaN, as no tap may read them) and the cotangent brick (the tile's
    channels of g), zero outside the volumes."""
    (ci0, cis), (co0, cos) = c
    regions = c3.f32_dw_regions(plan["tile"])
    base, ext, sw, _ = regions[-1]
    xs = np.full((base + ext[0] * ext[1] * sw, cis), np.nan)
    for base, ext, sw, off in regions:
        r = np.array(list(np.ndindex(*ext)))
        vox = stride * (np.array(origin) + r) + np.array(off)
        inside = ((vox >= 0) & (vox < np.array(xin.shape[1:4]))).all(axis=1)
        rows = base + (r[:, 0] * ext[1] + r[:, 1]) * sw + r[:, 2]
        xs[rows] = 0.0
        xs[rows[inside]] = xin[(sample,) + tuple(vox[inside].T)][
            :, ci0:ci0 + cis]
    m = np.array(list(np.ndindex(*plan["brick"]))) + np.array(origin)
    inside = (m < np.array(g.shape[1:4])).all(axis=1)
    gs_ = np.zeros((len(m), cos))
    gs_[inside] = g[(sample,) + tuple(m[inside].T)][:, co0:co0 + cos]
    return xs, gs_


def f32_dw_schedule(stride, plan, x, gy, pre=None, y=None, gs=None,
                    slope=float(np.float32(1e-2))):
    """The fp32 dW as the kernel computes it under ``plan``, in fp64 on
    numpy arrays: each unit stages each brick of its split (the
    (pre-op'd) input footprint and (corrected) cotangent, zero outside)
    and adds every tap's rows times the cotangent brick into its split's
    slice; the slices are added in split order. Returns (dW, bricks summed
    per (split, tile, brick))."""
    ci, co = x.shape[-1], gy.shape[-1]
    xin = x
    if pre is not None:
        u = x * pre[:, None, None, None, 0] - pre[:, None, None, None, 1]
        xin = np.where(u >= 0, u, u * slope)
    g = gy if y is None else gy + gs[:, None, None, None, 0] + (
        2 * y * gs[:, None, None, None, 1])
    part = np.zeros((plan["splits"], 27, ci, co))
    seen = np.zeros((plan["splits"], plan["ntiles"], plan["bricks"]),
                    np.int32)
    rows = f32_dw_tap_rows(plan)
    for u in range(plan["units"]):
        t = c3.f32_dw_unit(plan, u)
        c = ((t["ci0"], plan["ci"]), (t["co0"], plan["co"]))
        cis, cos = (slice(a, a + b) for a, b in c)
        for b in range(*t["bricks"]):
            sample, origin = c3.f32_dw_brick(plan, b)
            xs, gb = f32_dw_staged(plan, stride, sample, origin, xin, g, c)
            for (kd, kh, kw), r in rows.items():
                part[t["split"], (kd * 3 + kh) * 3 + kw, cis, cos] += (
                    xs[r].T @ gb)
            seen[t["split"], u % plan["ntiles"], b] += 1
    dw = part[0]
    for p in part[1:]:
        dw = dw + p
    return dw.reshape(3, 3, 3, ci, co), seen


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("stride,ci,co,size", F32_SHAPES, ids=F32_IDS)
def test_f32_dw_plan_sums_every_voxel_into_every_tap_once(stride, ci, co,
                                                          size, sms):
    """csrc/conv3d_k3_f32_dw.cu's units (conv3d.f32_dw_unit): every (split,
    tap, ci, co) belongs to exactly one unit (its tile's 27 taps, warp w =
    (kh, kw) holding taps 9 kd + w), the splits' brick ranges, in split
    order, cover the batch's bricks once, the bricks cover every output
    voxel once, the persistent blocks' ranges cover the units once, and a
    block's shared memory is f32_dw_smem's, within the H100's 227 KB."""
    n = 2
    out = tuple((s - 1) // stride + 1 for s in size)
    plan = c3._f32_dw_plan(n, size, ci, co, stride, sms)
    assert plan["smem"] == c3.f32_dw_smem(plan["tile"], False) <= SMEM_LIMIT
    assert c3.F32_DW_TILES[plan["tile"]]["stride"] == stride
    assert plan["ntci"] * plan["ci"] == ci and plan["ntco"] * plan["co"] == co
    assert plan["units"] == plan["splits"] * plan["ntiles"]
    assert 1 <= plan["splits"] <= min(sms, plan["bricks"])
    assert 1 <= plan["grid"] == min(sms, plan["units"])
    assert sorted(9 * kd + w for kd in range(3) for w in range(9)) == list(
        range(27))
    owner = np.zeros((plan["splits"], ci, co), np.int32)
    ranges = [[] for _ in range(plan["ntiles"])]
    for u in range(plan["units"]):
        t = c3.f32_dw_unit(plan, u)
        owner[t["split"], t["ci0"]:t["ci0"] + plan["ci"],
              t["co0"]:t["co0"] + plan["co"]] += 1
        ranges[u % plan["ntiles"]].append(t["bricks"])
    assert (owner == 1).all()
    for r in ranges:          # split order, each brick once
        assert r[0][0] == 0 and r[-1][1] == plan["bricks"]
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(r, r[1:]))
    per = math.prod(plan["nb"])
    assert plan["bricks"] == n * per
    b = np.arange(plan["bricks"])
    _, nbh, nbw = plan["nb"]
    idx = np.stack([b % per // (nbh * nbw), b % per // nbw % nbh,
                    b % per % nbw], 1) * np.array(plan["brick"])
    covered = np.zeros((n,) + tuple(e * k for e, k in zip(plan["nb"],
                                                        plan["brick"])),
                       np.int32)
    for m in np.ndindex(*plan["brick"]):
        v = idx + np.array(m)
        np.add.at(covered, (b // per, v[:, 0], v[:, 1], v[:, 2]), 1)
    assert (covered == 1).all() and covered.shape[1:] >= out
    # brick b decodes as f32_dw_brick says
    for k in (0, plan["bricks"] - 1):
        assert c3.f32_dw_brick(plan, k) == (k // per, tuple(idx[k]))
    blocks = np.zeros(plan["units"], np.int32)
    for blk in range(plan["grid"]):
        blocks[blk * plan["units"] // plan["grid"]:
               (blk + 1) * plan["units"] // plan["grid"]] += 1
    assert (blocks == 1).all()
    length = 27 * ci * co
    assert plan["part"] == (plan["splits"] * length if plan["splits"] > 1
                            else 0)
    assert plan["fin_grid"] == (-(-length // c3.F32_DW_FIN_THREADS)
                                if plan["splits"] > 1 else 0)


@pytest.mark.parametrize("corr", [False, True], ids=["plain", "corr"])
@pytest.mark.parametrize("tile", [0, 1, 2, 3])
def test_f32_dw_smem_fits_in_every_mode(tile, corr):
    """f32_dw_smem, the planner's and (checked by the C launcher) the
    kernel's dynamic shared memory, fits the H100's 232,448 bytes with and
    without CORR's y slots (PRE adds none), and is the sum of its parts:
    two fp64 input bricks of padded rows and cotangent bricks, the stages'
    fp32 slots (the input's real rows, the cotangent's, [scale; shift] and
    [gs0; gs1]), a word of inside bits a producer thread and stage; the
    planner takes each tile where it says. Each region's padded rows along
    w are a multiple of 4 long, its real rows within them, and the regions
    lie one after another."""
    t = c3.F32_DW_TILES[tile]
    regions = c3.f32_dw_regions(tile)
    assert len(regions) == (1 if t["stride"] == 1 else 8)
    base = 0
    for b, ext, sw, _ in regions:
        assert b == base and sw % 4 == 0 and ext[2] <= sw < ext[2] + 4
        base += ext[0] * ext[1] * sw
    real = sum(math.prod(e) for _, e, _, _ in regions)
    grow = (lambda b: b + 2) if t["stride"] == 1 else (lambda b: 2 * b + 1)
    assert real == math.prod(grow(b) for b in t["brick"])
    gf = math.prod(t["brick"]) * t["co"]
    parts = (2 * (base * t["ci"] + gf) * 8
             + t["stages"] * (real * t["ci"] + gf + 2 * t["ci"] + 2 * t["co"]
                              + 128 + gf * corr) * 4)
    assert c3.f32_dw_smem(tile, corr) == parts <= SMEM_LIMIT
    size, ci, co = {0: ((9, 10, 11), 32, 32), 1: ((4, 3, 4), 32, 32),
                    2: ((9, 10, 11), 32, 64), 3: ((9, 10, 11), 64, 32)}[tile]
    plan = c3._f32_dw_plan(2, size, ci, co, t["stride"], 132, corr)
    assert plan["tile"] == tile and plan["smem"] == parts


@pytest.mark.parametrize("tile", [0, 1, 2, 3])
def test_f32_dw_fragment_loads_hit_every_bank(tile):
    """The fp64 bricks' layout (f32_dw_swz, the kernel's ``swz``): for every
    step voxel, m-tile and tap, a quarter-warp's 16-byte cotangent loads
    (lane (g, t) of lanes 8p .. 8p + 7 reading row t's pair at 2 MT g + 2
    mi) hit the 8 bank groups once and a half-warp's 8-byte input loads (row
    t's double g + 8 ni) 16 distinct words; a tap's rows from one k-step to
    the next move by multiples of 4, where the swizzle repeats. The
    producers' 16-byte stores of converted pairs (input and cotangent
    items, 8 threads a phase) hit at most 2 of them each."""
    t = c3.F32_DW_TILES[tile]
    plan = c3._f32_dw_plan(2, (9, 10, 11), 64, 64 if tile != 3 else 32,
                           t["stride"], 132)
    plan = dict(plan, tile=tile, brick=t["brick"], ci=t["ci"], co=t["co"])
    mt, nt = t["co"] // 16, t["ci"] // 8
    v = math.prod(t["brick"])
    rows = f32_dw_tap_rows(plan)
    lanes = [(g, tq) for g in range(8) for tq in range(4)]
    for r in rows.values():
        assert ((r[8:] - r[:-8]) % 4 == 0).all()   # rows of k-steps s, s + 1
        assert (r[4::8] - r[::8] == 4).all() or t["brick"][2] == 4
    for s in range(v // 8):
        for hv in range(2):
            for mi in range(mt):         # the cotangent: row = the voxel
                addr = [8 * c3.f32_dw_swz(t["co"], 8 * s + 4 * hv + tq,
                                          2 * mt * g + 2 * mi)
                        for g, tq in lanes]
                for q in range(4):
                    assert len({a // 16 % 8 for a in addr[8 * q:8 * q + 8]}) == 8
            for r, ni in itertools.product(rows.values(), range(nt)):
                addr = [8 * c3.f32_dw_swz(t["ci"], int(r[8 * s + 4 * hv + tq]),
                                          g + 8 * ni) for g, tq in lanes]
                for q in range(2):       # each tap's input rows, 8 bytes
                    assert len({a // 8 % 16
                                for a in addr[16 * q:16 * q + 16]}) == 16
    # the producers: item e = (row e // Q, quarter e % Q) of the regions'
    # real rows (input) or of the brick voxels (cotangent), its pairs at
    # swz(row, 4q) and that ^ 2
    xrows = [b + (i // (e[1] * e[2]) * e[1] + i // e[2] % e[1]) * sw
             + i % e[2] for b, e, sw, _ in c3.f32_dw_regions(tile)
             for i in range(math.prod(e))]
    for rw, rowof in ((t["ci"], xrows), (t["co"], list(range(v)))):
        q = rw // 4
        for e0 in range(0, len(rowof) * q - 7, 8):
            for flip in (0, 2):
                addr = [8 * (c3.f32_dw_swz(rw, rowof[e // q], 4 * (e % q))
                             ^ flip) for e in range(e0, e0 + 8)]
                assert len({a // 16 % 8 for a in addr}) >= 4


@pytest.mark.parametrize("mode", ["plain", "pre", "corr", "pre_corr"])
@pytest.mark.parametrize("stride,ci,co,size,sms,split", [
    (1, 32, 32, (5, 9, 11), 4, True), (1, 64, 32, (5, 9, 11), 132, True),
    (1, 64, 32, (3, 4, 2), 4, False), (2, 32, 64, (7, 9, 11), 2, False),
    (2, 64, 32, (6, 7, 5), 132, True)])
def test_f32_dw_schedule_on_numbers_gives_the_plain_dw(stride, ci, co, size,
                                                        sms, split, mode):
    """The fp32 dW's units, staged footprints (stride 2 by parity class)
    and tap rows, walked on fp64 numbers (:func:`f32_dw_schedule`), give
    conv3d_k3_dw_plain's dW in fp64 in every mode, at extents that are no
    multiple of the bricks, on every tile; each (tile, brick) is summed
    once, in its split; a schedule one split short is far off."""
    n = 2
    rng = np.random.default_rng(4)
    out = tuple((s - 1) // stride + 1 for s in size)
    x = rng.standard_normal((n,) + size + (ci,))
    gy = rng.standard_normal((n,) + out + (co,))
    kw = {}
    if "pre" in mode:
        kw["pre"] = np.stack([rng.random((n, ci)) + 0.5,
                              rng.standard_normal((n, ci))], 1)
    if "corr" in mode:
        kw.update(y=rng.standard_normal((n,) + out + (co,)),
                  gs=rng.standard_normal((n, 2, co)) * 0.1)
    plan = c3._f32_dw_plan(n, size, ci, co, stride, sms, "corr" in mode)
    assert (plan["splits"] > 1) == split
    dw, seen = f32_dw_schedule(stride, plan, x, gy, **kw)
    want = c3.conv3d_k3_dw_plain(
        torch.from_numpy(x), torch.from_numpy(gy), stride,
        negative_slope=float(np.float32(1e-2)),
        **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    np.testing.assert_allclose(dw, want, rtol=1e-10, atol=1e-10)
    assert (seen.sum(axis=0) == 1).all()
    for sp in range(plan["splits"]):
        b0, b1 = sp * plan["bricks"] // plan["splits"], (
            (sp + 1) * plan["bricks"] // plan["splits"])
        assert (seen[sp][:, b0:b1] == 1).all()
    if split:
        short = dict(plan, units=plan["units"] - plan["ntiles"])
        dw_s, _ = f32_dw_schedule(stride, short, x, gy, **kw)
        assert np.linalg.norm(dw_s - want) > 1e-2 * np.linalg.norm(want)


def test_f32_flagship_plans_fill_the_card():
    """At the flagship's shapes on 132 SMs every fp32 conv launch has at
    least 128 units (the dW at 16^3 x 256 and 64 -> 128 @64^3 has exactly
    128) and a block on at least 128 SMs."""
    for stride, ci, co, size in F32_SHAPES[:5] + F32_SHAPES[7:9]:
        for plan in (c3._f32_fwd_plan(2, size, ci, co, stride, 132),
                     c3._f32_dx_plan(2, size, ci, co, stride, 132),
                     c3._f32_dw_plan(2, size, ci, co, stride, 132)):
            assert plan["units"] >= 128
            assert plan["grid"] >= 128
