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
numbers, must give the plain dx.
"""

import numpy as np
import pytest

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
