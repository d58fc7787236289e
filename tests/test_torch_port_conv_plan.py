"""The tiling planners of the port's tensor-core convs, on the CPU.

``ops/conv3d.py`` chooses in Python how the CUDA kernels
``csrc/conv3d_k3_s1.cu`` / ``conv3d_k3_s2.cu`` (the forward) and
``csrc/conv3d_k3_dw_s1.cu`` / ``conv3d_k3_dw_s2.cu`` (dW) cut their work:
bricks of voxels, channel tiles, the split of K across blocks and the
persistent blocks' unit ranges. ``s1_schedule``, ``s2_schedule`` and
``dw_schedule`` below decode every block's work as the kernels decode
their block indices (the planners' docstrings). At every flagship shape
(N = 2) and at extents that are no multiple of the bricks, on a card of
132 SMs and a smaller one, each (sample, voxel, output channel, input
chunk) of the forward and each (sample, voxel) of every (ci, co) tile of
dW (all 27 taps at once) must be covered exactly once; at stride 2 the
voxels are the output's. The stride-2 kernels' parity-split staging
(``s2_row``) must put every footprint position in its own row, and every
tap's 8 consecutive output w in 8 consecutive rows (what their ldmatrix
addressing takes).
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


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [(128,) * 3, (9, 10, 11), (7, 8, 9)])
def test_dx_post_slots(size, stride):
    n, ci = 2, 64
    shape = c3._dx_slots(n, size, ci, stride)
    classes = 8 if stride == 2 else 1
    # every voxel of every parity class has its 128-voxel block's slot
    largest = 0
    for par in range(classes):
        p = ((par >> 2) & 1, (par >> 1) & 1, par & 1)
        m = int(np.prod([-(-(s - q) // stride) for s, q in zip(size, p)]))
        largest = max(largest, m)
        assert m <= shape[3] * c3.DX_TV
    assert shape == (n, ci // c3.DX_CIB, classes, -(-largest // c3.DX_TV),
                     2 * c3.DX_CIB)


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
