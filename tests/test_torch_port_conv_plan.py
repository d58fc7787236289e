"""The tiling planners of the port's stride-1 tensor-core convs, on the CPU.

``ops/conv3d.py`` chooses in Python how the CUDA kernels
``csrc/conv3d_k3_s1.cu`` (the forward) and ``csrc/conv3d_k3_dw_s1.cu`` (dW)
cut their work: bricks of voxels, channel tiles, the split of K across
blocks and the persistent blocks' unit ranges. ``s1_schedule`` and
``dw_s1_schedule`` below decode every block's work as the kernels decode
their block indices (the planners' docstrings). At every flagship
stride-1 shape (N = 2) and at extents that are no multiple of the bricks,
on a card of 132 SMs and a smaller one, each
(sample, voxel, output channel, input chunk) of the forward and each
(sample, voxel) of every (ci, co) tile of dW (all 27 taps at once) must be
covered exactly once.
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


def dw_s1_schedule(n: int, size, ci: int, co: int,
                   sms: int) -> list:
    """Per block of the stride-1 dW kernel: (first ci, first co, [voxel
    bricks as (sample, origin (d, h, w))]), decoded as the kernel decodes
    them: block = split * tiles + tile, tile = ci tile * (co / 32) + co
    tile, split s takes bricks [s * B / splits, (s + 1) * B / splits) with
    brick = ((sample * nbd + bd) * nbh + bh) * nbw + bw."""
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
    blocks = dw_s1_schedule(n, size, ci, co, sms)
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
