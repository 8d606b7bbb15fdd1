"""The launch plans of the port's one-launch reduction kernels, on the CPU.

``ops.channel_sums.reduction_plan`` sizes the channel-sum grid and
``ops.fused_ssim.tile_plan`` cuts an MS-SSIM level into tiles; the wrappers
pass exactly these numbers to the kernels, which cut rows and tiles as the
helpers here do. Here: every
row of every BN input the training steps give the kernel is summed by
exactly one block, every valid SSIM position lies in exactly one tile whose
staged region stays inside the input, and a numpy model of the kernels'
last-ticket finish gives the same bits whatever order the blocks arrive in.

The BN inputs are those of ``chip_smoke.step_shapes`` (a USSS joint step at
batch 10 and the Discriminator of a WSSS adversarial step), recorded here
from train-mode forwards of the models on the meta device, so no arithmetic
runs."""

import collections

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from fcdgan_tpu_torch.models import layers
from fcdgan_tpu_torch.models import vgg as vgg_mod
from fcdgan_tpu_torch.models.discriminator import Discriminator
from fcdgan_tpu_torch.models.generator import Generator
from fcdgan_tpu_torch.models.segmentor import Segmentor
from fcdgan_tpu_torch.ops import channel_sums as cs_mod
from fcdgan_tpu_torch.ops import fused_ssim as ssim_mod
from fcdgan_tpu_torch.ops.tickets import MAX_TICKETS

SMS = [132, 114, 8, 1]  # an H100 SXM, an H100 PCIe, and small cards


@pytest.fixture(scope="module")
def bn_inputs():
    """NHWC shapes of the BN inputs of a USSS joint step and of a WSSS
    adversarial step's Discriminator, with their counts."""
    seen = []

    def record(y, scale, bias, eps):
        seen.append((y.shape[0], y.shape[2], y.shape[3], y.shape[1]))
        c = y.shape[1]
        return y, torch.zeros(c, device=y.device), torch.ones(c, device=y.device)

    def pool(x):
        return F.max_pool2d(x, 2)

    mp = pytest.MonkeyPatch()
    mp.setattr(layers, "bn_train", record)
    mp.setattr(layers, "uses_kernel", lambda conv, x: False)
    mp.setattr(layers, "max_pool_2x2", pool)
    mp.setattr(vgg_mod, "max_pool_2x2", pool)
    bf16 = torch.bfloat16
    try:
        with torch.no_grad():
            tile = torch.zeros((chip_smoke.BATCH, 3, chip_smoke.PATCH, chip_smoke.PATCH),
                               device="meta")
            Generator(3, compute_dtype=bf16).to("meta").train()(tile)
            Segmentor(3, compute_dtype=bf16).to("meta").train()(tile, tile)
            usss = collections.Counter(seen)
            seen.clear()
            side = chip_smoke.WSSS_SIZE
            sl = torch.zeros((chip_smoke.WSSS_BATCH, 3, side, side), device="meta")
            Discriminator(3, compute_dtype=bf16).to("meta").train()(sl, sl)
            wsss = collections.Counter(seen)
    finally:
        mp.undo()
    return usss, wsss


def test_bn_inputs_are_the_training_steps(bn_inputs):
    usss, wsss = bn_inputs
    # 29 BNs in a joint step (G's 13 at N = 10, S's 16 on the stacked pair),
    # D's three on the stacked 15 pairs
    assert sum(usss.values()) == 29 and len(usss) == 13
    assert usss[(10, 220, 220, 64)] == 11 and usss[(20, 220, 220, 64)] == 2
    assert sorted(wsss) == [(30, 13, 13, 512), (30, 25, 25, 256), (30, 50, 50, 128)]


def _edge_shapes():
    shapes = [(1, 1, 1, c) for c in (8, 16, 64, 512, 1024)]        # one row
    shapes += [(1, 3, 5, c) for c in (8, 24, 64, 96, 1024)]        # fewer rows than a block's share
    shapes += [(2, 9, 9, c) for c in (8, 32, 40, 128, 256, 1000, 1024)]
    shapes += [(40, 220, 220, 64), (3, 7, 5, 2048)]
    return shapes


def _check_plan(shape, itemsize, sms, inputs, nstat):
    rows, c = int(np.prod(shape[:-1])), shape[-1]
    vec = 16 // itemsize
    if c % vec:
        return None
    plan = cs_mod.reduction_plan(rows, c, itemsize, sms, inputs, nstat)
    groups = c // vec
    # channel tiles: a power of two of vectors, at most MAX_CTILE, covering
    # the channels with the last tile not empty
    assert plan.ctile & (plan.ctile - 1) == 0
    assert plan.ctile <= min(groups, cs_mod.MAX_CTILE)
    assert (plan.ctiles - 1) * plan.ctile < groups <= plan.ctiles * plan.ctile
    assert plan.ctiles <= MAX_TICKETS
    assert plan.row_lanes * plan.ctile == cs_mod.THREADS
    # blocks: at least one, at most the resident cap over all tiles
    cap = max(1, cs_mod.BLOCKS_PER_SM * sms // plan.ctiles)
    assert 1 <= plan.blocks <= min(cap, rows)
    # the kernel's row ranges: block i sums [i * rpb, min(R, (i + 1) * rpb))
    covered = np.zeros(rows, np.int64)
    starts = []
    for i in range(plan.blocks):
        lo, hi = i * plan.rows_per_block, min(rows, (i + 1) * plan.rows_per_block)
        assert lo < hi, "an empty block"
        covered[lo:hi] += 1
        starts.append(lo)
    assert (covered == 1).all()
    assert starts == sorted(starts) and starts[0] == 0
    # a block reads about BLOCK_BYTES unless the cap or the rows stop it
    if plan.blocks < min(cap, rows):
        assert plan.rows_per_block * plan.ctile * 16 * inputs <= 2 * cs_mod.BLOCK_BYTES
    assert plan.partial == plan.ctiles * plan.blocks * nstat * plan.ctile * vec
    return plan


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
def test_reduction_plan_covers_every_row_once(bn_inputs, itemsize, sms):
    usss, wsss = bn_inputs
    for shape in list(usss) + list(wsss) + _edge_shapes():
        for inputs, nstat in ((1, 1), (1, 2), (2, 2)):  # mode 0, mode 1, the pair
            _check_plan(shape, itemsize, sms, inputs, nstat)


def test_reduction_plan_sizes_the_grid_to_the_input():
    """On an H100 SXM: the largest BN input fills every SM, a 1 MB input
    runs on a handful of blocks, the wide layers on one block per tile."""
    big = cs_mod.reduction_plan(20 * 220 * 220, 64, 2, 132)
    assert (big.blocks, big.ctiles) == (132, 1)
    small = cs_mod.reduction_plan(1 << 13, 64, 2, 132)  # 1 MB of bf16
    assert small.ctiles == 1 and 16 <= small.blocks <= 64
    wide = cs_mod.reduction_plan(30 * 13 * 13, 512, 2, 132)
    assert wide.ctiles == 8 and wide.blocks * wide.ctiles <= 132


def _finish(partial, runs, acc_dtype):
    """The kernels' finish over the rows of ``partial`` (blocks x n), as the
    last block computes it: ``runs`` threads a column, each a contiguous
    run of rows added in order, then the runs added in order."""
    blocks, n = partial.shape
    out = np.zeros(n, acc_dtype)
    for col in range(n):
        total = None
        for r in range(runs):
            acc = acc_dtype(0)
            for b in range(r * blocks // runs, (r + 1) * blocks // runs):
                acc = acc_dtype(acc + acc_dtype(partial[b, col]))
            total = acc if total is None else acc_dtype(total + acc)
        out[col] = total
    return out


def _launch_model(partials, order, counter, runs, acc_dtype):
    """One launch: blocks arrive in ``order``, each writes its row at its
    own index and draws a ticket; the one that draws the last ticket
    finishes and sets the counter back to 0."""
    blocks = partials.shape[0]
    workspace = np.full_like(partials, np.nan)
    result = None
    for b in order:
        workspace[b] = partials[b]
        ticket = counter[0]
        counter[0] += 1
        if ticket == blocks - 1:
            assert not np.isnan(workspace).any()  # every row written before the finish
            result = _finish(workspace, runs, acc_dtype)
            counter[0] = 0
    return result


@pytest.mark.parametrize("kind,blocks,n", [
    ("channel_sums", 132, 128),   # (20, 220, 220, 64) mode 1 on 132 SMs
    ("channel_sums", 7, 128),     # (20, 13, 13, 512): one 64-channel tile
    ("channel_sums", 1, 8),
    ("fused_ssim", 189, 6),       # the 220^2 level: 189 tiles, 3 channels x 2 stats
    ("fused_ssim", 4, 6),         # the 14^2 level
])
def test_last_ticket_finish_does_not_depend_on_arrival_order(kind, blocks, n):
    """channel_sums: f32 rows, the kernel's threads over columns of four
    floats; fused_ssim: f32 tile partials of one image added in f64 by 256
    threads."""
    rng = np.random.default_rng(blocks * 1000 + n)
    if kind == "channel_sums":
        runs, acc = min(cs_mod.THREADS // (n // 4), blocks), np.float32
        partials = (rng.normal(size=(blocks, n)) * 1e3).astype(np.float32)
    else:
        runs, acc = min(256 // n, blocks), np.float64
        partials = (rng.uniform(0, 1, size=(blocks, n))
                    * 10.0 ** rng.uniform(-12, 12, size=(blocks, n))).astype(np.float32)
    want = _finish(partials, runs, acc)  # the rows in block-index order
    counter = [0]
    for _ in range(20):
        got = _launch_model(partials, rng.permutation(blocks), counter, runs, acc)
        assert counter == [0]  # left at 0 for the next launch on the stream
        assert np.array_equal(got, want)
    if blocks > 8:  # adding in arrival order would not be repeatable
        arrival = [np.add.accumulate(partials[rng.permutation(blocks)].astype(acc), axis=0)[-1]
                   for _ in range(20)]
        assert any(not np.array_equal(a, arrival[0]) for a in arrival[1:])


# (N, H, W) of the five MS-SSIM levels of a step, and edge shapes
SSIM_SHAPES = [(10, hw, hw) for hw in (220, 110, 55, 28, 14)] + [
    (10, 11, 11), (2, 12, 12), (3, 23, 17), (2, 221, 221), (1, 11, 200), (1, 200, 11)]


def _tile_extents(plan, h, w, k):
    """Each tile in launch order as csrc/fused_ssim.cu cuts it: (first valid
    row, first valid column, valid rows, valid columns); it stages the input
    from its first valid position on, k - 1 rows and columns more."""
    vh, vw = h - k + 1, w - k + 1
    for i in range(plan.tiles_y * plan.tiles_x):
        oy0, ox0 = (i // plan.tiles_x) * plan.th, (i % plan.tiles_x) * plan.tw
        yield oy0, ox0, min(plan.th, vh - oy0), min(plan.tw, vw - ox0)


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("n,h,w", SSIM_SHAPES)
def test_ssim_tiles_cover_every_valid_position_once(n, h, w, sms):
    k = 11
    plan = ssim_mod.tile_plan(n, h, w, k, sms)
    assert 1 <= plan.th <= 8 and 1 <= plan.tw <= ssim_mod.TILE_W
    vh, vw = h - k + 1, w - k + 1
    covered = np.zeros((vh, vw), np.int64)
    tiles = list(_tile_extents(plan, h, w, k))
    assert len(tiles) == plan.tiles_y * plan.tiles_x
    for oy0, ox0, th, tw in tiles:
        assert 1 <= th <= plan.th and 1 <= tw <= plan.tw
        covered[oy0:oy0 + th, ox0:ox0 + tw] += 1
        # the staged region: th + k - 1 rows and tw + k - 1 columns from the
        # tile's first valid position, inside the input
        assert 0 <= oy0 and oy0 + th + k - 1 <= h
        assert 0 <= ox0 and ox0 + tw + k - 1 <= w
    assert (covered == 1).all()
    # as tall as possible while the launch keeps a block per SM
    if plan.th < ssim_mod.TILE_HEIGHTS[0]:
        taller = ssim_mod.TILE_HEIGHTS[ssim_mod.TILE_HEIGHTS.index(plan.th) - 1]
        assert n * plan.tiles_x * -(-vh // taller) < sms
    if plan.th > 1:
        assert n * plan.tiles_y * plan.tiles_x >= sms


def test_ssim_small_levels_spread_over_the_card():
    """The 28^2 and 14^2 levels of a step (N = 10) on an H100 SXM: more
    than one block per image, more blocks than the 30 planes."""
    blocks = {hw: 10 * p.tiles_y * p.tiles_x
              for hw, p in ((hw, ssim_mod.tile_plan(10, hw, hw, 11, 132)) for hw in (28, 14))}
    assert blocks == {28: 180, 14: 40}


@pytest.mark.parametrize("need", [1, 10, 1024, 1025, 1100, 4096, 65535])
def test_ticket_arrays_grow_to_the_call(need):
    """A stream's counter array starts at MAX_TICKETS and is replaced, zeroed,
    by a power-of-two one when a call needs more counters (fused_ssim: one
    per image), and kept as it is for every smaller call after."""
    from fcdgan_tpu_torch.ops.tickets import counter_size, counters

    made = []

    def zeros(size):
        made.append(size)
        return torch.zeros(size, dtype=torch.int32)

    table = {}
    first = counters(table, ("dev", "stream"), MAX_TICKETS, zeros)
    assert made == [MAX_TICKETS] and first.numel() == MAX_TICKETS
    got = counters(table, ("dev", "stream"), need, zeros)
    want = max(MAX_TICKETS, 1 << (need - 1).bit_length())
    assert got.numel() == want >= need and counter_size(MAX_TICKETS, need) == want
    assert got.numel() < 2 * need or need <= MAX_TICKETS
    assert made == ([MAX_TICKETS] if need <= MAX_TICKETS else [MAX_TICKETS, want])
    assert not got.any()
    for smaller in (1, need, want):
        assert counters(table, ("dev", "stream"), smaller, zeros) is got
    assert counters(table, ("dev", "other stream"), 1, zeros) is not got
    assert len(made) == (2 if need <= MAX_TICKETS else 3)
