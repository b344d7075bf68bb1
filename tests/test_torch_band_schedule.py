"""The band kernels' schedule on the CPU: their reach (which shapes the band
variants take, in how few bands), pinned against a table; each launch's
threads, shared memory and band count; the split of a tile over threads;
and B2's two roles of warps, the conv warps and the dK warps with their
work items.  The kernels run on the card (tests/test_torch_cuda_kernels.py)."""

import pytest

from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi

# (H, W, C, fewest bands of B1, of B2; None: the wide variant).  B1's column
# is what its gate gave before the bands traded edge rows through device
# memory.  B2's is what its own layout needs (`bwd_smem_bytes`), which fits
# wherever the layout before it did: at most as many bands (64x40x4 and
# 2x825x1 take one band, not two), and the band variant takes the shapes
# of the last six rows, which ran on the wide one.
REACH = [
    (32, 32, 1, 1, 1), (32, 32, 3, 1, 1), (32, 32, 4, 1, 1), (32, 32, 8, 1, 1),
    (32, 32, 13, 1, 2), (32, 32, 16, 1, 2), (32, 32, 21, 2, 4), (32, 32, 22, 2, 4),
    (32, 32, 32, 2, 4), (32, 32, 38, 4, 8), (32, 32, 39, 4, 8), (32, 32, 48, 4, 8),
    (32, 32, 56, 8, 16), (32, 32, 57, 8, None), (32, 32, 60, 8, None), (32, 32, 64, 16, None),
    (32, 32, 65, None, None), (32, 32, 72, None, None), (32, 32, 100, None, None),
    (32, 32, 128, None, None), (28, 28, 16, 1, 2), (28, 28, 64, 16, None), (64, 64, 4, 1, 2),
    (64, 64, 8, 2, 4), (64, 64, 16, 4, 8), (64, 64, 32, 8, 16), (64, 64, 48, None, None),
    (48, 48, 8, 1, 2), (64, 40, 4, 1, 1), (16, 16, 6, 1, 1), (16, 16, 64, 4, 8), (13, 9, 8, 1, 1),
    (9, 7, 8, 1, 1), (3, 5, 6, 1, 1), (1, 1, 76, 1, 1), (1, 1, 100, None, None),
    (8, 8, 128, None, None), (8, 8, 96, None, None), (1, 4096, 1, None, None),
    (2, 825, 1, 1, 1), (4, 1024, 1, 2, 4), (4096, 1, 8, 16, None), (7, 9, 40, 1, 1),
    (81, 45, 32, 8, 16), (3, 85, 36, 1, 2), (1, 88, 44, 1, 1), (5, 124, 28, 2, 4),
    (129, 23, 40, 8, 16), (1, 325, 16, 1, 1),
]
BATCHES = (1, 7, 32, 256)


@pytest.mark.parametrize("height,width,channels,fwd,bwd", REACH,
                         ids=[f"{h}x{w}x{c}" for h, w, c, _, _ in REACH])
def test_the_reach_is_pinned(height, width, channels, fwd, bwd):
    """Each shape takes the variant and the fewest bands of the table."""
    assert fi.min_bands(height, width, channels, fi.state_smem_bytes) == fwd
    assert fi.min_bands(height, width, channels, fi.bwd_smem_bytes) == bwd
    for backward, fewest in ((False, fwd), (True, bwd)):
        assert fi.kernel_variant((1, height, width, channels), backward) == (
            "wide" if fewest is None else "band")


@pytest.mark.parametrize("height,width,channels,fwd,bwd", REACH,
                         ids=[f"{h}x{w}x{c}" for h, w, c, _, _ in REACH])
def test_band_launches_fit(height, width, channels, fwd, bwd):
    """Where a shape takes a band variant, every batch's plan fits: threads a
    whole number of warps <= 512, shared memory <= 232,448 bytes, at most
    32 bands, never fewer than the fewest that fit."""
    for batch in BATCHES:
        shape = (batch, height, width, channels)
        for backward, fewest in ((False, fwd), (True, bwd)):
            if fewest is None:
                continue
            plan = fi.launch_plan(shape, backward)
            assert plan["variant"] == "band"
            assert fewest <= plan["bands"] <= fi.PLAN_BANDS and plan["bands"] <= height
            assert plan["blocks"] == batch * plan["bands"]
            assert 32 <= plan["threads"] <= 512 and plan["threads"] % 32 == 0
            assert 0 < plan["smem_bytes"] <= fi.SMEM_LIMIT_BYTES
            split = fi.kernel_split(height, width, channels, plan["bands"])
            assert split in (1, 2)
            threads = fi.band_threads(height, width, channels, plan["bands"], split)
            if not backward:
                assert plan["threads"] == threads
                continue
            # B2: the conv warps, then the dK warps beside them.
            conv, dk, chunks = fi.bwd_roles(height, width, channels, plan["bands"], split)
            assert plan["threads"] == conv + dk
            assert (plan["conv_threads"], plan["dk_warps"], plan["row_chunks"]) == (
                conv, dk // 32, chunks)
            assert conv % 32 == 0 and dk % 32 == 0 and dk >= 32
            assert conv == threads or conv <= 256


@pytest.mark.parametrize("height,width,channels,fwd,bwd", REACH,
                         ids=[f"{h}x{w}x{c}" for h, w, c, _, _ in REACH])
def test_dk_items_cover_the_band(height, width, channels, fwd, bwd):
    """B2's dK pass at every band count it may run in, on the dK warps: row
    chunks a power of two <= 32 and <= the tallest band, items in whole
    chunk groups a warp, every item run once on the dK warps (as
    ``weight_grads`` hands them out), no round left empty, the block at most
    512 threads."""
    if bwd is None:
        return
    for bands in (n for n in (1, 2, 4, 8, 16, 32) if bwd <= n <= height):
        padded, _, rows, _ = fi._band_geometry(height, width, channels, bands)
        for split in (1, 2):
            conv, threads, _ = fi.bwd_roles(height, width, channels, bands, split)
            assert conv + threads <= 512
            chunks, items, per_warp, rounds = fi.dk_items(height, width, channels, bands, split)
            assert chunks & (chunks - 1) == 0 and chunks <= min(32, rows)
            assert items == 3 * (padded // 4) ** 2 * chunks
            assert per_warp % chunks == 0 and per_warp <= 32
            warps = threads // 32
            assert rounds * warps * per_warp >= items > (rounds - 1) * warps * per_warp
            ran = [r + w * per_warp + lane for r in range(0, items, warps * per_warp)
                   for w in range(warps) for lane in range(per_warp)
                   if r + w * per_warp + lane < items]
            assert sorted(ran) == list(range(items))
            # A chunk group's lanes sit in one warp (its shuffles).
            assert all((r + w * per_warp) % chunks == 0
                       for r in range(0, items, warps * per_warp) for w in range(warps))
            if chunks > 1:  # the chunks fill the dK warps
                assert items <= threads


def test_every_dk_lane_has_an_item_at_the_training_shape():
    """Batch 32 at 32x32x16, 4 bands of 8 rows: 8 conv warps (256 threads,
    one a 4x4 tile) and 3 dK warps, one a scheduler on three of the four,
    whose 96 items (R = 2) fill every lane."""
    assert fi.bwd_roles(32, 32, 16, 4, 1) == (256, 96, 2)
    assert fi.dk_items(32, 32, 16, 4, 1) == (2, 96, 32, 1)
    plan = fi.launch_plan((32, 32, 32, 16), backward=True)
    assert (plan["threads"], plan["conv_threads"], plan["dk_warps"]) == (352, 256, 3)


# B2's band counts at each shape of REACH and batch of BATCHES (None: the
# wide variant), as they were before its reverse sweep ran in two roles:
# the roles change no band count or variant.
BWD_BANDS = {
    (32, 32, 1): (32, 16, 4, 1), (32, 32, 3): (32, 16, 4, 1), (32, 32, 4): (32, 16, 4, 1),
    (32, 32, 8): (32, 16, 4, 1), (32, 32, 13): (32, 16, 4, 2), (32, 32, 16): (32, 16, 4, 2),
    (32, 32, 21): (32, 16, 4, 4), (32, 32, 22): (32, 16, 4, 4), (32, 32, 32): (32, 16, 4, 4),
    (32, 32, 38): (32, 16, 8, 8), (32, 32, 39): (32, 16, 8, 8), (32, 32, 48): (32, 16, 8, 8),
    (32, 32, 56): (32, 16, 16, 16), (32, 32, 57): None, (32, 32, 60): None, (32, 32, 64): None,
    (32, 32, 65): None, (32, 32, 72): None, (32, 32, 100): None, (32, 32, 128): None,
    (28, 28, 16): (16, 16, 4, 2), (28, 28, 64): None, (64, 64, 4): (32, 16, 4, 2),
    (64, 64, 8): (32, 16, 4, 4), (64, 64, 16): (32, 16, 8, 8), (64, 64, 32): (32, 16, 16, 16),
    (64, 64, 48): None, (48, 48, 8): (32, 16, 4, 2), (64, 40, 4): (32, 16, 4, 1),
    (16, 16, 6): (16, 16, 4, 1), (16, 16, 64): (16, 16, 8, 8), (13, 9, 8): (8, 8, 4, 1),
    (9, 7, 8): (8, 8, 4, 1), (3, 5, 6): (2, 2, 2, 1), (1, 1, 76): (1, 1, 1, 1),
    (1, 1, 100): None, (8, 8, 128): None, (8, 8, 96): None, (1, 4096, 1): None,
    (2, 825, 1): (2, 2, 2, 1), (4, 1024, 1): (4, 4, 4, 4), (4096, 1, 8): None,
    (7, 9, 40): (4, 4, 4, 1), (81, 45, 32): (32, 16, 16, 16), (3, 85, 36): (2, 2, 2, 2),
    (1, 88, 44): (1, 1, 1, 1), (5, 124, 28): (4, 4, 4, 4), (129, 23, 40): (32, 16, 16, 16),
    (1, 325, 16): (1, 1, 1, 1),
}


@pytest.mark.parametrize("height,width,channels,fwd,bwd", REACH,
                         ids=[f"{h}x{w}x{c}" for h, w, c, _, _ in REACH])
def test_backward_bands_and_variant_are_pinned(height, width, channels, fwd, bwd):
    """B2's variant and band count at every batch, as `BWD_BANDS` has them."""
    want = BWD_BANDS[(height, width, channels)]
    for i, batch in enumerate(BATCHES):
        shape = (batch, height, width, channels)
        assert fi.kernel_variant(shape, backward=True) == ("wide" if want is None else "band")
        assert fi.kernel_bands(shape, backward=True) == (None if want is None else want[i])
        if want is not None:
            assert fi.launch_plan(shape, backward=True)["bands"] == want[i]


def test_band_plan_and_split_at_the_main_shapes():
    """One block an SM: batch 32 in 4 bands of 8 rows, one thread a 4x4
    tile; batch 1 in 32 bands of one row, two threads a tile (a tile's
    inputs in two halves); B2's block adds its dK warps."""
    for backward in (False, True):
        assert fi.kernel_bands((32, 32, 32, 16), backward) == 4
        assert fi.kernel_split(32, 32, 16, 4) == 1
        assert fi.launch_plan((32, 32, 32, 16), backward)["threads"] == (352 if backward else 256)
        assert fi.kernel_bands((1, 32, 32, 16), backward) == 32
        assert fi.kernel_split(32, 32, 16, 32) == 2
        assert fi.launch_plan((1, 32, 32, 16), backward)["threads"] == (128 if backward else 64)
        assert fi.kernel_bands((32, 28, 28, 16), backward) == 4      # MNIST: 7 rows a band
        assert fi.kernel_split(28, 28, 16, 4) == 1
        assert fi.kernel_bands((32, 32, 32, 8), backward) == 4
        assert fi.kernel_split(32, 32, 8, 4) == 1
        assert fi.launch_plan((32, 32, 32, 8), backward)["threads"] == (224 if backward else 128)
    # B2's layout at the training shape: y_l and K^T double buffered.
    assert fi.bwd_layout(32, 32, 16, 4)[1] == (2, 2, 2)


def test_edge_exchange_scratch():
    """The edge rows a launch trades, in one buffer: two parities of each
    band's first and last padded rows, then one step counter a band (which
    the launch zeroes); nothing where one band an image trades nothing."""
    import torch

    x = torch.zeros(3, 32, 32, 16)
    scratch, edges, steps = fi._edge_exchange(x, 3, 32, 32, 16, 4)
    row = fi._band_geometry(32, 32, 16, 4)[3]
    assert scratch.numel() == 2 * 12 * 2 * row + 12 and row % 8 == 0
    assert edges == scratch.data_ptr() and steps == edges + 4 * 2 * 12 * 2 * row
    assert steps % 16 == 0
    assert fi._edge_exchange(x, 3, 32, 32, 16, 1) == (None, 0, 0)
