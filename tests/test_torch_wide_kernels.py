"""B1 and B2 over the JAX kernel gate's whole reach (C <= 128, H*W <= 4096):
every shape of the reach gets a kernel variant and a launch plan that fits
the card; the plain versions, which the wide variants are held against on
the card, agree with the JAX package's Pallas kernels (interpret mode on
the CPU, as tests/test_pallas.py runs them) at the widths the band variant
declines; and the model routes the ``use_pallas`` stacks at those widths to
the kernels.  The wide variants themselves run on the card
(tests/test_torch_cuda_kernels.py and chip_smoke.py)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from differential_equations_resnet_tpu.ops.antisymmetric import materialize_3x3
from differential_equations_resnet_tpu.ops.pallas import fused_integrator as jax_fi
from differential_equations_resnet_tpu_torch.models import cifar10_single_block_config
from differential_equations_resnet_tpu_torch.models import single_block_resnet as sbr
from differential_equations_resnet_tpu_torch.models.blocks import ConvParams
from differential_equations_resnet_tpu_torch.ops.antisymmetric import materialize_3x3_stacked
from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi

from torch_parity import assert_close, euler_case

CHANNELS = [1, 17, 33, 56, 57, 64, 65, 72, 96, 127, 128]
IMAGES = [(1, 1), (7, 9), (8, 8), (16, 16), (28, 28), (32, 32), (48, 48), (64, 64)]


@pytest.mark.parametrize("image", IMAGES, ids=[f"{h}x{w}" for h, w in IMAGES])
@pytest.mark.parametrize("channels", CHANNELS)
def test_every_shape_of_the_reach_has_a_plan_that_fits(channels, image):
    """Both kernels take every (H, W, C) of the reach at batch 1, 32 and 256:
    a variant, and a launch plan whose block fits one block's 232,448 bytes
    of shared memory and 512 threads; the band variant where its band fits,
    the wide one elsewhere, and both where the JAX gate says so."""
    height, width = image
    for batch in (1, 32, 256):
        shape = (batch, height, width, channels)
        x = torch.zeros(shape)
        assert fi.in_reference_reach(shape) and fi._declined(x) == ""
        for backward, smem in ((False, fi.state_smem_bytes), (True, fi.bwd_smem_bytes)):
            plan = fi.launch_plan(shape, backward)
            assert plan["variant"] == fi.kernel_variant(shape, backward)
            assert (plan["variant"] == "band") == (
                fi.min_bands(height, width, channels, smem) is not None)
            assert 0 < plan["smem_bytes"] <= fi.SMEM_LIMIT_BYTES
            assert 32 <= plan["threads"] <= 512 and plan["threads"] % 32 == 0
            if plan["variant"] == "band":
                assert plan["blocks"] == batch * plan["bands"]
                assert plan["smem_bytes"] == smem(height, width, channels, plan["bands"])
            else:
                rows, cols = plan["conv_grid"]
                assert rows * fi.WIDE_TILE_ROWS >= batch * height * width > (
                    rows - 1) * fi.WIDE_TILE_ROWS
                assert cols == 1  # one tile holds every output channel
                if backward:
                    splits, chunk = plan["splits"], plan["chunk"]
                    assert splits * chunk >= batch * height * width > (splits - 1) * chunk
                    assert chunk % fi.WIDE_STAGE == 0
                    padded = -(-channels // 4) * 4
                    cols = fi._wide_cols(padded)
                    assert plan["dk_grid"][1] == splits
                    assert plan["dk_grid"][0] * fi.WIDE_DK_ROWS[cols] >= 9 * padded
                    assert (np.prod(plan["dk_grid"]) <= fi.WIDE_DK_BLOCKS_PER_SM[cols] * fi.SM_COUNT
                            or splits == 1)


def test_the_wide_variant_takes_what_the_band_variant_declined():
    """The widths the band kernels declined (at 32x32 the band B1 took
    C <= 64 and B2 C <= 56) now take the wide variant, and the gates are the
    JAX gate's: C = 129 and H*W = 4160 are still declined."""
    for shape, fwd, bwd in (((32, 32, 32, 64), "band", "wide"), ((32, 32, 32, 65), "wide", "wide"),
                            ((32, 32, 32, 56), "band", "band"), ((1, 64, 64, 44), "band", "wide"),
                            ((1, 64, 64, 32), "band", "band"),
                            ((1, 64, 64, 48), "wide", "wide"), ((2, 8, 8, 76), "band", "wide"),
                            ((2, 8, 8, 128), "wide", "wide")):
        assert (fi.kernel_variant(shape), fi.kernel_variant(shape, True)) == (fwd, bwd), shape
    blocks = ConvParams(torch.zeros(1, 3, 3, 4, 4), torch.zeros(1, 4))
    for shape in ((1, 32, 32, 128), (1, 64, 64, 128), (3, 1, 4096, 96)):
        assert fi.fused_euler_eligible(torch.zeros(shape), blocks)
    for shape in ((1, 2, 2, 129), (1, 65, 64, 4), (1, 1, 4160, 8)):
        assert not fi.fused_euler_eligible(torch.zeros(shape), blocks)
        assert not fi.in_reference_reach(shape)


def test_the_dk_split_is_fixed_by_the_shape():
    """The wide B2 sums dK over the same pixel chunks whatever the call (so
    two calls are bit-identical on the card), at most one wave of blocks."""
    for shape in ((32, 32, 32, 64), (32, 32, 32, 128), (8, 64, 64, 128), (2, 8, 8, 72)):
        assert fi.wide_splits(shape) == fi.wide_splits(shape)
        assert fi.wide_plan(shape, backward=True)["splits"] == fi.wide_splits(shape)[0]
    assert fi.wide_splits((32, 32, 32, 128)) == (29, 1136)
    assert fi.wide_splits((32, 32, 32, 64)) == (57, 576)
    # The conv's block is the larger: the ring stages of its (128 x (steps +
    # 4)) patch and (steps x 64 or 128) kernel tiles, and 3 x 130 x 4 mask
    # words: 2 stages of a tap's 64 steps at 48 < Cp <= 64, else 4 of 16;
    # two blocks fit an SM's 228 KB (and four of the dK pass's at Cp <= 64:
    # 4 stages of (16 x 64) + (16 x 64) floats and 16 x 2 words).
    assert fi.wide_smem_bytes(64) == 4 * (2 * (128 * 68 + 64 * 64) + 3 * 130 * 4) == 108640
    assert fi.wide_smem_bytes(48) == 4 * (4 * (128 * 20 + 16 * 64) + 3 * 130 * 4) == 63584
    assert fi.wide_smem_bytes(128) == 4 * (4 * (128 * 20 + 16 * 128) + 3 * 130 * 4) == 79968
    assert 2 * (fi.wide_smem_bytes(64) + 1024) <= 233472
    assert 2 * (fi.wide_smem_bytes(128) + 1024) <= 233472
    assert 4 * (4 * 4 * (16 * 64 + 16 * 64 + 32) + 1024) <= 233472


@pytest.mark.parametrize("channels,tiles,cols,waste", [
    (64, 9, 64, 0), (68, 5, 128, 28), (100, 8, 128, 124), (128, 9, 128, 0)])
def test_the_wide_tiles_at_the_widths_that_matter(channels, tiles, cols, waste):
    """The dK pass's row tiles over the 9*Cp (tap, input) rows: 64 rows up
    to Cp = 64 and 128 past it, so exact at C = 64 and 128 (rows ``waste``
    of the last tile past 9*Cp elsewhere; the 128-row tiles of the design
    before the ring left 64 rows idle at C = 64).  One column tile holds
    every output channel (64 up to Cp = 64, else 128), and the conv's
    reduction runs 9 taps x ceil(Cp / 16) chunks, zero-filled past Cp."""
    padded = -(-channels // 4) * 4
    plan = fi.wide_plan((32, 32, 32, channels), backward=True)
    assert plan["dk_grid"][0] == tiles
    assert tiles * fi.WIDE_DK_ROWS[cols] - 9 * padded == waste
    assert fi._wide_cols(padded) == cols and plan["conv_grid"] == (256, 1)
    assert plan["threads"] == {64: 256, 128: 128}[cols]
    assert plan["dk_threads"] == {64: 128, 128: 256}[cols]


@pytest.mark.parametrize("channels,steps", [
    (1, 16), (33, 16), (44, 16), (48, 16), (49, 64), (52, 64), (57, 64), (64, 64), (65, 16),
    (100, 16), (128, 16)])
def test_the_wide_conv_takes_a_tap_a_stage_where_its_channels_fill_it(channels, steps):
    """The conv's stage is a whole tap (64 reduction steps, a ring of 2)
    where Cp > 48 and Cp <= 64, else 16 steps (a ring of 4): a stage never
    zero-fills more channels than the chunks of 16 do (at Cp = 48 a
    64-step stage would compute a third more, and took the conv from 0.42
    to 0.55 ms on an H100, PERF.md §6)."""
    padded = -(-channels // 4) * 4
    stage = fi.wide_conv_stage(padded)
    assert stage == (steps, 2 if steps == 64 else 4)
    assert -(-padded // steps) * steps == -(-padded // 16) * 16 or steps == 16
    assert fi.wide_plan((8, 32, 32, channels))["conv_stage"] == stage


def _stage_ffmas(kernel, padded):
    """A thread's FFMAs between two barriers of ``kernel``'s ring at Cp =
    ``padded`` (its outputs a thread times a stage's reduction steps), its
    threads and the blocks an SM holds by shared memory (1 KB reserved a
    block), from the mirror's constants."""
    cols = fi._wide_cols(padded)
    if kernel == "conv":
        threads, steps = fi.WIDE_THREADS[cols], fi.wide_conv_stage(padded)[0]
        outputs, smem = fi.WIDE_TILE_ROWS * cols // threads, fi.wide_smem_bytes(padded)
    else:
        threads, steps = fi.WIDE_DK_THREADS[cols], fi.WIDE_STAGE
        outputs = fi.WIDE_DK_ROWS[cols] * cols // threads
        smem = 4 * fi.WIDE_STAGES * fi.WIDE_STAGE * (fi.WIDE_DK_ROWS[cols] + cols + cols // 32)
    return outputs * steps, threads, 233472 // (smem + 1024)


@pytest.mark.parametrize("kernel,padded,ffmas", [
    ("conv", 64, 2048), ("conv", 128, 2048), ("conv", 48, 512),
    ("dk", 64, 512), ("dk", 128, 1024)])
def test_the_ffmas_a_wide_thread_does_between_barriers(kernel, padded, ffmas):
    """A thread of the wide conv does 2,048 FFMAs between two barriers at Cp
    = 64 (4 pixels x 8 channels x a tap's 64 steps) and at Cp = 128 (8 x 16
    x 16), 512 where a 64-step stage would zero-fill a quarter or more; the
    dK pass's 512 (4 rows x 8 channels x 16 pixels) or 1,024 (4 x 16 x 16):
    on an H100 its 2,048-FFMA stages (8 rows a thread on 64-thread blocks,
    or 32-pixel stages) were 8-33% slower (PERF.md §6).  Every block fits
    two an SM or more, the dK pass's the blocks its splits count on."""
    got, threads, blocks = _stage_ffmas(kernel, padded)
    assert got == ffmas and threads % 32 == 0 and blocks >= 2
    if kernel == "dk":
        blocks_per_sm = fi.WIDE_DK_BLOCKS_PER_SM[fi._wide_cols(padded)]
        assert blocks >= blocks_per_sm and threads * blocks_per_sm <= 2048


def jax_grads(case, h, w, matmul_dtype):
    """jax.grad of <y_L, w> through the Pallas custom VJP (interpret mode)."""
    (x_j, blocks_j), _ = case
    kernels_j = jax.vmap(lambda p: materialize_3x3(p, gamma=0.0))(blocks_j)
    loss = lambda x, k, b: jnp.vdot(jax_fi.fused_euler_dense(x, k, b, 0.125, matmul_dtype),
                                    jnp.asarray(w))
    with pltpu.force_tpu_interpret_mode():
        y = jax_fi.fused_euler_dense(x_j, kernels_j, blocks_j.bias, 0.125, matmul_dtype)
        grads = jax.grad(loss, argnums=(0, 1, 2))(x_j, kernels_j, blocks_j.bias)
    return y, grads


@pytest.mark.parametrize("matmul_dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("size", [4, 8])
@pytest.mark.parametrize("channels", [72, 128])
def test_plain_versions_match_pallas_at_the_wide_widths(channels, size, matmul_dtype):
    """The plain forward and backward (the wide variants' yardstick on the
    card) against the JAX Pallas kernels in interpret mode at C = 72 and
    128, 4x4 and 8x8, L = 2, in fp32 and bf16-operand mode: y, gx, gK and
    gb to 1e-5 (fp32 sums in another order; both round the same operands
    in bf16 mode)."""
    case = euler_case(batch=2, height=size, width=size, channels=channels, layers=2,
                      seed=channels + size)
    _, (x_t, blocks_t) = case
    w = np.random.default_rng(size).standard_normal(x_t.shape).astype(np.float32)
    want_y, want = jax_grads(case, 0.125, w, matmul_dtype)
    torch_dtype = torch.bfloat16 if matmul_dtype == jnp.bfloat16 else torch.float32
    leaves = [x_t.clone().requires_grad_(),
              materialize_3x3_stacked(blocks_t).detach().requires_grad_(),
              blocks_t.bias.clone().requires_grad_()]
    y = fi.fused_euler_dense(*leaves, 0.125, matmul_dtype=torch_dtype)
    assert_close(y, want_y, atol=1e-5, rtol=1e-5)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), leaves)
    for g, p in zip(got, want):
        assert_close(g, p, atol=1e-5, rtol=1e-5)


def stage_of(kernel_type, filters, **fields):
    """A 2-layer stage's config and dense stack, its leaves requiring
    gradients."""
    config = dataclasses.replace(
        cifar10_single_block_config(num_layers=2, num_filters=filters, kernel_type=kernel_type),
        **fields)
    blocks = sbr.init_single_block_resnet(config, torch.Generator().manual_seed(0))
    dense = sbr._dense_blocks(blocks["stages"][0]["blocks"], config)
    return config, ConvParams(*[t.detach().requires_grad_() for t in dense])


@pytest.mark.parametrize("filters", [64, 72, 128])
def test_use_pallas_stacks_at_the_wide_widths_are_routed_to_the_kernels(filters):
    """With use_pallas, the antisymmetric Euler stacks at 64, 72 and 128
    filters (which the band kernels declined in training) take the fused
    route, in training and in a forward, as the JAX package runs them on
    Pallas; bf16 compute, batch norm and C past the reach take the
    per-layer route."""
    config, dense = stage_of("antisymmetric", filters, use_pallas=True)
    x = torch.zeros(8, 32, 32, filters)
    assert sbr.jax_runs_pallas(config, x)
    assert sbr.identity_route(config, x, dense) == "fused"
    with torch.no_grad():
        assert sbr.identity_route(config, x, dense) == "fused"
    assert sbr.identity_route(config, x.to(torch.bfloat16), dense) == "per_layer"
    bn, bn_dense = stage_of("antisymmetric", filters, use_pallas=True, use_batch_norm=True)
    assert sbr.identity_route(bn, x, bn_dense) == "per_layer"
    past, past_dense = stage_of("antisymmetric", 132, use_pallas=True)
    assert sbr.identity_route(past, torch.zeros(8, 32, 32, 132), past_dense) == "per_layer"


@pytest.mark.parametrize("filters", [64, 72, 128])
def test_other_stacks_at_the_wide_widths_follow_the_wide_route(filters):
    """Without use_pallas (or with regular kernels) a stack whose shape needs
    a wide variant (B2's at every one of these widths, B1's too past 64)
    takes the fused route, with or without a gradient, as the JAX package's
    Pallas stacks do."""
    config, dense = stage_of("regular", filters)
    x = torch.zeros(8, 32, 32, filters)
    assert not sbr.jax_runs_pallas(config, x)
    assert fi.kernel_variant(x.shape, backward=True) == "wide"
    assert sbr.identity_route(config, x, dense) == "fused"
    with torch.no_grad():
        assert sbr.identity_route(config, x, dense) == "fused"
