"""Fused multi-layer forward-Euler integrator: the hand-written CUDA kernels
of its forward and backward, and their plain PyTorch versions.

Counterpart of `differential_equations_resnet_tpu/ops/pallas/fused_integrator.py`.
For NHWC fp32 x (B, H, W, C), dense HWIO kernels (L, 3, 3, C, C) and biases
(L, C) it computes

    y_0 = x,   y_{l+1} = y_l + h * relu(conv3x3_same(y_l, K_l) + b_l)

and, as the JAX custom VJP does, its gradient by recomputing the trajectory
from x: the autograd graph keeps only (x, kernels, biases), one state
whatever the depth.

The kernels take any dense 3x3 stack, so every kernel type runs on them:
`fused_euler_3x3` materializes packed antisymmetric parameters first; the
model passes its dense stack (regular kernels, or packed ones made dense)
to `fused_euler_dense` itself.

`fused_euler_dense` is the entry point.  On CPU tensors it runs the plain
versions (`reference_euler_dense`, `reference_euler_dense_bwd`); on CUDA
tensors it launches the forward kernel B1 and, in the backward, B2, or
raises: there is no fallback.  B1 is reached through a dispatcher op,
``deqres_torch::fused_euler_fwd`` (`fused_euler_fwd_op`, a
`torch.library` op: the plain version for CPU tensors, `_launch` for CUDA
ones, a shape-only fake for tracing), so that `torch.export`
records it as one node of a served program (`utils.serving`) and the
program launches it when it runs; B2 stays a call of its wrapper inside
`FusedEulerDense.backward`.  Both take every shape the JAX gate takes (a
4-D contiguous fp32 state with C <= 128 and H*W <= 4096, any batch:
`fused_euler_eligible`, `in_reference_reach`),
each in one of two variants chosen from the shape alone before anything is
launched (`kernel_variant`):

- "band" (``csrc/fused_euler_fwd.cu``, ``csrc/fused_euler_bwd.cu``): an
  image is n blocks, each holding a band of rows of the zero-padded state
  and a layer's kernel in shared memory for all L layers, trading edge rows
  with its neighbours through device memory after each step (`band_plan`
  chooses n).  It takes the shapes whose band fits one block's shared
  memory in some band count (`min_bands`): at 32x32, B1 C <= 64 and B2 C
  <= 56;
- "wide" (``csrc/fused_euler_wide.cu``), every other shape of the reach: the
  state stays in device memory between layers and each layer is a tiled
  implicit GEMM fed by cp.async (`wide_plan`): L launches for B1, 3L for
  B2.

Each call on the card reports itself, with its stack's shape, variant,
bands and the launches it made, to the record of hand-kernel calls
(`utils.tracing.STACKS`), the only count of the kernels' launches: a band
call makes one launch, or one for each group of images where the card
cannot hold every band of the batch at once; a wide call makes L (B1) or
3L (B2).  Under a CUDA-graph capture the kernel is recorded into the
graph, not launched, and the call goes into that graph's entries, which
each replay adds to the record's totals.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3Params,
    materialize_3x3_stacked,
)
from differential_equations_resnet_tpu_torch.ops.conv import (
    conv2d_same,
    relu_conv_vjp,
    round_operand,
)
from differential_equations_resnet_tpu_torch.ops.kernels import _build
from differential_equations_resnet_tpu_torch.utils.tracing import STACKS, StackEntry

# Dynamic shared memory one thread block may use on sm_90.
SMEM_LIMIT_BYTES = 232_448
# The JAX gate's own limits, kept: C <= 128 and H*W <= 64*64.
MAX_CHANNELS = 128
MAX_PIXELS = 64 * 64
# Streaming multiprocessors of an H100 SXM: the band plan's default.
SM_COUNT = 132
# Bands (blocks) an image: the plan fills SMs with up to 32, one block an SM;
# shapes whose band does not fit one block's shared memory otherwise may take
# up to 16 (`min_bands`).
PLAN_BANDS = 32
MAX_BANDS = 16

_MATMUL_DTYPES = (torch.float32, torch.bfloat16)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _col_off(column: int, padded_channels: int) -> int:
    """Floats from the start of a padded row to padded column ``column``:
    each group of four columns is followed by four floats of padding."""
    return column * padded_channels + (column // 4) * 4


def _band_geometry(height: int, width: int, channels: int, bands: int):
    """(Cp, floats of one padded band buffer, tallest band's rows, floats of
    a padded row) of the kernels' banded shared-memory layout, as
    ``csrc/euler_common.cuh::make_band`` computes them."""
    cp = _ceil(channels, 4) * 4
    base = _col_off(4 * _ceil(width, 4) + 2, cp)
    row = base + (8 - base % 32) % 32
    rows = _ceil(height, bands)
    return cp, (rows + 2) * row, rows, row


# Floats ahead of the buffers in a block's shared memory: the mbarriers of
# the bulk copies (B1: its two kernel buffers'; B2: also its y_l and K^T
# buffers').
FWD_HEADER_FLOATS = 4
BWD_HEADER_FLOATS = 12
# B2's reverse-sweep layouts, in order of preference: (y_l buffers, K^T
# buffers); two load a layer ahead.
BWD_LAYOUTS = ((2, 2), (2, 1), (1, 2), (1, 1))


def state_smem_bytes(height: int, width: int, channels: int, bands: int = 1) -> int:
    """Shared memory of one B1 block of an image in ``bands`` bands: two
    mbarriers, the band's zero-padded fp32 state twice (double buffered,
    halo rows included) and one or two layers' (9Cp, Cp) kernel and bias,
    two where they fit (the next layer's loads while this one computes)."""
    cp, band, _, _ = _band_geometry(height, width, channels, bands)
    for buffers in (2, 1):
        need = 4 * (FWD_HEADER_FLOATS + 2 * band + buffers * (9 * cp * cp + cp))
        if need <= SMEM_LIMIT_BYTES:
            break
    return need


def bwd_layout(height: int, width: int, channels: int, bands: int = 1):
    """(bytes, (kernel buffers, y_l buffers, K^T buffers)) of one B2 block:
    the first of `BWD_LAYOUTS` (with two forward kernel buffers, else one)
    whose larger phase fits, else the last tried.  B2 takes a shape in its
    band variant where this fits in some band count (`min_bands`).  The forward phase is B1's
    block with six mbarriers; the reverse sweep holds y_l, g_z twice, g of
    the band's pixels and K^T."""
    cp, band, rows, _ = _band_geometry(height, width, channels, bands)
    layer = 9 * cp * cp + cp
    for ny, nk in BWD_LAYOUTS:
        for nkb in (2, 1):
            forward = BWD_HEADER_FLOATS + 2 * band + nkb * layer
            reverse = (BWD_HEADER_FLOATS + (ny + 2) * band + rows * width * cp
                       + nk * 9 * cp * cp)
            need = 4 * max(forward, reverse)
            if need <= SMEM_LIMIT_BYTES:
                return need, (nkb, ny, nk)
    return need, (nkb, ny, nk)


def bwd_smem_bytes(height: int, width: int, channels: int, bands: int = 1) -> int:
    """Shared memory of one B2 block (`bwd_layout`)."""
    return bwd_layout(height, width, channels, bands)[0]


@functools.lru_cache(maxsize=1024)
def min_bands(height: int, width: int, channels: int, smem_bytes=state_smem_bytes):
    """The fewest bands (a power of two <= min(16, H)) whose block fits one
    block's shared memory, or None where no band count does."""
    bands = 1
    while bands <= min(MAX_BANDS, height):
        if smem_bytes(height, width, channels, bands) <= SMEM_LIMIT_BYTES:
            return bands
        bands *= 2
    return None


def band_plan(batch: int, height: int, fewest: int = 1, sms: int = SM_COUNT):
    """Rows of each band of an image: ((start, stop), ...), one band per
    block.

    The band count n is the largest power of two <= min(32, H) with
    ``batch * n <= sms`` (one block a streaming multiprocessor: on 132 SMs
    32 at batch 1-4, 16 at batch 5-8, 8 at batch 9-16, 4 at batch 17-33),
    and at least ``fewest`` (the fewest bands whose block fits in shared
    memory).  On an H100 at 32x32x16 both kernels ran fastest so: at batch
    32 in 4 bands (against 8, and 8 against 4 with clusters), at batch 1 in
    32 (PERF.md); a larger band spreads each layer's exchange over more
    work, a smaller one shortens the layer's serial chain where SMs are
    free.  Band r holds rows [r*H//n, (r+1)*H//n): every row once, heights
    differing by at most one."""
    bands = 1
    while 2 * bands <= min(PLAN_BANDS, height) and batch * 2 * bands <= sms:
        bands *= 2
    bands = max(bands, fewest)
    return tuple((r * height // bands, (r + 1) * height // bands) for r in range(bands))


def _declined(x: torch.Tensor) -> str:
    """Why the kernels cannot take ``x``, or "" where they can: what the JAX
    gate refuses (not a 4-D contiguous fp32 NHWC state, C > 128, H*W >
    4096), nothing more."""
    if x.dim() != 4:
        return f"x must be 4-D NHWC, got shape {tuple(x.shape)}"
    if x.dtype != torch.float32:
        return f"x must be float32, got {x.dtype}"
    if not x.is_contiguous():
        return "x must be contiguous NHWC"
    _, height, width, channels = x.shape
    if channels > MAX_CHANNELS:
        return f"C={channels} > {MAX_CHANNELS}"
    if height * width > MAX_PIXELS:
        return f"H*W={height * width} > {MAX_PIXELS}"
    return ""


def kernel_variant(x_shape, backward: bool = False) -> str:
    """The variant of B1 (or B2 with ``backward=True``) that runs a (B, H, W,
    C) state of the reach: "band" where a band of rows fits one block's
    shared memory in some band count (`min_bands` of `state_smem_bytes`,
    for B2 of `bwd_smem_bytes`), else "wide"."""
    _, height, width, channels = x_shape
    smem_bytes = bwd_smem_bytes if backward else state_smem_bytes
    return "band" if min_bands(height, width, channels, smem_bytes) is not None else "wide"


# The wide variants' tiles (``csrc/fused_euler_wide.cu``), by the column
# tile: 64 output channels where Cp <= 64, else 128 (one tile holds every
# channel).  The conv computes 128 pixels a block (256 threads of 4 pixels
# x 8 channels, or where Cp > 64 128 threads of 8 x 16); the dK pass a tile
# of (tap, input) rows (64 rows of 128 threads of 4 rows x 8 channels, four
# blocks an SM, where Cp <= 64; else 128 rows of 256 threads of 4 x 16, two
# an SM).  Each runs a ring of shared-memory stages filled by cp.async (the
# conv's `wide_conv_stage`; the dK pass's 4 stages of 16 pixels); the
# conv's patch stage keeps 4 floats of padding after each pixel's reduction
# steps, and beside the ring the relu-mask words of 3 rows of 130 pixels;
# the dK stage 16 pixels' mask words.  B1 launches once a layer; B2 once a
# layer in its recompute and twice in reverse (the dK pass, then the state
# cotangent's conv, which also sums the dK partials).
WIDE_THREADS = {64: 256, 128: 128}  # the conv's, by the column tile
WIDE_DK_ROWS = {64: 64, 128: 128}
WIDE_DK_THREADS = {64: 128, 128: 256}
WIDE_DK_BLOCKS_PER_SM = {64: 4, 128: 2}
WIDE_TILE_ROWS = 128
WIDE_STAGE = 16
WIDE_STAGES = 4
# The conv's stage where a tap's channels fill four chunks of 16 at Cp <= 64
# (48 < Cp <= 64): the whole tap, in a ring of 2.
WIDE_TAP_STAGE = 64
WIDE_TAP_STAGES = 2


def _wide_cols(padded: int) -> int:
    return 128 if padded > 64 else 64


def wide_conv_stage(padded: int) -> Tuple[int, int]:
    """(reduction steps a stage, stages in the ring) of the wide conv at Cp
    = ``padded`` channels: a whole tap in a ring of 2 where its channels
    fill four chunks of 16 at Cp <= 64, else 16 steps in a ring of 4.  A
    stage never holds more zero-filled channels than the 16-step chunks."""
    if 48 < padded <= 64:
        return WIDE_TAP_STAGE, WIDE_TAP_STAGES
    return WIDE_STAGE, WIDE_STAGES


def wide_smem_bytes(channels: int) -> int:
    """Dynamic shared memory of the largest wide block at C channels: the
    conv's (the ring stages of a (128, steps + 4) patch tile and a (steps,
    64 or 128) kernel tile, `wide_conv_stage`, and the relu-mask words of
    the pixels its taps reach: 3 rows of 130 pixels x 4 words) or the dK
    pass's (4 stages of a (16, 64 or 128 rows) patch tile, a (16, 64 or 128)
    g tile and 16 x 2 or 4 mask words), whichever is larger."""
    padded = _ceil(channels, 4) * 4
    cols = _wide_cols(padded)
    steps, stages = wide_conv_stage(padded)
    conv = (stages * (WIDE_TILE_ROWS * (steps + 4) + steps * cols)
            + 3 * (WIDE_TILE_ROWS + 2) * 4)
    dk = WIDE_STAGES * (WIDE_STAGE * WIDE_DK_ROWS[cols] + WIDE_STAGE * cols
                        + WIDE_STAGE * cols // 32)
    return 4 * max(conv, dk)


def wide_splits(x_shape, sms: int = SM_COUNT) -> Tuple[int, int]:
    """(S, chunk) of the wide B2's weight-gradient pass: its sum over the
    B*H*W pixels runs in S chunks of ``chunk`` pixels (a multiple of 16),
    one block each a (64- or 128-row, Cp) tile of the (9Cp, Cp) gradient, as
    many as the streaming multiprocessors hold at once (one wave), and the
    chunks' partials are summed in a fixed order.  Decided from the shape
    (and the default SM count) alone, so two calls sum in the same order."""
    batch, height, width, channels = x_shape
    padded = _ceil(channels, 4) * 4
    cols = _wide_cols(padded)
    pixels = max(1, batch * height * width)
    tiles = _ceil(9 * padded, WIDE_DK_ROWS[cols])
    splits = max(1, min(WIDE_DK_BLOCKS_PER_SM[cols] * sms // tiles, _ceil(pixels, 256)))
    chunk = _ceil(_ceil(pixels, splits), WIDE_STAGE) * WIDE_STAGE
    return _ceil(pixels, chunk), chunk


def wide_plan(x_shape, backward: bool = False) -> dict:
    """The wide variant's launches at a (B, H, W, C) state: the grid of a
    layer's conv (pixel tiles x channel tiles), its threads, (reduction
    steps a stage, stages) and shared memory a block, and in the backward
    the dK pass's grid, threads and its (S, chunk) split."""
    batch, height, width, channels = x_shape
    padded = _ceil(channels, 4) * 4
    cols = _wide_cols(padded)
    plan = {"variant": "wide", "threads": WIDE_THREADS[cols],
            "conv_stage": wide_conv_stage(padded), "smem_bytes": wide_smem_bytes(channels),
            "conv_grid": (_ceil(batch * height * width, WIDE_TILE_ROWS), _ceil(padded, cols))}
    if backward:
        splits, chunk = wide_splits(x_shape)
        plan.update(splits=splits, chunk=chunk, dk_threads=WIDE_DK_THREADS[cols],
                    dk_grid=(_ceil(9 * padded, WIDE_DK_ROWS[cols]), splits))
    return plan


def launch_plan(x_shape, backward: bool = False, sms: int = SM_COUNT) -> dict:
    """How B1 (or B2) runs a (B, H, W, C) state of the reach: the band
    variant's band count, threads and shared memory a block, or the wide
    variant's `wide_plan`."""
    batch, height, width, channels = x_shape
    if kernel_variant(x_shape, backward) == "wide":
        return wide_plan(x_shape, backward)
    bands = kernel_bands(x_shape, backward, sms)
    split = kernel_split(height, width, channels, bands)
    if not backward:
        return {"variant": "band", "bands": bands, "blocks": batch * bands,
                "threads": band_threads(height, width, channels, bands, split),
                "smem_bytes": state_smem_bytes(height, width, channels, bands)}
    conv, dk, chunks = bwd_roles(height, width, channels, bands, split)
    return {"variant": "band", "bands": bands, "blocks": batch * bands, "threads": conv + dk,
            "smem_bytes": bwd_smem_bytes(height, width, channels, bands),
            "conv_threads": conv, "dk_warps": dk // 32, "row_chunks": chunks}


def band_threads(height: int, width: int, channels: int, bands: int, split: int = 2) -> int:
    """Threads of a band block: one per work item (4 pixels x 4 outputs,
    the inputs in ``split`` parts) of the tallest band, in whole warps, at
    most 512."""
    cp, _, rows, _ = _band_geometry(height, width, channels, bands)
    items = rows * _ceil(width, 4) * (cp // 4) * split
    return min(32 * _ceil(items, 32), 512)


def kernel_split(height: int, width: int, channels: int, bands: int) -> int:
    """Threads of a band kernel's 4 x 4 tile (its input channels in that
    many parts, ``csrc/euler_common.cuh``) for an image in ``bands`` bands:
    2 where one thread a tile would leave a block fewer than 4 warps (the
    shorter chain and the added warps pay: batch 1 in 32 bands), else 1
    (the halves' shuffle and the extra instructions cost more than they
    gain; PERF.md)."""
    tiles = _ceil(height, bands) * _ceil(width, 4) * _ceil(channels, 4)
    return 2 if tiles < 128 else 1


# The dK threads that B2's row chunks fill at most: one warp a scheduler
# (at 32x32x16 in 4 bands, six dK warps, two on some schedulers beside their
# two conv warps, left B2 3% slower than three; PERF.md).
DK_FILL_THREADS = 128


def bwd_roles(height: int, width: int, channels: int, bands: int, split: int = 2):
    """(conv threads, dK threads, row chunks R) of B2's reverse sweep in a
    band block, whose threads are the two roles' (the forward recompute
    runs on all of them): the conv warps run the K^T conv, B1's work items
    (`band_threads`), and the dK warps beside them the dK items, (tap row,
    4 inputs, 4 outputs, a chunk of rows).  The conv warps are
    `band_threads` where that leaves room for one dK item of each (tap row,
    input group, output group), or up to 256 threads; else at most 256
    threads (half the block's most, as the roles do the same FMAs) with the
    work items in even rounds.  R is the largest power of two <= 32 and <=
    the tallest band whose items fill no more whole warps than one a
    scheduler (`DK_FILL_THREADS`) and the room beside the conv warps, and
    the dK warps as many as those items fill, at most the room
    (``csrc/fused_euler_bwd.cu::choose_roles``)."""
    cp, _, rows, _ = _band_geometry(height, width, channels, bands)
    items = rows * _ceil(width, 4) * (cp // 4) * split
    groups = 3 * (cp // 4) ** 2
    conv = band_threads(height, width, channels, bands, split)
    if conv + min(32 * _ceil(groups, 32), 256) > 512:
        conv = 32 * _ceil(_ceil(items, _ceil(items, 256)), 32)
    room = 512 - conv
    chunks = 1
    while (chunks < 32 and 2 * chunks <= rows
           and 32 * _ceil(groups * 2 * chunks, 32) <= min(room, DK_FILL_THREADS)):
        chunks *= 2
    return conv, min(32 * _ceil(groups * chunks, 32), room), chunks


def dk_items(height: int, width: int, channels: int, bands: int, split: int = 2):
    """(row chunks R, items, items a warp, rounds) of B2's dK pass on the dK
    warps of a band block (`bwd_roles`): the items spread evenly over
    those warps, whole chunk groups a warp (``weight_grads``)."""
    _, threads, chunks = bwd_roles(height, width, channels, bands, split)
    items = 3 * (_band_geometry(height, width, channels, bands)[0] // 4) ** 2 * chunks
    warps = threads // 32
    per_warp = min(32, _ceil(_ceil(items, warps), chunks) * chunks)
    return chunks, items, per_warp, _ceil(items, warps * per_warp)


def in_reference_reach(x_shape) -> bool:
    """Whether a (B, H, W, C) state lies where the JAX package's kernel gate
    takes it (C <= 128, H*W <= 4096): a 3x3 Euler stack there runs on B1/B2
    on the card or raises, never on a plain version of what they compute."""
    _, height, width, channels = x_shape
    return channels <= MAX_CHANNELS and height * width <= MAX_PIXELS


def _stack_with_bias(blocks) -> bool:
    """Whether ``blocks`` is a stacked 3x3 stack with a bias: packed
    `Antisym3x3Params`, or a dense ``ConvParams`` (recognised by its fields)
    of (L, 3, 3, C, C) kernels, as the model passes any kernel type."""
    if getattr(blocks, "bias", None) is None:
        return False
    if isinstance(blocks, Antisym3x3Params):
        return True
    if getattr(blocks, "_fields", None) == ("kernel", "bias"):
        kernel = blocks.kernel
        return kernel.dim() == 5 and tuple(kernel.shape[1:3]) == (3, 3)
    return False


def needs_gradient(*tensors: torch.Tensor) -> bool:
    """Whether autograd will differentiate through an op on ``tensors``:
    grad mode is on and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_euler_eligible(x: torch.Tensor, blocks) -> bool:
    """Whether the forward kernel B1 takes this (shape, dtype, params)
    combination, as the JAX gate does: a 4-D fp32 contiguous NHWC input, C
    <= 128 and H*W <= 4096, any batch; a stacked 3x3 stack with a bias
    (`Antisym3x3Params`, or dense ``ConvParams`` (L, 3, 3, C, C) of any
    kernel type).  The shape picks the variant (`kernel_variant`)."""
    return _stack_with_bias(blocks) and not _declined(x)


@functools.lru_cache(maxsize=1024)
def kernel_bands(x_shape, backward: bool = False, sms: int = SM_COUNT):
    """Bands an image of a batch of shape (B, H, W, C) runs in, on B1 (or on
    B2 with ``backward=True``): `band_plan`'s count with the fewest bands
    that fit.  None where the kernel declines the shape."""
    batch, height, width, channels = x_shape
    fewest = min_bands(height, width, channels, bwd_smem_bytes if backward else state_smem_bytes)
    if fewest is None:
        return None
    return len(band_plan(batch, height, fewest, sms))


def _preactivation(y, kernel, bias, matmul_dtype):
    """z = conv2d_same(y, K) + b, operands rounded as ``matmul_dtype`` says."""
    return conv2d_same(
        round_operand(y, matmul_dtype), round_operand(kernel, matmul_dtype), bias=bias
    )


def reference_euler_dense(
    x: torch.Tensor,
    kernels: torch.Tensor,
    biases: torch.Tensor,
    h: float,
    matmul_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The plain version of B1: L steps of `conv2d_same` and relu.  With
    ``matmul_dtype=torch.bfloat16`` the conv operands are rounded to bf16 and
    the conv runs in fp32, as the kernel's bf16 mode does."""
    y = x
    for layer in range(kernels.shape[0]):
        y = y + h * torch.relu(_preactivation(y, kernels[layer], biases[layer], matmul_dtype))
    return y


def reference_euler_dense_bwd(
    x: torch.Tensor,
    kernels: torch.Tensor,
    biases: torch.Tensor,
    g: torch.Tensor,
    h: float,
    matmul_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of B2: (gx, gk, gb), the cotangents of x, kernels
    and biases for the cotangent g of y_L.  It recomputes the trajectory with
    `conv2d_same`, then walks the layers in reverse with the relu-mask
    formulas of `ops.conv.euler_relu_step`'s backward, recomputing z (B2
    keeps the relu mask of its forward recompute as bits instead).  In bf16 mode the forward recompute and the transposed convolution
    take bf16 operands; dK and db stay fp32, as in the Pallas kernel."""
    num_layers = kernels.shape[0]
    trajectory = [x]
    for layer in range(num_layers - 1):
        z = _preactivation(trajectory[-1], kernels[layer], biases[layer], matmul_dtype)
        trajectory.append(trajectory[-1] + h * torch.relu(z))
    gk, gb = torch.zeros_like(kernels), torch.zeros_like(biases)
    for layer in reversed(range(num_layers)):
        y = trajectory[layer]
        z = _preactivation(y, kernels[layer], biases[layer], matmul_dtype)
        g_z = torch.where(z > 0, h * g, 0.0)
        dy, gk[layer], gb[layer] = relu_conv_vjp(y, kernels[layer], g_z, matmul_dtype)
        g = g + dy
    return g, gk, gb


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (argtypes, restype) of every C function of each kernel library.
_SIGNATURES = {
    "fused_euler_fwd": {
        "deqres_euler_fwd": ([_PTR] * 6 + [_I32] * 7 + [_F32, _I32, _PTR], _I32),
        "deqres_euler_fwd_smem": ([_I32] * 4, ctypes.c_longlong),
        "deqres_euler_fwd_resident_images": ([_I32] * 6, _I32),
        "deqres_cuda_error_string": ([_I32], ctypes.c_char_p),
    },
    "fused_euler_bwd": {
        "deqres_euler_bwd": ([_PTR] * 11 + [_I32] * 7 + [_F32, _I32, _PTR], _I32),
        "deqres_euler_bwd_smem": ([_I32] * 4, ctypes.c_longlong),
        "deqres_euler_bwd_layout": ([_I32] * 4, _I32),
        "deqres_euler_bwd_roles": ([_I32] * 5 + [_PTR], _I32),
        "deqres_euler_bwd_resident_images": ([_I32] * 6, _I32),
        "deqres_cuda_error_string": ([_I32], ctypes.c_char_p),
    },
    "fused_euler_wide": {
        "deqres_euler_wide_smem": ([_I32], ctypes.c_longlong),
        "deqres_euler_wide_fwd": ([_PTR] * 5 + [_I32] * 5 + [_F32, _I32, _PTR], _I32),
        "deqres_euler_wide_bwd": ([_PTR] * 12 + [_I32] * 7 + [_F32, _I32, _PTR], _I32),
        "deqres_cuda_error_string": ([_I32], ctypes.c_char_p),
    },
}


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    """The built kernel library ``name`` with every function's C signature
    declared."""
    lib = _build.load(name)
    for function, (argtypes, restype) in _SIGNATURES[name].items():
        getattr(lib, function).argtypes = argtypes
        getattr(lib, function).restype = restype
    return lib


def _kernel(backward: bool):
    return ("fused_euler_bwd", "bwd") if backward else ("fused_euler_fwd", "fwd")


def library_smem_bytes(height: int, width: int, channels: int, bands: int,
                       backward: bool = False) -> int:
    """The shared memory the built library asks for a block of this shape
    (-1 where it does not fit): what `state_smem_bytes` / `bwd_smem_bytes`
    compute, from the C side.  Builds the library."""
    name, short = _kernel(backward)
    return getattr(_library(name), f"deqres_euler_{short}_smem")(height, width, channels, bands)


def library_bwd_roles(height: int, width: int, channels: int, bands: int,
                      split: int) -> Tuple[int, int, int]:
    """(conv threads, dK threads, row chunks) the built B2 library gives a
    block of this shape: what `bwd_roles` computes, from the C side.
    Builds the library."""
    out = (ctypes.c_int * 3)()
    err = _library("fused_euler_bwd").deqres_euler_bwd_roles(
        height, width, channels, bands, split, ctypes.cast(out, ctypes.c_void_p))
    if err:
        raise ValueError(f"no band block at {height}x{width}x{channels} in {bands} bands")
    return tuple(out)


def wide_library_smem_bytes(channels: int) -> int:
    """The dynamic shared memory a block of the built wide library asks for
    at C channels: what `wide_smem_bytes` counts, from the C side.  Builds
    the library."""
    return _library("fused_euler_wide").deqres_euler_wide_smem(channels)


def resident_images(height: int, width: int, channels: int, bands: int,
                    backward: bool = False, bf16: bool = False) -> int:
    """How many images of this shape in ``bands`` bands B1 (or B2) runs at
    once on the current device: every band of an image is a block, and all
    of an image's blocks are resident together (they trade edge rows), so
    a launch holds at most this many images and a larger batch goes in
    several launches."""
    name, short = _kernel(backward)
    lib = _library(name)
    count = getattr(lib, f"deqres_euler_{short}_resident_images")(
        height, width, channels, bands, kernel_split(height, width, channels, bands), int(bf16))
    if count < 0:
        raise RuntimeError(f"resident images failed for {bands} bands of "
                           f"{height}x{width}x{channels}: {count}")
    return count


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check_operands(x, kernels, biases, matmul_dtype, which):
    reason = _declined(x)
    if reason:
        raise ValueError(f"{which} on CUDA takes what the JAX kernel gate takes; not this "
                         f"input: {reason}")
    channels, num_layers = x.shape[-1], kernels.shape[0]
    if tuple(kernels.shape) != (num_layers, 3, 3, channels, channels):
        raise ValueError(f"kernels must be (L, 3, 3, {channels}, {channels}), got {tuple(kernels.shape)}")
    if tuple(biases.shape) != (num_layers, channels):
        raise ValueError(f"biases must be ({num_layers}, {channels}), got {tuple(biases.shape)}")
    for name, t in (("kernels", kernels), ("biases", biases)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x.device}, got {t.dtype} on {t.device}")
    if matmul_dtype not in _MATMUL_DTYPES:
        raise ValueError(f"matmul_dtype must be float32 or bfloat16, got {matmul_dtype}")


def _kernel_operands(kernels, biases, padded, matmul_dtype):
    """(L, 3, 3, C, C) kernels and (L, C) biases as the kernels read them:
    zero-padded from C to Cp channels, the kernels' operands rounded as
    ``matmul_dtype`` says, contiguous and 16-byte aligned.  At C = Cp in
    fp32 the inputs themselves, where aligned."""
    channels = kernels.shape[-1]
    kernels = round_operand(kernels, matmul_dtype)
    if padded != channels:
        kernels = F.pad(kernels, (0, padded - channels, 0, padded - channels))
        biases = F.pad(biases, (0, padded - channels))
    return [_aligned(t.contiguous()) for t in (kernels, biases)]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it in its own storage where cp.async's 16-byte copies
    would start off a 16-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _padded_state(t: torch.Tensor, padded: int) -> torch.Tensor:
    """A contiguous, 16-byte aligned (B, H, W, Cp) copy of t zero-padded
    from C to Cp channels, or t itself where C = Cp and it is aligned."""
    if padded == t.shape[-1]:
        return _aligned(t.contiguous())
    return F.pad(t, (0, padded - t.shape[-1])).contiguous()


def _unpadded(t: torch.Tensor, channels: int) -> torch.Tensor:
    return t if t.shape[-1] == channels else t[..., :channels].contiguous()


def _raise_on_error(lib, err, which):
    if err != 0:
        raise RuntimeError(
            f"{which} launch failed: CUDA error {err} "
            f"({lib.deqres_cuda_error_string(err).decode()})"
        )


def _stack_entry(kernel: str, x, kernels, variant: str, bands: int, launches: int):
    """The record's `StackEntry` of a call of B1 or B2 (``kernel``) on the
    state ``x`` with (L, ...) ``kernels``."""
    _, height, width, channels = x.shape
    return StackEntry(kernel, (height, width, channels, kernels.shape[0]), variant, bands,
                      launches)


def _report(entry: StackEntry) -> None:
    """A call on the card to the record (`utils.tracing.STACKS`), into the
    graph being captured on the current stream if any."""
    STACKS.add(entry, torch.cuda.is_current_stream_capturing())


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(x, kernels, biases, h, matmul_dtype, bands=None) -> torch.Tensor:
    """B1 on CUDA tensors, in the variant the shape takes (`kernel_variant`);
    ``bands`` overrides the band plan (for measurements)."""
    _check_operands(x, kernels, biases, matmul_dtype, "fused_euler_dense")
    if bands is None and kernel_variant(x.shape) == "wide":
        return _launch_wide(x, kernels, biases, h, matmul_dtype)
    batch, height, width, channels = x.shape
    if bands is None:
        bands = kernel_bands(x.shape, sms=_sm_count(x.device.index or 0))
    padded = _band_geometry(height, width, channels, bands)[0]
    kernels, biases = _kernel_operands(kernels, biases, padded, matmul_dtype)
    out = torch.empty_like(x)
    _, edges, steps = _edge_exchange(x, batch, height, width, channels, bands)
    split = kernel_split(height, width, channels, bands)
    lib = _library("fused_euler_fwd")
    with torch.cuda.device(x.device):
        launches = lib.deqres_euler_fwd(
            x.data_ptr(), kernels.data_ptr(), biases.data_ptr(), out.data_ptr(),
            edges, steps, batch, height, width, channels,
            kernels.shape[0], bands, split, float(h), int(matmul_dtype == torch.bfloat16),
            _stream(x),
        )
    _raise_on_error(lib, -min(launches, 0), "fused_euler_fwd")  # minus the error, or the launches
    _report(_stack_entry("B1", x, kernels, "band", bands, launches))
    return out


def _edge_exchange(x, batch, height, width, channels, bands):
    """The band kernels' scratch for trading edge rows, in one allocation:
    (2, B*n, 2, RS) fp32 rows (every element a kernel reads is written
    first), then B*n 32-bit step counters, which the launch zeroes.
    Returns (the buffer, its rows' address, its counters' address); (None,
    0, 0) where one band an image trades nothing."""
    if bands == 1:
        return None, 0, 0
    rows = 2 * batch * bands * 2 * _band_geometry(height, width, channels, bands)[3]
    scratch = x.new_empty(rows + batch * bands)
    return scratch, scratch.data_ptr(), scratch.data_ptr() + 4 * rows


def _launch_wide(x, kernels, biases, h, matmul_dtype) -> torch.Tensor:
    """The wide B1: L layer launches of ``csrc/fused_euler_wide.cu`` on the
    current stream, the state alternating between ``out`` and one scratch
    buffer between layers."""
    batch, height, width, channels = x.shape
    num_layers = kernels.shape[0]
    if num_layers == 0:
        return x.clone()
    padded = _ceil(channels, 4) * 4
    kernels, biases = _kernel_operands(kernels, biases, padded, matmul_dtype)
    xp = _padded_state(x, padded)
    out = x.new_empty((batch, height, width, padded))
    scratch = x.new_empty(out.shape) if num_layers > 1 else out  # unread at L = 1
    lib = _library("fused_euler_wide")
    with torch.cuda.device(x.device):
        err = lib.deqres_euler_wide_fwd(
            xp.data_ptr(), kernels.data_ptr(), biases.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), batch, height, width, channels, num_layers,
            float(h), int(matmul_dtype == torch.bfloat16), _stream(x),
        )
    _raise_on_error(lib, err, "fused_euler_fwd (wide)")
    _report(_stack_entry("B1", x, kernels, "wide", 0, num_layers))
    return _unpadded(out, channels)


def _transposed(kernels):
    """The conv-transpose kernels: rot180 in (dh, dw), c_in and c_out swapped."""
    return kernels.flip(1, 2).transpose(3, 4)


def _launch_bwd(x, kernels, biases, g, h, matmul_dtype, bands=None):
    """B2 on CUDA tensors, in the variant the shape takes (`kernel_variant`);
    ``bands`` overrides the band plan (for measurements)."""
    _check_operands(x, kernels, biases, matmul_dtype, "fused_euler_dense_bwd")
    if kernels.shape[0] < 1:
        raise ValueError("the backward kernel needs at least one layer")
    if g.shape != x.shape or g.dtype != torch.float32 or g.device != x.device:
        raise ValueError(f"g must be float32 {tuple(x.shape)} on {x.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    if bands is None and kernel_variant(x.shape, backward=True) == "wide":
        return _launch_bwd_wide(x, kernels, biases, g, h, matmul_dtype)
    batch, height, width, channels = x.shape
    num_layers = kernels.shape[0]
    if bands is None:
        bands = kernel_bands(x.shape, backward=True, sms=_sm_count(x.device.index or 0))
    padded, _, rows, row = _band_geometry(height, width, channels, bands)
    g = g.contiguous()
    kernels_t, _ = _kernel_operands(_transposed(kernels), biases, padded, matmul_dtype)
    kernels, biases = _kernel_operands(kernels, biases, padded, matmul_dtype)
    gx = torch.empty_like(x)
    layer = 9 * padded * padded + padded
    partials = x.new_empty((batch * bands, num_layers, layer))  # dK and db, one row a band
    trajectory = x.new_empty((num_layers, batch, height, row))
    split = kernel_split(height, width, channels, bands)
    # A 16-bit relu-mask word a work item and layer (4 / split pixels x 4
    # outputs).
    mask = torch.empty((num_layers, batch * bands, rows * _ceil(width, 4) * padded // 4 * split),
                       dtype=torch.int16, device=x.device)
    _, edges, steps = _edge_exchange(x, batch, height, width, channels, bands)
    lib = _library("fused_euler_bwd")
    with torch.cuda.device(x.device):
        launches = lib.deqres_euler_bwd(
            x.data_ptr(), kernels.data_ptr(), biases.data_ptr(), kernels_t.data_ptr(),
            g.data_ptr(), gx.data_ptr(), partials.data_ptr(), trajectory.data_ptr(),
            mask.data_ptr(), edges, steps, batch, height, width,
            channels, num_layers, bands, split, float(h), int(matmul_dtype == torch.bfloat16),
            _stream(x),
        )
    _raise_on_error(lib, -min(launches, 0), "fused_euler_bwd")  # minus the error, or the launches
    _report(_stack_entry("B2", x, kernels, "band", bands, launches))
    # The bands' partials summed here, in a fixed order, where the JAX
    # wrapper sums its tiles'.
    total = partials.sum(dim=0)
    gk = total[:, :9 * padded * padded].reshape(num_layers, 3, 3, padded, padded)
    gb = total[:, 9 * padded * padded:]
    return gx, gk[..., :channels, :channels].contiguous(), gb[:, :channels].contiguous()


def _launch_bwd_wide(x, kernels, biases, g, h, matmul_dtype):
    """The wide B2: the forward recompute into a (L, B, H, W, Cp)
    trajectory with its relu-mask words, then 2 launches a layer in reverse
    (the dK pass, and the conv that sums its partials and steps g), all on
    the current stream (``csrc/fused_euler_wide.cu``)."""
    batch, height, width, channels = x.shape
    num_layers = kernels.shape[0]
    padded = _ceil(channels, 4) * 4
    splits, chunk = wide_splits(x.shape)
    kernels_t, _ = _kernel_operands(_transposed(kernels), biases, padded, matmul_dtype)
    kernels, biases = _kernel_operands(kernels, biases, padded, matmul_dtype)
    trajectory = x.new_empty((num_layers, batch, height, width, padded))
    trajectory[0].copy_(_padded_state(x, padded))
    # Every word is written by the recompute: no zeroing.
    mask = torch.empty((num_layers, batch, height, width, _ceil(padded, 32)), dtype=torch.int32,
                       device=x.device)
    g_state = _padded_state(g, padded)  # only read
    gx = x.new_empty((batch, height, width, padded))
    scratch = x.new_empty(gx.shape) if num_layers > 1 else gx  # unread at L = 1
    partials = x.new_empty((splits, 9 * padded, padded))
    bias_partials = x.new_empty((splits, padded))
    gk = x.new_empty((num_layers, 3, 3, channels, channels))
    gb = x.new_empty((num_layers, channels))
    lib = _library("fused_euler_wide")
    with torch.cuda.device(x.device):
        err = lib.deqres_euler_wide_bwd(
            kernels.data_ptr(), biases.data_ptr(), kernels_t.data_ptr(), trajectory.data_ptr(),
            mask.data_ptr(), g_state.data_ptr(), gx.data_ptr(), scratch.data_ptr(),
            partials.data_ptr(), bias_partials.data_ptr(), gk.data_ptr(), gb.data_ptr(), batch,
            height, width, channels, num_layers, splits, chunk, float(h),
            int(matmul_dtype == torch.bfloat16), _stream(x),
        )
    _raise_on_error(lib, err, "fused_euler_bwd (wide)")
    _report(_stack_entry("B2", x, kernels, "wide", 0, 3 * num_layers))
    return _unpadded(gx, channels), gk, gb


def _device_type(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_euler_dense runs on CPU or CUDA tensors, not {x.device}")
    return x.device.type


# B1 as a dispatcher op, so that `torch.export` records it as one node of
# the graph and the exported program launches it when it runs.  Its kernels
# are registered with the dispatcher directly (`torch.library.Library.impl`):
# bound through `torch.library.custom_op`'s wrappers instead, it made the
# eager 64L x 16F train step 0.35-0.70 ms slower on an H100's host; bound
# so, the step stays within the unbound kernel's spread (PERF.md, §6).
_LIBRARY = torch.library.Library("deqres_torch", "DEF")
_LIBRARY.define("fused_euler_fwd(Tensor x, Tensor kernels, Tensor biases, float h, "
                "ScalarType matmul_dtype) -> Tensor")


def _fused_euler_fwd_cpu(x, kernels, biases, h, matmul_dtype):
    """The op on CPU tensors: `reference_euler_dense`, recorded as a
    "plain" call."""
    STACKS.add(_stack_entry("B1", x, kernels, "plain", 0, 0), captured=False)
    y = reference_euler_dense(x, kernels, biases, h, matmul_dtype)
    return y.clone() if y is x else y  # an op's output never aliases its input


def _fused_euler_fwd_cuda(x, kernels, biases, h, matmul_dtype):
    """The op on CUDA tensors: `_launch`, whose band plan, operand padding,
    stream and launch count are all decided when the op runs, never while
    it is traced.  An exported graph keeps the strides of the device it was
    traced on; the kernel reads a contiguous NHWC state whatever they were."""
    return _launch(x.contiguous(), kernels, biases, h, matmul_dtype)


_LIBRARY.impl("fused_euler_fwd", _fused_euler_fwd_cpu, "CPU")
_LIBRARY.impl("fused_euler_fwd", _fused_euler_fwd_cuda, "CUDA")


@torch.library.register_fake("deqres_torch::fused_euler_fwd", lib=_LIBRARY)
def _fused_euler_fwd_fake(x, kernels, biases, h, matmul_dtype):
    return torch.empty_like(x)


fused_euler_fwd_op = torch.ops.deqres_torch.fused_euler_fwd.default


def _forward(x, kernels, biases, h, matmul_dtype):
    _device_type(x)  # raises on other devices; the op's fake would serve the meta device
    return fused_euler_fwd_op(x, kernels, biases, float(h), matmul_dtype)


def fused_euler_dense_bwd(
    x: torch.Tensor,
    kernels: torch.Tensor,
    biases: torch.Tensor,
    g: torch.Tensor,
    h: float,
    matmul_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gx, gk, gb) of `fused_euler_dense` at the cotangent g of y_L.  CPU
    tensors take `reference_euler_dense_bwd`; CUDA tensors launch B2 in the
    variant the shape takes, reported to `utils.tracing.STACKS`, or raise
    `ValueError` outside the JAX gate's reach."""
    if _device_type(x) == "cpu":
        STACKS.add(_stack_entry("B2", x, kernels, "plain", 0, 0), captured=False)
        return reference_euler_dense_bwd(x, kernels, biases, g, h, matmul_dtype)
    return _launch_bwd(x, kernels, biases, g, h, matmul_dtype)


class FusedEulerDense(torch.autograd.Function):
    """B1 forward, B2 backward; the graph keeps (x, kernels, biases) only."""

    @staticmethod
    def forward(ctx, x, kernels, biases, h, matmul_dtype):
        ctx.save_for_backward(x, kernels, biases)
        ctx.h, ctx.matmul_dtype = h, matmul_dtype
        return _forward(x, kernels, biases, h, matmul_dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, kernels, biases = ctx.saved_tensors
        gx, gk, gb = fused_euler_dense_bwd(x, kernels, biases, g, ctx.h, ctx.matmul_dtype)
        return gx, gk, gb, None, None


def fused_euler_dense(
    x: torch.Tensor,
    kernels: torch.Tensor,
    biases: torch.Tensor,
    h: float,
    matmul_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """y_L of L fused Euler steps with dense (L, 3, 3, C, C) kernels.

    CPU tensors take the plain versions.  CUDA tensors launch B1 (and B2 in
    the backward), each in the variant the shape takes and reported to
    `utils.tracing.STACKS`, or raise `ValueError` outside the JAX gate's
    reach (`in_reference_reach`).
    ``matmul_dtype=torch.bfloat16`` rounds the conv operands to bf16 and
    keeps fp32 sums; the state y stays fp32 throughout."""
    if needs_gradient(x, kernels, biases):
        return FusedEulerDense.apply(x, kernels, biases, h, matmul_dtype)
    return _forward(x, kernels, biases, h, matmul_dtype)


def fused_euler_3x3(
    x: torch.Tensor,
    blocks: Antisym3x3Params,
    h: float,
    gamma: float,
    matmul_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Fused L-layer Euler integration with packed antisymmetric parameters:
    the dense kernels are materialized first, differentiably, so the dense
    kernel gradient folds back onto the packed leaves through autograd."""
    kernels = materialize_3x3_stacked(blocks, gamma=gamma)
    return fused_euler_dense(x, kernels, blocks.bias, float(h), matmul_dtype)

