"""The banded kernels' plan on the CPU: how many bands (blocks) an image
runs in, which rows each band holds, and the shared memory a
band's block needs, which decides the kernels' gates.  The kernels
themselves run on the card (tests/test_torch_cuda_kernels.py)."""

import ctypes
import re

import pytest
import torch

from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi

PLANS = [  # (batch, height, fewest bands)
    (32, 32, 1),    # the training and batch-32 serving shape
    (1, 32, 1),     # a serving request
    (7, 32, 1),
    (16, 32, 1),
    (17, 32, 1),
    (33, 32, 1),
    (132, 32, 1),
    (2, 13, 1),     # H not divisible by the band count
    (1, 3, 1),      # fewer rows than the plan's usual 8 bands
    (1, 1, 1),
    (64, 64, 4),    # 64x64x16: at least 4 bands to fit
    (200, 64, 16),
    (1, 4096, 1),
]


@pytest.mark.parametrize("batch,height,fewest", PLANS)
def test_band_plan_covers_every_row_once(batch, height, fewest):
    plan = fi.band_plan(batch, height, fewest)
    rows = [r for start, stop in plan for r in range(start, stop)]
    assert rows == list(range(height))                          # every row exactly once, in order
    heights = [stop - start for start, stop in plan]
    assert min(heights) >= 1 and max(heights) - min(heights) <= 1
    bands = len(plan)
    assert bands & (bands - 1) == 0                             # a power of two
    assert fewest <= bands <= max(fi.PLAN_BANDS, fewest) and fewest <= fi.MAX_BANDS
    assert bands <= height
    if bands > fewest:
        assert batch * bands <= fi.SM_COUNT                    # one block a multiprocessor


def test_band_plan_at_the_main_shapes():
    assert len(fi.band_plan(32, 32)) == 4                       # 128 blocks on 132 SMs
    assert len(fi.band_plan(1, 32)) == 32                       # 32 SMs for a single request
    assert len(fi.band_plan(7, 32)) == 16
    assert len(fi.band_plan(9, 32)) == 8
    assert len(fi.band_plan(34, 32)) == 2
    assert len(fi.band_plan(67, 32)) == 1
    assert len(fi.band_plan(133, 32)) == 1
    assert len(fi.band_plan(32, 32, sms=64)) == 2               # another card's SM count
    assert fi.band_plan(32, 32) == tuple((8 * r, 8 * r + 8) for r in range(4))
    assert fi.band_plan(1, 13) == ((0, 1), (1, 3), (3, 4), (4, 6), (6, 8), (8, 9),
                                   (9, 11), (11, 13))


@pytest.mark.parametrize("shape,backward,bands", [
    ((32, 32, 32, 16), False, 4),
    ((32, 32, 32, 16), True, 4),
    ((64, 32, 32, 16), True, 2),
    ((1, 32, 32, 16), False, 32),
    ((1, 32, 32, 16), True, 32),
    ((8, 32, 32, 16), True, 16),
    ((200, 32, 32, 16), False, 1),
    ((200, 32, 32, 16), True, 2),   # the whole image's g_z, y and g do not fit one block
    ((1, 64, 64, 16), False, 32),
    ((200, 64, 64, 16), False, 4),
    ((200, 64, 64, 16), True, 8),
    ((1, 1, 1, 100), False, None),  # one layer's kernel is over the limit
    ((1, 32, 32, 60), True, None),
])
def test_kernel_bands(shape, backward, bands):
    assert fi.kernel_bands(shape, backward=backward) == bands


def test_shared_memory_formulas():
    """The banded layout: Cp = C rounded up to 4, rows padded per 4-column
    group and to 8 (mod 32) floats; B1: two mbarriers, two state buffers and
    one or two kernel buffers (two where they fit); B2: the first layout of
    `BWD_LAYOUTS` that fits."""
    # 32x32x16 in 4 bands: rows of 34*16 + 8*4 = 576 floats, padded to 584;
    # 10 padded rows a buffer; kernels 9*16*16 + 16 floats.
    band, layer = 10 * 584, 9 * 256 + 16
    assert fi.state_smem_bytes(32, 32, 16, 4) == 4 * (4 + 2 * band + 2 * layer) == 65_296
    # B2's reverse sweep: six mbarriers, y twice, g_z twice, g of 8x32
    # pixels, K^T twice.
    assert fi.bwd_layout(32, 32, 16, 4) == (
        4 * (12 + 4 * band + 8 * 32 * 16 + 2 * 9 * 256), (2, 2, 2))
    assert fi.bwd_smem_bytes(32, 32, 16, 4) == 128_304
    assert fi.state_smem_bytes(32, 32, 16, 8) == 46_608
    assert fi.bwd_smem_bytes(32, 32, 16, 8) == 82_736  # two blocks an SM
    # C = 6 pads to 8 channels.
    assert fi.state_smem_bytes(16, 16, 6, 2) == fi.state_smem_bytes(16, 16, 8, 2)
    # More bands never need more (B2: where a band count fits, every larger
    # one does).
    for height, width, channels in ((32, 32, 16), (64, 64, 16), (13, 9, 6), (32, 32, 56)):
        sizes = [fi.state_smem_bytes(height, width, channels, n) for n in (1, 2, 4, 8, 16)
                 if n <= height]
        assert sizes == sorted(sizes, reverse=True)
        fits = [fi.bwd_smem_bytes(height, width, channels, n) <= fi.SMEM_LIMIT_BYTES
                for n in (1, 2, 4, 8, 16) if n <= height]
        assert fits == sorted(fits)
    # One kernel buffer where two do not fit: 32x32x64 in 16 bands.
    assert fi.state_smem_bytes(32, 32, 64, 16) <= fi.SMEM_LIMIT_BYTES
    assert fi.state_smem_bytes(32, 32, 64, 16) < 4 * 2 * (9 * 64 * 64 + 64)
    # B2 at its widest band shape, 32x32x56 in 16 bands: one buffer of each.
    assert fi.bwd_layout(32, 32, 56, 16)[1] == (1, 1, 1)


@pytest.mark.parametrize("shape", [
    (32, 32, 6), (16, 16, 6), (32, 32, 12), (8, 8, 3), (5, 7, 1),  # C not in {4, 8, 16, 32}
    (64, 64, 8), (64, 64, 4), (48, 48, 8), (64, 40, 4),            # more than 2048 pixels
])
def test_gates_keep_what_one_block_per_image_took(shape):
    """The shapes the one-block-per-image kernels sent to their staged
    variants stay eligible for both kernels, in their band variants."""
    height, width, channels = shape
    x = torch.zeros(1, height, width, channels)
    assert fi._declined(x) == ""
    for backward, smem in ((False, fi.state_smem_bytes), (True, fi.bwd_smem_bytes)):
        assert fi.min_bands(height, width, channels, smem) is not None
        assert fi.kernel_variant(x.shape, backward) == "band"


@pytest.mark.parametrize("channels", range(1, 39))
def test_gates_at_32x32_keep_their_old_widths(channels):
    """At 32x32 one block per image took C <= 38 (B1) and C <= 21 (B2);
    bands take both up to C <= 38 and beyond."""
    assert fi.min_bands(32, 32, channels) is not None
    assert fi.min_bands(32, 32, channels, fi.bwd_smem_bytes) is not None


def test_min_bands():
    assert fi.min_bands(32, 32, 16) == 1
    assert fi.min_bands(32, 32, 16, fi.bwd_smem_bytes) == 2
    assert fi.min_bands(64, 64, 16) == 4
    assert fi.min_bands(64, 64, 16, fi.bwd_smem_bytes) == 8
    assert fi.min_bands(32, 32, 64) == 16
    assert fi.min_bands(32, 32, 65) is None
    assert fi.min_bands(1, 1, 100) is None


C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong,
           "const char*": ctypes.c_char_p}


@pytest.mark.parametrize("library,function", [
    (library, function) for library, functions in fi._SIGNATURES.items() for function in functions])
def test_ctypes_signatures_match_the_sources(library, function):
    """Each C entry point's argument and return types, read from its source,
    are what the ctypes binding declares (any pointer is c_void_p)."""
    source = fi._build.SOURCES[library].path.read_text()
    found = re.search(r"^(const char\*|long long|int) " + function + r"\(([^)]*)\)", source,
                      re.MULTILINE)
    assert found, function
    params = [" ".join(p.split()[:-1]) for p in found.group(2).replace("\n", " ").split(",")]
    declared = [C_TYPES.get(p, ctypes.c_void_p) if "*" not in p else ctypes.c_void_p
                for p in params]
    argtypes, restype = fi._SIGNATURES[library][function]
    assert argtypes == declared
    assert restype == C_TYPES[found.group(1)]
