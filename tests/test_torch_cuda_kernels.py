"""The hand-written kernels B1 (`csrc/fused_euler_fwd.cu`) and B2
(`csrc/fused_euler_bwd.cu`), and their wide variants
(`csrc/fused_euler_wide.cu`), against their plain PyTorch versions on the
card.

Every test here needs a CUDA device and skips itself without one.  The file
imports neither JAX nor the JAX package (nor the test helpers that do), so it
runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Inputs are made with NumPy from a seed.  The band-edge cases cover what the
banded kernels split: batch 1 and 7, a height the band count does not divide,
fewer rows than the plan's usual count, one band an image, and 64x64x16,
which needs bands to fit at all.  The wide variants take the widths the
band kernels decline, up to the JAX gate's C = 128 and 64x64.  Unstructured
(regular) kernels at 16 and 8 filters, a regular-kernel train step against
the CPU, the widths the band kernels decline training on the wide variants,
and a captured remat midpoint step against the eager one cover the other
kernel types and the per-layer route; ResNet-50's eval forward against
the CPU and a captured ResNet-50 step against eager steps (the batch-norm
buffers) cover the bottleneck family, which runs no hand-written kernel.
chip_smoke.py holds both kernels at the main path's 64-layer shapes.
"""

import numpy as np
import pytest
import torch

from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3Params,
    materialize_3x3_stacked,
    num_cross_pairs,
)
from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi

pytestmark = pytest.mark.cuda

TOL = 1e-4  # rtol = atol: fp32 sums in another order than cuDNN's


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs);
    TF32 off for the plain versions' convolutions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py checks the kernels on the card)")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield


def case(batch, height, width, channels, layers, seed):
    """x, dense kernels (from packed antisymmetric params), biases and a
    cotangent g, made with NumPy from ``seed``, on the card."""
    rng = np.random.default_rng(seed)
    std = np.sqrt(2.0 / (9 * channels))
    draw = lambda *shape: (std * rng.standard_normal((layers, *shape))).astype(np.float32)
    leaves = [draw(channels) for _ in range(4)] + [draw(3, 3, num_cross_pairs(channels))]
    bias = (0.05 * rng.standard_normal((layers, channels))).astype(np.float32)
    blocks = Antisym3x3Params(*[torch.from_numpy(v) for v in (*leaves, bias)])
    x = rng.standard_normal((batch, height, width, channels)).astype(np.float32)
    g = rng.standard_normal((batch, height, width, channels)).astype(np.float32)
    kernels = materialize_3x3_stacked(blocks)
    return [t.cuda() for t in (torch.from_numpy(x), kernels, blocks.bias, torch.from_numpy(g))]


def test_kernel_matches_plain_version_on_cuda(card):
    x, kernels, bias, _ = case(3, 8, 8, 8, 3, seed=7)
    before = fi.fused_euler_dense.launches
    for dtype in (torch.float32, torch.bfloat16):
        got = fi.fused_euler_dense(x, kernels, bias, 0.125, matmul_dtype=dtype)
        want = fi.reference_euler_dense(x, kernels, bias, 0.125, matmul_dtype=dtype)
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert fi.fused_euler_dense.launches == before + 2
    # Gradients come from B2 and match the plain backward.
    leaves = [t.clone().requires_grad_() for t in (x, kernels, bias)]
    bwd_before = fi.fused_euler_dense_bwd.launches
    got = torch.autograd.grad(torch.sin(fi.fused_euler_dense(*leaves, 0.125)).sum(), leaves)
    assert fi.fused_euler_dense_bwd.launches == bwd_before + 1
    g = torch.cos(fi.reference_euler_dense(x, kernels, bias, 0.125))
    want = fi.reference_euler_dense_bwd(x, kernels, bias, g, 0.125)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
    # The band B1 takes 32x32x60 and the band B2 does not: the wide B2 does
    # (it raised before it); 1x1x100 takes the wide B1; C = 129 is past the
    # JAX gate's reach and raises before any launch.
    x, kernels, bias, g = case(1, 32, 32, 60, 2, seed=9)  # no |z| within 1e-5 of 0
    leaves = [t.clone().requires_grad_() for t in (x, kernels, bias)]
    wide = fi.WIDE_BWD.launches
    got = torch.autograd.grad((fi.fused_euler_dense(*leaves, 0.125) * g).sum(), leaves)
    assert fi.WIDE_BWD.launches == wide + 1
    want = fi.reference_euler_dense_bwd(x, kernels, bias, g, 0.125)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
    x, kernels, bias, _ = case(1, 1, 1, 100, 2, seed=10)
    torch.testing.assert_close(fi.fused_euler_dense(x, kernels, bias, 0.125),
                               fi.reference_euler_dense(x, kernels, bias, 0.125),
                               rtol=TOL, atol=TOL)
    launched = fi.fused_euler_dense.launches
    with pytest.raises(ValueError, match="JAX kernel gate"):
        fi.fused_euler_dense(torch.zeros(1, 2, 2, 129, device="cuda"),
                             torch.zeros(1, 3, 3, 129, 129, device="cuda"),
                             torch.zeros(1, 129, device="cuda"), 0.125)
    assert fi.fused_euler_dense.launches == launched


@pytest.mark.parametrize("shape", [(3, 8, 8, 8, 3), (3, 16, 16, 6, 3)])  # C = 8, C = 6
def test_backward_kernel_matches_plain_version_on_cuda(card, shape):
    """B2 against `reference_euler_dense_bwd` on the card, both modes, at a
    depth where no relu mask flips (chip_smoke.py holds the 64-layer
    training shape against a float64 judge)."""
    x, kernels, bias, g = case(*shape, seed=15)
    before = fi.fused_euler_dense_bwd.launches
    for dtype in (torch.float32, torch.bfloat16):
        got = fi.fused_euler_dense_bwd(x, kernels, bias, g, 0.125, dtype)
        want = fi.reference_euler_dense_bwd(x, kernels, bias, g, 0.125, dtype)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
    assert fi.fused_euler_dense_bwd.launches == before + 2


BAND_EDGES = {  # (batch, H, W, C, L): what the band plan makes of it
    "batch 1, 8 bands": (1, 32, 32, 16, 3),
    "batch 7, 8 bands": (7, 32, 32, 16, 3),
    "H=13 in 8 bands of 1-2 rows": (2, 13, 9, 8, 3),
    "H=3 in 2 bands": (1, 3, 5, 4, 3),
    "1 band (batch 70)": (70, 8, 8, 8, 2),
    "64x64x16 (needs 4+ bands)": (1, 64, 64, 16, 2),
    "C=22 at 32x32 (B2 declined it before bands)": (2, 32, 32, 22, 2),
    "C=56: one kernel buffer, B2 in 16 bands": (1, 32, 32, 56, 3),
}


def norm_rel(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


@pytest.mark.parametrize("shape", BAND_EDGES.values(), ids=BAND_EDGES.keys())
def test_band_edges_on_cuda(card, shape):
    """Both kernels against their plain versions where the bands are
    uneven, short, single or many.  B1 directly, fp32 and bf16 operands.  B2
    by a float64 run of the plain version, as chip_smoke.py judges it: where
    |z| is below the difference of two fp32 recomputes (or, in bf16 mode, a
    last-bit difference moves a state element across a bf16 rounding
    boundary), a relu-mask element flips and moves one g_z element by h * g,
    so B2 must be as close to float64 as the plain version is (2x its
    distance + 1e-5)."""
    batch, height, width, channels, layers = shape
    # Seed 19 leaves no |z| within 2e-6 of 0 (float64) in any case, so no
    # relu-mask element sits where an fp32 recompute could flip it.
    x, kernels, bias, g = case(*shape, seed=19)
    for backward in (False, True):
        bands = fi.kernel_bands(x.shape, backward=backward)
        assert bands == len(fi.band_plan(batch, height, fi.min_bands(
            height, width, channels, fi.bwd_smem_bytes if backward else fi.state_smem_bytes)))
        assert fi.resident_images(height, width, channels, bands, backward) >= 1
    for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, 1e-2)):
        got = fi.fused_euler_dense(x, kernels, bias, 0.125, matmul_dtype=dtype)
        want = fi.reference_euler_dense(x, kernels, bias, 0.125, matmul_dtype=dtype)
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        got = fi.fused_euler_dense_bwd(x, kernels, bias, g, 0.125, dtype)
        want = fi.reference_euler_dense_bwd(x, kernels, bias, g, 0.125, dtype)
        judge = fi.reference_euler_dense_bwd(*[t.double() for t in (x, kernels, bias, g)],
                                             0.125, dtype)
        for name, a, w, j in zip(("gx", "gk", "gb"), got, want, judge):
            assert norm_rel(a, j) <= 2 * norm_rel(w, j) + 1e-5, (dtype, name)


@pytest.mark.parametrize("shape", [(32, 32, 16), (13, 9, 8), (64, 64, 16), (3, 5, 6), (1, 1, 76)])
def test_library_shared_memory_matches_the_gate(card, shape):
    """The C side asks for the shared memory the Python gate counts, at every
    band count, and refuses exactly what the gate refuses; B2 takes the
    layout `bwd_layout` names."""
    height, width, channels = shape
    for backward, formula in ((False, fi.state_smem_bytes), (True, fi.bwd_smem_bytes)):
        for bands in range(1, min(fi.PLAN_BANDS, height) + 1):
            want = formula(height, width, channels, bands)
            got = fi.library_smem_bytes(height, width, channels, bands, backward)
            assert got == (want if want <= fi.SMEM_LIMIT_BYTES else -1), (backward, bands)
    lib = fi._library("fused_euler_bwd")
    for bands in range(1, min(fi.PLAN_BANDS, height) + 1):
        need, (nkb, ny, nk) = fi.bwd_layout(height, width, channels, bands)
        want = nkb + 4 * ny + 16 * nk if need <= fi.SMEM_LIMIT_BYTES else -1
        assert lib.deqres_euler_bwd_layout(height, width, channels, bands) == want, bands


# Shapes at the edges of the band schedule (batch, H, W, C, L, bands or None
# for the plan's); the band count fixes the threads a tile (`kernel_split`).
SCHEDULE_EDGES = {
    "W=28 (7 column groups), 4 bands of 7 rows": (32, 28, 28, 16, 3, None),
    "W=7, C=8, one thread a tile": (2, 32, 7, 8, 3, 1),
    "W=7, C=8, two threads a tile": (2, 9, 7, 8, 3, None),
    "C=1": (2, 16, 16, 1, 2, None),
    "C=3, one thread a tile": (2, 32, 16, 3, 2, 1),
    "C=13 (Cp=16 of 13)": (2, 16, 16, 13, 2, None),
    "L=1": (3, 32, 32, 16, 1, None),
    "H=28 in 8 bands of 3/4 rows": (2, 28, 28, 16, 3, 8),
    "batch 1 in 16 bands": (1, 32, 32, 16, 3, 16),
    "batch 1 in 32 bands of one row (the plan)": (1, 32, 32, 16, 3, None),
    "batch 1 in 8 bands, one thread a tile": (1, 32, 32, 16, 3, 8),
    "one band, two threads a tile": (2, 4, 16, 16, 3, 1),
    "batch 32, 8 bands, one thread a tile": (32, 32, 32, 16, 2, 8),
    "C=64 in 16 bands (B1's widest at 32x32)": (1, 32, 32, 64, 2, 16),
    "C=56 in 16 bands (B2's widest at 32x32)": (1, 32, 32, 56, 2, 16),
    "81x45x32: B2 in 16 bands, a shape it took on the wide variant before":
        (2, 81, 45, 32, 2, None),
    "batch 150 at 64x64x16: more bands than the card holds, several launches":
        (150, 64, 64, 16, 2, None),
}


@pytest.mark.parametrize("shape", SCHEDULE_EDGES.values(), ids=SCHEDULE_EDGES.keys())
def test_band_schedule_edges_on_cuda(card, shape):
    """The band kernels' schedule (a tile's inputs over one or two threads,
    the bands trading edge rows through device memory) against the plain
    versions where it splits unevenly: W and C not multiples of 4, one
    layer, uneven, one-row, single and many bands, both splits, the widest
    band shapes of the reach, a batch whose bands the card cannot hold at
    once (each of its launches counted); fp32 and bf16 operands.  B2 is
    judged by a float64 run of the plain version (as
    `test_band_edges_on_cuda`), and two B2 calls give bit-identical
    results.  (C = 64 is B1's alone: B2 takes it on the wide variant.)"""
    batch, height, width, channels, layers, bands = shape
    x, kernels, bias, g = case(batch, height, width, channels, layers, seed=19)
    backward_too = fi.kernel_variant(x.shape, backward=True) == "band"
    for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, 1e-2)):
        before = fi.fused_euler_dense.launches
        got = fi._launch(x, kernels, bias, 0.125, dtype, bands)
        n = bands or fi.kernel_bands(x.shape)
        groups = 1 if n == 1 else -(-batch // fi.resident_images(height, width, channels, n))
        assert fi.fused_euler_dense.launches - before == groups
        want = fi.reference_euler_dense(x, kernels, bias, 0.125, matmul_dtype=dtype)
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        if not backward_too:
            continue
        got = fi._launch_bwd(x, kernels, bias, g, 0.125, dtype, bands)
        want = fi.reference_euler_dense_bwd(x, kernels, bias, g, 0.125, dtype)
        judge = fi.reference_euler_dense_bwd(*[t.double() for t in (x, kernels, bias, g)],
                                             0.125, dtype)
        for name, a, w, j in zip(("gx", "gk", "gb"), got, want, judge):
            assert norm_rel(a, j) <= 2 * norm_rel(w, j) + 1e-5, (dtype, name)
        again = fi._launch_bwd(x, kernels, bias, g, 0.125, dtype, bands)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), dtype


def test_band_kernels_on_two_streams_at_once(card):
    """B1 and B2 launched on two streams at once, each launch's bands
    filling the card, again and again: the blocks of an image wait for
    each other, so a launch whose bands were not all resident together
    would never end.  The launches are cooperative (every block resident,
    or the launch waits), so they finish, with the bits of one stream
    alone."""
    x, kernels, bias, g = case(32, 32, 32, 16, 8, seed=19)
    want = (fi._launch(x, kernels, bias, 0.125, torch.float32),
            *fi._launch_bwd(x, kernels, bias, g, 0.125, torch.float32))
    streams = [torch.cuda.Stream() for _ in range(2)]
    for stream in streams:
        stream.wait_stream(torch.cuda.current_stream())
    results = []
    for turn in range(6):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                if (turn + i) % 2:
                    results.append((fi._launch(x, kernels, bias, 0.125, torch.float32),))
                else:
                    results.append(fi._launch_bwd(x, kernels, bias, g, 0.125, torch.float32))
    torch.cuda.synchronize()
    for got in results:
        expected = want[:1] if len(got) == 1 else want[1:]
        assert all(torch.equal(a, b) for a, b in zip(got, expected))


def test_weight_gradients_are_deterministic_on_cuda(card):
    """No float atomics: dK and db are bit-identical across two calls."""
    x, kernels, bias, g = case(8, 32, 32, 16, 4, seed=19)
    first = fi.fused_euler_dense_bwd(x, kernels, bias, g, 0.125)
    second = fi.fused_euler_dense_bwd(x, kernels, bias, g, 0.125)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_graph_replayed_train_step_equals_the_eager_step(card):
    """A train step captured once in a CUDA graph and replayed
    (`make_multi_step`) against the eager step (`make_train_step`) on a twin
    model with the same capturable Adam, 3 steps of a 2-layer model: loss,
    correct, grad norms and parameters agree (cuDNN's weight gradient sums
    in no fixed order, so not bit for bit).  The kernels' counters count
    the warm-up calls and the replays' launches; the capture is counted
    apart, in ``captured``."""
    from differential_equations_resnet_tpu_torch.models import (
        build_single_block_resnet,
        cifar10_single_block_config,
    )
    from differential_equations_resnet_tpu_torch.train import (
        make_adam,
        make_device_eval,
        make_eval_step,
        make_multi_step,
        make_predict_step,
        make_train_step,
    )
    from differential_equations_resnet_tpu_torch.train.train_step import WARMUP_CALLS

    config = cifar10_single_block_config(num_layers=2, num_filters=8)
    models = [build_single_block_resnet(config, generator=torch.Generator().manual_seed(0),
                                        device="cuda") for _ in range(2)]
    optimizers = [make_adam(m.parameters()) for m in models]
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(0, 255, (3, 8, 32, 32, 3)).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 10, (3, 8))).cuda()
    lrs = [1e-3, 2e-3, 5e-4]
    before = (fi.fused_euler_dense.launches, fi.fused_euler_dense_bwd.launches)
    captured_before = fi.captured_launches()
    metrics, norms = make_multi_step(models[0], optimizers[0])(images, labels, lrs)
    torch.cuda.synchronize()
    counted = (fi.fused_euler_dense.launches - before[0], fi.fused_euler_dense_bwd.launches - before[1])
    assert counted == (WARMUP_CALLS + 3, WARMUP_CALLS + 3)
    assert [a - b for a, b in zip(fi.captured_launches(), captured_before)] == [1, 1, 0, 0]
    eager = make_train_step(models[1], optimizers[1])
    for i in range(3):
        m, n = eager(images[i], labels[i], lrs[i])
        torch.testing.assert_close(metrics["loss"][i], m["loss"], rtol=1e-5, atol=0)
        assert float(metrics["correct"][i]) == float(m["correct"])
        torch.testing.assert_close(norms[i], n, rtol=1e-4, atol=0)
    for p, q in zip(*[m.parameters() for m in models]):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-5)
    # Eval and predict graphs against the eager forward.
    x, y = images[0], labels[0]
    want = make_eval_step(models[0])(x, y)
    got = make_device_eval(models[0], 8)(x[:7], y[:7])
    assert float(got["count"][0]) == 7
    assert torch.isfinite(got["loss"]).all()
    full = make_device_eval(models[0], 8)(x, y)
    torch.testing.assert_close(full["loss"][0], want["loss"], rtol=1e-5, atol=0)
    with torch.no_grad():
        probs = models[0](x)
    torch.testing.assert_close(make_predict_step(models[0])(x), probs, rtol=1e-5, atol=1e-6)


def regular_case(batch, height, width, channels, layers, seed):
    """As `case`, with unstructured (regular) He-scaled dense kernels."""
    rng = np.random.default_rng(seed)
    std = np.sqrt(2.0 / (9 * channels))
    kernels = (std * rng.standard_normal((layers, 3, 3, channels, channels))).astype(np.float32)
    bias = (0.05 * rng.standard_normal((layers, channels))).astype(np.float32)
    x = rng.standard_normal((batch, height, width, channels)).astype(np.float32)
    g = rng.standard_normal((batch, height, width, channels)).astype(np.float32)
    return [torch.from_numpy(t).cuda() for t in (x, kernels, bias, g)]


@pytest.mark.parametrize("channels", [16, 8])
def test_kernels_take_unstructured_regular_kernels(card, channels):
    """B1 and B2 compute any dense 3x3 stack, not only antisymmetric ones:
    regular kernels at 32x32 and 16 and 8 filters, 4 layers, batch 4,
    against the plain versions (B1 to 1e-4; B2 judged by float64 as in
    test_band_edges_on_cuda)."""
    x, kernels, bias, g = regular_case(4, 32, 32, channels, 4, seed=23)
    got = fi.fused_euler_dense(x, kernels, bias, 0.125)
    torch.testing.assert_close(got, fi.reference_euler_dense(x, kernels, bias, 0.125),
                               rtol=TOL, atol=TOL)
    got = fi.fused_euler_dense_bwd(x, kernels, bias, g, 0.125)
    want = fi.reference_euler_dense_bwd(x, kernels, bias, g, 0.125)
    judge = fi.reference_euler_dense_bwd(*[t.double() for t in (x, kernels, bias, g)], 0.125)
    for name, a, w, j in zip(("gx", "gk", "gb"), got, want, judge):
        assert norm_rel(a, j) <= 2 * norm_rel(w, j) + 1e-5, name


def _card_model(config):
    """The model of ``config`` on the card, random weights from seed 0."""
    from differential_equations_resnet_tpu_torch.models import build_single_block_resnet

    return build_single_block_resnet(config, generator=torch.Generator().manual_seed(0),
                                     device="cuda")


def test_regular_train_step_on_the_card_equals_the_cpu(card):
    """A regular-kernel model (3L x 8F) takes one B1 and one B2 launch a
    train step on the card, and its loss, grad-norm row and parameters
    after 2 Adam updates agree with the CPU's plain path."""
    from differential_equations_resnet_tpu_torch.models import cifar10_single_block_config
    from differential_equations_resnet_tpu_torch.train import make_adam, make_train_step

    config = cifar10_single_block_config(num_layers=3, num_filters=8, kernel_type="regular",
                                         final_time=0.375)
    from differential_equations_resnet_tpu_torch.models import build_single_block_resnet

    on_card = _card_model(config)
    on_cpu = build_single_block_resnet(config, params=on_card.params(), device="cpu")
    steps = [make_train_step(m, make_adam(m.parameters())) for m in (on_card, on_cpu)]
    rng = np.random.default_rng(5)
    before = (fi.fused_euler_dense.launches, fi.fused_euler_dense_bwd.launches)
    for _ in range(2):
        images = torch.from_numpy(rng.uniform(0, 255, (4, 32, 32, 3)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, 10, 4))
        (m_card, n_card), (m_cpu, n_cpu) = [s(images.to(d), labels.to(d), 1e-3)
                                            for s, d in zip(steps, ("cuda", "cpu"))]
        torch.testing.assert_close(m_card["loss"].cpu(), m_cpu["loss"], rtol=1e-5, atol=0)
        torch.testing.assert_close(n_card.cpu(), n_cpu, rtol=1e-4, atol=0)
    assert (fi.fused_euler_dense.launches - before[0],
            fi.fused_euler_dense_bwd.launches - before[1]) == (2, 2)
    for p, q in zip(on_card.parameters(), on_cpu.parameters()):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), rtol=0, atol=1e-5)


def test_a_width_the_kernels_decline_raises_on_the_card(card):
    """The Euler 3x3 stacks within the JAX gate's reach that the band
    kernels decline (which raised, or ran layer by layer, before the wide
    variants) run on the wide variants and agree with the CPU: a regular
    train step at 64 filters (the band B2 takes C <= 56 at 32x32) on the
    route `wide_route` names, a forward at 72 (the band B1 takes C <= 64),
    and, where the JAX package would run Pallas (use_pallas,
    antisymmetric), a train step at 64 filters on B1 and the wide B2."""
    import dataclasses

    from differential_equations_resnet_tpu_torch.models import (
        build_single_block_resnet,
        cifar10_single_block_config,
    )
    from differential_equations_resnet_tpu_torch.models import single_block_resnet as sbr
    from differential_equations_resnet_tpu_torch.train import make_adam, make_train_step

    rng = np.random.default_rng(8)
    images = torch.from_numpy(rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, 2))
    config = cifar10_single_block_config(num_layers=2, num_filters=64, kernel_type="regular",
                                         final_time=0.25)
    pallas = dataclasses.replace(config, kernel_type="antisymmetric", use_pallas=True)
    for cfg, fused in ((config, sbr.wide_route(64) == "fused"), (pallas, True)):
        before = (fi.fused_euler_dense.launches, fi.WIDE_BWD.launches)
        on_card = _card_model(cfg)
        on_cpu = build_single_block_resnet(cfg, params=on_card.params(), device="cpu")
        steps = [make_train_step(m, make_adam(m.parameters())) for m in (on_card, on_cpu)]
        (m_card, n_card), (m_cpu, n_cpu) = [s(images.to(d), labels.to(d), 1e-3)
                                            for s, d in zip(steps, ("cuda", "cpu"))]
        torch.testing.assert_close(m_card["loss"].cpu(), m_cpu["loss"], rtol=1e-5, atol=0)
        torch.testing.assert_close(n_card.cpu(), n_cpu, rtol=1e-4, atol=0)
        for p, q in zip(on_card.parameters(), on_cpu.parameters()):
            torch.testing.assert_close(p.detach().cpu(), q.detach(), rtol=0, atol=1e-5)
        launched = (fi.fused_euler_dense.launches - before[0], fi.WIDE_BWD.launches - before[1])
        assert launched == ((1, 1) if fused else (0, 0)), cfg.kernel_type
    wide = dataclasses.replace(config, filters_per_block=(72,))
    wide_card = _card_model(wide)
    wide_cpu = build_single_block_resnet(wide, params=wide_card.params(), device="cpu")
    before = fi.WIDE_FWD.launches
    with torch.no_grad():
        torch.testing.assert_close(wide_card(images.cuda()).cpu(), wide_cpu(images),
                                   rtol=TOL, atol=TOL)
    assert fi.WIDE_FWD.launches - before == (1 if sbr.wide_route(72) == "fused" else 0)


# (batch, H, W, C, L), seed: each seed leaves no |z| within 5e-6 of 0
# (float64, both modes) in any layer, so no relu-mask element sits where an
# fp32 recompute could flip it (see test_band_edges_on_cuda).  The edges of
# the wide tiles: the dK pass's last 128-row tile part full (9 * 68 = 612 and
# 9 * 100 = 900 rows), a last pixel chunk shorter than the others (23x23 at
# batch 5: 11 chunks of 256 pixels, the last of 85) and a ragged last
# 128-pixel tile (432 and 2645 pixels).
WIDE_CASES = {
    "32x32x72": ((2, 32, 32, 72, 3), 45),
    "32x32x128": ((2, 32, 32, 128, 2), 37),
    "8x8x128": ((4, 8, 8, 128, 3), 32),
    "64x64x48": ((1, 64, 64, 48, 2), 32),
    "7x9x57": ((3, 7, 9, 57, 3), 31),
    "1x1x100": ((2, 1, 1, 100, 2), 31),
    "32x32x68": ((2, 32, 32, 68, 2), 31),
    "12x12x100": ((3, 12, 12, 100, 2), 30),
    "23x23x68": ((5, 23, 23, 68, 2), 35),
}


@pytest.mark.parametrize("shape,seed", WIDE_CASES.values(), ids=WIDE_CASES.keys())
def test_wide_variants_match_plain_versions_on_cuda(card, shape, seed):
    """The wide B1 and B2 against their plain versions, fp32 and bf16
    operands: B1 to 1e-4 (1e-2 in bf16, as in test_band_edges_on_cuda), B2
    judged by a float64 run of the plain version (2x its distance +
    1e-5); dK and db bit-identical across two calls; the library's shared
    memory is what `wide_smem_bytes` counts."""
    x, kernels, bias, g = case(*shape, seed=seed)
    assert fi.wide_library_smem_bytes(shape[3]) == fi.wide_smem_bytes(shape[3])
    before = (fi.WIDE_FWD.launches, fi.WIDE_BWD.launches)
    for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, 1e-2)):
        got = fi._launch_wide(x, kernels, bias, 0.125, dtype)
        want = fi.reference_euler_dense(x, kernels, bias, 0.125, matmul_dtype=dtype)
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        got = fi._launch_bwd_wide(x, kernels, bias, g, 0.125, dtype)
        want = fi.reference_euler_dense_bwd(x, kernels, bias, g, 0.125, dtype)
        judge = fi.reference_euler_dense_bwd(*[t.double() for t in (x, kernels, bias, g)],
                                             0.125, dtype)
        for name, a, w, j in zip(("gx", "gk", "gb"), got, want, judge):
            assert norm_rel(a, j) <= 2 * norm_rel(w, j) + 1e-5, (dtype, name)
        again = fi._launch_bwd_wide(x, kernels, bias, g, 0.125, dtype)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert (fi.WIDE_FWD.launches - before[0], fi.WIDE_BWD.launches - before[1]) == (2, 4)


def test_captured_remat_midpoint_step_equals_the_eager_step(card):
    """A midpoint stack with remat (each layer checkpointed without saving
    the RNG state, so a CUDA graph can capture its recompute) replayed from
    one captured step against the eager step on a twin: the per-layer route
    launches no kernel, and 3 steps agree (cuDNN's weight gradient sums in
    no fixed order, so not bit for bit)."""
    from differential_equations_resnet_tpu_torch.models import cifar10_single_block_config
    from differential_equations_resnet_tpu_torch.train import (
        make_adam,
        make_multi_step,
        make_train_step,
    )

    config = cifar10_single_block_config(num_layers=3, num_filters=8, integrator="midpoint",
                                         remat=True, final_time=0.375)
    models = [_card_model(config) for _ in range(2)]
    optimizers = [make_adam(m.parameters()) for m in models]
    rng = np.random.default_rng(6)
    images = torch.from_numpy(rng.uniform(0, 255, (3, 4, 32, 32, 3)).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 10, (3, 4))).cuda()
    before = (fi.fused_euler_dense.launches, fi.fused_euler_dense_bwd.launches)
    metrics, norms = make_multi_step(models[0], optimizers[0])(images, labels, [1e-3] * 3)
    eager = make_train_step(models[1], optimizers[1])
    for i in range(3):
        m, n = eager(images[i], labels[i], 1e-3)
        torch.testing.assert_close(metrics["loss"][i], m["loss"], rtol=1e-5, atol=0)
        torch.testing.assert_close(norms[i], n, rtol=1e-4, atol=0)
    for p, q in zip(*[m.parameters() for m in models]):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-5)
    assert (fi.fused_euler_dense.launches, fi.fused_euler_dense_bwd.launches) == before


def _resnet50_pair(image_size, classes, seed=0, **fields):
    """ResNet-50 with antisymmetric mid-convs, random weights from ``seed``,
    on the card and its twin on the CPU."""
    from differential_equations_resnet_tpu_torch.models import build_resnet, resnet_preset

    config = resnet_preset("resnet50", classes, antisymmetric_mid=True,
                           image_shape=(image_size, image_size, 3), **fields)
    on_card = build_resnet(config, generator=torch.Generator().manual_seed(seed), device="cuda")
    on_cpu = build_resnet(config, params=on_card.params(), state=on_card.state(), device="cpu")
    return on_card, on_cpu


def test_resnet50_eval_forward_on_the_card_equals_the_cpu(card):
    """ResNet-50 (antisymmetric mid-convs, full widths) in eval mode at
    32x32, batch 2, on cuDNN with TF32 off, against the CPU: logits to 1e-4
    norm-relative.  No hand-written kernel runs in this family."""
    on_card, on_cpu = _resnet50_pair(32, 10)
    images = torch.from_numpy(np.random.default_rng(9).uniform(0, 255, (2, 32, 32, 3))
                              .astype(np.float32))
    before = (fi.fused_euler_dense.launches, fi.fused_euler_dense_bwd.launches)
    with torch.no_grad():
        got = on_card(images.cuda(), return_logits=True).cpu()
        want = on_cpu(images, return_logits=True)
    assert norm_rel(got, want) <= 1e-4
    assert (fi.fused_euler_dense.launches, fi.fused_euler_dense_bwd.launches) == before


def test_captured_bottleneck_step_leaves_the_running_statistics_as_an_eager_step(card):
    """A ResNet-50 train step (batch 8, 32x32, v1.5) captured in a CUDA graph
    after its warm-up calls and replayed 3 times, against 3 eager steps on
    a twin, at learning rate 0 (the parameters stay put, so the running
    statistics depend on the batches alone): the warm-up gives the
    batch-norm buffers back as it found them, so losses and running
    statistics agree and the parameters are equal."""
    from differential_equations_resnet_tpu_torch.models import build_resnet
    from differential_equations_resnet_tpu_torch.train import (
        make_adam,
        make_multi_step,
        make_train_step,
    )

    replayed, _ = _resnet50_pair(32, 10, version=1.5)
    eager = build_resnet(replayed.config, generator=torch.Generator().manual_seed(0),
                         device="cuda")  # the same draws, in storage of its own
    rng = np.random.default_rng(10)
    images = torch.from_numpy(rng.uniform(0, 255, (3, 8, 32, 32, 3)).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 10, (3, 8))).cuda()
    metrics, _ = make_multi_step(replayed, make_adam(replayed.parameters()))(images, labels,
                                                                             [0.0] * 3)
    step = make_train_step(eager, make_adam(eager.parameters()))
    for i in range(3):
        m, _ = step(images[i], labels[i], 0.0)
        torch.testing.assert_close(metrics["loss"][i], m["loss"], rtol=1e-5, atol=0)
    for (name, a), b in zip(replayed.named_buffers(), eager.buffers()):
        assert norm_rel(a, b) <= 1e-5, name
    for p, q in zip(replayed.parameters(), eager.parameters()):
        assert torch.equal(p, q)


def test_b1_op_on_cuda_is_one_launch_of_the_kernel(card):
    """``deqres_torch::fused_euler_fwd`` on CUDA tensors launches B1 once
    and returns what `_launch` returns, bit for bit, whatever the state's
    memory layout."""
    x, kernels, biases, _ = case(2, 16, 16, 8, 3, 71)
    fi.reset_launch_counts()
    got = torch.ops.deqres_torch.fused_euler_fwd(x, kernels, biases, 0.125, torch.float32)
    assert fi.fused_euler_dense.launches == 1
    assert torch.equal(got, fi._launch(x, kernels, biases, 0.125, torch.float32))
    # A state in another memory layout (as an exported graph may hand it
    # over) runs as its contiguous copy.
    transposed = x.permute(0, 2, 1, 3)
    assert torch.equal(
        torch.ops.deqres_torch.fused_euler_fwd(transposed, kernels, biases, 0.125, torch.float32),
        fi._launch(transposed.contiguous(), kernels, biases, 0.125, torch.float32))


def test_compiled_export_serves_on_the_card(card, tmp_path):
    """An export traced on the CPU and one traced on the card, both served
    on the card through forward.pt2: one B1 launch a request, the same
    answer, within TOL of the CPU's."""
    from differential_equations_resnet_tpu_torch.models import (
        build_single_block_resnet,
        cifar10_single_block_config,
    )
    from differential_equations_resnet_tpu_torch.utils.serving import export_model, load_exported

    config = cifar10_single_block_config(num_layers=4, num_filters=16)
    cpu = build_single_block_resnet(config, generator=torch.Generator().manual_seed(9),
                                    device="cpu")
    gpu = build_single_block_resnet(config, params=cpu.params(), device="cuda")
    x = np.random.default_rng(9).uniform(0, 255, (4, 32, 32, 3)).astype(np.float32)
    want, _ = load_exported(export_model(cpu, str(tmp_path / "cpu"), batch_size=4), device="cpu")
    answers = []
    for name, model in (("from_cpu", cpu), ("from_card", gpu)):
        predict, _ = load_exported(export_model(model, str(tmp_path / name), batch_size=4),
                                   device="cuda")
        predict(x)  # the capture
        fi.reset_launch_counts()
        answers.append(predict(x))
        assert fi.fused_euler_dense.launches == 1 and predict.routes["compiled"] == 2
    np.testing.assert_array_equal(answers[0], answers[1])
    np.testing.assert_allclose(answers[0], want(x), rtol=TOL, atol=TOL)


def _logit_gaps(probs, ref):
    """Each class's logit less its row's top class's (top by ``ref``),
    from probabilities: log p_i - log p_j = z_i - z_j.  Classes either
    gives 0 are left out."""
    p, q = (torch.as_tensor(np.asarray(a), dtype=torch.float64) for a in (probs, ref))
    top = q.argmax(-1, keepdim=True)
    kept = (p > 0) & (q > 0)
    return [(t.log() - t.log().gather(-1, top))[kept] for t in (p, q)]


@pytest.mark.parametrize("route", ["fused", "per_layer"])
def test_served_program_is_fp32_in_one_graph_for_several_threads(card, tmp_path, monkeypatch,
                                                                 route):
    """On the card, with cuDNN's TF32 flag on as PyTorch sets it: the
    served forward.pt2 answers as the rebuilt model does, within 1e-5 of
    its logit gaps, a tolerance the program run in TF32 misses on the
    per-layer route's 3x3 convolutions; a predictor holds one captured
    graph whatever batch sizes come; requests from several threads at once
    get their own answers."""
    import os
    import threading

    from differential_equations_resnet_tpu_torch.models import (
        build_single_block_resnet,
        cifar10_single_block_config,
    )
    from differential_equations_resnet_tpu_torch.utils import serving

    config = cifar10_single_block_config(num_layers=8, num_filters=16,
                                         kernel_type="antisymmetric" if route == "fused"
                                         else "centrosymmetric", kernel_size=3 if route == "fused"
                                         else 5)
    model = build_single_block_resnet(config, generator=torch.Generator().manual_seed(12),
                                      device="cuda")
    export_dir = serving.export_model(model, str(tmp_path / "e"), batch_size=8)
    made = []

    class Counted(serving._Replayed):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)

    monkeypatch.setattr(serving, "_Replayed", Counted)
    draw = lambda n, seed: np.random.default_rng(seed).uniform(0, 255, (n, 32, 32, 3)).astype(
        np.float32)
    x = draw(8, 12)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        compiled, _ = serving.load_exported(export_dir, device="cuda")
        rebuilt, _ = serving.load_exported(export_dir, prefer_stablehlo=False, device="cuda")
        got, want = compiled(x), rebuilt(x)
        raw = torch.export.load(os.path.join(export_dir, serving.FORWARD_FILE)).module()
        with torch.no_grad():
            tf32 = raw(torch.from_numpy(x).cuda()).cpu().numpy()
        for n in (1, 3, 8, 5, 8):
            compiled(draw(n, n)), rebuilt(draw(n, n))
        requests = [draw(8 if i % 2 else 3, 20 + i) for i in range(8)]
        answers = [compiled(r) for r in requests]
        served = [None] * len(requests)

        def serve(i):
            for _ in range(3):
                served[i] = compiled(requests[i])

        threads = [threading.Thread(target=serve, args=(i,)) for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    torch.testing.assert_close(*_logit_gaps(got, want), rtol=1e-5, atol=1e-5)
    if route == "per_layer":
        assert not torch.allclose(*_logit_gaps(tf32, want), rtol=1e-5, atol=1e-5)
    assert len(made) == 2 and [len(r.graphs) for r in made] == [1, 1]
    for s, a in zip(served, answers):
        np.testing.assert_array_equal(s, a)
