"""B1 and B2 at the three stacks of the three-stage CIFAR configuration
(``perfbench/configs/sb-antisym-3x18-cifar10.json``) at its batch of 128,
on the card: 32x32x16 at L = 18 (B1 one band an image, B2 two), 16x16x32
and 8x8x64 at L = 17 (B2 two bands, so more blocks than the card holds at
once: a launch for each group of images it holds).

Each kernel against its plain version, eagerly and replayed from a
captured graph, with the launches that `fused_integrator.resident_images`
implies, as the port's record of hand-kernel calls (`utils.tracing.STACKS`)
lists and counts them; and the model's captured train step,
whose record lists the three stacks' B1 calls forward, then their B2 calls
in reverse.  Every test needs a CUDA device and skips itself without one.
The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_three_stage.py
"""

import numpy as np
import pytest
import torch

from differential_equations_resnet_tpu_torch.models import SingleBlockResNet
from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    Antisym3x3Params,
    materialize_3x3_stacked,
    num_cross_pairs,
)
from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi
from differential_equations_resnet_tpu_torch.train import make_adam, make_multi_step
from differential_equations_resnet_tpu_torch.train.train_step import _capture
from differential_equations_resnet_tpu_torch.utils.serving import config_from_json
from differential_equations_resnet_tpu_torch.utils.tracing import STACKS, StackEntry

pytestmark = pytest.mark.cuda

BATCH, H_STEP = 128, 0.125
TOL = 1e-4  # rtol = atol: fp32 sums in another order than cuDNN's
# No image keeps a preactivation |z| within this of 0 (float64) in any
# layer, so no relu-mask element sits where an fp32 recompute could flip
# it (as in test_torch_cuda_kernels.py's wide cases).
MARGIN = 5e-6
STACKS_3X18 = {"32x32x16 L18": (32, 32, 16, 18), "16x16x32 L17": (16, 16, 32, 17),
               "8x8x64 L17": (8, 8, 64, 17)}
MODEL = dict(image_shape=[32, 32, 3], kernel_type="antisymmetric", kernel_size=3, h=H_STEP,
             gamma=0.0, num_stages=4, blocks_per_stage=[18, 18, 18],
             filters_per_block=[16, 32, 64], strides=[[1, 1], [2, 2], [2, 2]],
             include_top=True, fc_activation="softmax", num_classes=10, use_batch_norm=False,
             use_max_pooling=[False] * 4, l2_regularization=0.0, subtract_mean=127.5,
             divide_by_stddev=127.5, integrator="euler", compute_dtype="float32")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs);
    TF32 off for the plain versions' convolutions; the record cleared."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    STACKS.clear()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield
    STACKS.clear()


def case(height, width, channels, layers, seed):
    """x, dense kernels (from packed antisymmetric parameters), biases and a
    cotangent g at batch 128, made with NumPy from ``seed``, on the card:
    the images drawn 128 at a time and kept where their float64 trajectory
    has no |z| within `MARGIN` of 0.  (At batch 128 and these depths no
    seed leaves a whole batch so: a mask flip moves B2's result or the
    plain version's by ~1e-4 of its norm, whichever recompute it hits.)"""
    rng = np.random.default_rng(seed)
    std = np.sqrt(2.0 / (9 * channels))
    draw = lambda *shape: (std * rng.standard_normal((layers, *shape))).astype(np.float32)
    leaves = [draw(channels) for _ in range(4)] + [draw(3, 3, num_cross_pairs(channels))]
    bias = (0.05 * rng.standard_normal((layers, channels))).astype(np.float32)
    blocks = Antisym3x3Params(*[torch.from_numpy(v) for v in (*leaves, bias)])
    kernels, bias = materialize_3x3_stacked(blocks).cuda(), blocks.bias.cuda()
    xs, gs = [], []
    while sum(len(x) for x in xs) < BATCH:
        x = torch.from_numpy(rng.standard_normal((BATCH, height, width, channels))).float().cuda()
        g = torch.from_numpy(rng.standard_normal((BATCH, height, width, channels))).float().cuda()
        y, near = x.double(), torch.zeros(BATCH, dtype=torch.bool, device="cuda")
        for k, b in zip(kernels.double(), bias.double()):
            z = fi._preactivation(y, k, b, torch.float32)
            near |= (z.abs() < MARGIN).flatten(1).any(1)
            y = y + H_STEP * torch.relu(z)
        xs.append(x[~near])
        gs.append(g[~near])
    return torch.cat(xs)[:BATCH], kernels, bias, torch.cat(gs)[:BATCH]


def planned(shape, backward):
    """(bands an image, launches) the planners give B1 (or B2) at batch 128."""
    height, width, channels, _ = shape
    bands = fi.kernel_bands((BATCH, height, width, channels), backward)
    if bands == 1:
        return bands, 1
    return bands, -(-BATCH // fi.resident_images(height, width, channels, bands, backward))


def norm_rel(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


@pytest.mark.parametrize("shape", STACKS_3X18.values(), ids=STACKS_3X18.keys())
def test_stack_kernels_match_plain_versions_eager_and_replayed(card, shape):
    x, kernels, bias, g = case(*shape, seed=sum(shape))
    fwd_bands, fwd_launches = planned(shape, False)
    bwd_bands, bwd_launches = planned(shape, True)
    want = [StackEntry("B1", shape, "band", fwd_bands, fwd_launches),
            StackEntry("B2", shape, "band", bwd_bands, bwd_launches)]

    def both(x, kernels, bias, g):
        return (fi.fused_euler_dense(x, kernels, bias, H_STEP),
                *fi.fused_euler_dense_bwd(x, kernels, bias, g, H_STEP))

    eager = both(x, kernels, bias, g)
    torch.cuda.synchronize()
    assert (STACKS.launches("B1"), STACKS.launches("B2")) == (fwd_launches, bwd_launches)
    assert list(STACKS.eager) == want
    torch.testing.assert_close(eager[0], fi.reference_euler_dense(x, kernels, bias, H_STEP),
                               rtol=TOL, atol=TOL)
    # B2 is judged by a float64 run of its plain version.
    plain = fi.reference_euler_dense_bwd(x, kernels, bias, g, H_STEP)
    judge = fi.reference_euler_dense_bwd(*[t.double() for t in (x, kernels, bias, g)], H_STEP)
    for name, a, w, j in zip(("gx", "gk", "gb"), eager[1:], plain, judge):
        assert norm_rel(a, j) <= 2 * norm_rel(w, j) + 1e-5, name

    graph, outputs, recorded = _capture("stack pair", both, [x, kernels, bias, g])
    assert recorded.entries == want == STACKS.graph("stack pair")
    STACKS.reset()
    for _ in range(2):
        graph.replay()
        STACKS.replay(recorded)
    torch.cuda.synchronize()
    assert (STACKS.launches("B1"), STACKS.launches("B2")) == (2 * fwd_launches, 2 * bwd_launches)
    for name, a, b in zip(("y", "gx", "gk", "gb"), outputs, eager):
        assert torch.equal(a, b), name
    assert list(STACKS.eager)[2:] == want * 3  # the capture's warm-up calls, eager


def test_the_models_captured_step_records_its_stacks(card):
    model = SingleBlockResNet(config_from_json(MODEL), generator=torch.Generator().manual_seed(0),
                              device="cuda")
    multi = make_multi_step(model, make_adam(model.parameters()))
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(0, 255, (3, BATCH, 32, 32, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, (3, BATCH)))
    metrics, _ = multi(images.cuda(), labels.cuda(), [1e-3] * 3)
    assert torch.isfinite(metrics["loss"]).all()
    shapes = list(STACKS_3X18.values())
    want = ([StackEntry("B1", s, "band", *planned(s, False)) for s in shapes]
            + [StackEntry("B2", s, "band", *planned(s, True)) for s in reversed(shapes)])
    assert STACKS.graph("train step") == want
    per_step = [sum(e.launches for e in want if e.kernel == k) for k in ("B1", "B2")]
    # Three warm-up calls, then the capture and three replays.
    assert (STACKS.launches("B1"), STACKS.launches("B2")) == (6 * per_step[0], 6 * per_step[1])
