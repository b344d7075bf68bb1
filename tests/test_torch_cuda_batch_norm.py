"""Train-mode batch norm's hand-written kernels (`csrc/batch_norm.cu`) against
their plain PyTorch versions on the card.

Every test here needs a CUDA device and skips itself without one.  The file
imports neither JAX nor the JAX package (nor the test helpers that do), so it
runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_batch_norm.py

The kernels run at ResNet-50's nine batch-norm shapes at batch 32 and
224x224 and at the single-block family's C = 8 and 16; `blocks.batch_norm`
sends only train-mode fp32 to them; two runs give the same
bits; a captured ResNet-50 train step, replayed twice, gives the eager step's
logits and batch-norm gradients bit for bit, with 53 x 4 launches a step.
"""

import numpy as np
import pytest
import torch

from differential_equations_resnet_tpu_torch.models.blocks import BN_EPSILON, BN_MOMENTUM
from differential_equations_resnet_tpu_torch.ops.kernels import batch_norm as fbn
from differential_equations_resnet_tpu_torch.utils.tracing import STACKS

pytestmark = pytest.mark.cuda

# ResNet-50's batch norms at batch 32, 224x224: (N, H, W, C).
RESNET50_SHAPES = [(32, 112, 112, 64), (32, 56, 56, 64), (32, 56, 56, 256), (32, 28, 28, 128),
                   (32, 28, 28, 512), (32, 14, 14, 256), (32, 14, 14, 1024), (32, 7, 7, 512),
                   (32, 7, 7, 2048)]
SHAPES = RESNET50_SHAPES + [(32, 32, 32, 8), (32, 32, 32, 16), (3, 5, 7, 6)]
LAUNCHES_A_LAYER = 4  # the forward's apply (after torch.var_mean), three backward
RESNET50_BATCH_NORMS = 53  # the stem, 16 blocks x 3, 4 shortcuts


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py checks the kernels on the card)")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield


def bn_case(shape, seed=0):
    """x (mean about 2, spread 3), scale, offset, running mean and variance,
    and a cotangent, on the card."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    arrays = [2.0 + 3.0 * rng.standard_normal(shape), 1.0 + 0.1 * rng.standard_normal(c),
              0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c),
              rng.uniform(0.5, 1.5, c), rng.standard_normal(shape)]
    return [torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays]


def norm_rel(got, want):
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()).clamp_min(1e-30))


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_kernels_match_the_plain_version(card, shape):
    """y, mean, inv and the running statistics are the plain version's (the
    composite's forward) bit for bit: the kernel's rsqrtf is torch's rsqrt;
    dx, dscale, doffset within fp32 rounding of it (both take fp64 sums);
    one launch forward, three backward, and two runs bit for bit."""
    x, scale, offset, mean, var, dy = bn_case(shape)
    eps = torch.finfo(torch.float32).eps
    before = STACKS.launches("BN", "forward"), STACKS.launches("BN", "backward")
    y, stats = fbn._launch(x, scale, offset, mean, var, BN_EPSILON, BN_MOMENTUM)
    grads = fbn._launch_bwd(dy, x, stats, scale)
    torch.cuda.synchronize()
    assert (STACKS.launches("BN", "forward") - before[0],
            STACKS.launches("BN", "backward") - before[1]) == (1, LAUNCHES_A_LAYER - 1)
    want_y, want_stats = fbn.reference_batch_norm(x, scale, offset, mean, var, BN_EPSILON,
                                                  BN_MOMENTUM)
    assert torch.equal(stats, want_stats)
    assert torch.equal(y, want_y)
    want = fbn.reference_batch_norm_bwd(dy, x, stats, scale)
    for name, a, b in zip(("dx", "dscale", "doffset"), grads, want):
        assert norm_rel(a, b) <= 8 * eps, name
    again = fbn._launch(x, scale, offset, mean, var, BN_EPSILON, BN_MOMENTUM)
    again_grads = fbn._launch_bwd(dy, x, stats, scale)
    for a, b in zip((y, stats, *grads), (*again, *again_grads)):
        assert torch.equal(a, b)


def test_unaligned_tensors_take_one_channel_a_thread(card):
    """A tensor that starts off a 16-byte boundary runs with one channel a
    thread: its forward is the plain version's bit for bit and its backward
    the aligned run's (torch.var_mean itself reduces an unaligned tensor in
    another order, so the aligned run's statistics are not the yardstick)."""
    x, scale, offset, mean, var, dy = bn_case((4, 6, 6, 64), seed=3)
    store = torch.empty(x.numel() + 1, device="cuda")
    shifted = store[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 and fbn._plan(shifted)["vec"] == 1
    y, stats = fbn._launch(shifted, scale, offset, mean, var, BN_EPSILON, BN_MOMENTUM)
    want_y, want_stats = fbn.reference_batch_norm(shifted, scale, offset, mean, var, BN_EPSILON,
                                                  BN_MOMENTUM)
    assert torch.equal(stats, want_stats) and torch.equal(y, want_y)
    grads = fbn._launch_bwd(dy, shifted, stats, scale)
    for a, b in zip(grads, fbn._launch_bwd(dy, x, stats, scale)):
        assert torch.equal(a, b)


def test_the_autograd_function_on_the_card(card):
    """`fused_batch_norm` on CUDA tensors: the gradient of sum(sin(y)) with
    respect to x, scale and offset is the backward kernel's."""
    x, scale, offset, mean, var, _ = bn_case((8, 14, 14, 256), seed=5)
    leaves = [t.clone().requires_grad_() for t in (x, scale, offset)]
    y, stats = fbn.fused_batch_norm(*leaves, mean, var, BN_EPSILON, BN_MOMENTUM)
    got = torch.autograd.grad(torch.sin(y).sum(), leaves)
    want = fbn._launch_bwd(torch.cos(y.detach()), x, stats, scale)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,train,fused", [
    (torch.float32, True, True), (torch.float32, False, False), (torch.bfloat16, True, False),
    (torch.float16, True, False), (torch.float64, True, False)])
def test_the_route_on_the_card(card, dtype, train, fused):
    """`blocks.batch_norm` on a CUDA tensor: train mode in fp32 takes the
    kernels (four launches, the composite's y and running statistics bit
    for bit); eval mode and every other dtype take the composite."""
    from differential_equations_resnet_tpu_torch.models import blocks

    x, scale, offset, mean, var, _ = bn_case((4, 7, 7, 64), seed=3)
    x = x.to(dtype).requires_grad_()
    params, state = blocks.BatchNormParams(scale, offset), blocks.BatchNormState(mean, var)
    before = STACKS.launches("BN")
    y, new_state = blocks.batch_norm(x, params, state, train)
    torch.autograd.grad(y.float().sum(), x)
    torch.cuda.synchronize()
    assert (type(y.grad_fn).__name__ == "FusedBatchNormBackward") == fused
    assert STACKS.launches("BN") - before == (LAUNCHES_A_LAYER if fused else 0)
    want_y, want_state = blocks.composite_batch_norm(x.detach(), params, state, train)
    if fused:
        assert torch.equal(y.detach(), want_y)
        assert torch.equal(new_state.mean, want_state.mean)
        assert torch.equal(new_state.var, want_state.var)


def _resnet50(seed=0):
    from differential_equations_resnet_tpu_torch.models import build_resnet, resnet_preset

    config = resnet_preset("resnet50", 10, antisymmetric_mid=True, image_shape=(32, 32, 3))
    return build_resnet(config, generator=torch.Generator().manual_seed(seed), device="cuda")


def test_captured_resnet50_step_replays_the_eager_step_bit_for_bit(card):
    """A ResNet-50 forward and backward (batch 8, 32x32, cuDNN deterministic)
    run eagerly, then captured in a CUDA graph and replayed twice: the
    logits and the gradients of every batch-norm scale and offset are the
    eager step's bit for bit in both replays.  The eager step launches
    53 x 4 batch-norm kernels, the graph holds as many, and each replay
    counts them."""
    from differential_equations_resnet_tpu_torch.train.train_step import _capture, build_loss_fn

    model = _resnet50()
    loss_fn = build_loss_fn(model)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    bn = [i for i, n in enumerate(names) if "bn" in n]  # scales and offsets, stacked by stage

    def step(images, labels):
        loss, logits = loss_fn(images, labels)
        grads = torch.autograd.grad(loss, params)
        return (logits.detach(), *[grads[i] for i in bn])  # no graph kept past the step

    rng = np.random.default_rng(7)
    images = torch.from_numpy(rng.uniform(0, 255, (8, 32, 32, 3)).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 10, 8)).cuda()
    per_step = RESNET50_BATCH_NORMS * LAUNCHES_A_LAYER
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        before = STACKS.launches("BN")
        eager = [t.clone() for t in step(images, labels)]
        torch.cuda.synchronize()
        assert STACKS.launches("BN") - before == per_step
        graph, outputs, recorded = _capture("bn step", step, [images, labels],
                                            keep=list(model.buffers()))
        assert sum(e.launches for e in recorded.entries if e.kernel == "BN") == per_step
        for _ in range(2):
            before = STACKS.launches("BN")
            graph.replay()
            STACKS.replay(recorded)
            torch.cuda.synchronize()
            assert STACKS.launches("BN") - before == per_step
            for i, (a, b) in enumerate(zip(outputs, eager)):
                assert torch.equal(a, b), ("logits" if i == 0 else names[bn[i - 1]])
    finally:
        torch.backends.cudnn.deterministic = deterministic
