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
The epilogues (relu, residual add and relu) give the separate torch ops'
bits forward, at 0, -0.0 and NaN; the relu backward gives the plain
kernels' bits on threshold_backward's gradient; a ResNet-50 step with the
epilogues is the step with separate ops bit for bit.
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
# A ResNet-50 step's batch-norm calls by variant (the record's): relu after
# the stem and each block's bn1 and bn2, the residual add and relu after
# each block's last batch norm, none after the conv blocks' bn3.
RESNET50_VARIANTS = {"forward": 4, "forward+relu": 33, "forward+add_relu": 16,
                     "backward": 20, "backward+relu": 33}


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
        assert variant_counts(recorded.entries) == RESNET50_VARIANTS
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


def variant_counts(entries):
    counts = {}
    for e in entries:
        if e.kernel == "BN":
            counts[e.variant] = counts.get(e.variant, 0) + 1
    return counts


def same_bits(a, b):
    """Equal bytes: NaNs and signed zeros compare exactly."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def edge_case(shape, seed=0):
    """`bn_case` whose batch norm and epilogues meet 0, -0.0 and NaN:
    channel 0 constant with a negative scale and a -0.0 offset (y -0.0),
    channel 1 constant with a 0 offset (y +0.0), channel 2 with a NaN (its
    y NaN); a residual that is -y at a quarter of the places (y + residual
    +0.0), -0.0 at another quarter and NaN at one."""
    x, scale, offset, mean, var, dy = bn_case(shape, seed)
    x[..., 0], x[..., 1] = 1.5, -0.25
    x.view(-1, shape[-1])[x.numel() // shape[-1] // 2, 2] = float("nan")
    scale[0], offset[0], offset[1] = -1.0, -0.0, 0.0
    y, _ = fbn.reference_batch_norm(x, scale, offset, mean, var, BN_EPSILON, BN_MOMENTUM)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pick = torch.randint(0, 4, shape, device="cuda", generator=gen)
    residual = torch.randn(shape, device="cuda", generator=gen)
    residual = torch.where(pick == 0, -y, torch.where(pick == 1, torch.full_like(y, -0.0),
                                                      residual))
    residual.view(-1)[residual.numel() // 3] = float("nan")
    return x, scale, offset, mean, var, dy, residual


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_each_epilogue_is_the_torch_ops_bit_for_bit(card, shape):
    """The apply with "relu" or "add_relu" writes torch.relu of the plain
    apply's y (of y + residual), and of the plain version's, bit for bit,
    signed zeros and NaNs included; the statistics are unchanged; one
    launch a call, recorded under the epilogue's variant."""
    x, scale, offset, mean, var, _, residual = edge_case(shape)
    y, stats = fbn._launch(x, scale, offset, mean, var, BN_EPSILON, BN_MOMENTUM)
    assert torch.signbit(y[..., 0]).all() and (y[..., 0] == 0).all()
    for epilogue, res, want in (("relu", None, torch.relu(y)),
                                ("add_relu", residual, torch.relu(y + residual))):
        before = STACKS.launches("BN", "forward+" + epilogue)
        out, out_stats = fbn._launch(x, scale, offset, mean, var, BN_EPSILON, BN_MOMENTUM,
                                     epilogue, res)
        torch.cuda.synchronize()
        assert STACKS.launches("BN", "forward+" + epilogue) - before == 1
        assert same_bits(out, want), epilogue
        assert same_bits(out_stats, stats), epilogue
        plain, _ = fbn.reference_batch_norm(x, scale, offset, mean, var, BN_EPSILON, BN_MOMENTUM,
                                            epilogue, res)
        assert same_bits(out, plain), epilogue
    assert torch.isnan(out[..., 2]).all() and ((out == 0) & ~torch.signbit(out)).any()


def near_zero_case(shape, seed=1):
    """x on a coarse grid (many equal values a channel), a tenth of it one
    ulp above and a tenth one ulp below its channel's median value, and
    offsets chosen so that y is exactly 0 wherever x is that median value
    and a few ulps from 0 at its neighbours."""
    x, scale, _, mean, var, dy = bn_case(shape, seed)
    rows = x.view(-1, shape[-1])
    rows.copy_(torch.round(rows * 2) / 2)
    pick = rows.median(0).values.expand_as(rows)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draw = torch.rand(rows.shape, device="cuda", generator=gen)
    up, down = (draw < 0.1) & (rows == pick), (draw > 0.9) & (rows == pick)
    rows.copy_(torch.where(up, torch.nextafter(pick, pick + 1), rows))
    rows.copy_(torch.where(down, torch.nextafter(pick, pick - 1), rows))
    t, _ = fbn.reference_batch_norm(x, scale, torch.zeros_like(scale), mean, var, BN_EPSILON,
                                    BN_MOMENTUM)
    hit = (rows == pick).float().argmax(0)
    offset = -t.view(-1, shape[-1])[hit, torch.arange(shape[-1], device="cuda")]
    return x, scale, offset.contiguous(), mean, var, dy


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_relu_backward_is_the_kernels_on_threshold_backward(card, shape):
    """The backward with "relu" (the mask recomputed in the kernels) gives
    dx, dscale and doffset bit for bit as the plain backward kernels on
    threshold_backward(dout, relu's output, 0), with many y at 0 exactly and
    next to it; three launches, recorded as "backward+relu"."""
    x, scale, offset, mean, var, dy = near_zero_case(shape)
    out, stats = fbn._launch(x, scale, offset, mean, var, BN_EPSILON, BN_MOMENTUM, "relu")
    y, _ = fbn._launch(x, scale, offset, mean, var, BN_EPSILON, BN_MOMENTUM)
    assert int((y == 0).sum()) >= x.numel() // 100, "too few y at 0"
    assert int(((y != 0) & (y.abs() < 1e-5)).sum()) >= x.numel() // 200, "too few y next to 0"
    before = STACKS.launches("BN", "backward+relu")
    got = fbn._launch_bwd(dy, x, stats, scale, offset, "relu")
    torch.cuda.synchronize()
    assert STACKS.launches("BN", "backward+relu") - before == LAUNCHES_A_LAYER - 1
    want = fbn._launch_bwd(torch.ops.aten.threshold_backward(dy, out, 0), x, stats, scale)
    for name, a, b in zip(("dx", "dscale", "doffset"), got, want):
        assert same_bits(a, b), name
    plain = fbn.reference_batch_norm_bwd(dy, x, stats, scale, offset, "relu")
    eps = torch.finfo(torch.float32).eps
    for name, a, b in zip(("dx", "dscale", "doffset"), got, plain):
        assert norm_rel(a, b) <= 8 * eps, name


def test_add_relu_autograd_masks_once_for_both_inputs(card):
    """`fused_batch_norm` with "add_relu": the residual's gradient is
    threshold_backward(dout, out, 0), and x's, scale's and offset's are the
    plain kernels' on it, bit for bit."""
    x, scale, offset, mean, var, dy, residual = edge_case((8, 14, 14, 256), seed=2)
    x[..., 2] = 0.5  # no NaN: every gradient finite
    leaves = [t.clone().requires_grad_() for t in (x, scale, offset, residual)]
    out, stats = fbn.fused_batch_norm(*leaves[:3], mean, var, BN_EPSILON, BN_MOMENTUM,
                                      "add_relu", leaves[3])
    got = torch.autograd.grad(out, leaves, dy)
    masked = torch.ops.aten.threshold_backward(dy, out.detach(), 0)
    assert same_bits(got[3], masked)
    for a, b in zip(got[:3], fbn._launch_bwd(masked, x, stats, scale)):
        assert same_bits(a, b)


@pytest.mark.parametrize("epilogue", ["relu", "add_relu"])
@pytest.mark.parametrize("dtype,train,fused", [
    (torch.float32, True, True), (torch.float32, False, False), (torch.bfloat16, True, False)])
def test_the_route_applies_the_epilogue_on_the_card(card, dtype, train, fused, epilogue):
    """`blocks.batch_norm` with an epilogue on a CUDA tensor: the kernels in
    train-mode fp32, the composite and torch ops otherwise, the same output
    bit for bit (fp32) on either."""
    from differential_equations_resnet_tpu_torch.models import blocks

    x, scale, offset, mean, var, _, residual = edge_case((4, 7, 7, 64), seed=3)
    x, residual = x.to(dtype), (residual.to(dtype) if epilogue == "add_relu" else None)
    params, state = blocks.BatchNormParams(scale, offset), blocks.BatchNormState(mean, var)
    before = STACKS.calls("BN", "forward+" + epilogue)
    out, new_state = blocks.batch_norm(x, params, state, train, epilogue, residual)
    assert STACKS.calls("BN", "forward+" + epilogue) - before == (1 if fused else 0)
    y, want_state = blocks.composite_batch_norm(x, params, state, train)
    assert same_bits(out, fbn.epilogue_of(y, epilogue, residual))
    assert same_bits(new_state.mean, want_state.mean)


def test_resnet50_step_with_epilogues_is_the_separate_ops_step_bit_for_bit(card, monkeypatch):
    """A ResNet-50 train step (batch 8, 32x32, cuDNN deterministic) whose
    batch norms take their epilogues gives the logits, every parameter's
    gradient and the new running statistics bit for bit as the step whose
    kernels write y and leave the relu and the residual add to torch ops,
    as the model ran before the epilogues."""
    from differential_equations_resnet_tpu_torch.models import blocks
    from differential_equations_resnet_tpu_torch.train.train_step import build_loss_fn

    rng = np.random.default_rng(9)
    images = torch.from_numpy(rng.uniform(0, 255, (8, 32, 32, 3)).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 10, 8)).cuda()

    def step():
        model = _resnet50(seed=4)
        loss, logits = build_loss_fn(model)(images, labels)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return [logits.detach(), *grads, *[b.clone() for b in model.buffers()]]

    real = blocks.fused_batch_norm

    def separate(x, scale, offset, mean, var, epsilon, momentum, epilogue="none", residual=None):
        y, stats = real(x, scale, offset, mean, var, epsilon, momentum)
        return fbn.epilogue_of(y, epilogue, residual), stats

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        before = {v: STACKS.calls("BN", v) for v in RESNET50_VARIANTS}
        fused = step()
        assert {v: STACKS.calls("BN", v) - before[v] for v in RESNET50_VARIANTS} == \
            RESNET50_VARIANTS
        monkeypatch.setattr(blocks, "fused_batch_norm", separate)
        plain = step()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert len(fused) == len(plain)
    for i, (a, b) in enumerate(zip(fused, plain)):
        assert same_bits(a, b), i
