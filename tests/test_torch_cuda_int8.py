"""The int8 convolutions (`ops.quantize`) and the space-to-depth route on the
card against the CPU: quantized operands and int32 accumulators equal, the
weight-gradient correlation equal, int8 and s2d train steps captured in a
CUDA graph against eager steps, and int8 serving against the CPU.

Every test here needs a CUDA device and skips itself without one.  The file
imports neither JAX nor the JAX package (nor the test helpers that do), so
it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_int8.py

Inputs are made with NumPy from a seed.  chip_smoke.py holds the same ops at
the main path's full-width shapes.
"""

import numpy as np
import pytest
import torch

from differential_equations_resnet_tpu_torch.ops import quantize as q

pytestmark = pytest.mark.cuda

OUT_TOL = 1e-6    # the rescaled conv output, norm-relative
SERVE_TOL = 1e-2  # quantized logits: stem sums differ in the last bit, a quantizer may flip


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs);
    TF32 off for the fp32 convolutions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py checks int8 on the card)")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield


def norm_rel(got, want):
    return float((got.double().cpu() - want.double().cpu()).norm() / want.double().cpu().norm())


@pytest.mark.parametrize("batch,size,cin,cout,k,stride", [
    (4, 16, 16, 32, 3, 1),   # the trunk conv
    (1, 7, 8, 8, 3, 1),      # M = 49, K = 72: padded to the GEMM's multiples of 8
    (2, 14, 16, 24, 3, 2),   # v1.5's strided 3x3: SAME pads after the image
    (2, 14, 32, 16, 1, 2),   # v1's strided 1x1
    (2, 9, 8, 16, 5, 1),
])
def test_int8_conv_on_the_card_equals_the_cpu(card, batch, size, cin, cout, k, stride):
    rng = np.random.default_rng(batch + size + k)
    x = torch.from_numpy(rng.standard_normal((batch, size, size, cin)).astype(np.float32))
    kern = torch.from_numpy((0.1 * rng.standard_normal((k, k, cin, cout))).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    strides = (stride, stride)
    qp = q.quantize_kernel_per_cout(kern, bias)
    qp_card = q.quantize_kernel_per_cout(kern.cuda(), bias.cuda())
    assert torch.equal(qp_card.kernel_q.cpu(), qp.kernel_q)
    assert torch.equal(qp_card.scale.cpu(), qp.scale)
    z, yq, s_y = q._dynamic_int8_conv_parts(x, qp, strides)
    z_card, yq_card, s_card = q._dynamic_int8_conv_parts(x.cuda(), qp_card, strides)
    assert torch.equal(yq_card.cpu(), yq) and torch.equal(s_card.cpu(), s_y)
    assert torch.equal(q.int8_conv_same(yq_card, qp_card.kernel_q, strides).cpu(),
                       q.int8_conv_same(yq, qp.kernel_q, strides))
    assert norm_rel(z_card, z) <= OUT_TOL


@pytest.mark.parametrize("k,channels", [(3, 8), (3, 32), (5, 16)])
def test_int8_wgrad_on_the_card_equals_the_cpu(card, k, channels):
    rng = np.random.default_rng(k * channels)
    yq = torch.from_numpy(rng.integers(-127, 128, (4, 12, 12, channels)).astype(np.int8))
    gq = torch.from_numpy(rng.integers(-127, 128, (4, 12, 12, channels)).astype(np.int8))
    assert torch.equal(q._int8_wgrad(yq.cuda(), gq.cuda(), (k, k)).cpu(),
                       q._int8_wgrad(yq, gq, (k, k)))


def _captured_against_eager(config, steps=3, batch=4, size=32):
    """``steps`` train steps replayed from one captured step against eager
    steps of a twin from the same seed: the losses, the grad-norm rows and
    the parameters after Adam."""
    from differential_equations_resnet_tpu_torch.models import build_single_block_resnet
    from differential_equations_resnet_tpu_torch.train import (
        make_adam,
        make_multi_step,
        make_train_step,
    )

    models = [build_single_block_resnet(config, generator=torch.Generator().manual_seed(0),
                                        device="cuda") for _ in range(2)]
    optimizers = [make_adam(m.parameters()) for m in models]
    rng = np.random.default_rng(7)
    images = torch.from_numpy(
        rng.uniform(0, 255, (steps, batch, size, size, 3)).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, 10, (steps, batch))).cuda()
    metrics, norms = make_multi_step(models[0], optimizers[0])(images, labels, [1e-3] * steps)
    eager = make_train_step(models[1], optimizers[1])
    for i in range(steps):
        m, n = eager(images[i], labels[i], 1e-3)
        torch.testing.assert_close(metrics["loss"][i], m["loss"], rtol=1e-5, atol=0)
        torch.testing.assert_close(norms[i], n, rtol=1e-3, atol=0)
    for p, w in zip(*[m.parameters() for m in models]):
        torch.testing.assert_close(p, w, rtol=0, atol=1e-5)
    return metrics


@pytest.mark.parametrize("integrator,mode", [("euler", "wgrad"), ("rk4", "full")])
def test_captured_int8_step_equals_the_eager_step(card, integrator, mode):
    """An int8 train step captures in a CUDA graph: its activation scales
    are taken anew at every replay (no host value baked in), so replayed
    steps follow the eager ones."""
    from differential_equations_resnet_tpu_torch.models import cifar10_single_block_config
    from differential_equations_resnet_tpu_torch.models import single_block_resnet as sbr

    config = cifar10_single_block_config(num_layers=3, num_filters=16, integrator=integrator,
                                         int8_forward=True, int8_backward=mode)
    sbr.per_layer_counts.update(int8=0, s2d=0, direct=0)
    _captured_against_eager(config)
    assert sbr.per_layer_counts["int8"] > 0 and sbr.per_layer_counts["s2d"] == 0


def test_captured_s2d_step_equals_the_eager_step(card):
    """A midpoint stack forced into space-to-depth (its gather indices made
    on the card before the capture) replays as its eager twin steps."""
    from differential_equations_resnet_tpu_torch.models import cifar10_single_block_config
    from differential_equations_resnet_tpu_torch.models import single_block_resnet as sbr

    config = cifar10_single_block_config(num_layers=3, num_filters=8, integrator="midpoint",
                                         s2d_block=2, s2d_force=True, final_time=0.375)
    sbr.per_layer_counts.update(int8=0, s2d=0, direct=0)
    _captured_against_eager(config)
    assert sbr.per_layer_counts["s2d"] > 0 and sbr.per_layer_counts["int8"] == 0


def test_int8_serving_on_the_card_equals_the_cpu(card):
    """`make_quantized_forward` of a 128-wide trunk (over the gate) on the
    card against the same model on the CPU."""
    from differential_equations_resnet_tpu_torch.models import (
        build_single_block_resnet,
        cifar10_single_block_config,
        make_quantized_forward,
    )

    config = cifar10_single_block_config(num_layers=2, num_filters=128)
    on_card = build_single_block_resnet(config, generator=torch.Generator().manual_seed(1),
                                        device="cuda")
    on_cpu = build_single_block_resnet(config, params=on_card.params(), device="cpu")
    x = torch.from_numpy(np.random.default_rng(8).uniform(0, 255, (4, 32, 32, 3))
                         .astype(np.float32))
    got = make_quantized_forward(on_card, return_logits=True)(x.cuda())
    want = make_quantized_forward(on_cpu, return_logits=True)(x)
    assert norm_rel(got, want) <= SERVE_TOL
