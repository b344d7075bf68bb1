"""B1 as a dispatcher op (``deqres_torch::fused_euler_fwd``): on CPU tensors
it is `reference_euler_dense` bit for bit, its fake implementation gives the
output's shape and dtype, `torch.export` of a fused-route stack records it
as one node, and its CUDA kernel hands `_launch` a contiguous state."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from differential_equations_resnet_tpu_torch.models import (
    build_single_block_resnet,
    cifar10_single_block_config,
)
from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi


def operands(layers, channels, seed, batch=2, size=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, size, size, channels)).astype(np.float32)
    k = (0.2 * rng.standard_normal((layers, 3, 3, channels, channels))).astype(np.float32)
    b = (0.1 * rng.standard_normal((layers, channels))).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, k, b)]


@pytest.mark.parametrize("layers", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_op_on_cpu_is_the_plain_version(layers, dtype):
    x, k, b = operands(layers, 5, 40 + layers)
    got = torch.ops.deqres_torch.fused_euler_fwd(x, k, b, 0.125, dtype)
    want = fi.reference_euler_dense(x, k, b, 0.125, dtype)
    assert torch.equal(got, want)
    assert got.data_ptr() != x.data_ptr()  # never an alias of its input, at L = 0 too
    assert torch.equal(fi.fused_euler_dense(x, k, b, 0.125, dtype), want)


def test_fake_implementation_gives_shape_and_dtype():
    with FakeTensorMode():
        x = torch.empty(3, 8, 8, 4)
        y = fi.fused_euler_fwd_op(x, torch.empty(2, 3, 3, 4, 4), torch.empty(2, 4), 0.5,
                                  torch.float32)
    assert tuple(y.shape) == (3, 8, 8, 4) and y.dtype == torch.float32


@pytest.mark.parametrize("kernel_type,integrator,calls", [
    ("antisymmetric", "euler", 1), ("regular", "euler", 1), ("antisymmetric", "rk4", 0)])
def test_export_records_the_op(kernel_type, integrator, calls):
    """A fused-route stack is one node of B1's op in the exported graph; a
    per-layer stack (RK4) holds none."""
    model = build_single_block_resnet(
        cifar10_single_block_config(num_layers=2, num_filters=4, kernel_type=kernel_type,
                                    integrator=integrator),
        generator=torch.Generator().manual_seed(1), device="cpu")

    class Forward(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, images):
            return self.model(images)

    x = torch.rand(2, 32, 32, 3) * 255
    with torch.no_grad():
        program = torch.export.export(Forward(), (x,))
        targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
        assert targets.count(torch.ops.deqres_torch.fused_euler_fwd.default) == calls
        assert torch.equal(program.module()(x), model(x))


def test_cuda_kernel_launches_on_a_contiguous_state(monkeypatch):
    """The op's CUDA kernel is `_launch` on the state made contiguous (an
    exported graph keeps the strides of the device it was traced on)."""
    seen = []
    monkeypatch.setattr(fi, "_launch", lambda x, *rest: seen.append(x.is_contiguous()) or x)
    x, k, b = operands(1, 4, 3)
    fi._fused_euler_fwd_cuda(x.permute(0, 2, 1, 3), k, b, 0.1, torch.float32)
    assert seen == [True]
