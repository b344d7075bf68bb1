"""The port's fused Euler integrator against the JAX package's Pallas kernel
(interpret mode on the CPU, as tests/test_pallas.py runs it) and its XLA
reference.  On the CPU the port runs its plain PyTorch version; the kernel
itself is held against that version on the card (the `cuda` test below and
chip_smoke.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from differential_equations_resnet_tpu.ops.antisymmetric import materialize_3x3
from differential_equations_resnet_tpu.ops.pallas import fused_integrator as jax_fi
from differential_equations_resnet_tpu_torch.ops.antisymmetric import materialize_3x3_stacked
from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi

from torch_parity import assert_close, euler_case, require_cuda


def jax_dense(blocks, gamma=0.0):
    return jax.vmap(lambda p: materialize_3x3(p, gamma=gamma))(blocks)


def check_against_jax(case, h, atol=1e-5, matmul_dtype=jnp.float32):
    (x_j, blocks_j), (x_t, blocks_t) = case
    kernels_j = jax_dense(blocks_j)
    with pltpu.force_tpu_interpret_mode():
        pallas = jax_fi.fused_euler_dense(x_j, kernels_j, blocks_j.bias, h, matmul_dtype)
    torch_dtype = torch.bfloat16 if matmul_dtype == jnp.bfloat16 else torch.float32
    got = fi.fused_euler_dense(
        x_t, materialize_3x3_stacked(blocks_t), blocks_t.bias, h, matmul_dtype=torch_dtype
    )
    assert_close(got, pallas, atol=atol)
    if matmul_dtype == jnp.float32:
        xla = jax_fi.reference_euler_dense(x_j, kernels_j, blocks_j.bias, h)
        assert_close(got, xla, atol=atol)


def test_forward_matches_pallas_interpret_and_xla():
    check_against_jax(euler_case(), 0.125)


def test_forward_uneven_batch():
    check_against_jax(euler_case(batch=6, height=4, width=4, channels=4, layers=2), 0.5)


def test_forward_large_biases():
    check_against_jax(euler_case(batch=2, height=6, width=5, channels=8, layers=4,
                                 seed=3, bias_scale=0.5), 0.25)


def test_forward_bf16_operands_match_pallas_interpret():
    check_against_jax(euler_case(batch=2, height=4, width=4, channels=8, layers=3, seed=4),
                      0.125, atol=1e-5, matmul_dtype=jnp.bfloat16)


def test_fused_euler_3x3_with_gamma():
    (x_j, blocks_j), (x_t, blocks_t) = euler_case(batch=2, height=5, width=5,
                                                  channels=4, layers=3, seed=5)
    h, gamma = 0.25, 0.1
    with pltpu.force_tpu_interpret_mode():
        want = jax_fi.fused_euler_3x3(x_j, blocks_j, h, gamma)
    assert_close(fi.fused_euler_3x3(x_t, blocks_t, h, gamma), want, atol=1e-5)


def test_plain_path_stays_differentiable_on_cpu():
    (x_j, blocks_j), (x_t, blocks_t) = euler_case(batch=2, height=4, width=4,
                                                  channels=4, layers=2, seed=6)
    h = 0.2
    kernels_j = jax_dense(blocks_j)
    want = jax.grad(
        lambda x, k, b: jnp.sum(jnp.sin(jax_fi.reference_euler_dense(x, k, b, h))),
        argnums=(0, 1, 2),
    )(x_j, kernels_j, blocks_j.bias)
    leaves = [x_t.clone().requires_grad_(),
              materialize_3x3_stacked(blocks_t).detach().requires_grad_(),
              blocks_t.bias.clone().requires_grad_()]
    loss = torch.sin(fi.fused_euler_dense(*leaves, h)).sum()
    for got, ref in zip(torch.autograd.grad(loss, leaves), want):
        assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_eligibility_gate():
    _, (x, blocks) = euler_case()
    assert fi.fused_euler_eligible(x, blocks)
    assert not fi.fused_euler_eligible(x.to(torch.bfloat16), blocks)
    assert not fi.fused_euler_eligible(x[0], blocks)
    assert not fi.fused_euler_eligible(x.transpose(1, 2), blocks)  # not contiguous
    assert not fi.fused_euler_eligible(x, blocks._replace(bias=None))
    assert not fi.fused_euler_eligible(x, (blocks.a, blocks.bias))
    zeros = lambda *shape: torch.zeros(shape)
    # The serving shape, and the widest C one block's shared memory holds at 32x32.
    assert fi.fused_euler_eligible(zeros(32, 32, 32, 16), blocks)
    assert fi.fused_euler_eligible(zeros(1, 32, 32, 38), blocks)
    assert not fi.fused_euler_eligible(zeros(1, 32, 32, 39), blocks)
    # The JAX gate takes 64x64x16; its padded state (279 KB) does not fit here.
    assert fi.state_smem_bytes(64, 64, 16) > fi.SMEM_LIMIT_BYTES
    assert not fi.fused_euler_eligible(zeros(1, 64, 64, 16), blocks)
    assert fi.fused_euler_eligible(zeros(1, 64, 64, 8), blocks)
    assert not fi.fused_euler_eligible(zeros(1, 65, 64, 4), blocks)  # H*W > 4096
    assert not fi.fused_euler_eligible(zeros(1, 2, 2, 129), blocks)  # C > 128
    assert not fi.fused_euler_eligible(zeros(1, 224, 224, 16), blocks)


def test_declined_shape_raises_before_any_launch():
    """The CUDA wrapper refuses what the kernel cannot take, with
    NotImplementedError, before it builds or launches anything."""
    x = torch.zeros(1, 64, 64, 16)
    kernels, biases = torch.zeros(2, 3, 3, 16, 16), torch.zeros(2, 16)
    with pytest.raises(NotImplementedError, match="shared memory"):
        fi._launch(x, kernels, biases, 0.1, torch.float32)


def test_other_devices_are_refused():
    x = torch.zeros(1, 4, 4, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fi.fused_euler_dense(x, x.new_zeros(1, 3, 3, 4, 4), x.new_zeros(1, 4), 0.1)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_cuda():
    require_cuda()
    _, (x, blocks) = euler_case(batch=3, height=8, width=8, channels=8, layers=3, seed=7)
    x, kernels, bias = x.cuda(), materialize_3x3_stacked(blocks).cuda(), blocks.bias.cuda()
    before = fi.fused_euler_dense.launches
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for dtype in (torch.float32, torch.bfloat16):
            got = fi.fused_euler_dense(x, kernels, bias, 0.125, matmul_dtype=dtype)
            want = fi.reference_euler_dense(x, kernels, bias, 0.125, matmul_dtype=dtype)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert fi.fused_euler_dense.launches == before + 2
    with pytest.raises(NotImplementedError, match="B2"):
        fi.fused_euler_dense(x, kernels.requires_grad_(), bias, 0.125)
    with pytest.raises(NotImplementedError):
        fi.fused_euler_dense(torch.zeros(1, 64, 64, 16, device="cuda"),
                             torch.zeros(1, 3, 3, 16, 16, device="cuda"),
                             torch.zeros(1, 16, device="cuda"), 0.125)
