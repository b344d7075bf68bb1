"""The port's fused Euler integrator, forward and backward, against the JAX
package's Pallas kernels (interpret mode on the CPU, as tests/test_pallas.py
runs them) and its XLA reference.  On the CPU the port runs its plain PyTorch
versions through the same autograd Function the card uses; the kernels
themselves are held against those versions on the card
(tests/test_torch_cuda_kernels.py and chip_smoke.py)."""

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

from torch_parity import assert_close, euler_case, norm_rel


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


def backward_case(case, h, seed, matmul_dtype=jnp.float32):
    """(port grads, Pallas-interpret grads, XLA-reference grads) of
    <y_L, w> for a random cotangent w, for (x, kernels, biases)."""
    (x_j, blocks_j), (x_t, blocks_t) = case
    kernels_j = jax_dense(blocks_j)
    w = np.random.default_rng(seed).standard_normal(x_t.shape).astype(np.float32)
    loss = lambda fn: (lambda x, k, b: jnp.vdot(fn(x, k, b), jnp.asarray(w)))
    with pltpu.force_tpu_interpret_mode():
        pallas = jax.grad(loss(lambda x, k, b: jax_fi.fused_euler_dense(
            x, k, b, h, matmul_dtype)), argnums=(0, 1, 2))(x_j, kernels_j, blocks_j.bias)
    xla = jax.grad(loss(lambda x, k, b: jax_fi.reference_euler_dense(x, k, b, h)),
                   argnums=(0, 1, 2))(x_j, kernels_j, blocks_j.bias)
    leaves = [x_t.clone().requires_grad_(),
              materialize_3x3_stacked(blocks_t).detach().requires_grad_(),
              blocks_t.bias.clone().requires_grad_()]
    torch_dtype = torch.bfloat16 if matmul_dtype == jnp.bfloat16 else torch.float32
    y = fi.fused_euler_dense(*leaves, h, matmul_dtype=torch_dtype)
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), leaves)
    return got, pallas, xla


@pytest.mark.parametrize("shape,h", [
    (dict(batch=2, height=6, width=6, channels=4, layers=3), 0.2),
    (dict(batch=3, height=5, width=7, channels=8, layers=4, bias_scale=0.5), 0.25),
])
def test_backward_matches_pallas_interpret_and_xla(shape, h):
    """fp32: (gx, gk, gb) against jax.grad of the Pallas custom VJP (its
    backward kernel runs: grid <= 64) and of the XLA scan, to 1e-5
    (fp32 sums in a different order)."""
    got, pallas, xla = backward_case(euler_case(**shape, seed=8), h, seed=9)
    for g, p, r, name in zip(got, pallas, xla, ("x", "kernels", "biases")):
        assert_close(g, p, atol=1e-5, rtol=1e-5)
        assert_close(g, r, atol=1e-5, rtol=1e-5)


def test_backward_bf16_operands_match_pallas_interpret():
    """bf16 mode: the forward recompute and g_z * K^T take bf16 operands,
    dK and db stay fp32; against the Pallas backward kernel in bf16 mode
    (grid 1, so it runs, not the fp32 XLA fallback).  Both round the same
    operands and sum in fp32, so they agree to fp32 reordering, 1e-5."""
    case = euler_case(batch=2, height=4, width=4, channels=8, layers=3, seed=10)
    got, pallas, _ = backward_case(case, 0.125, seed=11, matmul_dtype=jnp.bfloat16)
    for g, p in zip(got, pallas):
        assert_close(g, p, atol=1e-5, rtol=1e-5)
    # And the bf16 rounding is visible: fp32 gradients differ from these.
    fp32, _, _ = backward_case(case, 0.125, seed=11)
    assert norm_rel(got[0], fp32[0].numpy()) > 1e-5


def test_packed_fold_back_through_fused_euler_3x3():
    """Gradients of the packed leaves (a, b, c, d, cross, bias) with gamma
    != 0 against jax.grad of the Pallas fused_euler_3x3, at a tiny shape."""
    (x_j, blocks_j), (x_t, blocks_t) = euler_case(batch=2, height=4, width=4,
                                                  channels=4, layers=2, seed=12)
    h, gamma = 0.25, 0.1
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda b: jnp.sum(jax_fi.fused_euler_3x3(x_j, b, h, gamma) ** 2))(blocks_j)
    leaves = type(blocks_t)(*[t.clone().requires_grad_() for t in blocks_t])
    loss = torch.sum(fi.fused_euler_3x3(x_t, leaves, h, gamma) ** 2)
    got = torch.autograd.grad(loss, list(leaves))
    for g, w, name in zip(got, want, blocks_t._fields):
        assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_plain_backward_gradcheck_float64():
    """The plain backward is the exact adjoint of the plain forward: finite
    differences in float64 (relu kinks are far from these inputs' z)."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((2, 5, 4, 3)))
    kernels = torch.from_numpy(0.3 * rng.standard_normal((2, 3, 3, 3, 3)))
    biases = torch.from_numpy(0.1 * rng.standard_normal((2, 3)))
    leaves = [t.clone().requires_grad_() for t in (x, kernels, biases)]
    assert torch.autograd.gradcheck(lambda a, k, b: fi.fused_euler_dense(a, k, b, 0.3), leaves)


def test_function_saves_only_the_input_state():
    """The graph keeps (x, kernels, biases), one state whatever the depth,
    as the JAX custom VJP does."""
    _, (x, blocks) = euler_case(batch=2, height=4, width=4, channels=4, layers=5, seed=14)
    kernels = materialize_3x3_stacked(blocks).detach().requires_grad_()
    y = fi.fused_euler_dense(x, kernels, blocks.bias, 0.1)
    saved = y.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [tuple(x.shape), tuple(kernels.shape),
                                               tuple(blocks.bias.shape)]
    with torch.no_grad():
        assert fi.fused_euler_dense(x, kernels, blocks.bias, 0.1).grad_fn is None


def test_eligibility_gate():
    _, (x, blocks) = euler_case()
    assert fi.fused_euler_eligible(x, blocks)
    assert not fi.fused_euler_eligible(x.to(torch.bfloat16), blocks)
    assert not fi.fused_euler_eligible(x[0], blocks)
    assert not fi.fused_euler_eligible(x.transpose(1, 2), blocks)  # not contiguous
    assert not fi.fused_euler_eligible(x, blocks._replace(bias=None))
    assert not fi.fused_euler_eligible(x, (blocks.a, blocks.bias))
    zeros = lambda *shape: torch.zeros(shape)
    # The serving shape, and the widest C a band's shared memory holds at
    # 32x32 (in 16 bands); one block per image held C <= 38.
    assert fi.fused_euler_eligible(zeros(32, 32, 32, 16), blocks)
    assert fi.fused_euler_eligible(zeros(1, 32, 32, 38), blocks)
    assert fi.kernel_variant((1, 32, 32, 64)) == "band"
    # Past the band's reach the wide variant takes it, as the JAX gate does.
    assert fi.kernel_variant((1, 32, 32, 65)) == "wide"
    assert fi.fused_euler_eligible(zeros(1, 32, 32, 65), blocks)
    assert fi.fused_euler_eligible(zeros(1, 32, 32, 128), blocks)
    # The JAX gate takes 64x64x16: its padded state (279 KB) does not fit one
    # block, but a band of 16 rows does.
    assert fi.state_smem_bytes(64, 64, 16) > fi.SMEM_LIMIT_BYTES
    assert fi.min_bands(64, 64, 16) == 4
    assert fi.fused_euler_eligible(zeros(1, 64, 64, 16), blocks)
    assert fi.fused_euler_eligible(zeros(1, 64, 64, 8), blocks)
    assert not fi.fused_euler_eligible(zeros(1, 65, 64, 4), blocks)  # H*W > 4096
    assert not fi.fused_euler_eligible(zeros(1, 2, 2, 129), blocks)  # C > 128
    assert not fi.fused_euler_eligible(zeros(1, 224, 224, 16), blocks)


def test_backward_eligibility_gate():
    _, (x, blocks) = euler_case()
    zeros = lambda *shape: torch.zeros(shape)
    assert fi.fused_euler_eligible(x, blocks)
    assert not fi.fused_euler_eligible(x, blocks._replace(bias=None))
    # The training shape in its 4 bands: 128,304 B a block (y_l and K^T
    # double buffered); a whole image does not fit one block.
    assert fi.bwd_smem_bytes(32, 32, 16, 4) == 128_304
    assert fi.bwd_smem_bytes(32, 32, 16) > fi.SMEM_LIMIT_BYTES
    assert fi.fused_euler_eligible(zeros(32, 32, 32, 16), blocks)
    # At 32x32 the band B2 takes C <= 56 (it took C <= 21), B1 C <= 64; the
    # wide B2 takes the rest of the reach.
    assert fi.fused_euler_eligible(zeros(1, 32, 32, 21), blocks)
    assert fi.fused_euler_eligible(zeros(1, 32, 32, 22), blocks)
    assert fi.kernel_variant((1, 32, 32, 56), backward=True) == "band"
    assert fi.kernel_variant((1, 32, 32, 57), backward=True) == "wide"
    assert fi.kernel_variant((1, 32, 32, 57)) == "band"
    assert fi.fused_euler_eligible(zeros(1, 32, 32, 57), blocks)
    assert fi.fused_euler_eligible(zeros(1, 64, 64, 16), blocks)
    assert not fi.fused_euler_eligible(zeros(1, 2, 2, 129), blocks)


def test_declined_shape_raises_before_any_launch():
    """The CUDA wrappers refuse what the JAX gate refuses, with ValueError,
    before they build or launch anything (C = 129, H*W = 4160); the shapes
    the band variant declines (C = 100 at 1x1, C = 60 at 32x32 in the
    backward) go to the wide variant."""
    for shape in ((1, 2, 2, 129), (1, 65, 64, 4)):
        channels = shape[-1]
        x = torch.zeros(shape)
        kernels, biases = torch.zeros(2, 3, 3, channels, channels), torch.zeros(2, channels)
        with pytest.raises(ValueError, match="JAX kernel gate"):
            fi._launch(x, kernels, biases, 0.1, torch.float32)
        with pytest.raises(ValueError, match="JAX kernel gate"):
            fi._launch_bwd(x, kernels, biases, x, 0.1, torch.float32)
    launched = []
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(fi, "_launch_wide", lambda *args: launched.append("fwd") or args[0])
        patch.setattr(fi, "_launch_bwd_wide", lambda *args: launched.append("bwd") or args[:3])
        x = torch.zeros(1, 1, 1, 100)  # one layer's kernel alone is 360 KB
        fi._launch(x, torch.zeros(2, 3, 3, 100, 100), torch.zeros(2, 100), 0.1, torch.float32)
        x = torch.zeros(1, 32, 32, 60)
        kernels, biases = torch.zeros(2, 3, 3, 60, 60), torch.zeros(2, 60)
        fi._launch_bwd(x, kernels, biases, x, 0.1, torch.float32)
    assert launched == ["fwd", "bwd"]


def test_function_declines_before_the_forward_launch(monkeypatch):
    """A CUDA input that the band B1 takes and the band B2 declines (C = 60
    at 32x32) trains: the forward launches the band B1 and the backward the
    wide B2, with no raise; under no_grad the forward alone runs.  A shape
    past the JAX reach raises before any launch.  The dispatcher routes B1's
    op by the tensor's real device, so the op is replaced by its CUDA
    kernel here."""
    launched = []
    monkeypatch.setattr(fi, "_launch", lambda *args: launched.append("fwd") or args[0])
    monkeypatch.setattr(fi, "fused_euler_fwd_op", fi._fused_euler_fwd_cuda)
    monkeypatch.setattr(fi, "_launch_bwd", lambda x, k, b, g, *rest: launched.append("bwd") or (
        g, torch.zeros_like(k), torch.zeros_like(b)))
    x = torch.zeros(1, 32, 32, 60)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda", 0)))
    kernels = torch.zeros(1, 3, 3, 60, 60, requires_grad=True)
    y = fi.FusedEulerDense.apply(x, kernels, torch.zeros(1, 60), 0.1, torch.float32)
    y.sum().backward()
    assert launched == ["fwd", "bwd"] and kernels.grad is not None
    assert fi.kernel_variant(x.shape) == "band" and fi.kernel_variant(x.shape, True) == "wide"
    with torch.no_grad():
        fi.fused_euler_dense(x, kernels, torch.zeros(1, 60), 0.1)
    assert launched == ["fwd", "bwd", "fwd"]


def test_other_devices_are_refused():
    x = torch.zeros(1, 4, 4, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fi.fused_euler_dense(x, x.new_zeros(1, 3, 3, 4, 4), x.new_zeros(1, 4), 0.1)
