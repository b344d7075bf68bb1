"""The port's explicit integrators (ops/integrators.py) against the JAX
package's: the order-of-accuracy checks of tests/test_integrators.py, Euler
as the residual block, remat equal to plain in values and gradients, the
trajectory, and each function against the JAX function on the same conv
field and parameters."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.ops import antisymmetric as jax_antisym
from differential_equations_resnet_tpu.ops import conv as jax_conv
from differential_equations_resnet_tpu.ops import integrators as jax_integrators
from differential_equations_resnet_tpu_torch.ops import antisymmetric as torch_antisym
from differential_equations_resnet_tpu_torch.ops import integrators
from differential_equations_resnet_tpu_torch.ops.conv import conv2d_same, conv_relu_field

from torch_parity import euler_case


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs a worker a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def global_error(method, num_steps):
    """Error at t=1 of y' = lambda*y, y(0)=1, lambda as the per-step
    parameter (the stacked-parameter path), in float64."""
    lam = -1.5
    params = torch.full((num_steps,), lam, dtype=torch.float64)
    y = integrators.integrate(lambda y, p: p * y, torch.tensor(1.0, dtype=torch.float64),
                              params, 1.0 / num_steps, method=method)
    return abs(float(y) - float(np.exp(lam)))


@pytest.mark.parametrize("method,order,steps", [("euler", 1, 32), ("midpoint", 2, 16), ("rk4", 4, 4)])
def test_order_of_accuracy(method, order, steps):
    """The observed convergence rate between h and h/2 is the method's
    order, within 0.35 (tests/test_integrators.py's bound)."""
    rate = np.log2(global_error(method, steps) / global_error(method, 2 * steps))
    assert abs(rate - order) < 0.35, (method, rate)


def test_euler_step_is_residual_block():
    y = torch.tensor([1.0, -2.0, 3.0])
    w, b, h = 0.5, 0.1, 0.125
    f = lambda y, p: torch.relu(p["w"] * y + p["b"])
    got = integrators.euler_step(f, y, h, {"w": w, "b": b})
    torch.testing.assert_close(got, y + h * torch.relu(w * y + b), rtol=0, atol=0)


def test_unknown_method_raises_and_stages():
    with pytest.raises(ValueError, match="leapfrog"):
        integrators.get_integrator("leapfrog")
    assert integrators.INTEGRATOR_STAGES == jax_integrators.INTEGRATOR_STAGES


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
def test_remat_matches_plain_in_values_and_gradients(method):
    """Checkpointed layers recompute the same numbers: values and gradients
    bit for bit."""
    f = lambda y, p: torch.tanh(p * y)
    results = []
    for remat in (False, True):
        params = torch.linspace(0.1, 1.0, 8, dtype=torch.float64).requires_grad_()
        y0 = torch.ones(4, dtype=torch.float64, requires_grad=True)
        y = integrators.integrate(f, y0, params, 0.25, method, remat=remat)
        y.sum().backward()
        results.append((y.detach(), params.grad, y0.grad))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    want = jax.grad(lambda p: jnp.sum(jax_integrators.integrate(
        lambda y, q: jnp.tanh(q * y), jnp.ones((4,)), p, 0.25, method, remat=True)))(
        jnp.linspace(0.1, 1.0, 8))
    np.testing.assert_allclose(results[1][1].numpy(), np.asarray(want), rtol=1e-5)


def test_trajectory_shape_and_final_state():
    f = lambda y, p: p * y
    y0 = torch.ones(2, 3)
    params = torch.arange(1.0, 6.0)
    y_final, traj = integrators.integrate_with_trajectory(f, y0, params, 0.01)
    assert traj.shape == (5, 2, 3)
    torch.testing.assert_close(traj[-1], y_final, rtol=0, atol=0)
    torch.testing.assert_close(integrators.integrate(f, y0, params, 0.01), y_final, rtol=0, atol=0)
    want_final, want_traj = jax_integrators.integrate_with_trajectory(
        lambda y, p: p * y, jnp.ones((2, 3)), jnp.arange(1.0, 6.0), 0.01)
    np.testing.assert_allclose(traj.numpy(), np.asarray(want_traj), rtol=1e-6)


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
def test_conv_field_against_jax(method):
    """integrate and integrate_with_trajectory over the ODE field relu(conv(y,
    K_l) + b_l) of 3 materialized antisymmetric layers (4x8x8x8, h = 0.125),
    against the JAX functions on the same field and parameters: states to
    1e-5, and the gradients with respect to y0 and the dense kernels to
    1e-4 relative (fp32 sums in other orders)."""
    (x_j, blocks_j), (x_t, blocks_t) = euler_case(seed=5)
    kernels_j = jax_antisym.materialize_3x3_stacked(blocks_j, 0.0)
    kernels_t = torch_antisym.materialize_3x3_stacked(blocks_t, 0.0)
    h = 0.125

    def jax_field(y, p):
        return jax.nn.relu(jax_conv.conv2d_same(y, p[0], bias=p[1]))

    def jax_loss(x, k):
        return jnp.sum(jnp.sin(jax_integrators.integrate(jax_field, x, (k, blocks_j.bias), h, method)))

    want_final, want_traj = jax_integrators.integrate_with_trajectory(
        jax_field, x_j, (kernels_j, blocks_j.bias), h, method)
    want_grads = jax.grad(jax_loss, argnums=(0, 1))(x_j, kernels_j)

    field = lambda y, p: conv_relu_field(y, p[0], p[1])
    final, traj = integrators.integrate_with_trajectory(
        lambda y, p: torch.relu(conv2d_same(y, p[0], bias=p[1])), x_t, (kernels_t, blocks_t.bias),
        h, method)
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(traj.numpy(), np.asarray(want_traj), rtol=1e-5, atol=1e-5)
    for remat in (False, True):
        x = x_t.clone().requires_grad_()
        k = kernels_t.detach().clone().requires_grad_()
        y = integrators.integrate(field, x, (k, blocks_t.bias), h, method, remat=remat)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_final), rtol=1e-5, atol=1e-5)
        torch.sin(y).sum().backward()
        for got, want in ((x.grad, want_grads[0]), (k.grad, want_grads[1])):
            want = np.asarray(want)
            assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) < 1e-4


def test_layer_slice_and_num_layers():
    tree = {"a": torch.arange(6.0).reshape(3, 2), "b": [torch.zeros(3, 4), None]}
    assert integrators.num_layers(tree) == 3
    one = integrators.layer_slice(tree, 1)
    torch.testing.assert_close(one["a"], torch.tensor([2.0, 3.0]))
    assert one["b"][1] is None and one["b"][0].shape == (4,)
    with pytest.raises(ValueError):
        integrators.num_layers([None])


def test_antisymmetric_field_norm_conservation():
    """With f(y) = A y, A antisymmetric (gamma = 0), the exact flow keeps
    ||y||; RK4 over the materialized antisymmetric conv keeps it to O(h^4)
    (tests/test_integrators.py's check)."""
    channels, steps, h = 4, 50, 0.02
    params = torch_antisym.init_antisym_3x3(torch.Generator().manual_seed(0), channels)
    kernel = torch_antisym.materialize_3x3(params, gamma=0.0)
    y0 = torch.randn(1, 8, 8, channels, generator=torch.Generator().manual_seed(1))
    y = integrators.integrate(lambda y, _: conv2d_same(y, kernel), y0, torch.zeros(steps), h, "rk4")
    assert abs(float(y.norm()) - float(y0.norm())) / float(y0.norm()) < 1e-5
