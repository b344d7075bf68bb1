"""The port's packed antisymmetric kernels against the JAX package and the
loop-level NumPy oracle (tests/reference_numpy.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.ops import antisymmetric as jax_antisym
from differential_equations_resnet_tpu_torch.ops import antisymmetric as torch_antisym
from differential_equations_resnet_tpu_torch.utils.weight_utils import params_to_jax

from reference_numpy import numpy_dense_kernels_from_packed
from torch_parity import both_packed, packed_leaves


@pytest.mark.parametrize("channels", [1, 2, 5, 8])
@pytest.mark.parametrize("gamma", [0.0, 0.3])
def test_materialize_3x3_matches_jax_exactly(channels, gamma):
    rng = np.random.default_rng(channels)
    p_jax, p_torch = both_packed(packed_leaves(rng, channels))
    want = np.asarray(jax_antisym.materialize_3x3(p_jax, gamma=gamma))
    got = torch_antisym.materialize_3x3(p_torch, gamma=gamma).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3, 8])
def test_materialize_3x3_stacked_matches_jax_and_oracle_exactly(channels):
    rng = np.random.default_rng(10 + channels)
    p_jax, p_torch = both_packed(packed_leaves(rng, channels, layers=4))
    gamma = 0.02
    got = torch_antisym.materialize_3x3_stacked(p_torch, gamma=gamma).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_antisym.materialize_3x3_stacked(p_jax, gamma=gamma))
    )
    # The oracle assembles in fp64; every entry is an fp32 value or gamma.
    oracle = numpy_dense_kernels_from_packed(params_to_jax(p_torch), gamma)
    np.testing.assert_array_equal(got, np.stack(oracle).astype(np.float32))
    # The stacked form is the per-layer form, layer by layer.
    for layer in range(4):
        one = torch_antisym.Antisym3x3Params(*[leaf[layer] for leaf in p_torch])
        np.testing.assert_array_equal(
            got[layer], torch_antisym.materialize_3x3(one, gamma=gamma).numpy()
        )


def test_skew_centrosymmetry():
    """K[:, :, i, j] == -rot180(K[:, :, j, i]) for every channel pair, apart
    from the diagonal blocks' centre, which is gamma on both sides."""
    rng = np.random.default_rng(3)
    _, p_torch = both_packed(packed_leaves(rng, 6))
    gamma = 0.25
    k = torch_antisym.materialize_3x3(p_torch, gamma=gamma).numpy()
    mirrored = -k[::-1, ::-1].transpose(0, 1, 3, 2)
    expected_gap = np.zeros_like(k)
    expected_gap[1, 1] = 2 * gamma * np.eye(6, dtype=k.dtype)
    np.testing.assert_array_equal(k - mirrored, expected_gap)


def test_pack_3x3_round_trip():
    rng = np.random.default_rng(4)
    _, p_torch = both_packed(packed_leaves(rng, 5))
    kernel = torch_antisym.materialize_3x3(p_torch, gamma=0.1)
    packed = torch_antisym.pack_3x3(kernel, bias=p_torch.bias)
    for got, want in zip(packed, p_torch):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        torch_antisym.materialize_3x3(packed, gamma=0.1).numpy(), kernel.numpy()
    )


def test_pack_3x3_matches_jax():
    rng = np.random.default_rng(5)
    p_jax, _ = both_packed(packed_leaves(rng, 4))
    dense = np.array(jax_antisym.materialize_3x3(p_jax, gamma=0.0))
    got = torch_antisym.pack_3x3(torch.from_numpy(dense))
    want = jax_antisym.pack_3x3(jnp.asarray(dense))
    for name in ("a", "b", "c", "d", "cross"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


def test_materialize_gradient_folds_onto_packed_leaves():
    """The dense-kernel cotangent folds back onto (a, b, c, d, cross) as the
    JAX scatter's VJP folds it."""
    rng = np.random.default_rng(6)
    leaves = packed_leaves(rng, 4, layers=2)
    p_jax, p_torch = both_packed(leaves)
    weight = rng.standard_normal((2, 3, 3, 4, 4)).astype(np.float32)

    want = jax.grad(
        lambda p: jnp.sum(jax_antisym.materialize_3x3_stacked(p, 0.1) * weight)
    )(p_jax)
    fields = [leaf.requires_grad_() for leaf in p_torch[:5]]
    loss = (torch_antisym.materialize_3x3_stacked(
        torch_antisym.Antisym3x3Params(*fields, p_torch.bias), 0.1
    ) * torch.from_numpy(weight)).sum()
    got = torch.autograd.grad(loss, fields)
    for g, name in zip(got, ("a", "b", "c", "d", "cross")):
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)), atol=1e-6)


def test_he_truncated_normal_statistics():
    """N(0, 2/fan_in) truncated at 2 standard deviations, like the JAX
    draw (the two frameworks' streams differ, their distributions must not)."""
    fan_in, n = 144, 200_000
    stddev = np.sqrt(2.0 / fan_in)
    got = torch_antisym.he_truncated_normal(
        torch.Generator().manual_seed(0), (n,), fan_in
    ).numpy()
    want = np.asarray(jax_antisym.he_truncated_normal(jax.random.key(0), (n,), fan_in))
    assert got.dtype == np.float32
    assert np.abs(got).max() <= 2 * stddev * (1 + 1e-6)
    # Std of a unit normal truncated at +-2: sqrt(1 - 4 phi(2) / (2 Phi(2) - 1)).
    truncated_std = 0.879596 * stddev
    for draws in (got, want):
        assert abs(draws.mean()) < 5 * truncated_std / np.sqrt(n)
        assert abs(draws.std() / truncated_std - 1) < 0.01
    # Same generator state, same draws.
    again = torch_antisym.he_truncated_normal(torch.Generator().manual_seed(0), (n,), fan_in)
    np.testing.assert_array_equal(again.numpy(), got)


def test_init_antisym_3x3_shapes():
    params = torch_antisym.init_antisym_3x3(torch.Generator().manual_seed(1), 6)
    ref = jax_antisym.init_antisym_3x3(jax.random.key(1), 6)
    for got, want in zip(params, ref):
        assert tuple(got.shape) == want.shape
    assert not params.bias.any()
