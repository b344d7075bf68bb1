"""The port's general k x k (anti-)centrosymmetric kernels against the JAX
package: layout, materialization, packing, init statistics and the
gradient that folds back onto the packed leaves (the centrosymmetric centre
included)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.ops import antisymmetric as jax_antisym
from differential_equations_resnet_tpu_torch.ops import antisymmetric as torch_antisym


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs a worker a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def kxk_leaves(rng, k, channels, antisymmetric, layers=None):
    """NumPy (diag, cross, bias) of packed k x k params, He-scaled."""
    lead = () if layers is None else (layers,)
    std = np.sqrt(2.0 / (k * k * channels))
    n_free = jax_antisym.num_diag_free(k, antisymmetric)
    draw = lambda *shape: (std * rng.standard_normal(lead + shape)).astype(np.float32)
    return [draw(n_free, channels), draw(k, k, torch_antisym.num_cross_pairs(channels)),
            (0.05 * rng.standard_normal(lead + (channels,))).astype(np.float32)]


def both(leaves):
    return (jax_antisym.AntisymKxKParams(*[jnp.asarray(v) for v in leaves]),
            torch_antisym.AntisymKxKParams(*[torch.from_numpy(v.copy()) for v in leaves]))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("antisymmetric", [True, False])
def test_layout_matches_jax(k, antisymmetric):
    free, mirror, center = torch_antisym._diag_layout(k, antisymmetric)
    want_free, want_mirror, want_center = jax_antisym._diag_layout(k, antisymmetric)
    np.testing.assert_array_equal(free, want_free)
    np.testing.assert_array_equal(mirror, want_mirror)
    assert center == want_center
    assert torch_antisym.num_diag_free(k, antisymmetric) == jax_antisym.num_diag_free(k, antisymmetric)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("antisymmetric", [True, False])
@pytest.mark.parametrize("layers", [None, 3])
def test_materialize_matches_jax_exactly(k, antisymmetric, layers):
    """Every entry is a free value, its negation or gamma: bit for bit."""
    rng = np.random.default_rng(k + 10 * antisymmetric + (layers or 0))
    p_jax, p_torch = both(kxk_leaves(rng, k, 5, antisymmetric, layers))
    for gamma in (0.0, 0.3):
        want = np.asarray(jax_antisym.materialize_kxk(p_jax, k, gamma, antisymmetric))
        got = torch_antisym.materialize_kxk(p_torch, k, gamma, antisymmetric).numpy()
        assert got.shape == ((layers,) if layers else ()) + (k, k, 5, 5)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("antisymmetric", [True, False])
def test_pack_matches_jax_and_inverts_materialize(k, antisymmetric):
    rng = np.random.default_rng(20 + k)
    leaves = kxk_leaves(rng, k, 4, antisymmetric)
    p_jax, p_torch = both(leaves)
    dense = torch_antisym.materialize_kxk(p_torch, k, 0.2, antisymmetric)
    got = torch_antisym.pack_kxk(dense, p_torch.bias, antisymmetric)
    want = jax_antisym.pack_kxk(jnp.asarray(dense.numpy()), p_jax.bias, antisymmetric)
    for g, w, leaf in zip(got, want, leaves):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), leaf)
    # A stacked kernel packs layer by layer.
    stacked = torch_antisym.materialize_kxk(
        both(kxk_leaves(rng, k, 4, antisymmetric, layers=2))[1], k, 0.0, antisymmetric)
    packed = torch_antisym.pack_kxk(stacked, None, antisymmetric)
    for layer in range(2):
        one = torch_antisym.pack_kxk(stacked[layer], None, antisymmetric)
        torch.testing.assert_close(packed.diag[layer], one.diag, rtol=0, atol=0)
        torch.testing.assert_close(packed.cross[layer], one.cross, rtol=0, atol=0)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("antisymmetric", [True, False])
def test_gradient_folds_back_as_jax_grad(k, antisymmetric):
    """The gradient of sum(W * materialize_kxk(p)) with respect to the packed
    leaves, stacked over 2 layers, against jax.grad: each free entry
    collects its own and its mirror's cotangents, and the centrosymmetric
    centre (in both the free and the mirror list) collects its one
    cotangent once.  Sums of two fp32 values: to 1e-6."""
    rng = np.random.default_rng(30 + k)
    leaves = kxk_leaves(rng, k, 4, antisymmetric, layers=2)
    p_jax, p_torch = both(leaves)
    weights = rng.standard_normal((2, k, k, 4, 4)).astype(np.float32)

    def jax_loss(diag, cross):
        p = jax_antisym.AntisymKxKParams(diag, cross, None)
        return jnp.sum(jnp.asarray(weights) * jax_antisym.materialize_kxk(p, k, 0.1, antisymmetric))

    want = jax.grad(jax_loss, argnums=(0, 1))(p_jax.diag, p_jax.cross)
    diag, cross = (p_torch.diag.requires_grad_(), p_torch.cross.requires_grad_())
    dense = torch_antisym.materialize_kxk(
        torch_antisym.AntisymKxKParams(diag, cross, None), k, 0.1, antisymmetric)
    torch.sum(torch.from_numpy(weights) * dense).backward()
    for got, w in ((diag.grad, want[0]), (cross.grad, want[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    if not antisymmetric:
        # The centre entry: its cotangent once, not twice.
        free, _, _ = torch_antisym._diag_layout(k, False)
        centre = int(np.flatnonzero(free == (k * k) // 2)[0])
        i = k // 2
        np.testing.assert_allclose(diag.grad[:, centre].numpy(),
                                   np.einsum("lcc->lc", weights[:, i, i]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k,antisymmetric", [(3, False), (5, False), (5, True)])
def test_init_statistics_match_jax(k, antisymmetric):
    """He truncated normal with fan_in = k*k*C: shapes equal; over all free
    entries (diag and cross, thousands of draws) the standard deviations
    within 3% of 0.8796 * sqrt(2 / fan_in) (the truncation at 2 sigma),
    means near 0, nothing past 2 sigma; bias zero."""
    channels = 32
    got = torch_antisym.init_antisym_kxk(torch.Generator().manual_seed(0), k, channels,
                                         antisymmetric=antisymmetric)
    want = jax_antisym.init_antisym_kxk(jax.random.key(0), k, channels,
                                        antisymmetric=antisymmetric)
    sigma = np.sqrt(2.0 / (k * k * channels))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
    for draws in (np.concatenate([t.numpy().ravel() for t in got[:2]]),
                  np.concatenate([np.asarray(t).ravel() for t in want[:2]])):
        assert abs(draws.std() / (0.8796 * sigma) - 1) < 0.03
        assert abs(draws.mean()) < 0.05 * sigma
        assert np.abs(draws).max() <= 2 * sigma + 1e-6
    assert not got.bias.any()
    assert torch_antisym.init_antisym_kxk(torch.Generator(), 3, 4, use_bias=False).bias is None


def test_centrosymmetric_and_antisymmetric_structure():
    """Diagonal blocks are centrosymmetric (K = rot180(K)) with a free centre,
    or anti-centrosymmetric with the gamma centre; cross blocks are always
    -rot180 mirrors."""
    rng = np.random.default_rng(40)
    for antisymmetric, gamma in ((False, 0.0), (True, 0.25)):
        _, p = both(kxk_leaves(rng, 5, 3, antisymmetric))
        kernel = torch_antisym.materialize_kxk(p, 5, gamma, antisymmetric).numpy()
        for c in range(3):
            block = kernel[:, :, c, c]
            sign = -1.0 if antisymmetric else 1.0
            off_centre = np.ones((5, 5), bool)
            off_centre[2, 2] = False
            np.testing.assert_array_equal(block[off_centre], (sign * block[::-1, ::-1])[off_centre])
            if antisymmetric:
                assert block[2, 2] == np.float32(gamma)
        for i in range(3):
            for j in range(3):
                if i != j:
                    np.testing.assert_array_equal(kernel[:, :, i, j], -kernel[::-1, ::-1, j, i])
