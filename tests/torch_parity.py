"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with NumPy from a seed and handed to both packages, so the
JAX reference and the port see the same numbers.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.models import blocks as jax_blocks
from differential_equations_resnet_tpu.ops import antisymmetric as jax_antisym
from differential_equations_resnet_tpu_torch.ops import antisymmetric as torch_antisym

# The JAX package's parameter classes, by name, for `params_to_jax`.
JAX_CLASSES = {
    "ConvParams": jax_blocks.ConvParams,
    "DenseParams": jax_blocks.DenseParams,
    "Antisym3x3Params": jax_antisym.Antisym3x3Params,
}


def to_numpy(tree):
    """A JAX tree with NumPy leaves (the form `params_from_jax` takes)."""
    return jax.tree.map(np.asarray, tree)


def packed_leaves(rng, channels, layers=None, bias_scale=0.05):
    """NumPy leaves of packed antisymmetric params (a, b, c, d, cross, bias),
    He-scaled; stacked over ``layers`` when it is not None."""
    lead = () if layers is None else (layers,)
    std = np.sqrt(2.0 / (9 * channels))
    draw = lambda *shape: (std * rng.standard_normal(lead + shape)).astype(np.float32)
    pairs = torch_antisym.num_cross_pairs(channels)
    bias = (bias_scale * rng.standard_normal(lead + (channels,))).astype(np.float32)
    return [draw(channels), draw(channels), draw(channels), draw(channels),
            draw(3, 3, pairs), bias]


def both_packed(leaves):
    """The same packed params as the JAX package's and the port's class."""
    return (
        jax_antisym.Antisym3x3Params(*[jnp.asarray(v) for v in leaves]),
        torch_antisym.Antisym3x3Params(*[torch.from_numpy(v.copy()) for v in leaves]),
    )


def euler_case(batch=4, height=8, width=8, channels=8, layers=3, seed=0, bias_scale=0.05):
    """x (NHWC) and stacked packed params with nonzero biases, for both
    packages: ((x_jax, blocks_jax), (x_torch, blocks_torch))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, height, width, channels)).astype(np.float32)
    blocks_jax, blocks_torch = both_packed(packed_leaves(rng, channels, layers, bias_scale))
    return (jnp.asarray(x), blocks_jax), (torch.from_numpy(x), blocks_torch)


def assert_close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), atol=atol, rtol=rtol,
    )


def require_cuda():
    """Skip the calling test unless a CUDA device is present (decided when
    the test runs, never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py checks the kernel on the card)")
