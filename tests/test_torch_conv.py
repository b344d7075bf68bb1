"""The port's `conv2d_same` against the JAX package's (TF "SAME" padding,
asymmetric at stride 2)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.ops.conv import conv2d_same as jax_conv2d_same
from differential_equations_resnet_tpu_torch.ops.conv import conv2d_same, same_padding

from reference_numpy import numpy_conv2d_same


@pytest.mark.parametrize("size", [(8, 8), (7, 9), (5, 4)])
@pytest.mark.parametrize("strides", [(1, 1), (2, 2), (2, 1)])
@pytest.mark.parametrize("kernel_size", [3, 1])
def test_conv2d_same_matches_jax(size, strides, kernel_size):
    rng = np.random.default_rng(sum(size) + 10 * strides[0] + kernel_size)
    x = rng.standard_normal((2, *size, 3)).astype(np.float32)
    kernel = rng.standard_normal((kernel_size, kernel_size, 3, 5)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    want = np.asarray(jax_conv2d_same(
        jnp.asarray(x), jnp.asarray(kernel), strides=strides, bias=jnp.asarray(bias)
    ))
    got = conv2d_same(
        torch.from_numpy(x), torch.from_numpy(kernel), strides=strides,
        bias=torch.from_numpy(bias),
    )
    assert got.is_contiguous() and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), numpy_conv2d_same(x, kernel, strides, bias), atol=1e-5
    )


def test_same_padding_is_asymmetric_at_stride_2():
    assert same_padding(8, 3, 1) == (1, 1)
    assert same_padding(8, 3, 2) == (0, 1)
    assert same_padding(7, 3, 2) == (1, 1)
    assert same_padding(8, 1, 2) == (0, 0)
