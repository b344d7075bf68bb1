"""The port's `conv2d_same` against the JAX package's (TF "SAME" padding,
asymmetric at stride 2), values and gradients, and its `euler_relu_step` and
`conv_relu_field` against `jax.grad` of the JAX functions."""

import inspect
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.ops import conv as jax_conv
from differential_equations_resnet_tpu.ops.conv import conv2d_same as jax_conv2d_same
from differential_equations_resnet_tpu_torch.ops.conv import (
    _fp32_conv_context,
    conv2d_same,
    conv_relu_field,
    euler_relu_step,
    same_padding,
)

from reference_numpy import numpy_conv2d_same
from torch_parity import assert_close


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


@pytest.mark.parametrize("size,strides", [((8, 8), (1, 1)), ((8, 8), (2, 2)), ((7, 9), (2, 1))])
def test_conv2d_same_gradients_match_jax(size, strides):
    """The backward of the autograd Function (the one that keeps TF32 off
    on the card) against jax.grad, including the asymmetric stride-2 pad."""
    rng = np.random.default_rng(sum(size) + strides[0])
    x = rng.standard_normal((2, *size, 3)).astype(np.float32)
    kernel = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    out_shape = jax_conv2d_same(jnp.asarray(x), jnp.asarray(kernel), strides=strides).shape
    w = rng.standard_normal(out_shape).astype(np.float32)
    want = jax.grad(
        lambda a, k, b: jnp.vdot(jax_conv2d_same(a, k, strides=strides, bias=b), w),
        argnums=(0, 1, 2),
    )(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    leaves = [torch.from_numpy(v).requires_grad_() for v in (x, kernel, bias)]
    out = conv2d_same(leaves[0], leaves[1], strides=strides, bias=leaves[2])
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for g, r in zip(got, want):
        assert_close(g, r, atol=1e-4, rtol=1e-5)


def step_case(seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((2, 6, 5, 4)).astype(np.float32)
    kernel = (0.3 * rng.standard_normal((3, 3, 4, 4))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(4)).astype(np.float32)
    w = rng.standard_normal(y.shape).astype(np.float32)
    return y, kernel, bias, w


@pytest.mark.parametrize("name", ["euler_relu_step", "conv_relu_field"])
def test_mask_backward_matches_jax_grad(name):
    """Values and the three gradients against jax.grad of the JAX custom
    VJPs (to 1e-5: fp32 sums in a different order); the saved residual
    is a torch.bool relu mask, not the fp32 pre-activation."""
    y, kernel, bias, w = step_case(seed=20 + len(name))
    h = 0.3
    jax_fn = {"euler_relu_step": lambda a, k, b: jax_conv.euler_relu_step(a, k, b, h),
              "conv_relu_field": jax_conv.conv_relu_field}[name]
    port_fn = {"euler_relu_step": lambda a, k, b: euler_relu_step(a, k, b, h),
               "conv_relu_field": conv_relu_field}[name]
    args = [jnp.asarray(v) for v in (y, kernel, bias)]
    want_out = jax_fn(*args)
    want = jax.grad(lambda a, k, b: jnp.vdot(jax_fn(a, k, b), w), argnums=(0, 1, 2))(*args)
    leaves = [torch.from_numpy(v).requires_grad_() for v in (y, kernel, bias)]
    out = port_fn(*leaves)
    assert_close(out, want_out, atol=1e-5)
    saved = out.grad_fn.saved_tensors
    assert [t.dtype for t in saved] == [torch.float32, torch.float32, torch.bool]
    assert saved[2].shape == out.shape
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for g, r in zip(got, want):
        assert_close(g, r, atol=1e-5, rtol=1e-5)


def test_mask_steps_refuse_a_missing_bias():
    y, kernel, _, _ = step_case(seed=30)
    with pytest.raises(ValueError, match="bias"):
        euler_relu_step(torch.from_numpy(y), torch.from_numpy(kernel), None, 0.1)
    with pytest.raises(ValueError, match="bias"):
        conv_relu_field(torch.from_numpy(y), torch.from_numpy(kernel), None)


def cudnn_flags():
    """Every cuDNN flag `torch.backends.cudnn.flags` names on this torch (its
    signature differs between versions), and the conv precision that
    ``allow_tf32`` sets."""
    cudnn = torch.backends.cudnn
    flags = {name: getattr(cudnn, name) for name in inspect.signature(cudnn.flags).parameters
             if hasattr(cudnn, name)}
    if hasattr(cudnn, "conv"):
        flags["conv.fp32_precision"] = cudnn.conv.fp32_precision
    return flags


@pytest.mark.parametrize("caller", [
    dict(deterministic=True, benchmark=True),
    dict(deterministic=True, benchmark=False, allow_tf32=False),
    dict(enabled=False, deterministic=False, benchmark=True),
], ids=["deterministic-benchmark", "deterministic-no-tf32", "disabled"])
def test_fp32_conv_context_changes_only_allow_tf32(caller):
    """The context every CUDA convolution of the port runs in (entered
    through `_fp32_conv_context` on a tensor that reports CUDA) turns
    ``allow_tf32`` off and leaves every other cuDNN flag as the caller set
    it (``torch.backends.cudnn.flags`` would reset ``deterministic`` and
    ``benchmark``); on exit every flag is the caller's again."""
    cudnn = torch.backends.cudnn
    before = {name: getattr(cudnn, name) for name in ("enabled", "deterministic", "benchmark",
                                                      "allow_tf32")}
    try:
        for name, value in caller.items():
            setattr(cudnn, name, value)
        outside = cudnn_flags()
        with _fp32_conv_context(types.SimpleNamespace(is_cuda=True)):
            inside = cudnn_flags()
        after = cudnn_flags()
    finally:
        for name, value in before.items():
            setattr(cudnn, name, value)
    assert inside["allow_tf32"] is False
    assert {k: v for k, v in inside.items() if k not in ("allow_tf32", "conv.fp32_precision")} == {
        k: v for k, v in outside.items() if k not in ("allow_tf32", "conv.fp32_precision")}
    assert after == outside


def test_fp32_conv_context_is_a_no_op_on_the_cpu():
    """On a CPU tensor the context touches no flag."""
    outside = cudnn_flags()
    with _fp32_conv_context(torch.zeros(1)):
        assert cudnn_flags() == outside
