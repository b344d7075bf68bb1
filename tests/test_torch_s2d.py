"""The port's space-to-depth route (`ops.s2d` and the per-layer "s2d" form
of `models.single_block_resnet`) against the JAX package's: the transforms
and packed parameters bit for bit, packed convs and whole s2d stacks
(Euler, midpoint, RK4) to fp32 tolerance, forward and gradients, and the
gate's decisions."""

import dataclasses
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.models import (
    SingleBlockResNetConfig as JaxConfig,
    build_single_block_resnet as jax_build,
)
from differential_equations_resnet_tpu.ops import s2d as jax_s2d
from differential_equations_resnet_tpu.ops.conv import conv2d_same as jax_conv2d_same
from differential_equations_resnet_tpu.train.train_step import (
    cross_entropy_from_logits as jax_cross_entropy,
)
from differential_equations_resnet_tpu_torch.models import (
    cifar10_single_block_config,
    single_block_resnet as sbr,
)
from differential_equations_resnet_tpu_torch.ops import s2d
from differential_equations_resnet_tpu_torch.ops.conv import conv2d_same
from differential_equations_resnet_tpu_torch.train.train_step import cross_entropy_from_logits
from differential_equations_resnet_tpu_torch.utils.weight_utils import params_to_jax

from torch_parity import JAX_CLASSES, jax_params_with_biases, norm_rel, port_model

FWD_TOL = 1e-5   # packed against direct, or port against JAX: fp32 sums in other orders
GRAD_TOL = 1e-4  # norm-relative, per leaf


@pytest.mark.parametrize("block", [2, 4])
def test_transforms_and_packed_parameters_are_bit_identical(block):
    rng = np.random.default_rng(block)
    x = rng.standard_normal((2, 8, 12, 5)).astype(np.float32)
    packed = s2d.space_to_depth(torch.from_numpy(x), block)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_s2d.space_to_depth(x, block)))
    np.testing.assert_array_equal(s2d.depth_to_space(packed, block).numpy(), x)
    stacked = rng.standard_normal((3, 3, 3, 4, 6)).astype(np.float32)
    for kernel in (stacked, stacked[1]):
        np.testing.assert_array_equal(
            s2d.pack_kernel_s2d(torch.from_numpy(kernel), block).numpy(),
            np.asarray(jax_s2d.pack_kernel_s2d(jnp.asarray(kernel), block)))
    bias = rng.standard_normal((3, 6)).astype(np.float32)
    np.testing.assert_array_equal(s2d.pack_bias_s2d(torch.from_numpy(bias), block).numpy(),
                                  np.asarray(jax_s2d.pack_bias_s2d(jnp.asarray(bias), block)))
    tap, valid = s2d._pack_kernel_indices(block)
    want_tap, want_valid = jax_s2d._pack_kernel_indices(block)
    np.testing.assert_array_equal(tap, want_tap)
    np.testing.assert_array_equal(valid, want_valid)


def test_phase_major_layout():
    """c' = (p*b + q)*C + c, as in the JAX package."""
    x = torch.zeros(1, 4, 4, 3)
    x[0, 1, 0, 2] = 7.0
    packed = s2d.space_to_depth(x, 2)
    assert float(packed[0, 0, 0, (1 * 2 + 0) * 3 + 2]) == 7.0 and float(packed.abs().sum()) == 7.0
    with pytest.raises(ValueError, match="divisible"):
        s2d.space_to_depth(torch.zeros(1, 5, 4, 3), 2)


@pytest.mark.parametrize("block,channels", [(2, 3), (2, 16), (4, 3)])
def test_packed_conv_matches_direct(block, channels):
    """The packed conv, unpacked, against the port's direct conv and the JAX
    package's, to 1e-5 norm-relative."""
    rng = np.random.default_rng(channels)
    x = rng.standard_normal((2, 8, 8, channels)).astype(np.float32)
    k = rng.standard_normal((3, 3, channels, channels)).astype(np.float32)
    b = rng.standard_normal(channels).astype(np.float32)
    xt, kt, bt = (torch.from_numpy(v) for v in (x, k, b))
    packed = conv2d_same(s2d.space_to_depth(xt, block), s2d.pack_kernel_s2d(kt, block),
                         bias=s2d.pack_bias_s2d(bt, block))
    got = s2d.depth_to_space(packed, block)
    assert norm_rel(got, conv2d_same(xt, kt, bias=bt)) <= FWD_TOL
    assert norm_rel(got, jax_conv2d_same(jnp.asarray(x), jnp.asarray(k), bias=jnp.asarray(b))) \
        <= FWD_TOL


def s2d_config(integrator, image_size, **fields):
    """A JAX config at test size with s2d forced on (the CPU gate declines
    packing otherwise, in both packages)."""
    return JaxConfig(image_shape=(image_size, image_size, 3), h=0.25, num_stages=2,
                     blocks_per_stage=(3,), filters_per_block=(6,), strides=((1, 1),),
                     num_classes=5, subtract_mean=127.5, divide_by_stddev=127.5,
                     integrator=integrator, s2d_block=2, s2d_force=True, **fields)


@pytest.mark.parametrize("integrator,image_size,kernel_type", [
    ("euler", 66, "antisymmetric"),
    ("midpoint", 8, "antisymmetric"),
    ("rk4", 8, "regular"),
])
def test_s2d_stacks_match_jax(integrator, image_size, kernel_type):
    """The s2d_force model against the JAX package's s2d_force model from
    the same params: logits to 1e-5 and every parameter gradient of the
    cross-entropy to 1e-4 norm-relative.  The Euler stack is at 66x66,
    past the fused route's reach (H*W <= 4096), where the port takes s2d;
    midpoint and RK4 take it at any size."""
    config = s2d_config(integrator, image_size, kernel_type=kernel_type)
    jax_model = jax_build(config)
    params, state = jax_params_with_biases(jax_model, 3)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 255, (2, image_size, image_size, 3)).astype(np.float32)
    y = rng.integers(0, 5, 2).astype(np.int32)

    def jax_loss(p):
        logits, _ = jax_model.apply(p, state, jnp.asarray(x), return_logits=True)
        return jax_cross_entropy(logits, jnp.asarray(y)), logits

    (_, want_logits), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    model = port_model(config, params)
    sbr.per_layer_counts.update(int8=0, s2d=0, direct=0)
    logits = model(torch.from_numpy(x), return_logits=True)
    assert sbr.per_layer_counts == {"int8": 0, "s2d": 1, "direct": 0}
    cross_entropy_from_logits(logits, torch.from_numpy(y)).backward()
    assert norm_rel(logits, want_logits) <= FWD_TOL
    grads = params_to_jax(sbr.map_leaves(lambda p: p.grad, model.params()), JAX_CLASSES)
    got, want = jax.tree.leaves(grads), jax.tree.leaves(want_grads)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert norm_rel(g, w) <= GRAD_TOL


def test_s2d_equals_the_direct_stack_on_the_port():
    """The same port model with and without s2d_force: logits to 1e-5."""
    config = s2d_config("rk4", 8)
    params, _ = jax_params_with_biases(jax_build(config), 5)
    x = torch.from_numpy(np.random.default_rng(6).uniform(0, 255, (2, 8, 8, 3))
                         .astype(np.float32))
    packed = port_model(config, params)
    direct = port_model(dataclasses.replace(config, s2d_force=False), params)
    with torch.no_grad():
        assert norm_rel(packed(x, return_logits=True), direct(x, return_logits=True)) <= FWD_TOL


def on_card(*shape):
    """A stand-in for a CUDA tensor of ``shape``: the gate reads only the
    shape and the device."""
    return types.SimpleNamespace(shape=shape, is_cuda=True)


def test_gate_decisions():
    """The JAX rule except its default: on the card nothing is packed
    unless s2d_force or an explicit s2d_max_rows says so; on the CPU only
    s2d_force packs; 3x3 and divisible H, W only; int8 overrides it."""
    base = cifar10_single_block_config(num_layers=4, num_filters=16, s2d_block=2)
    cpu = torch.zeros(32, 32, 32, 16)
    assert not sbr._s2d_eligible(base, cpu)
    assert not sbr._s2d_eligible(dataclasses.replace(base, s2d_max_rows=1 << 20), cpu)
    assert sbr._s2d_eligible(dataclasses.replace(base, s2d_force=True), cpu)
    assert not sbr._s2d_eligible(base, on_card(32, 32, 32, 16))
    assert not sbr._s2d_eligible(base, on_card(1, 2, 2, 16))
    rows = dataclasses.replace(base, s2d_max_rows=32768)
    assert sbr._s2d_eligible(rows, on_card(32, 32, 32, 16))
    assert not sbr._s2d_eligible(rows, on_card(64, 32, 32, 16))
    forced = dataclasses.replace(base, s2d_force=True)
    assert not sbr._s2d_eligible(dataclasses.replace(forced, s2d_block=0), cpu)
    assert not sbr._s2d_eligible(forced, torch.zeros(2, 7, 7, 16))
    centro = dataclasses.replace(forced, kernel_type="centrosymmetric", kernel_size=5)
    assert not sbr._s2d_eligible(centro, cpu)
    assert sbr.per_layer_form(forced, cpu) == "s2d"
    assert sbr.per_layer_form(dataclasses.replace(forced, int8_forward=True), cpu) == "int8"
    assert sbr.per_layer_form(base, cpu) == "direct"


def test_odd_images_fall_back_to_the_direct_stack():
    """s2d_force on 7x7 images runs the direct stack instead of failing."""
    config = s2d_config("midpoint", 7)
    params, _ = jax_params_with_biases(jax_build(config), 7)
    model = port_model(config, params)
    sbr.per_layer_counts.update(int8=0, s2d=0, direct=0)
    with torch.no_grad():
        out = model(torch.zeros(1, 7, 7, 3))
    assert out.shape == (1, 5) and sbr.per_layer_counts["direct"] == 1
