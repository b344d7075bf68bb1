"""The port's bottleneck ResNet family and what only it needs against the JAX
package, on the CPU: the dense-lower antisymmetric layout (conversions bit
for bit, materialization equal to the packed one), `conv2d_valid` and
`antisym_conv2d_3x3` in both layouts with their gradients, the presets, and
the model's forward in eval and train mode with its new running statistics,
v1 and v1.5, antisymmetric and regular mid-convs, at narrow widths and at
ResNet-50's full widths.  Inputs and parameters are made with NumPy from a
seed; parameters and state come over by `params_from_jax` and
`state_from_jax`."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.models import bottleneck_resnet as jax_bottleneck
from differential_equations_resnet_tpu.ops import antisymmetric as jax_antisym
from differential_equations_resnet_tpu.ops import conv as jax_conv
from differential_equations_resnet_tpu.utils import weight_utils as jax_weight_utils
from differential_equations_resnet_tpu.utils.serving import _config_to_json
from differential_equations_resnet_tpu_torch.models import bottleneck_resnet as bottleneck
from differential_equations_resnet_tpu_torch.ops import antisymmetric as antisym
from differential_equations_resnet_tpu_torch.ops import conv
from differential_equations_resnet_tpu_torch.utils import weight_utils
from differential_equations_resnet_tpu_torch.utils.serving import config_from_json

from torch_parity import (
    BOTTLENECK_CASES as CASES,
    BOTTLENECK_IDS as IDS,
    JAX_CLASSES,
    drawn_bottleneck_trees,
    narrow_bottleneck_config as narrow_config,
    norm_rel,
    packed_leaves,
    port_model,
)

EVAL_TOL = 1e-5    # logits, norm-relative (the golden fixture's 5e-5 bound elementwise)
TRAIN_TOL = 1e-4   # logits in train mode, norm-relative: see test_torch_batch_norm.py
STATE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs a worker a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def both_layouts(seed, channels=6, layers=None):
    """The same packed params for both packages, and each package's
    dense-lower conversion of them."""
    leaves = packed_leaves(np.random.default_rng(seed), channels, layers)
    jax_packed = jax_antisym.Antisym3x3Params(*leaves)
    packed = antisym.Antisym3x3Params(*[torch.from_numpy(a.copy()) for a in leaves])
    return (jax_packed, jax_antisym.dense_from_packed(jax_packed)), (
        packed, antisym.dense_from_packed(packed))


@pytest.mark.parametrize("layers", [None, 3], ids=["one", "stacked"])
def test_dense_and_packed_layouts_round_trip_bit_for_bit(layers):
    """dense_from_packed equals the JAX package's, packed_from_dense gives
    the packed params back, both bit for bit; the dense cross is zero off
    its strictly lower (c_in > c_out) triangle."""
    (_, jax_dense), (packed, dense) = both_layouts(0, layers=layers)
    for got, want in zip(dense, jax_dense):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not torch.any(dense.cross.triu() != 0)
    for got, want in zip(antisym.packed_from_dense(dense), packed):
        assert torch.equal(got, want)


def test_dense_init_draws_what_the_packed_init_draws():
    packed = antisym.init_antisym_3x3(torch.Generator().manual_seed(4), 7)
    dense = antisym.init_antisym_3x3_dense(torch.Generator().manual_seed(4), 7)
    assert dense.cross.shape == (3, 3, 7, 7)
    for got, want in zip(antisym.packed_from_dense(dense), packed):
        assert torch.equal(got, want)


@pytest.mark.parametrize("layers", [None, 3], ids=["one", "stacked"])
def test_materialize_from_dense_equals_the_packed_materialization(layers):
    """materialize_3x3_from_dense (mask, flip, transpose, add) gives
    materialize_3x3's kernel bit for bit and the JAX package's, for one
    layer and for a stack at once; its gradient lands only on the free
    (strictly lower) cross entries."""
    (_, jax_dense), (packed, dense) = both_layouts(1, layers=layers)
    got = antisym.materialize_3x3_from_dense(dense, gamma=0.05)
    materialize = antisym.materialize_3x3 if layers is None else antisym.materialize_3x3_stacked
    np.testing.assert_array_equal(got.numpy(), materialize(packed, gamma=0.05).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_antisym.materialize_3x3_from_dense(jax_dense, gamma=0.05)))
    cross = dense.cross.clone().requires_grad_()
    kernel = antisym.materialize_3x3_from_dense(dense._replace(cross=cross))
    (grad,) = torch.autograd.grad((kernel * torch.randn_like(kernel)).sum(), cross)
    assert torch.all(grad.triu() == 0) and torch.any(grad.tril(-1) != 0)


def test_convert_antisym_layout_matches_jax():
    """Every antisymmetric leaf of a tree converted both ways, bit for bit,
    as the JAX package converts it; other leaves pass through."""
    (jax_packed, jax_dense), (packed, dense) = both_layouts(2)
    tree = {"a": [packed, {"b": torch.ones(3)}]}
    to_dense = weight_utils.convert_antisym_layout(tree, "dense")
    want = jax_weight_utils.convert_antisym_layout({"a": [jax_packed, {"b": np.ones(3)}]}, "dense")
    assert isinstance(to_dense["a"][0], antisym.Antisym3x3DenseParams)
    for got, w in zip(jax.tree.leaves(weight_utils.params_to_jax(to_dense, JAX_CLASSES)),
                      jax.tree.leaves(want)):
        np.testing.assert_array_equal(got, np.asarray(w))
    back = weight_utils.convert_antisym_layout(to_dense, "packed")
    for got, w in zip(back["a"][0], packed):
        assert torch.equal(got, w)
    with pytest.raises(ValueError):
        weight_utils.convert_antisym_layout(tree, "diagonal")


def vjp_both(jax_fn, torch_fn, arrays, seed):
    """(outputs, cotangent-gradients) of both packages' functions of the
    same NumPy ``arrays``, the cotangent made from ``seed``."""
    want, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in arrays])
    g = np.random.default_rng(seed).standard_normal(want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    got = torch_fn(*leaves)
    got_grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    return (got, want), list(zip(got_grads, want_grads))


@pytest.mark.parametrize("kernel,strides,shape", [
    ((7, 7), (2, 2), (2, 22, 22, 3)),   # the stem: after a zero pad of 3
    ((7, 7), (2, 2), (1, 21, 19, 3)),   # rows the stride does not use
    ((3, 3), (1, 1), (2, 6, 5, 4)),
])
def test_conv2d_valid_matches_jax(kernel, strides, shape):
    """VALID convolution and its input and kernel gradients against JAX
    `conv2d_valid`, to 1e-5."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    k = (0.2 * rng.standard_normal((*kernel, shape[-1], 5))).astype(np.float32)
    b = (0.1 * rng.standard_normal(5)).astype(np.float32)
    (got, want), grads = vjp_both(
        lambda x, k, b: jax_conv.conv2d_valid(x, k, strides, b),
        lambda x, k, b: conv.conv2d_valid(x, k, strides, b), (x, k, b), 4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for g, w in grads:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("strides", [(1, 1), (2, 2)])
def test_antisym_conv2d_3x3_matches_jax(layout, strides):
    """The antisymmetric conv of either layout, stride 1 and 2 (TF's
    asymmetric SAME padding), and its gradients with respect to x and every
    leaf, against JAX `antisym_conv2d_3x3`, to 1e-5."""
    (jax_packed, jax_dense), _ = both_layouts(5)
    jax_params = jax_dense if layout == "dense" else jax_packed
    cls = antisym.Antisym3x3DenseParams if layout == "dense" else antisym.Antisym3x3Params
    x = np.random.default_rng(6).standard_normal((2, 8, 7, 6)).astype(np.float32)
    arrays = (x, *[np.asarray(a) for a in jax_params])
    (got, want), grads = vjp_both(
        lambda x, *p: jax_conv.antisym_conv2d_3x3(x, type(jax_params)(*p), 0.05, strides),
        lambda x, *p: conv.antisym_conv2d_3x3(x, cls(*p), 0.05, strides), arrays, 7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for g, w in grads:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("preset", ["resnet50", "resnet101", "resnet152"])
@pytest.mark.parametrize("antisymmetric_mid", [True, False])
def test_presets_match_jax(preset, antisymmetric_mid):
    want = jax_bottleneck.resnet_preset(preset, 257, antisymmetric_mid=antisymmetric_mid,
                                        version=1.5)
    got = bottleneck.resnet_preset(preset, 257, antisymmetric_mid=antisymmetric_mid, version=1.5)
    assert got == config_from_json(_config_to_json(want), "bottleneck")
    # The keyword surface's preset (at widths of 1 and 2, to build it fast).
    model = bottleneck.build_resnet(preset=preset, num_classes=3, filters_per_block=[[1, 1, 2]] * 4,
                                    generator=torch.Generator().manual_seed(0), device="cpu")
    assert model.config.blocks_per_stage == jax_bottleneck._PRESETS[preset]


def jax_forward(jax_model, train=False, return_logits=True):
    """The JAX model's apply, jitted (op by op it takes seconds a call)."""
    return jax.jit(lambda p, s, x: jax_model.apply(p, s, jnp.asarray(x), train=train,
                                                   return_logits=return_logits))


@pytest.mark.parametrize("version,antisymmetric_mid", CASES, ids=IDS)
def test_forward_matches_jax_apply(version, antisymmetric_mid):
    """Logits and probabilities in eval mode (norm-relative 1e-5) and
    logits in train mode (1e-4) at batch 4, against JAX apply on the same
    parameters and running statistics; train mode writes the new state into
    the buffers (to 1e-5), eval mode leaves them alone."""
    config = narrow_config(version, antisymmetric_mid)
    jax_model = jax_bottleneck.build_resnet(config)
    params, state = drawn_bottleneck_trees(config, 8)
    model = port_model(config, params, state)
    mid = model.params()["stages"][0]["identity_blocks"]["conv2"]
    assert isinstance(mid, antisym.Antisym3x3DenseParams) == antisymmetric_mid
    x = np.random.default_rng(9).uniform(0, 255, (4, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        for logits in (True, False):
            want, _ = jax_forward(jax_model, return_logits=logits)(params, state, x)
            assert norm_rel(model(torch.from_numpy(x), return_logits=logits), want) <= EVAL_TOL
        want, new_state = jax_forward(jax_model, train=True)(params, state, x)
        for got, w in zip(jax.tree.leaves(weight_utils.params_to_jax(model.state(), JAX_CLASSES)),
                          jax.tree.leaves(state)):
            np.testing.assert_array_equal(got, np.asarray(w))
        assert norm_rel(model(torch.from_numpy(x), return_logits=True, train=True), want) <= TRAIN_TOL
    got_state = jax.tree.leaves(weight_utils.params_to_jax(model.state(), JAX_CLASSES))
    want_state = jax.tree.leaves(new_state)
    assert len(got_state) == len(want_state) == 2 * (1 + 4 * (3 + 1) + 3)  # mean, var a norm
    for got, w in zip(got_state, want_state):
        np.testing.assert_allclose(got, np.asarray(w), **STATE_TOL)


def test_without_batch_norm_the_state_is_empty():
    """use_batch_norm=False: no buffers, train and eval mode the same
    forward, equal to JAX apply's."""
    config = narrow_config(1, True, use_batch_norm=False)
    jax_model = jax_bottleneck.build_resnet(config)
    params, state = drawn_bottleneck_trees(config, 10)
    model = port_model(config, params, state)
    assert not list(model.buffers())
    x = np.random.default_rng(11).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    want, _ = jax_forward(jax_model)(params, state, x)
    with torch.no_grad():
        for train in (False, True):
            got = model(torch.from_numpy(x), return_logits=True, train=train)
            assert norm_rel(got, want) <= EVAL_TOL


def test_full_width_resnet50_eval_forward_matches_jax():
    """ResNet-50 at its published widths with antisymmetric mid-convs, 32x32
    images (the JAX bench's CIFAR-scale row) and 10 classes: the eval-mode
    logits at batch 2 against JAX apply, norm-relative 1e-5."""
    config = jax_bottleneck.resnet_preset("resnet50", 10, antisymmetric_mid=True,
                                          image_shape=(32, 32, 3))
    jax_model = jax_bottleneck.build_resnet(config)
    params, state = drawn_bottleneck_trees(config, 12)
    model = port_model(config, params, state)
    template = jax.eval_shape(jax_model.init, jax.random.key(0))
    assert jax.tree.structure(template) == jax.tree.structure((params, state))
    x = np.random.default_rng(13).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    want, _ = jax_forward(jax_model)(params, state, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x), return_logits=True)
    assert got.shape == (2, 10)
    assert norm_rel(got, want) <= EVAL_TOL


def test_unsupported_options_raise():
    """The config validates as the JAX package's does.  int8 (which raised
    naming ROADMAP A13 before the port had it) builds: its numbers are held
    against the JAX package in tests/test_torch_quantized_model.py, reduced
    precision in `test_reduced_precision_matches_jax_apply`."""
    config = dataclasses.replace(bottleneck.resnet_preset("resnet50", 10), int8_forward=True)
    assert bottleneck.build_resnet(config, generator=torch.Generator(),
                                   device="cpu").config.int8_forward
    with pytest.raises(ValueError, match="requires int8_forward=True"):
        dataclasses.replace(config, int8_forward=False, int8_backward="wgrad")
    with pytest.raises(ValueError, match="version"):
        bottleneck.BottleneckResNetConfig(num_classes=3, version=2)
    with pytest.raises(ValueError, match="num_classes"):
        bottleneck.BottleneckResNetConfig()
    with pytest.raises(TypeError):
        bottleneck.build_resnet(bottleneck.resnet_preset("resnet50", 10), device="cpu")


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16], ids=["bf16", "fp16"])
def test_reduced_precision_matches_jax_apply(dtype):
    """bf16 and fp16 compute (which raised naming ROADMAP A5 before the port
    had them): the narrow v1 antisymmetric model's eval-mode logits at batch
    2 against JAX apply in the same dtype, to 2e-2 norm-relative (both
    round to the compute dtype after every layer, but sum in fp32 in other
    orders: tests/test_torch_bf16.py); its parameters stay fp32."""
    config = narrow_config(1, True, compute_dtype=dtype)
    jax_model = jax_bottleneck.build_resnet(config)
    params, state = drawn_bottleneck_trees(config, 14)
    model = port_model(config, params, state)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = np.random.default_rng(15).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    want, _ = jax_forward(jax_model)(params, state, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x), return_logits=True)
    assert got.dtype == torch.float32 and norm_rel(got, want) <= 2e-2
