"""The port's batch norm and pooling (`models.blocks`) and the single-block
ODE-ResNet with ``use_batch_norm=True`` against the JAX package, on the CPU:
`batch_norm` in train and eval mode with its new running statistics and its
gradients, `max_pool`, the L2 penalty of the dense-lower antisymmetric
layout, and the model's forward in both modes, its new state and its train
steps (loss, correct count, grad-norm row, parameters and state after Adam),
with remat and with gradient accumulation.  Inputs and parameters are made
with NumPy from a seed; parameters and state come over by `params_from_jax`
and `state_from_jax`."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.models import blocks as jax_blocks
from differential_equations_resnet_tpu.models import (
    SingleBlockResNetConfig as JaxConfig,
    build_single_block_resnet as jax_build,
    cifar10_single_block_config as jax_cifar10_config,
)
from differential_equations_resnet_tpu.ops import antisymmetric as jax_antisym
from differential_equations_resnet_tpu.train import (
    create_train_state as jax_create_train_state,
    make_adam as jax_make_adam,
    make_train_step as jax_make_train_step,
)
from differential_equations_resnet_tpu_torch.models import blocks
from differential_equations_resnet_tpu_torch.models import single_block_resnet as sbr
from differential_equations_resnet_tpu_torch.ops import antisymmetric as antisym
from differential_equations_resnet_tpu_torch.train import make_adam, make_train_step
from differential_equations_resnet_tpu_torch.utils.weight_utils import params_to_jax

from torch_parity import (
    JAX_CLASSES,
    assert_params_close,
    assert_stepped_state_close,
    jax_params_and_state,
    norm_rel,
    port_model,
)

LR = 1e-3
EVAL_TOL = dict(rtol=5e-5, atol=5e-5)   # tests/test_golden_fixture.py's bound
# Train mode divides by the batch's standard deviation, computed in another
# order (torch.var_mean against jnp.var), which the layers after carry.
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)  # 0.99 old + 0.01 batch statistic


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs a worker a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bn_case(seed, shape=(4, 5, 6, 7)):
    """x (NHWC), BatchNormParams and BatchNormState as NumPy arrays."""
    rng = np.random.default_rng(seed)
    channels = shape[-1]
    x = (2.0 + 3.0 * rng.standard_normal(shape)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(channels)).astype(np.float32)
    offset = (0.1 * rng.standard_normal(channels)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(channels)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, channels).astype(np.float32)
    return x, (scale, offset), (mean, var)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_norm_matches_jax(train):
    """y, the new running statistics (biased batch variance, momentum 0.99,
    epsilon 1e-3) and the gradients of sum(sin(y)) with respect to x, scale
    and offset, against JAX `blocks.batch_norm`, to 1e-5."""
    x, (scale, offset), (mean, var) = bn_case(0)
    jax_fn = lambda x, s, o: jax_blocks.batch_norm(
        x, jax_blocks.BatchNormParams(s, o), jax_blocks.BatchNormState(mean, var), train)
    (want_y, want_state), vjp = jax.vjp(jax_fn, x, scale, offset)
    want_grads = vjp((jnp.cos(want_y), jax.tree.map(jnp.zeros_like, want_state)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, offset)]
    y, state = blocks.batch_norm(leaves[0], blocks.BatchNormParams(*leaves[1:]),
                                 blocks.BatchNormState(torch.from_numpy(mean),
                                                       torch.from_numpy(var)), train)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    assert not state.mean.requires_grad and not state.var.requires_grad
    np.testing.assert_allclose(state.mean.numpy(), np.asarray(want_state.mean), **STATE_TOL)
    np.testing.assert_allclose(state.var.numpy(), np.asarray(want_state.var), **STATE_TOL)
    if not train:
        np.testing.assert_array_equal(state.var.numpy(), var)
    grads = torch.autograd.grad(torch.sin(y).sum(), leaves)
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_running_variance_is_the_biased_batch_variance():
    """From mean 0 and variance 1, one train-mode call leaves 0.01 * the
    batch mean and 0.99 + 0.01 * the biased (population) batch variance,
    not torch's unbiased one."""
    x, params, _ = bn_case(1)
    _, state = blocks.batch_norm(torch.from_numpy(x), blocks.BatchNormParams(
        *map(torch.from_numpy, params)), blocks.init_batch_norm(x.shape[-1])[1], True)
    flat = x.reshape(-1, x.shape[-1]).astype(np.float64)
    np.testing.assert_allclose(state.mean.numpy(), 0.01 * flat.mean(0), rtol=1e-5)
    np.testing.assert_allclose(state.var.numpy(), 0.99 + 0.01 * flat.var(0), rtol=1e-6)


@pytest.mark.parametrize("window,strides,shape", [
    ((3, 3), (2, 2), (2, 18, 18, 5)),
    ((3, 3), (2, 2), (1, 9, 7, 3)),
    ((2, 2), (2, 2), (2, 8, 6, 4)),
])
def test_max_pool_matches_jax(window, strides, shape):
    """VALID max pooling, NHWC, bit for bit with JAX `blocks.max_pool`, and
    max_pool_2x2 with JAX's."""
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    got = blocks.max_pool(torch.from_numpy(x), window, strides).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_blocks.max_pool(jnp.asarray(x), window, strides)))
    np.testing.assert_array_equal(blocks.max_pool_2x2(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_blocks.max_pool_2x2(jnp.asarray(x))))


def test_l2_penalty_takes_the_dense_lower_layout():
    """The L2 penalty of a tree holding dense-lower antisymmetric params
    equals the JAX package's and the packed layout's (the structural zeros
    add nothing); batch-norm parameters are left out."""
    rng = np.random.default_rng(3)
    std = np.sqrt(2.0 / 54)
    leaves = [(std * rng.standard_normal(shape)).astype(np.float32)
              for shape in ((6,), (6,), (6,), (6,), (3, 3, 15), (6,))]
    packed = antisym.Antisym3x3Params(*map(torch.from_numpy, leaves))
    scale = torch.ones(6)
    tree = {"conv2": antisym.dense_from_packed(packed), "bn": blocks.BatchNormParams(scale, scale)}
    jax_tree = {"conv2": jax_antisym.dense_from_packed(jax_antisym.Antisym3x3Params(*leaves)),
                "bn": jax_blocks.BatchNormParams(np.ones(6, np.float32), np.ones(6, np.float32))}
    got = float(blocks.l2_kernel_penalty(tree, 1e-2))
    np.testing.assert_allclose(got, float(jax_blocks.l2_kernel_penalty(jax_tree, 1e-2)), rtol=1e-6)
    np.testing.assert_allclose(got, float(blocks.l2_kernel_penalty({"conv2": packed}, 1e-2)),
                               rtol=1e-6)


def bn_config(name):
    """Small single-block configs with batch norm, at the headline step size."""
    if name == "multi_stage":
        return JaxConfig(
            image_shape=(12, 12, 3), num_stages=3, blocks_per_stage=(2, 3),
            filters_per_block=(4, 8), strides=((1, 1), (2, 2)), num_classes=5,
            use_max_pooling=(False, True, False, False), h=0.3, gamma=0.05,
            subtract_mean=127.5, divide_by_stddev=127.5, use_batch_norm=True)
    kernel_type, remat = {"antisymmetric": ("antisymmetric", False),
                          "regular_remat": ("regular", True)}[name]
    return dataclasses.replace(
        jax_cifar10_config(num_layers=3, final_time=0.375, num_filters=4, kernel_type=kernel_type,
                           remat=remat, s2d_block=0),
        use_batch_norm=True)


CONFIGS = ["antisymmetric", "regular_remat", "multi_stage"]


def images(config, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (batch, *config.image_shape)).astype(np.float32),
            rng.integers(0, config.num_classes, batch).astype(np.int32))


def assert_tree_close(got_tree, want_tree, **tol):
    got = jax.tree.leaves(params_to_jax(got_tree, JAX_CLASSES))
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **tol)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_with_batch_norm_matches_jax(name):
    """Logits and probabilities in eval mode (running statistics, to 5e-5)
    and train mode (batch statistics, to 1e-4), and the new state of train
    mode in the model's buffers, against JAX apply; eval mode leaves the
    buffers alone.  Every identity stack takes the per-layer route."""
    config = bn_config(name)
    jax_model = jax_build(config)
    params, state = jax_params_and_state(jax_model, 4)
    model = port_model(config, params, state)
    x, _ = images(config, 4, 5)
    sbr.route_counts.update(fused=0, per_layer=0)
    apply = jax.jit(jax_model.apply, static_argnames=("train", "return_logits"))
    with torch.no_grad():
        for logits in (True, False):
            want, _ = apply(params, state, jnp.asarray(x), return_logits=logits)
            np.testing.assert_allclose(model(torch.from_numpy(x), return_logits=logits).numpy(),
                                       np.asarray(want), **EVAL_TOL)
        assert_tree_close(model.state(), state, rtol=0, atol=0)
        want, new_state = apply(params, state, jnp.asarray(x), train=True, return_logits=True)
        got = model(torch.from_numpy(x), return_logits=True, train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TRAIN_TOL)
    assert_tree_close(model.state(), new_state, **STATE_TOL)
    stacks = sum(1 for b in config.blocks_per_stage if b > 1)  # identity stacks a forward
    assert sbr.route_counts == {"fused": 0, "per_layer": 3 * stacks}


@pytest.mark.parametrize("name", CONFIGS)
def test_train_steps_with_batch_norm_match_jax(name):
    """2 steps at batch 4 from the same parameters and state (L2 on): loss
    and grad-norm row to 1e-4 relative, correct and count exactly, the
    parameters after each Adam update as `assert_params_close` says and the
    running statistics to 1e-4 (norm-relative)."""
    config = dataclasses.replace(bn_config(name), l2_regularization=1e-3)
    jax_model = jax_build(config)
    params, state = jax_params_and_state(jax_model, 6)
    tx = jax_make_adam()
    train_state = jax_create_train_state(jax_model, jax.random.key(0), tx)
    train_state = train_state._replace(params=params, model_state=state, opt_state=tx.init(params))
    jax_step = jax_make_train_step(jax_model, tx, donate=False)
    model = port_model(config, params, state)
    step = make_train_step(model, make_adam(model.parameters()))
    for steps, seed in enumerate((7, 8), 1):
        x, y = images(config, 4, seed)
        train_state, jax_metrics, jax_norms = jax_step(train_state, jnp.asarray(x), jnp.asarray(y), LR)
        metrics, norms = step(torch.from_numpy(x), torch.from_numpy(y), LR)
        np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]), rtol=1e-4)
        assert float(metrics["correct"]) == float(jax_metrics["correct"])
        assert float(metrics["count"]) == float(jax_metrics["count"]) == 4
        np.testing.assert_allclose(norms.numpy(), np.asarray(jax_norms), rtol=1e-4)
        assert_params_close(model.params(), train_state.params, steps, LR)
        assert_stepped_state_close(model.state(), train_state.model_state)


def test_accumulated_steps_with_batch_norm_match_jax():
    """accum_steps=2: each microbatch normalized by its own statistics, the
    running statistics threaded through the two in order, one Adam update
    on the averaged gradient, as the JAX step does."""
    config = bn_config("antisymmetric")
    jax_model = jax_build(config)
    params, state = jax_params_and_state(jax_model, 9)
    tx = jax_make_adam()
    train_state = jax_create_train_state(jax_model, jax.random.key(0), tx)
    train_state = train_state._replace(params=params, model_state=state, opt_state=tx.init(params))
    jax_step = jax_make_train_step(jax_model, tx, donate=False, accum_steps=2)
    model = port_model(config, params, state)
    step = make_train_step(model, make_adam(model.parameters()), accum_steps=2)
    x, y = images(config, 8, 10)
    train_state, jax_metrics, jax_norms = jax_step(train_state, jnp.asarray(x), jnp.asarray(y), LR)
    metrics, norms = step(torch.from_numpy(x), torch.from_numpy(y), LR)
    np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]), rtol=1e-4)
    assert float(metrics["correct"]) == float(jax_metrics["correct"])
    np.testing.assert_allclose(norms.numpy(), np.asarray(jax_norms), rtol=1e-4)
    assert_params_close(model.params(), train_state.params, 1, LR)
    assert_stepped_state_close(model.state(), train_state.model_state)
    # Two microbatches are not the monolithic step: the statistics moved twice.
    mono = port_model(config, params, state)
    make_train_step(mono, make_adam(mono.parameters()))(torch.from_numpy(x), torch.from_numpy(y), LR)
    assert norm_rel(mono.state()["stem_bn"].mean, model.state()["stem_bn"].mean.numpy()) > 1e-3


def test_state_is_held_as_buffers_and_checked():
    """The running statistics are buffers under the JAX state's tree paths
    (in state_dict beside the parameters); a state tree of another
    structure is refused."""
    config = bn_config("multi_stage")
    params, state = jax_params_and_state(jax_build(config), 11)
    model = port_model(config, params, state)
    buffers = dict(model.named_buffers())
    assert {"stem_bn__mean", "stem_bn__var", "stages__1__bn_main__var",
            "stages__1__bn_shortcut__mean", "stages__1__blocks_bn__mean"} <= set(buffers)
    assert buffers["stages__0__blocks_bn__var"].shape == (2, 4)
    assert set(buffers) <= set(model.state_dict())
    np.testing.assert_array_equal(buffers["stem_bn__var"].numpy(), state["stem_bn"].var)
    bad = jax.tree.map(lambda a: a, state)
    bad["stages"][0].pop("blocks_bn")
    with pytest.raises(ValueError, match="does not fit the config"):
        port_model(config, params, bad)
