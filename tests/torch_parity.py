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
from differential_equations_resnet_tpu.models import bottleneck_resnet as jax_bottleneck
from differential_equations_resnet_tpu.ops import antisymmetric as jax_antisym
from differential_equations_resnet_tpu.utils.serving import _config_to_json
from differential_equations_resnet_tpu_torch.models import build_resnet, build_single_block_resnet
from differential_equations_resnet_tpu_torch.models.bottleneck_resnet import init_resnet
from differential_equations_resnet_tpu_torch.ops import antisymmetric as torch_antisym
from differential_equations_resnet_tpu_torch.utils.serving import config_from_json
from differential_equations_resnet_tpu_torch.utils.weight_utils import (
    params_from_jax,
    params_to_jax,
    state_from_jax,
)

# The JAX package's parameter classes, by name, for `params_to_jax`.
JAX_CLASSES = {
    "ConvParams": jax_blocks.ConvParams,
    "DenseParams": jax_blocks.DenseParams,
    "BatchNormParams": jax_blocks.BatchNormParams,
    "BatchNormState": jax_blocks.BatchNormState,
    "Antisym3x3Params": jax_antisym.Antisym3x3Params,
    "Antisym3x3DenseParams": jax_antisym.Antisym3x3DenseParams,
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


def jax_params_with_biases(jax_model, seed):
    """JAX init, then every bias made nonzero with NumPy (init leaves them 0)."""
    params, state = jax_model.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (
            leaf + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
            if "bias" in jax.tree_util.keystr(path) else leaf
        ),
        params,
    )
    return params, state


def with_batch_norms(params, state, seed):
    """JAX trees with every batch norm made non-trivial with NumPy: scale 1
    + 0.1 N(0, 1), offset 0.1 N(0, 1), running mean 0.1 N(0, 1), running
    variance U(0.5, 1.5) (init leaves them 1, 0, 0, 1)."""
    rng = np.random.default_rng(seed + 1000)
    normal = lambda leaf, loc: (loc + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    def bn(path, leaf):
        key = jax.tree_util.keystr(path)
        if key.endswith(".scale"):
            return normal(leaf, 1.0)
        if key.endswith(".offset") or key.endswith(".mean"):
            return normal(leaf, 0.0)
        if key.endswith(".var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return leaf

    return (jax.tree_util.tree_map_with_path(bn, params),
            jax.tree_util.tree_map_with_path(bn, state))


def jax_params_and_state(jax_model, seed):
    """`jax_params_with_biases`, then `with_batch_norms`."""
    return with_batch_norms(*jax_params_with_biases(jax_model, seed), seed)


def narrow_bottleneck_config(version, antisymmetric_mid, **fields):
    """A JAX `BottleneckResNetConfig` at test size: two identity blocks in
    stage 2, one block in the others, bottleneck width 8 (mid 8 or
    antisymmetric), outer width 16, 32x32 images, 5 classes."""
    mid = None if antisymmetric_mid else 8
    return jax_bottleneck.BottleneckResNetConfig(
        image_shape=(32, 32, 3), num_classes=5, version=version,
        blocks_per_stage=(2, 1, 1, 1), filters_per_block=((8, mid, 16),) * 4,
        kernel_type="antisymmetric" if antisymmetric_mid else "regular", gamma=0.05,
        subtract_mean=127.5, divide_by_stddev=127.5, **fields)


# (version, antisymmetric mid-convs) of the parity tests, and their ids.
BOTTLENECK_CASES = [(1, True), (1, False), (1.5, True), (1.5, False)]
BOTTLENECK_IDS = [f"v{v}-{'antisymmetric' if a else 'regular'}" for v, a in BOTTLENECK_CASES]


def drawn_bottleneck_trees(config, seed):
    """(params, state) for a JAX `BottleneckResNetConfig` as the JAX
    package's trees of NumPy leaves, drawn by the port's init from a torch
    seed (JAX's init draws leaf by leaf, ~12 s at ResNet-50's widths on the
    CPU), with nonzero biases and `with_batch_norms`."""
    port_config = config_from_json(_config_to_json(config), "bottleneck")
    params, state = init_resnet(port_config, torch.Generator().manual_seed(seed))
    params, state = params_to_jax(params, JAX_CLASSES), params_to_jax(state, JAX_CLASSES)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (leaf + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
                            if jax.tree_util.keystr(path).endswith(".bias") else leaf), params)
    return with_batch_norms(params, state, seed)


def port_model(config, jax_params, jax_state=None):
    """The port's model of a JAX config (either family), on the CPU, holding
    ``jax_params`` and, where given, the ``jax_state`` running statistics."""
    bottleneck = hasattr(config, "version")
    port_config = config_from_json(_config_to_json(config),
                                   "bottleneck" if bottleneck else "single_block")
    state = None if jax_state is None else state_from_jax(to_numpy(jax_state))
    build = build_resnet if bottleneck else build_single_block_resnet
    return build(port_config, params=params_from_jax(to_numpy(jax_params)), state=state,
                 device="cpu")


# Parameters after Adam where batch norm is in the model.  Its train-mode
# gradients carry ~1e-7 of fp32 roundoff, and Adam's first steps move an
# element by about lr * sign(g) whatever |g|, so an element whose true
# gradient is within that roundoff of 0 may step either way in either
# package.  So: every element within 2 lr a step of the JAX package's, and
# all but OUTLIERS of them within STEP_TOL of a step.
STEP_TOL = 1e-2
OUTLIERS = 1e-2
# The running statistics after a train step, per leaf, norm-relative: the
# step's batch statistics come from the parameters above.
STEPPED_STATE_TOL = 1e-4


def assert_params_close(got_tree, want_tree, steps, lr):
    """The port's parameter tree after ``steps`` Adam updates at rate ``lr``
    against the JAX package's ``want_tree``: every element within 2 * lr *
    steps, and all but a fraction OUTLIERS of the elements within STEP_TOL *
    lr * steps, the conv biases that feed a batch norm left out of that
    count: the norm subtracts them out, so their true gradient is 0 and each
    package's Adam steps them by its own roundoff.  ``got_tree`` may also
    hold NumPy leaves already (`params_to_jax` of the port's tree)."""
    got = jax.tree.leaves(params_to_jax(got_tree, JAX_CLASSES)
                          if isinstance(jax.tree.leaves(got_tree)[0], torch.Tensor) else got_tree)
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert len(got) == len(want) > 0
    counted = off = 0
    for g, (path, w) in zip(got, want):
        key = jax.tree_util.keystr(path)
        err = np.abs(g - np.asarray(w))
        assert err.max() <= 2 * lr * steps, (key, float(err.max()))
        if not (key.endswith(".bias") and not key.startswith("['head']")):
            counted += err.size
            off += int(np.sum(err > STEP_TOL * lr * steps))
    assert off <= OUTLIERS * counted, (off, counted)


def assert_stepped_state_close(got_tree, want_tree):
    """The port's running statistics after train steps within
    STEPPED_STATE_TOL (norm-relative, per leaf) of the JAX package's."""
    got = jax.tree.leaves(params_to_jax(got_tree, JAX_CLASSES))
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert norm_rel(g, w) <= STEPPED_STATE_TOL


def norm_rel(got, want) -> float:
    """||got - want|| / ||want||."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


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


def jax_mesh(shape, names):
    """A JAX mesh of ``shape`` over the first virtual CPU devices."""
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(names))


def jax_train(config, params, batches, lr, state=None, mesh=None, accum_steps=1,
              shard_map=False):
    """The JAX package's train steps over ``batches`` [(images, labels)]
    from ``params`` (and the batch-norm ``state``), jitted over ``mesh``
    (`make_train_step(mesh=...)`, or `make_shard_map_train_step`): its
    telemetry rows [loss, correct, count, *grad_norms], the parameters and
    state after, and the eval-mode logits of the first batch."""
    from differential_equations_resnet_tpu.models import build_single_block_resnet as build
    from differential_equations_resnet_tpu.parallel import make_shard_map_train_step
    from differential_equations_resnet_tpu.train import create_train_state, make_adam
    from differential_equations_resnet_tpu.train import make_train_step

    model = build(config)
    tx = make_adam()
    train_state = create_train_state(model, jax.random.key(0), tx)
    train_state = train_state._replace(
        params=params, opt_state=tx.init(params),
        model_state=train_state.model_state if state is None else state)
    if shard_map:
        step = make_shard_map_train_step(model, tx, mesh, donate=False, accum_steps=accum_steps)
    else:
        step = make_train_step(model, tx, mesh=mesh, donate=False, accum_steps=accum_steps)
    rows = []
    for images, labels in batches:
        train_state, metrics, norms = step(train_state, jnp.asarray(images),
                                           jnp.asarray(labels), jnp.float32(lr))
        rows.append(np.concatenate([[float(metrics[k]) for k in ("loss", "correct", "count")],
                                    np.asarray(norms)]))
    logits, _ = model.apply(train_state.params, train_state.model_state,
                            jnp.asarray(batches[0][0]), return_logits=True)
    return {"rows": np.stack(rows), "params": to_numpy(train_state.params),
            "state": to_numpy(train_state.model_state), "logits": np.asarray(logits)}


def port_config_of(config):
    """The port's config of a JAX config (either family)."""
    family = "bottleneck" if hasattr(config, "version") else "single_block"
    return config_from_json(_config_to_json(config), family)


def assert_rows_close(got, want, loss_rtol=1e-5, row_rtol=1e-3):
    """Telemetry rows: loss to ``loss_rtol``, correct and count exactly, the
    grad-norm row to ``row_rtol`` relative."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=loss_rtol)
    np.testing.assert_array_equal(got[:, 1:3], want[:, 1:3])
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], rtol=row_rtol)


def assert_trees_close(got, want, atol=1e-3, rtol=0.0):
    """Two parameter trees leaf by leaf (JAX tree order)."""
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=rtol)


def case_result(results, name):
    """One case's result from `torch_mesh_cases.run`, raising its error."""
    result = results[name]
    if isinstance(result, dict) and "error" in result:
        raise AssertionError(result["error"])
    return result
