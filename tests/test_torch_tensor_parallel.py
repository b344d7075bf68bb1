"""Channel tensor parallelism of the identity stacks (``tp_mesh``,
parallel/tensor_parallel.py) on gloo CPU ranks against the JAX package.

Four ranks make a (data 2, model 2) mesh, spawned once for the file
(tests/torch_dist.py).  Each rank of the ``model`` axis convolves the full
activations into its half of the output channels and the halves are
all-gathered (the Megatron form); the JAX package shards the same layers
through GSPMD and gets the unsharded model's numbers.  Held here:

- the logits and the gradient of the mean cross-entropy in every
  parameter (so dK, db and, through the stem's, dx) of the Euler, s2d,
  RK4 and int8 'dgrad' stacks against JAX's unsharded model (rtol 2e-4,
  atol 1e-6: tests/test_pipeline.py's model-level bounds; 1e-5 atol for
  int8, whose partial int32 sums meet in fp32);
- train steps on the mesh (each data rank its rows, TP inside) against
  JAX's make_train_step(mesh=...) with ``tp_mesh`` on the same (2, 2)
  mesh: loss 1e-5, row 1e-3, parameters 1e-3;
- where the JAX package runs Pallas (``use_pallas``), each rank runs the
  fused stack on full channels, the route counters say so."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from differential_equations_resnet_tpu.models import build_single_block_resnet as jax_build
from differential_equations_resnet_tpu.models import cifar10_single_block_config
from differential_equations_resnet_tpu.train.train_step import cross_entropy_from_logits
from differential_equations_resnet_tpu_torch.utils.weight_utils import params_from_jax, state_from_jax

import torch_mesh_cases
from torch_dist import run_ranks
from torch_parity import (
    assert_params_close,
    assert_rows_close,
    assert_trees_close,
    case_result,
    jax_mesh,
    jax_params_and_state,
    jax_params_with_biases,
    jax_train,
    port_config_of,
    to_numpy,
)

WORLD = 4
SHAPE, NAMES = (2, 2), ("data", "model")
LR = 1e-3
FORMS = {
    "euler": {},
    "s2d": dict(s2d_block=2, s2d_force=True),
    "rk4": dict(integrator="rk4"),
    "remat_midpoint": dict(integrator="midpoint", remat=True),
    "int8_dgrad": dict(int8_forward=True, int8_backward="dgrad"),
    "int8_wgrad": dict(int8_forward=True, int8_backward="wgrad"),
}
STEPS = ["euler", "s2d", "int8_dgrad"]


def config(**kw):
    return dataclasses.replace(
        cifar10_single_block_config(num_layers=2, num_filters=8, s2d_block=0), **kw)


def trees(cfg, seed=1, batch_norm=False):
    model = jax_build(cfg)
    params, state = (jax_params_and_state if batch_norm else jax_params_with_biases)(model, seed)
    return to_numpy(params), to_numpy(state)


PARAMS = {name: trees(config(**kw)) for name, kw in FORMS.items()}
NORMED = trees(config(use_batch_norm=True), batch_norm=True)
rng = np.random.default_rng(0)
IMAGES = rng.uniform(0, 255, (8, 8, 8, 3)).astype(np.float32)
LABELS = rng.integers(0, 10, 8).astype(np.int64)
DATA = [(IMAGES, LABELS), (rng.uniform(0, 255, (8, 8, 8, 3)).astype(np.float32),
                           rng.integers(0, 10, 8).astype(np.int64))]


def cases():
    out = []
    for name, kw in FORMS.items():
        out.append((f"grads_{name}", "model_forward_and_grads", dict(
            config=port_config_of(config(**kw)), params=params_from_jax(PARAMS[name][0]),
            images=IMAGES, labels=LABELS, mesh_shape=SHAPE, mesh_names=NAMES, tp=True)))
    for name in STEPS:
        out.append((f"step_{name}", "train", dict(
            config=port_config_of(config(**FORMS[name])), params=params_from_jax(PARAMS[name][0]),
            batches=DATA, lr=LR, mesh_shape=SHAPE, mesh_names=NAMES, tp=True)))
    out.append(("step_bn", "train", dict(
        config=port_config_of(config(use_batch_norm=True)), params=params_from_jax(NORMED[0]),
        state=state_from_jax(NORMED[1]), batches=DATA, lr=LR, mesh_shape=SHAPE,
        mesh_names=NAMES, tp=True)))
    out.append(("pallas", "routes_of", dict(
        config=port_config_of(config(use_pallas=True)), params=params_from_jax(PARAMS["euler"][0]),
        images=IMAGES, mesh_shape=SHAPE, mesh_names=NAMES)))
    out.append(("direct_routes", "routes_of", dict(
        config=port_config_of(config()), params=params_from_jax(PARAMS["euler"][0]),
        images=IMAGES, mesh_shape=SHAPE, mesh_names=NAMES)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(torch_mesh_cases.run, WORLD, tmp_path_factory.mktemp("ranks"), cases())


def each(ranks, name):
    return [case_result(r, name) for r in ranks]


def jax_forward_and_grads(cfg, params):
    model = jax_build(cfg)
    _, state = model.init(jax.random.key(0))
    x, y = jnp.asarray(IMAGES), jnp.asarray(LABELS)

    def loss(p):
        logits, _ = model.apply(p, state, x, return_logits=True)
        return cross_entropy_from_logits(logits, y)

    logits, _ = model.apply(params, state, x, return_logits=True)
    return np.asarray(logits), jax.grad(loss)(params)


@pytest.mark.parametrize("name", list(FORMS))
def test_tensor_parallel_logits_and_gradients_match_jax(ranks, name):
    logits, grads = jax_forward_and_grads(config(**FORMS[name]), PARAMS[name][0])
    atol = 1e-5 if name.startswith("int8") else 1e-6
    for got in each(ranks, f"grads_{name}"):
        np.testing.assert_allclose(got["logits"], logits, rtol=2e-4, atol=1e-5)
        assert_trees_close(got["grads"], grads, rtol=2e-4, atol=atol)
        assert got["routes"]["tensor_parallel"] >= 1


@pytest.mark.parametrize("name", STEPS)
def test_tensor_parallel_train_steps_match_jax(ranks, name):
    mesh = jax_mesh(SHAPE, NAMES)
    want = jax_train(config(**FORMS[name], tp_mesh=mesh), PARAMS[name][0], DATA, LR, mesh=mesh)
    for got in each(ranks, f"step_{name}"):
        assert_rows_close(got["rows"], want["rows"])
        assert_trees_close(got["params"], want["params"], atol=1e-3)


def test_tensor_parallel_batch_norm_step_matches_jax(ranks):
    """Batch norm after the all-gathered conv, its moments over the data
    axis: rows to the bounds above, parameters under the batch-norm bounds
    of tests/torch_parity.py, running statistics to 1e-4."""
    mesh = jax_mesh(SHAPE, NAMES)
    want = jax_train(config(use_batch_norm=True, tp_mesh=mesh), NORMED[0], DATA, LR,
                     state=NORMED[1], mesh=mesh)
    for got in each(ranks, "step_bn"):
        assert_rows_close(got["rows"], want["rows"])
        assert_params_close(got["params"], want["params"], steps=2, lr=LR)
        assert_trees_close(got["buffers"], want["state"], atol=1e-4, rtol=1e-4)


def test_where_jax_runs_pallas_each_rank_runs_the_fused_stack(ranks):
    """use_pallas: the JAX package runs its kernel on the replicated stack,
    so each rank runs B1/B2 (their plain versions on the CPU) on full
    channels; without it the stack B1/B2 would take runs tensor-parallel."""
    for got in each(ranks, "pallas"):
        assert got["routes"]["fused"] == 1 and got["routes"]["tensor_parallel"] == 0
        np.testing.assert_allclose(got["logits"], got["meshless"], rtol=1e-6, atol=1e-6)
    for got in each(ranks, "direct_routes"):
        assert got["routes"]["fused"] == 0 and got["routes"]["tensor_parallel"] == 1
        np.testing.assert_allclose(got["logits"], got["meshless"], rtol=1e-5, atol=1e-5)
