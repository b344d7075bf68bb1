"""The explicit-collective data-parallel step (parallel/shard_map_step.py)
on gloo CPU ranks against the JAX package's `make_shard_map_train_step`.

Four ranks stand in for the four devices of a ``data`` mesh (spawned once
for the file, tests/torch_dist.py).  Both packages' steps train on each
shard's rows and reduce the gradient, the loss, ``correct`` and ``count``
over the axis once a step: loss to 1e-5, grad-norm row to 1e-3,
parameters to 1e-3 (PERF.md §2), with and without accumulation, the L2
penalty in the objective; batch norm is refused with the JAX message."""

import dataclasses

import numpy as np
import pytest

from differential_equations_resnet_tpu.models import build_single_block_resnet as jax_build
from differential_equations_resnet_tpu.models import cifar10_single_block_config
from differential_equations_resnet_tpu.parallel import make_shard_map_train_step as jax_shard_map_step
from differential_equations_resnet_tpu.train import make_adam as jax_make_adam
from differential_equations_resnet_tpu_torch.utils.weight_utils import params_from_jax, state_from_jax

import torch_mesh_cases
from torch_dist import run_ranks
from torch_parity import (
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
LR = 1e-3


def config(**kw):
    return dataclasses.replace(
        cifar10_single_block_config(num_layers=2, num_filters=8, s2d_block=0), **kw)


def batches(steps, batch, seed):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 255, (batch, 8, 8, 3)).astype(np.float32),
             rng.integers(0, 10, batch).astype(np.int64)) for _ in range(steps)]


CASES = {
    "plain": (dict(), 1, batches(2, 8, 0)),
    "l2": (dict(l2_regularization=5e-4), 1, batches(2, 8, 1)),
    "accum": (dict(), 2, batches(2, 16, 2)),
}
PARAMS = {name: to_numpy(jax_params_with_biases(jax_build(config(**kw)), 1)[0])
          for name, (kw, _, _) in CASES.items()}
BN = config(use_batch_norm=True)
BN_PARAMS, BN_STATE = (to_numpy(t) for t in jax_params_and_state(jax_build(BN), 1))


def cases():
    out = [(name, "train", dict(
        config=port_config_of(config(**kw)), params=params_from_jax(PARAMS[name]), batches=data,
        lr=LR, mesh_shape=(WORLD,), accum_steps=accum, shard_map=True))
        for name, (kw, accum, data) in CASES.items()]
    out.append(("batch_norm", "shard_map_rejects_batch_norm", dict(
        config=port_config_of(BN), params=params_from_jax(BN_PARAMS),
        state=state_from_jax(BN_STATE))))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(torch_mesh_cases.run, WORLD, tmp_path_factory.mktemp("ranks"), cases())


@pytest.mark.parametrize("name", list(CASES))
def test_shard_map_step_matches_jax(ranks, name):
    kw, accum, data = CASES[name]
    want = jax_train(config(**kw), PARAMS[name], data, LR, mesh=jax_mesh((WORLD,), ("data",)),
                     accum_steps=accum, shard_map=True)
    for r in ranks:
        got = case_result(r, name)
        assert_rows_close(got["rows"], want["rows"])
        assert_trees_close(got["params"], want["params"], atol=1e-3)


def test_shard_map_step_refuses_batch_norm_with_the_jax_message(ranks):
    with pytest.raises(ValueError) as jax_error:
        jax_shard_map_step(jax_build(BN), jax_make_adam(), jax_mesh((WORLD,), ("data",)))
    for r in ranks:
        assert case_result(r, "batch_norm") == str(jax_error.value)
