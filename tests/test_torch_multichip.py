"""The composition matrix of the JAX package's `dryrun_multichip(8)`
(__graft_entry__.py:64-415) on eight gloo CPU ranks standing in for its
eight devices, each composition held against the JAX package.

Ranks are spawned once for the file (tests/torch_dist.py).  As in the
dryrun: a (data 4, model 2) mesh for the dp x tp step (the 4L x 8F trunk
channel-parallel over ``model``), with accumulation, with int8 'dgrad'
and 'wgrad'; an 8-way ``data`` mesh for the shard_map step, the K-step
loop and the device-resident epoch; pipelines over 4 stages, dp x pp,
tp x pp and dp x tp x pp; the device-resident epoch again under dp x tp.
Steps: loss 1e-5, grad-norm row 1e-3, parameters 1e-3 against the JAX
package's sharded steps (PERF.md §2); pipelines: rtol 1e-4 on values,
rtol 1e-3 and atol 1e-5 on gradients against `reference_euler_dense`;
epochs against the port's meshless epoch (torch draws their order)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from differential_equations_resnet_tpu.models import build_single_block_resnet as jax_build
from differential_equations_resnet_tpu.models import cifar10_single_block_config
from differential_equations_resnet_tpu.ops.pallas.fused_integrator import reference_euler_dense
from differential_equations_resnet_tpu.train import create_train_state, make_adam, make_multi_step
from differential_equations_resnet_tpu_torch.utils.weight_utils import params_from_jax

import torch_mesh_cases
from torch_dist import run_ranks
from torch_parity import (
    assert_rows_close,
    assert_trees_close,
    case_result,
    jax_mesh,
    jax_params_with_biases,
    jax_train,
    port_config_of,
    to_numpy,
)

WORLD = 8
DP_TP = ((4, 2), ("data", "model"))
DP = ((8,), ("data",))
LR = 1e-3


def config(**kw):
    return dataclasses.replace(
        cifar10_single_block_config(num_layers=4, num_filters=8, s2d_block=0), **kw)


STEPS = {
    "dp_tp": (dict(), 1, DP_TP, True, False),
    "dp_tp_accum": (dict(), 2, DP_TP, True, False),
    "dp_tp_int8_dgrad": (dict(int8_forward=True, int8_backward="dgrad"), 1, DP_TP, True, False),
    "dp_tp_int8_wgrad": (dict(int8_forward=True, int8_backward="wgrad"), 1, DP_TP, True, False),
    "shard_map": (dict(), 1, DP, False, True),
}
PARAMS = {name: to_numpy(jax_params_with_biases(jax_build(config(**kw)), i)[0])
          for i, (name, (kw, _, _, _, _)) in enumerate(STEPS.items())}
rng = np.random.default_rng(0)
BATCH = [(rng.uniform(0, 255, (8, 8, 8, 3)).astype(np.float32),
          rng.integers(0, 10, 8).astype(np.int64))]
FEATURES = np.random.default_rng(4).integers(0, 256, (64, 8, 8, 3)).astype(np.uint8)
LABELS = np.random.default_rng(5).integers(0, 10, 64).astype(np.int64)


def pipe_data(seed, layers, batch):
    rng = np.random.default_rng(seed)
    kernels = rng.normal(0, 0.2, (layers, 3, 3, 8, 8)).astype(np.float32)
    biases = rng.normal(0, 0.1, (layers, 8)).astype(np.float32)
    x = rng.normal(0, 0.5, (batch, 4, 4, 8)).astype(np.float32)
    return kernels, biases, x


# The dryrun's pipelines: name -> (seed, layers, batch, mesh, names, micro, batch axis, tp axis)
PIPES = {
    "pp": (3, 8, 8, (4,), ("pipe",), 4, None, None),
    "dp_pp": (6, 8, 8, (2, 4), ("data", "pipe"), 2, "data", None),
    "tp_pp": (6, 8, 8, (2, 2), ("pipe", "model"), 2, None, "model"),
    "dp_tp_pp": (9, 4, 8, (2, 2, 2), ("data", "pipe", "model"), 2, "data", "model"),
}


def cases():
    out = []
    for name, (kw, accum, (shape, names), tp, shard_map) in STEPS.items():
        out.append((name, "train", dict(
            config=port_config_of(config(**kw)), params=params_from_jax(PARAMS[name]),
            batches=BATCH, lr=LR, mesh_shape=shape, mesh_names=names, accum_steps=accum, tp=tp,
            shard_map=shard_map)))
    out.append(("multi_step", "multi_step", dict(
        config=port_config_of(config()), params=params_from_jax(PARAMS["dp_tp"]),
        images=BATCH[0][0], labels=BATCH[0][1], lr=LR, k=2, mesh_shape=DP[0])))
    for name, (seed, layers, batch, shape, names, micro, batch_axis, tp_axis) in PIPES.items():
        kernels, biases, x = pipe_data(seed, layers, batch)
        out.append((name, "pipeline", dict(
            kernels=kernels, biases=biases, x=x, h=0.25, mesh_shape=shape, mesh_names=names,
            num_microbatches=micro, batch_axis=batch_axis, tp_axis=tp_axis)))
    epoch = dict(config=port_config_of(config()), params=params_from_jax(PARAMS["dp_tp"]),
                 features=FEATURES, labels=LABELS, batch_size=8, steps=3, lr=LR)
    out.append(("epoch_dp", "device_epochs", dict(epoch, mesh_shape=DP[0], mesh_names=DP[1])))
    out.append(("epoch_dp_tp", "device_epochs", dict(epoch, mesh_shape=DP_TP[0],
                                                      mesh_names=DP_TP[1], tp=True)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(torch_mesh_cases.run, WORLD, tmp_path_factory.mktemp("ranks"), cases())


def in_mesh(ranks, name):
    got = [r for r in (case_result(r, name) for r in ranks) if r is not None]
    assert got
    return got


@pytest.mark.parametrize("name", list(STEPS))
def test_step_compositions_match_jax(ranks, name):
    """The dp x tp step (plain, accumulated, int8 'dgrad' and 'wgrad') and
    the shard_map step over 8-way data, each against the JAX package's
    step over the same mesh."""
    kw, accum, (shape, names), tp, shard_map = STEPS[name]
    mesh = jax_mesh(shape, names)
    cfg = config(**kw, tp_mesh=mesh) if tp else config(**kw)
    want = jax_train(cfg, PARAMS[name], BATCH, LR, mesh=mesh, accum_steps=accum,
                     shard_map=shard_map)
    for got in in_mesh(ranks, name):
        assert_rows_close(got["rows"], want["rows"])
        assert_trees_close(got["params"], want["params"], atol=1e-3)


def test_multi_step_under_data_parallelism_matches_jax(ranks):
    """K = 2 steps in one make_multi_step call over 8-way data."""
    mesh = jax_mesh(*DP)
    model = jax_build(config())
    tx = make_adam()
    state = create_train_state(model, jax.random.key(0), tx)
    state = state._replace(params=PARAMS["dp_tp"], opt_state=tx.init(PARAMS["dp_tp"]))
    multi = make_multi_step(model, tx, mesh=mesh, donate=False)
    xs = np.broadcast_to(BATCH[0][0], (2,) + BATCH[0][0].shape).copy()
    ys = np.broadcast_to(BATCH[0][1], (2,) + BATCH[0][1].shape).copy()
    state, metrics, norms = multi(state, xs, ys, jnp.full((2,), LR, jnp.float32))
    for got in in_mesh(ranks, "multi_step"):
        np.testing.assert_allclose(got["loss"], np.asarray(metrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["norms"], np.asarray(norms), rtol=1e-3)
        assert_trees_close(got["params"], to_numpy(state.params), atol=1e-3)


@pytest.mark.parametrize("name", list(PIPES))
def test_pipeline_compositions_match_jax(ranks, name):
    seed, layers, batch, shape = PIPES[name][:4]
    kernels, biases, x = (jnp.asarray(a) for a in pipe_data(seed, layers, batch))

    def loss(k, b, xx):
        return jnp.sum(reference_euler_dense(xx, k, b, 0.25) ** 2)

    value, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(kernels, biases, x)
    got_ranks = in_mesh(ranks, name)
    assert len(got_ranks) == int(np.prod(shape))
    for got in got_ranks:
        np.testing.assert_allclose(got["value"], float(value), rtol=1e-4)
        for a, b in zip(got["grads"], grads):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("name", ["epoch_dp", "epoch_dp_tp"])
def test_device_epoch_compositions_equal_the_meshless_epoch(ranks, name):
    """Three device-resident steps of 8 from 64 images under 8-way data and
    under dp x tp, against the same epoch without a mesh."""
    for got in in_mesh(ranks, name):
        assert_rows_close(got["mesh"]["rows"], got["meshless"]["rows"])
        assert_trees_close(got["mesh"]["params"], got["meshless"]["params"], atol=1e-5)
