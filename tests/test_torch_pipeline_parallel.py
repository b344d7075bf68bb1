"""Pipeline parallelism over depth (parallel/pipeline.py, ``pp_mesh``) on
gloo CPU ranks against the JAX package.

Eight ranks are spawned once for the file (tests/torch_dist.py); each case
builds its mesh over the first ranks it needs.  `pipeline_blocks_apply`'s
value sum(y^2) and its gradients in the kernels, the biases and the input
are held against the JAX package's `reference_euler_dense` and `jax.grad`
of it, for the stages x microbatches cases of tests/test_pipeline.py and
the dp x pp, tp x pp and dp x tp x pp compositions: rtol 1e-4 on values,
rtol 1e-3 and atol 1e-5 on gradients (the JAX package's own bounds).  The
model-level ``pp_mesh`` (with s2d, and tp x pp on one mesh) is held
against the JAX model's logits and parameter gradients (rtol 2e-4, atol
1e-6, tests/test_pipeline.py's), and a (data 2, pipe 2) train step against
the JAX package's step with ``pp_mesh`` and ``pp_batch_axis``."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from differential_equations_resnet_tpu.models import build_single_block_resnet as jax_build
from differential_equations_resnet_tpu.models import cifar10_single_block_config
from differential_equations_resnet_tpu.ops.pallas.fused_integrator import reference_euler_dense
from differential_equations_resnet_tpu.train.train_step import cross_entropy_from_logits
from differential_equations_resnet_tpu_torch.models import cifar10_single_block_config as port_config
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
L, B, H, W, C = 8, 8, 4, 4, 8
STEP = 0.25
LR = 1e-3


def data(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, (B, H, W, C)).astype(np.float32)
    kernels = rng.normal(0, 0.2, (L, 3, 3, C, C)).astype(np.float32)
    biases = rng.normal(0, 0.1, (L, C)).astype(np.float32)
    return kernels, biases, x


# name: (mesh shape, axis names, microbatches, batch axis, tp axis, seed)
PIPELINES = {
    "stages4_micro4": ((4,), ("pipe",), 4, None, None, 0),
    "stages2_micro8": ((2,), ("pipe",), 8, None, None, 1),
    "stages8_micro2": ((8,), ("pipe",), 2, None, None, 2),
    "dp_pp": ((2, 4), ("data", "pipe"), 2, "data", None, 3),
    "tp_pp": ((4, 2), ("pipe", "model"), 2, None, "model", 4),
    "tp_pp_2x2": ((2, 2), ("pipe", "model"), 2, None, "model", 5),
    "dp_tp_pp": ((2, 2, 2), ("data", "pipe", "model"), 2, "data", "model", 6),
}


def config(num_layers=8, **kw):
    return dataclasses.replace(
        cifar10_single_block_config(num_layers=num_layers, num_filters=8, s2d_block=0), **kw)


# name: (config fields, mesh shape, axis names, tp)
MODELS = {
    "pp": (dict(), (4,), ("pipe",), False),
    "pp_s2d": (dict(s2d_block=2, s2d_force=True), (4,), ("pipe",), False),
    "tp_pp": (dict(), (4, 2), ("pipe", "model"), True),
    "tp_pp_s2d": (dict(s2d_block=2, s2d_force=True), (4, 2), ("pipe", "model"), True),
}
PARAMS = {name: to_numpy(jax_params_with_biases(jax_build(config(**kw)), 0)[0])
          for name, (kw, _, _, _) in MODELS.items()}
rng = np.random.default_rng(1)
IMAGES = rng.uniform(0, 255, (8, 8, 8, 3)).astype(np.float32)
LABELS = rng.integers(0, 10, 8).astype(np.int64)
STEPS = [(IMAGES, LABELS), (rng.uniform(0, 255, (8, 8, 8, 3)).astype(np.float32),
                            rng.integers(0, 10, 8).astype(np.int64))]
STEP_CONFIG = dict(num_layers=4)
STEP_PARAMS = to_numpy(jax_params_with_biases(jax_build(config(**STEP_CONFIG)), 2)[0])


def cases():
    out = []
    for name, (shape, names, micro, batch_axis, tp_axis, seed) in PIPELINES.items():
        kernels, biases, x = data(seed)
        out.append((name, "pipeline", dict(
            kernels=kernels, biases=biases, x=x, h=STEP, mesh_shape=shape, mesh_names=names,
            num_microbatches=micro, batch_axis=batch_axis, tp_axis=tp_axis)))
    out.append(("errors", "pipeline_errors", dict(zip(("kernels", "biases", "x"), data(0)),
                                                  h=STEP)))
    for name, (kw, shape, names, tp) in MODELS.items():
        out.append((f"model_{name}", "model_forward_and_grads", dict(
            config=port_config_of(config(**kw)), params=params_from_jax(PARAMS[name]),
            images=IMAGES, labels=LABELS, mesh_shape=shape, mesh_names=names, tp=tp, pp=True,
            pp_microbatches=4)))
    out.append(("dp_pp_step", "train", dict(
        config=dataclasses.replace(port_config_of(config(**STEP_CONFIG)), pp_microbatches=2,
                                   pp_batch_axis="data"),
        params=params_from_jax(STEP_PARAMS), batches=STEPS, lr=LR, mesh_shape=(2, 2),
        mesh_names=("data", "pipe"), pp=True)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(torch_mesh_cases.run, WORLD, tmp_path_factory.mktemp("ranks"), cases())


def in_mesh(ranks, name):
    results = [case_result(r, name) for r in ranks]
    got = [r for r in results if r is not None]
    assert got
    return got


def jax_reference(seed):
    kernels, biases, x = (jnp.asarray(a) for a in data(seed))

    def loss(k, b, xx):
        return jnp.sum(reference_euler_dense(xx, k, b, STEP) ** 2)

    value, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(kernels, biases, x)
    return np.asarray(reference_euler_dense(x, kernels, biases, STEP)), float(value), grads


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_values_and_gradients_match_jax(ranks, name):
    y, value, grads = jax_reference(PIPELINES[name][-1])
    got = in_mesh(ranks, name)
    assert len(got) == int(np.prod(PIPELINES[name][0]))
    for g in got:
        np.testing.assert_allclose(g["y"], y, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g["value"], value, rtol=1e-4)
        for a, b in zip(g["grads"], grads):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-5)


def test_pipeline_refuses_what_does_not_split(ranks):
    """The JAX package's ValueErrors: layers over the stages, the batch over
    the microbatches, channels over the TP axis."""
    got = in_mesh(ranks, "errors")[0]
    assert got[0] == "num_layers (6) must divide evenly into 4 pipeline stages"
    assert got[1] == "batch (8) must divide into 3 microbatches"
    assert got[2] == "channels (3) must divide evenly over the 2-way tensor-parallel axis 'model'"


@pytest.mark.parametrize("name", list(MODELS))
def test_model_level_pipeline_matches_jax(ranks, name):
    kw = MODELS[name][0]
    model = jax_build(config(**kw))
    _, state = model.init(jax.random.key(0))
    x, y = jnp.asarray(IMAGES), jnp.asarray(LABELS)
    params = PARAMS[name]

    def loss(p):
        logits, _ = model.apply(p, state, x, return_logits=True)
        return cross_entropy_from_logits(logits, y)

    logits, _ = model.apply(params, state, x, return_logits=True)
    grads = jax.grad(loss)(params)
    for got in in_mesh(ranks, f"model_{name}"):
        np.testing.assert_allclose(got["logits"], np.asarray(logits), rtol=1e-5, atol=1e-5)
        assert_trees_close(got["grads"], grads, rtol=2e-4, atol=1e-6)
        assert got["routes"]["pipeline"] >= 1


def test_data_parallel_pipelined_step_matches_jax(ranks):
    """A (data 2, pipe 2) mesh: make_train_step splits the batch over data,
    the model pipelines each rank's rows over pipe; JAX's step with
    pp_mesh and pp_batch_axis='data' on the same mesh."""
    mesh = jax_mesh((2, 2), ("data", "pipe"))
    want = jax_train(config(**STEP_CONFIG, pp_mesh=mesh, pp_microbatches=2,
                            pp_batch_axis="data"), STEP_PARAMS, STEPS, LR, mesh=mesh)
    for got in in_mesh(ranks, "dp_pp_step"):
        assert_rows_close(got["rows"], want["rows"])
        assert_trees_close(got["params"], want["params"], atol=1e-3)


def test_model_config_refuses_what_the_pipeline_does_not_run():
    """The JAX package's config checks (single_block_resnet.py:177-195)."""
    mesh, other = object(), object()
    for fields in (dict(integrator="rk4"), dict(use_batch_norm=True), dict(use_pallas=True)):
        with pytest.raises(ValueError, match="pipeline parallelism"):
            dataclasses.replace(port_config(num_layers=4), pp_mesh=mesh, **fields)
    with pytest.raises(ValueError, match="ONE mesh"):
        port_config(num_layers=4, pp_mesh=mesh, tp_mesh=other)
    port_config(num_layers=4, pp_mesh=mesh, tp_mesh=mesh)
