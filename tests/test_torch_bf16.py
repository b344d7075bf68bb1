"""bf16 compute in both model families against the JAX package in bf16, on
the CPU: the single-block model (antisymmetric and regular kernels; Euler,
midpoint and RK4; with and without batch norm) and a narrow bottleneck
model, one train step (loss, grad-norm row, the parameters after Adam), an
export -> load round trip, and the library sweep's default dtype.

Inputs are made with NumPy from a seed and the parameters carried over with
`params_from_jax`, so both packages compute on the same numbers.  The two
round to bf16 at the same places (the input, every convolution, batch norm
and dense output, each residual update) but sum in fp32 in other orders, so
a last-bit difference before a rounding moves a value by one bf16 ulp (2^-8
relative) and later layers carry it on: outputs agree to about 1e-2
norm-relative (BF16_TOL), not to fp32's 1e-5."""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.experiments import sweeps as jax_sweeps
from differential_equations_resnet_tpu.models import bottleneck_resnet as jax_bottleneck
from differential_equations_resnet_tpu.models import (
    build_single_block_resnet as jax_build,
    cifar10_single_block_config as jax_cifar10_config,
)
from differential_equations_resnet_tpu.train import (
    create_train_state as jax_create_train_state,
    make_adam as jax_make_adam,
    make_train_step as jax_make_train_step,
)
from differential_equations_resnet_tpu.utils.serving import _config_to_json
from differential_equations_resnet_tpu_torch import experiments
from differential_equations_resnet_tpu_torch.models import single_block_resnet as sbr
from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi
from differential_equations_resnet_tpu_torch.train import make_adam, make_train_step
from differential_equations_resnet_tpu_torch.utils.serving import (
    config_from_json,
    config_to_json,
    export_model,
    load_exported,
)
from differential_equations_resnet_tpu_torch.utils.weight_utils import params_to_jax

from torch_parity import (
    JAX_CLASSES,
    drawn_bottleneck_trees,
    jax_params_and_state,
    jax_params_with_biases,
    narrow_bottleneck_config,
    norm_rel,
    port_model,
)

# Norm-relative, port against JAX, both in bf16 (see the module docstring).
BF16_TOL = 2e-2
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs a worker a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def single_block_config(kernel_type="antisymmetric", integrator="euler", layers=3, filters=8,
                        **fields):
    """The JAX package's CIFAR-10 config at test size, in bf16."""
    return dataclasses.replace(
        jax_cifar10_config(num_layers=layers, final_time=0.125 * layers, num_filters=filters,
                           kernel_type=kernel_type, integrator=integrator, s2d_block=0,
                           compute_dtype=jnp.bfloat16), **fields)


def images(batch, seed):
    return np.random.default_rng(seed).uniform(0, 255, (batch, 32, 32, 3)).astype(np.float32)


MODELS = [(k, i, False) for k in ("antisymmetric", "regular") for i in ("euler", "midpoint", "rk4")]
MODELS += [(k, "euler", True) for k in ("antisymmetric", "regular")]


@pytest.mark.parametrize("kernel_type,integrator,batch_norm", MODELS,
                         ids=[f"{k}-{i}{'-bn' if b else ''}" for k, i, b in MODELS])
def test_single_block_logits_match_jax_in_bf16(kernel_type, integrator, batch_norm):
    """Logits in eval mode (and in train mode with batch norm, on the
    batch's statistics) at 3L x 8F, batch 4, against JAX apply in bf16; the
    logits are fp32 (the head runs on an fp32 input), the stack takes the
    per-layer route, and the model's parameters stay fp32."""
    config = single_block_config(kernel_type, integrator, use_batch_norm=batch_norm)
    jax_model = jax_build(config)
    params, state = (jax_params_and_state if batch_norm else jax_params_with_biases)(jax_model, 5)
    model = port_model(config, params, state if batch_norm else None)
    assert model.config.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = images(4, 6)
    sbr.route_counts.update(fused=0, per_layer=0)
    with torch.no_grad():
        for train in ((False, True) if batch_norm else (False,)):
            want, _ = jax_model.apply(params, state, jnp.asarray(x), train=train,
                                      return_logits=True)
            got = model(torch.from_numpy(x), return_logits=True, train=train)
            assert got.dtype == torch.float32
            assert norm_rel(got, want) <= BF16_TOL, train
    assert sbr.route_counts["fused"] == 0


@pytest.mark.parametrize("version,antisymmetric_mid", [(1, True), (1.5, False)],
                         ids=["v1-antisymmetric", "v1.5-regular"])
def test_narrow_bottleneck_logits_match_jax_in_bf16(version, antisymmetric_mid):
    """The narrow bottleneck model in bf16 against JAX apply in bf16: eval
    mode to BF16_TOL.  In train mode batch norm normalizes its last stages
    over a few values (1x1 at 32x32), where bf16 itself moves the logits
    5-15% from the fp32 forward in either package; there the judge is JAX's
    fp32 forward: the port in bf16 is as close to it as the JAX package in
    bf16 is (2x its distance + BF16_TOL).  The running statistics a
    train-mode forward writes stay fp32."""
    config = narrow_bottleneck_config(version, antisymmetric_mid, compute_dtype=jnp.bfloat16)
    jax_model = jax_bottleneck.build_resnet(config)
    judge = jax_bottleneck.build_resnet(dataclasses.replace(config, compute_dtype=jnp.float32))
    params, state = drawn_bottleneck_trees(config, 21)
    model = port_model(config, params, state)
    x = images(4, 22)
    with torch.no_grad():
        want, _ = jax_model.apply(params, state, jnp.asarray(x), return_logits=True)
        assert norm_rel(model(torch.from_numpy(x), return_logits=True), want) <= BF16_TOL
        want, _ = jax_model.apply(params, state, jnp.asarray(x), train=True, return_logits=True)
        exact, new_state = judge.apply(params, state, jnp.asarray(x), train=True,
                                       return_logits=True)
        got = model(torch.from_numpy(x), return_logits=True, train=True)
        assert got.dtype == torch.float32
        assert norm_rel(got, exact) <= 2 * norm_rel(np.asarray(want), exact) + BF16_TOL
    got_state = jax.tree.leaves(params_to_jax(model.state(), JAX_CLASSES))
    want_state = jax.tree.leaves(new_state)
    assert len(got_state) == len(want_state)
    for g, w in zip(got_state, want_state):
        assert g.dtype == np.float32
        assert norm_rel(g, w) <= BF16_TOL


def jax_step(config, params, model_state, x, y):
    """(metrics, grad-norm row, params) of one JAX train step from these
    parameters and running statistics."""
    jax_model = jax_build(config)
    tx = jax_make_adam()
    state = jax_create_train_state(jax_model, jax.random.key(0), tx)
    state = state._replace(params=params, model_state=model_state, opt_state=tx.init(params))
    state, metrics, norms = jax_make_train_step(jax_model, tx, donate=False)(
        state, jnp.asarray(x), jnp.asarray(y), LR)
    return metrics, np.asarray(norms), state.params


@pytest.mark.parametrize("kernel_type,batch_norm", [("antisymmetric", False), ("regular", True)])
def test_train_step_matches_jax_in_bf16(kernel_type, batch_norm):
    """One train step at 3L x 8F, batch 8, from the same parameters: the
    loss (log-softmax in fp32) to BF16_TOL, the count exactly, every
    parameter fp32 and, after Adam, within 2 lr of the JAX package's
    (Adam's first step moves an element by about lr * sign(g), and a bf16
    gradient near 0 may take either sign).  The grad-norm row agrees with
    the JAX package's in bf16 to BF16_TOL or, with batch norm, is closer to
    its fp32 step than its bf16 step is, and within BF16_TOL of it: there
    the identity layers' true kernel gradients are ~1e-5 and the JAX
    package's bf16 batch-norm backward on the CPU reports ~10x that, while
    the port's stays within 1% of the fp32 step."""
    config = single_block_config(kernel_type, use_batch_norm=batch_norm)
    params, model_state = (jax_params_and_state if batch_norm
                           else jax_params_with_biases)(jax_build(config), 7)
    model = port_model(config, params, model_state if batch_norm else None)
    x = images(8, 8)
    y = np.random.default_rng(8).integers(0, 10, 8).astype(np.int32)
    jax_metrics, jax_norms, jax_params = jax_step(config, params, model_state, x, y)
    metrics, norms = make_train_step(model, make_adam(model.parameters()))(
        torch.from_numpy(x), torch.from_numpy(y), LR)
    assert metrics["loss"].dtype == torch.float32
    np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]), rtol=BF16_TOL)
    assert float(metrics["count"]) == float(jax_metrics["count"]) == 8
    assert norms.dtype == torch.float32 and norms.shape == jax_norms.shape
    if batch_norm:
        _, exact, _ = jax_step(dataclasses.replace(config, compute_dtype=jnp.float32), params,
                               model_state, x, y)
        assert norm_rel(norms, exact) <= min(BF16_TOL, norm_rel(jax_norms, exact))
    else:
        assert norm_rel(norms, jax_norms) <= BF16_TOL
    got = jax.tree.leaves(params_to_jax(model.params(), JAX_CLASSES))
    want = jax.tree.leaves(jax_params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        assert np.abs(g - np.asarray(w)).max() <= 2 * LR


def test_bf16_export_round_trip(tmp_path):
    """A bf16 model exports with its dtype by name, as the JAX package's
    config.json names it, and loads back to the same probabilities."""
    config = single_block_config(layers=2, filters=4)
    params, _ = jax_params_with_biases(jax_build(config), 9)
    model = port_model(config, params)
    export_dir = export_model(model, str(tmp_path / "bf16"), batch_size=2)
    with open(os.path.join(export_dir, "config.json")) as f:
        manifest = json.load(f)
    assert manifest["config"]["compute_dtype"] == "bfloat16"
    assert manifest["config"] == json.loads(json.dumps(_config_to_json(config)))
    assert config_from_json(manifest["config"]) == model.config
    assert config_to_json(model.config)["compute_dtype"] == "bfloat16"
    predict, loaded = load_exported(export_dir, device="cpu")
    x = images(3, 10)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(predict(x), want)
    assert loaded["config"]["compute_dtype"] == "bfloat16"


def test_imagenet32_config_defaults_to_bf16():
    """The library workload computes in bf16 by default, as the JAX
    package's does, and equals its config."""
    want = jax_sweeps.imagenet32_config(num_layers=4, num_filters=8)
    got = experiments.imagenet32_config(num_layers=4, num_filters=8)
    assert np.dtype(want.compute_dtype) == np.dtype(jnp.bfloat16)
    assert got.compute_dtype == torch.bfloat16
    assert got == config_from_json(_config_to_json(want))


def test_a_bf16_stack_never_takes_the_kernels():
    """The JAX gate takes fp32 only: a bf16 state is declined by the
    kernels' gate, and a use_pallas antisymmetric bf16 stack takes the
    per-layer route, with or without a gradient."""
    config = config_from_json(_config_to_json(single_block_config(use_pallas=True)))
    model = port_model(single_block_config(use_pallas=True),
                       jax_params_with_biases(jax_build(single_block_config()), 11)[0])
    dense = sbr._dense_blocks(model.params()["stages"][0]["blocks"], config)
    x = torch.zeros(2, 32, 32, 8, dtype=torch.bfloat16)
    assert not fi.fused_euler_eligible(x, dense)
    assert not sbr.jax_runs_pallas(config, x)
    assert sbr.identity_route(config, x, dense) == "per_layer"
    with torch.no_grad():
        assert sbr.identity_route(config, x, dense) == "per_layer"
    sbr.route_counts.update(fused=0, per_layer=0)
    make_train_step(model, make_adam(model.parameters()))(
        torch.from_numpy(images(2, 12)), torch.zeros(2, dtype=torch.long), LR)
    assert sbr.route_counts == {"fused": 0, "per_layer": 1}
