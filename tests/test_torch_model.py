"""The port's single-block ODE-ResNet against the JAX package's `model.apply`
on the same parameters (carried over by `params_from_jax`) and against the
fp64 golden fixture."""

import dataclasses
import json
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.models import (
    SingleBlockResNetConfig as JaxConfig,
    build_single_block_resnet as jax_build,
    cifar10_single_block_config as jax_cifar10_config,
)
from differential_equations_resnet_tpu.utils.serving import _config_to_json
from differential_equations_resnet_tpu.utils.weight_utils import import_reference_weights
from differential_equations_resnet_tpu_torch.models import (
    build_single_block_resnet,
    cifar10_single_block_config,
)
from differential_equations_resnet_tpu_torch.models.single_block_resnet import stage_plans
from differential_equations_resnet_tpu_torch.utils.serving import config_from_json
from differential_equations_resnet_tpu_torch.utils.weight_utils import (
    params_from_jax,
    params_to_jax,
)

from golden.make_golden import fixture_config
from torch_parity import JAX_CLASSES, jax_params_with_biases, port_model

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
TOL = dict(rtol=5e-5, atol=5e-5)  # tests/test_golden_fixture.py's bound


def check_model(config, seed, batch=2):
    jax_model = jax_build(config)
    params, state = jax_params_with_biases(jax_model, seed)
    x = np.random.default_rng(seed).uniform(0, 255, (batch, *config.image_shape))
    x = x.astype(np.float32)
    model = port_model(config, params)
    with torch.no_grad():
        for logits in (True, False):
            want, _ = jax_model.apply(params, state, jnp.asarray(x), return_logits=logits)
            got = model(torch.from_numpy(x), return_logits=logits)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("layers,filters", [(8, 8), (4, 16)])
def test_model_matches_jax_apply(layers, filters):
    check_model(jax_cifar10_config(num_layers=layers, num_filters=filters, s2d_block=0),
                seed=layers)


def test_jax_default_s2d_config_gives_the_same_numbers():
    """JAX's cifar10 default s2d_block=2 (forced on, since the JAX gate keeps
    it off on CPU platforms) is an exact layout transform: the port accepts
    the fields, ignores them and gives the same numbers."""
    config = jax_cifar10_config(num_layers=4, num_filters=8, s2d_force=True)
    assert config.s2d_block == 2
    check_model(config, seed=11)


def test_multi_stage_model_with_conv_block_and_pooling():
    """Stride-2 conv blocks, max pooling and two identity stacks."""
    config = JaxConfig(
        image_shape=(12, 12, 3), num_stages=3, blocks_per_stage=(2, 3),
        filters_per_block=(4, 8), strides=((1, 1), (2, 2)), num_classes=5,
        use_max_pooling=(False, True, False, False), h=0.3, gamma=0.05,
        subtract_mean=127.5, divide_by_stddev=127.5,
    )
    assert [p.has_conv_block for p in stage_plans(config_from_json(_config_to_json(config)))] \
        == [False, True]
    check_model(config, seed=12, batch=3)


def test_golden_fixture():
    with open(os.path.join(GOLDEN_DIR, "reference_weights_8L8F.pkl"), "rb") as f:
        weights = pickle.load(f)
    x = np.load(os.path.join(GOLDEN_DIR, "input_batch.npy"))
    want_logits = np.load(os.path.join(GOLDEN_DIR, "expected_logits_fp64.npy"))
    want_probs = np.load(os.path.join(GOLDEN_DIR, "expected_probs_fp64.npy"))
    config = fixture_config()
    template, _ = jax_build(config).init(jax.random.key(0))
    model = port_model(config, import_reference_weights(weights, template, config))
    with torch.no_grad():
        logits = model(torch.from_numpy(x), return_logits=True).numpy()
        probs = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(logits, want_logits, **TOL)
    np.testing.assert_allclose(probs, want_probs, **TOL)


def test_params_round_trip_through_both_packages():
    config = jax_cifar10_config(num_layers=3, num_filters=4, s2d_block=0)
    jax_model = jax_build(config)
    model = build_single_block_resnet(
        config_from_json(_config_to_json(config)),
        generator=torch.Generator().manual_seed(3), device="cpu",
    )
    as_jax = params_to_jax(model.params(), JAX_CLASSES)
    template, state = jax_model.init(jax.random.key(0))
    assert jax.tree.structure(as_jax) == jax.tree.structure(template)
    back = params_from_jax(as_jax)
    got = dict(build_single_block_resnet(model.config, params=back, device="cpu").state_dict())
    assert got.keys() == model.state_dict().keys()
    for key, value in model.state_dict().items():
        assert torch.equal(got[key], value), key
    x = np.random.default_rng(0).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    want, _ = jax_model.apply(as_jax, state, jnp.asarray(x), return_logits=True)
    with torch.no_grad():
        np.testing.assert_allclose(
            model(torch.from_numpy(x), return_logits=True).numpy(), np.asarray(want), **TOL
        )


def test_port_config_matches_the_jax_keyword_surface():
    jax_fields = {f.name for f in dataclasses.fields(JaxConfig)}
    port_config = cifar10_single_block_config(num_layers=64, num_filters=16)
    assert {f.name for f in dataclasses.fields(port_config)} == jax_fields
    assert port_config.h == 0.125 and port_config.s2d_block == 0
    # A JAX config.json, keys and values, builds the port's config.
    as_json = json.loads(json.dumps(_config_to_json(jax_cifar10_config())))
    assert config_from_json(as_json).blocks_per_stage == (64,)


@pytest.mark.parametrize("overrides,item", [
    (dict(use_batch_norm=True), "A10"),
    (dict(integrator="midpoint"), "A4"),
    (dict(integrator="rk4"), "A4"),
    (dict(kernel_type="regular"), "A5"),
    (dict(kernel_type="centrosymmetric"), "A2"),
    (dict(int8_forward=True), "A13"),
    (dict(compute_dtype=torch.bfloat16), "A5"),
    (dict(pp_mesh="mesh"), "A15"),
])
def test_features_outside_the_slice_raise(overrides, item):
    config = dataclasses.replace(
        cifar10_single_block_config(num_layers=2, num_filters=4), **overrides
    )
    with pytest.raises(NotImplementedError, match=item):
        build_single_block_resnet(config, generator=torch.Generator(), device="cpu")


def test_build_needs_params_or_generator():
    config = cifar10_single_block_config(num_layers=2, num_filters=4)
    with pytest.raises(TypeError):
        build_single_block_resnet(config, device="cpu")
    with pytest.raises(TypeError):
        build_single_block_resnet(config, image_shape=(8, 8, 3))
