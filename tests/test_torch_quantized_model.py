"""int8 in both model families of the port against the JAX package, on the
CPU: int8-forward train steps in every backward mode (single-block Euler,
midpoint and RK4 trunks; bottleneck blocks), the quantized serving forward
(`models.quantized`) of both families, its narrow-gate fallback, int8
exports of either package through the port's `load_exported`, the config's
validation and routing, and ``export --int8`` / ``train --int8-forward``
through the port's CLI.  The int8 gates are lowered alike in both packages
where a test must cross them at a small width."""

import dataclasses
import json
import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.models import (
    SingleBlockResNetConfig as JaxConfig,
    bottleneck_resnet as jax_bottleneck,
    build_single_block_resnet as jax_build,
    cifar10_single_block_config as jax_cifar10_config,
    quantized as jax_quantized,
)
from differential_equations_resnet_tpu.train import (
    TrainState as JaxTrainState,
    make_adam as jax_make_adam,
    make_train_step as jax_make_train_step,
)
from differential_equations_resnet_tpu.utils import serving as jax_serving
from differential_equations_resnet_tpu.utils.serving import _config_to_json
from differential_equations_resnet_tpu_torch import cli
from differential_equations_resnet_tpu_torch.models import (
    apply_quantized,
    apply_resnet_quantized,
    apply_single_block_resnet_quantized,
    build_single_block_resnet,
    cifar10_single_block_config,
    make_quantized_forward,
    single_block_resnet as sbr,
)
from differential_equations_resnet_tpu_torch.models.quantized import (
    BOTTLENECK_MIN_MID_CHANNELS,
    MIN_CHANNELS,
)
from differential_equations_resnet_tpu_torch.train import make_adam, make_train_step
from differential_equations_resnet_tpu_torch.utils.serving import export_model, load_exported

from torch_parity import (
    drawn_bottleneck_trees,
    jax_params_with_biases,
    narrow_bottleneck_config,
    norm_rel,
    port_model,
)

LR = 1e-3
LOSS_TOL = 1e-4     # train-step loss, relative
NORMS_TOL = 1e-3    # the per-layer gradient-norm row, relative
# Quantized logits, norm-relative: fp32 sums upstream of a quantizer (the
# stem, batch norm) differ in the last bit between the packages, which can
# move an activation across a rounding boundary and change its int8 value
# by one step.
SERVE_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs a worker a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def images(batch, size=32, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (batch, size, size, 3)).astype(np.float32)


def labels(batch, classes=10, seed=0):
    return np.random.default_rng(seed + 100).integers(0, classes, batch).astype(np.int32)


def assert_steps_match(jax_step, train_state, step, batches):
    """Each batch through both steps: loss, correct, the grad-norm row."""
    for x, y in batches:
        train_state, jax_metrics, jax_norms = jax_step(train_state, jnp.asarray(x),
                                                       jnp.asarray(y), LR)
        metrics, norms = step(torch.from_numpy(x), torch.from_numpy(y), LR)
        np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]),
                                   rtol=LOSS_TOL)
        assert float(metrics["correct"]) == float(jax_metrics["correct"])
        np.testing.assert_allclose(norms.numpy(), np.asarray(jax_norms), rtol=NORMS_TOL)


@pytest.mark.parametrize("integrator,mode", [
    ("euler", "ste"), ("euler", "dgrad"), ("euler", "wgrad"), ("euler", "full"),
    ("midpoint", "wgrad"), ("rk4", "ste"),
])
def test_single_block_int8_train_steps_match_jax(integrator, mode):
    """2 train steps at 3L x 8F, batch 4, from the same params: the int8
    trunk (per-tensor scales, the mode's backward) through both packages'
    train steps."""
    config = jax_cifar10_config(num_layers=3, num_filters=8, s2d_block=0, integrator=integrator,
                                int8_forward=True, int8_backward=mode)
    jax_model = jax_build(config)
    params, _ = jax_params_with_biases(jax_model, 1)
    tx = jax_make_adam()
    train_state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                model_state={"stages": [{}]}, opt_state=tx.init(params))
    model = port_model(config, params)
    sbr.per_layer_counts.update(int8=0, s2d=0, direct=0)
    assert_steps_match(jax_make_train_step(jax_model, tx, donate=False), train_state,
                       make_train_step(model, make_adam(model.parameters())),
                       [(images(4, seed=s), labels(4, seed=s)) for s in range(2)])
    assert sbr.per_layer_counts == {"int8": 2, "s2d": 0, "direct": 0}


@pytest.mark.parametrize("version,antisymmetric_mid,mode", [
    (1, True, "wgrad"), (1.5, False, "ste"), (1.5, True, "full"),
])
def test_bottleneck_int8_train_steps_match_jax(version, antisymmetric_mid, mode):
    """One train step at batch 8 of the narrow bottleneck model with its
    int8 gate lowered to the mid width 8, so every block's stride-1 convs
    run int8 (strided ones fp), against the JAX package's step."""
    config = narrow_bottleneck_config(version, antisymmetric_mid, int8_forward=True,
                                      int8_backward=mode, int8_min_mid_channels=8)
    params, state = drawn_bottleneck_trees(config, 30)
    tx = jax_make_adam()
    train_state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state=state,
                                opt_state=tx.init(params))
    model = port_model(config, params, state)
    assert_steps_match(jax_make_train_step(jax_bottleneck.build_resnet(config), tx, donate=False),
                       train_state, make_train_step(model, make_adam(model.parameters())),
                       [(images(8, seed=31), labels(8, classes=5, seed=31))])


def single_block_serving_config(**fields):
    return JaxConfig(image_shape=(16, 16, 3), h=0.25, num_stages=3, blocks_per_stage=(2, 2),
                     filters_per_block=(8, 16), strides=((1, 1), (2, 2)), num_classes=5,
                     subtract_mean=127.5, divide_by_stddev=127.5, **fields)


@pytest.mark.parametrize("fields", [
    dict(), dict(integrator="rk4"), dict(use_batch_norm=True, kernel_type="regular"),
], ids=["euler", "rk4", "batch-norm"])
def test_single_block_quantized_forward_matches_jax(fields):
    """`apply_single_block_resnet_quantized` with the gate at 8 (both
    stages int8: the 8-wide stem stage and the 16-wide conv-block stage),
    batch 4, against the JAX function: logits to 1e-2 norm-relative, and
    away from the fp forward (the int8 path ran)."""
    config = single_block_serving_config(**fields)
    jax_model = jax_build(config)
    params, state = jax_params_with_biases(jax_model, 40)
    x = images(4, size=16, seed=41)
    want = jax.jit(lambda p, s, v: jax_quantized.apply_single_block_resnet_quantized(
        p, s, v, config, min_channels=8, return_logits=True))(params, state, jnp.asarray(x))
    model = port_model(config, params, state)
    with torch.no_grad():
        got = apply_single_block_resnet_quantized(model.params(), model.state(),
                                                  torch.from_numpy(x), model.config,
                                                  min_channels=8, return_logits=True)
        fp = model(torch.from_numpy(x), return_logits=True)
    assert norm_rel(got, want) <= SERVE_TOL
    assert norm_rel(got, fp) > 0


@pytest.mark.parametrize("version,antisymmetric_mid", [(1, True), (1.5, False)],
                         ids=["v1-antisymmetric", "v1.5-regular"])
def test_bottleneck_quantized_forward_matches_jax(version, antisymmetric_mid):
    """`apply_resnet_quantized` with the mid-width gate at 8 (every stage
    int8, the strided 1x1 (v1) or 3x3 (v1.5) convs and the strided
    shortcuts included) against the JAX function, logits to 1e-2."""
    config = narrow_bottleneck_config(version, antisymmetric_mid)
    params, state = drawn_bottleneck_trees(config, 42)
    x = images(4, seed=43)
    want = jax.jit(lambda p, s, v: jax_quantized.apply_resnet_quantized(
        p, s, v, config, min_mid_channels=8, return_logits=True))(params, state, jnp.asarray(x))
    model = port_model(config, params, state)
    got = make_quantized_forward(model, min_channels=8, return_logits=True)(torch.from_numpy(x))
    assert norm_rel(got, want) <= SERVE_TOL
    with torch.no_grad():
        assert norm_rel(apply_resnet_quantized(model.params(), model.state(),
                                               torch.from_numpy(x), model.config,
                                               min_mid_channels=8, return_logits=True), got) == 0


def test_narrow_gate_falls_back_to_the_fp_forward_exactly():
    """With the default gates (trunk 128, mid 256) the narrow models are not
    quantized: `apply_quantized` is the model's own forward, bit for bit."""
    assert (MIN_CHANNELS, BOTTLENECK_MIN_MID_CHANNELS) == (128, 256)
    single = single_block_serving_config()
    params, state = jax_params_with_biases(jax_build(single), 44)
    bottleneck = narrow_bottleneck_config(1, True)
    for config, (p, s) in ((single, (params, state)),
                           (bottleneck, drawn_bottleneck_trees(bottleneck, 45))):
        model = port_model(config, p, s)
        size = config.image_shape[0]
        x = torch.from_numpy(images(3, size=size, seed=46))
        with torch.no_grad():
            np.testing.assert_array_equal(
                apply_quantized(model.params(), model.state(), x, model.config).numpy(),
                model(x).numpy())


def wide_single_block(layers=2):
    """A single-block model whose trunk crosses the default 128 gate, at a
    CPU test's size: 8x8 images, 128 filters."""
    return JaxConfig(image_shape=(8, 8, 3), h=0.25, num_stages=2, blocks_per_stage=(layers,),
                     filters_per_block=(128,), strides=((1, 1),), num_classes=10,
                     subtract_mean=127.5, divide_by_stddev=127.5)


def test_jax_int8_export_served_by_the_port(tmp_path):
    """A JAX ``export_model(quantize="int8")`` of a 128-wide model, loaded
    by the port's `load_exported`: the manifest says int8, the port serves
    it through its quantized forward, and the probabilities agree with the
    JAX loader's to 1e-2."""
    config = wide_single_block()
    jax_model = jax_build(config)
    params, state = jax_params_with_biases(jax_model, 47)
    out = jax_serving.export_model(jax_model, str(tmp_path / "jax_int8"), params=params,
                                   model_state=state, batch_size=2, stablehlo=False,
                                   quantize="int8")
    want_predict, _ = jax_serving.load_exported(out, prefer_stablehlo=False)
    predict, manifest = load_exported(out, device="cpu")
    assert manifest["quantize"] == "int8"
    x = images(2, size=8, seed=48)
    got = predict(x)
    assert norm_rel(got, want_predict(x)) <= SERVE_TOL
    model = port_model(config, params, state)
    np.testing.assert_array_equal(got, make_quantized_forward(model)(torch.from_numpy(x)).numpy())
    with torch.no_grad():
        assert norm_rel(got, model(torch.from_numpy(x)).numpy()) > 0


@pytest.mark.parametrize("family", ["single_block", "bottleneck"])
def test_port_int8_export_round_trip(tmp_path, family):
    """The port's own int8 export: ``"quantize": "int8"`` in config.json,
    fp32 parameters, and the loader serves exactly what
    `make_quantized_forward` of the exported model computes (gates lowered
    by nothing: the wide single-block trunk crosses 128; the narrow
    bottleneck model serves fp)."""
    if family == "single_block":
        config, size = wide_single_block(layers=1), 8
        params, state = jax_params_with_biases(jax_build(config), 49)
    else:
        config, size = narrow_bottleneck_config(1.5, True), 32
        params, state = drawn_bottleneck_trees(config, 49)
    model = port_model(config, params, state)
    out = export_model(model, str(tmp_path / "int8"), quantize="int8")
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f)["quantize"] == "int8"
    predict, manifest = load_exported(out, device="cpu")
    assert manifest["family"] == family
    x = images(2, size=size, seed=50)
    np.testing.assert_array_equal(predict(x),
                                  make_quantized_forward(model)(torch.from_numpy(x)).numpy())
    with pytest.raises(ValueError, match="quantize"):
        export_model(model, str(tmp_path / "int4"), quantize="int4")


def test_int8_validation_and_routing_match_jax():
    """``int8_forward`` with batch norm or ``use_pallas`` raises the JAX
    package's ValueError; an int8 Euler stack the fused route would take
    goes layer by layer; 'dgrad'/'full' warn at trunk width >= 64 only."""
    base = cifar10_single_block_config(num_layers=2, num_filters=8)
    for fields in (dict(use_batch_norm=True), dict(use_pallas=True)):
        with pytest.raises(ValueError, match="int8_forward requires the plain integrator"):
            dataclasses.replace(base, int8_forward=True, **fields)
        with pytest.raises(ValueError, match="int8_forward requires the plain integrator"):
            JaxConfig(num_classes=5, int8_forward=True, **fields)
    with pytest.raises(ValueError, match="requires int8_forward=True"):
        dataclasses.replace(base, int8_backward="wgrad")
    config = dataclasses.replace(base, int8_forward=True, int8_backward="full")
    x = torch.zeros(2, 32, 32, 8)
    model = build_single_block_resnet(config, generator=torch.Generator().manual_seed(0),
                                      device="cpu")
    dense = sbr._dense_blocks(model.params()["stages"][0]["blocks"], config)
    assert sbr.identity_route(config, x, dense) == "per_layer"
    assert sbr.identity_route(dataclasses.replace(base), x, dense) == "fused"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sbr._warn_int8_divergent_backward(config, x)
        sbr._warn_int8_divergent_backward(dataclasses.replace(config, int8_backward="wgrad"),
                                          torch.zeros(1, 4, 4, 64))
    with pytest.warns(UserWarning, match="diverged"):
        sbr._warn_int8_divergent_backward(config, torch.zeros(1, 4, 4, 64))


def test_int8_forward_overrides_s2d():
    """An int8 stack with s2d forced runs int8 in the direct layout, as in
    the JAX package, and its logits are the JAX int8 model's."""
    config = jax_cifar10_config(num_layers=2, num_filters=8, s2d_block=2, s2d_force=True,
                                int8_forward=True)
    jax_model = jax_build(config)
    params, state = jax_params_with_biases(jax_model, 51)
    x = images(2, seed=52)
    want, _ = jax_model.apply(params, state, jnp.asarray(x), return_logits=True)
    model = port_model(config, params)
    sbr.per_layer_counts.update(int8=0, s2d=0, direct=0)
    with torch.no_grad():
        got = model(torch.from_numpy(x), return_logits=True)
    assert sbr.per_layer_counts == {"int8": 1, "s2d": 0, "direct": 0}
    assert norm_rel(got, want) <= LOSS_TOL


def run(capsys, *argv):
    assert cli.main(list(argv)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_export_int8_and_train_int8(tmp_path, capsys):
    """``export --int8`` then `load_exported` serves int8 (a 128-wide trunk:
    not the fp forward), and ``train --int8-forward --int8-backward wgrad``
    takes its steps with a finite loss and builds the JAX CLI's config."""
    from differential_equations_resnet_tpu import cli as jax_cli
    from differential_equations_resnet_tpu_torch.utils.serving import config_from_json

    wide = ["--num-layers", "1", "--num-filters", "128", "--device", "cpu"]
    out = run(capsys, "export", str(tmp_path / "export"), *wide, "--int8")
    predict, manifest = load_exported(out["export_dir"], device="cpu")
    assert manifest["quantize"] == "int8"
    model = build_single_block_resnet(config_from_json(manifest["config"]),
                                      generator=torch.Generator().manual_seed(0), device="cpu")
    x = images(2, seed=53)
    np.testing.assert_array_equal(predict(x),
                                  make_quantized_forward(model)(torch.from_numpy(x)).numpy())
    flags = ["--num-layers", "2", "--num-filters", "4", "--device", "cpu", "--int8-forward",
             "--int8-backward", "wgrad"]
    result = run(capsys, "train", *flags, "--epochs", "1", "--steps-per-epoch", "3",
                 "--synthetic-train-size", "64", "--synthetic-val-size", "16",
                 "--csv-dir", str(tmp_path / "csv"))
    assert np.isfinite(result["best"]["loss"])
    built = cli._build_model(_parsed(flags))
    want = config_from_json(_config_to_json(jax_cli._build_model(_parsed(flags)).config))
    assert built.config == want and built.config.int8_backward == "wgrad"


def _parsed(flags):
    """The port CLI's parsed arguments of ``train`` with ``flags``."""
    import argparse

    parser = argparse.ArgumentParser()
    cli._add_model_args(parser)
    return parser.parse_args(flags)
