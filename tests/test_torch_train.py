"""The port's training step, telemetry, metrics and schedules against the JAX
package's: the same parameters (carried over by `params_from_jax`) and the
same batches (made with NumPy from a seed) through both train steps."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.models import (
    BottleneckResNetConfig,
    SingleBlockResNetConfig as JaxConfig,
    build_single_block_resnet as jax_build,
    cifar10_single_block_config as jax_cifar10_config,
)
from differential_equations_resnet_tpu.train import schedules as jax_schedules
from differential_equations_resnet_tpu.train import (
    CsvLogger as JaxCsvLogger,
    StreamingMetrics as JaxStreamingMetrics,
    create_train_state as jax_create_train_state,
    gradient_metric_names as jax_gradient_metric_names,
    make_adam as jax_make_adam,
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
)
from differential_equations_resnet_tpu.models.blocks import l2_kernel_penalty as jax_l2
from differential_equations_resnet_tpu.train.train_step import (
    per_example_cross_entropy as jax_per_example_cross_entropy,
)
from differential_equations_resnet_tpu_torch.models.blocks import l2_kernel_penalty
from differential_equations_resnet_tpu_torch.train import (
    CsvLogger,
    StreamingMetrics,
    create_train_state,
    gradient_metric_names,
    make_adam,
    make_eval_step,
    make_train_step,
    schedules,
)
from differential_equations_resnet_tpu_torch.train.train_step import (
    cross_entropy_from_logits,
    per_example_cross_entropy,
)
from differential_equations_resnet_tpu.utils.serving import _config_to_json
from differential_equations_resnet_tpu_torch.utils.serving import config_from_json
from differential_equations_resnet_tpu_torch.utils.weight_utils import params_to_jax

from torch_parity import JAX_CLASSES, jax_params_with_biases, norm_rel, port_model

LR = 1e-3


def batches(steps, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 255, (batch, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, batch).astype(np.int32)) for _ in range(steps)]


def both_trainers(config, seed=1, accum_steps=1):
    """(JAX state, JAX step, port model, port step) from the same params."""
    jax_model = jax_build(config)
    params, _ = jax_params_with_biases(jax_model, seed)
    tx = jax_make_adam()
    state = jax_create_train_state(jax_model, jax.random.key(0), tx)
    state = state._replace(params=params, opt_state=tx.init(params))
    jax_step = jax_make_train_step(jax_model, tx, donate=False)
    model = port_model(config, params)
    state_t = create_train_state(model)
    port_step = make_train_step(state_t.model, state_t.optimizer, accum_steps=accum_steps)
    return state, jax_step, model, port_step


@pytest.mark.parametrize("l2,accum_steps", [(0.0, 1), (5e-4, 1), (0.0, 2)])
def test_three_steps_match_jax(l2, accum_steps):
    """3 steps at 3L x 8F, batch 4, CIFAR shape, from the same params, with
    the L2 penalty on and with 2 microbatches (held against JAX's
    monolithic step).  Loss and grad norms to 1e-4 relative (fp32 sums in
    other orders through 3 layers and Adam); correct and count exactly;
    params after each Adam update elementwise to 2e-6 (an update moves a
    parameter by about lr = 1e-3 at most, and the two packages' updates
    differ only by fp32 rounding of m and v)."""
    config = jax_cifar10_config(num_layers=3, num_filters=8, s2d_block=0, l2_regularization=l2)
    state, jax_step, model, port_step = both_trainers(config, accum_steps=accum_steps)
    for images, labels in batches(3):
        state, jax_metrics, jax_norms = jax_step(state, jnp.asarray(images), jnp.asarray(labels), LR)
        metrics, norms = port_step(torch.from_numpy(images), torch.from_numpy(labels), LR)
        np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]), rtol=1e-4)
        assert float(metrics["correct"]) == float(jax_metrics["correct"])
        assert float(metrics["count"]) == float(jax_metrics["count"]) == len(images)
        assert norms.shape == (4,)
        np.testing.assert_allclose(norms.numpy(), np.asarray(jax_norms), rtol=1e-4)
        got = jax.tree.leaves(params_to_jax(model.params(), JAX_CLASSES))
        want = jax.tree.leaves(state.params)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=2e-6, rtol=0)


def test_accumulated_step_equals_the_monolithic_step():
    """accum_steps=2 on the port against the port's own monolithic step:
    one averaged update, the mean loss and the summed correct count."""
    config = jax_cifar10_config(num_layers=2, num_filters=4, s2d_block=0, l2_regularization=1e-3)
    models = [port_model(config, jax_params_with_biases(jax_build(config), 2)[0])
              for _ in range(2)]
    steps = [make_train_step(m, make_adam(m.parameters()), accum_steps=k)
             for m, k in zip(models, (1, 2))]
    for images, labels in batches(2, batch=6, seed=3):
        out = [s(torch.from_numpy(images), torch.from_numpy(labels), LR) for s in steps]
        np.testing.assert_allclose(float(out[1][0]["loss"]), float(out[0][0]["loss"]), rtol=1e-5)
        assert float(out[1][0]["correct"]) == float(out[0][0]["correct"])
        np.testing.assert_allclose(out[1][1].numpy(), out[0][1].numpy(), rtol=1e-4)
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        torch.testing.assert_close(a, b, atol=2e-6, rtol=0)


def test_ragged_batch_trains_monolithically_with_a_warning():
    config = jax_cifar10_config(num_layers=1, num_filters=4)
    model = port_model(config, jax_params_with_biases(jax_build(config), 4)[0])
    step = make_train_step(model, make_adam(model.parameters()), accum_steps=2)
    (images, labels), = batches(1, batch=3, seed=4)
    with pytest.warns(UserWarning, match="not divisible by accum_steps=2"):
        metrics, _ = step(torch.from_numpy(images), torch.from_numpy(labels), LR)
    assert float(metrics["count"]) == 3
    with pytest.raises(ValueError, match="accum_steps"):
        make_train_step(model, make_adam(model.parameters()), accum_steps=0)


def test_eval_step_and_l2_penalty_match_jax():
    """Eval reports plain cross-entropy, never the L2 penalty; the penalty
    itself covers kernels and packed leaves, not biases."""
    config = jax_cifar10_config(num_layers=3, num_filters=8, s2d_block=0, l2_regularization=1e-2)
    jax_model = jax_build(config)
    params, state = jax_params_with_biases(jax_model, 5)
    model = port_model(config, params)
    (images, labels), = batches(1, batch=5, seed=5)
    want = jax_make_eval_step(jax_model)(params, state, jnp.asarray(images), jnp.asarray(labels))
    got = make_eval_step(model)(torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    assert float(got["correct"]) == float(want["correct"])
    assert float(got["count"]) == 5
    np.testing.assert_allclose(float(l2_kernel_penalty(model.params(), 1e-2).detach()),
                               float(jax_l2(params, 1e-2)), rtol=1e-6)


def test_cross_entropy_integer_and_one_hot_labels():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((5, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 5)
    one_hot = np.eye(10, dtype=np.float32)[labels]
    want = np.asarray(jax_per_example_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    for lab in (torch.from_numpy(labels), torch.from_numpy(one_hot)):
        np.testing.assert_allclose(
            per_example_cross_entropy(torch.from_numpy(logits), lab).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        float(cross_entropy_from_logits(torch.from_numpy(logits), torch.from_numpy(labels))),
        want.mean(), rtol=1e-6)


@pytest.mark.parametrize("config", [
    jax_cifar10_config(num_layers=64, num_filters=16),
    JaxConfig(image_shape=(12, 12, 3), num_stages=3, blocks_per_stage=(2, 3),
              filters_per_block=(4, 8), strides=((1, 1), (2, 2)), num_classes=5),
])
def test_gradient_metric_names_match_jax(config):
    names = gradient_metric_names(config_from_json(_config_to_json(config)))
    assert names == jax_gradient_metric_names(config)


def test_headline_names_are_conv1_and_64_residual_layers():
    names = gradient_metric_names(config_from_json(_config_to_json(jax_cifar10_config())))
    assert len(names) == 65
    assert names[0] == "conv1_kernel_gradient_mean_norm"
    assert names[-1] == "res2_63_branch2_kernel_gradient_mean_norm"


def test_telemetry_of_the_bottleneck_family_waits_for_a12():
    """The bottleneck family's names (the port's config, A12 ported) equal
    the JAX package's; a config of neither family raises."""
    from differential_equations_resnet_tpu_torch.models import (
        BottleneckResNetConfig as PortBottleneckConfig,
    )

    jax_config = BottleneckResNetConfig(num_classes=10, blocks_per_stage=(2, 1, 3, 1))
    names = gradient_metric_names(config_from_json(_config_to_json(jax_config), "bottleneck"))
    assert isinstance(config_from_json(_config_to_json(jax_config), "bottleneck"),
                      PortBottleneckConfig)
    assert names == jax_gradient_metric_names(jax_config)
    assert names[1] == "res2_0_branch2b_kernel_gradient_mean_norm" and len(names) == 8
    with pytest.raises(TypeError):
        gradient_metric_names(jax_config)
    with pytest.raises(TypeError):
        gradient_metric_names(object())


def test_csv_logger_output_is_byte_identical_to_jax(tmp_path):
    names = jax_gradient_metric_names(jax_cifar10_config(num_layers=3, num_filters=8))
    rows = [[0.001 * i + j for j in range(len(names))] for i in range(3)]
    for cls, path in ((CsvLogger, tmp_path / "port.csv"), (JaxCsvLogger, tmp_path / "jax.csv")):
        logger = cls(str(path), names)
        for row in rows:
            logger.log(row)
        logger.close()
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    # Appending to a file that has rows writes no second header.
    logger = CsvLogger(str(tmp_path / "port.csv"), names)
    logger.log(rows[0])
    logger.close()
    assert (tmp_path / "port.csv").read_text().count("conv1_kernel") == 1
    with pytest.raises(ValueError, match="Expected 4 values"):
        CsvLogger(str(tmp_path / "x.csv"), names).log([1.0])


def test_streaming_metrics_match_jax():
    updates = [(2.0, 3.0, 4.0), (torch.tensor(1.0), torch.tensor(1.0), torch.tensor(4.0)),
               (torch.tensor([0.5, 1.5]), torch.tensor([2.0, 0.0]), torch.tensor([4.0, 4.0]))]
    port, ref = StreamingMetrics(), JaxStreamingMetrics()
    for loss, correct, count in updates:
        port.update(loss, correct, count)
        ref.update(*[jnp.asarray(np.asarray(v)) for v in (loss, correct, count)])
    assert port.results() == pytest.approx(ref.results())
    assert port.results() == pytest.approx({"mean_loss": 5.0 / 4, "accuracy": 6.0 / 16})
    port.reset()
    assert port.results() == {"mean_loss": 0.0, "accuracy": 0.0}


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", (0.1,)),
    ("piecewise_constant_schedule", ((3, 6), (1.0, 0.5, 0.1))),
    ("exponential_decay_schedule", (1.0, 0.5, 4)),
    ("exponential_decay_schedule", (1.0, 0.5, 4, True)),
    ("linear_warmup_schedule", (0.4, 4)),
    ("linear_warmup_schedule", (0.4, 0)),
])
def test_schedules_match_jax(name, args):
    port, ref = getattr(schedules, name)(*args), getattr(jax_schedules, name)(*args)
    assert [port(s) for s in range(10)] == [ref(s) for s in range(10)]


def test_schedules_refuse_bad_arguments():
    with pytest.raises(ValueError):
        schedules.piecewise_constant_schedule((1,), (1.0,))
    with pytest.raises(ValueError):
        schedules.linear_warmup_schedule(1.0, -1)


def test_train_step_norm_row_follows_the_model_gradients():
    """The grad-norm row is ||grad||_2 / free DOF per layer of the port's own
    gradients (checked here against a direct computation)."""
    config = jax_cifar10_config(num_layers=2, num_filters=4)
    model = port_model(config, jax_params_with_biases(jax_build(config), 7)[0])
    (images, labels), = batches(1, batch=2, seed=7)
    _, norms = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0))(
        torch.from_numpy(images), torch.from_numpy(labels), 0.0)
    blocks = model.params()["stages"][0]["blocks"]
    free = 4 * 4 + 9 * 6
    for layer in range(2):
        sq = sum(float(torch.sum(leaf.grad[layer] ** 2)) for leaf in blocks[:5])
        assert norm_rel(norms[1 + layer], np.sqrt(sq) / free) < 1e-6
    stem = model.params()["stem"].kernel.grad
    assert norm_rel(norms[0], float(stem.norm()) / stem.numel()) < 1e-6
