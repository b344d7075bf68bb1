"""Training and serving the port's bottleneck ResNet against the JAX package,
on the CPU: train steps against JAX `make_train_step` (loss, correct count,
the grad-norm row and its names, parameters and running statistics after
Adam), v1 and v1.5, antisymmetric and regular mid-convs, with gradient
accumulation; the ResNet-50/101/152 telemetry names; a checkpoint round
trip; serving a JAX export and the port's own; and ``cli train --model
resnet50`` then ``export --checkpoint``."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from differential_equations_resnet_tpu.models import bottleneck_resnet as jax_bottleneck
from differential_equations_resnet_tpu.train import (
    TrainState as JaxTrainState,
    gradient_metric_names as jax_gradient_metric_names,
    make_adam as jax_make_adam,
    make_train_step as jax_make_train_step,
)
from differential_equations_resnet_tpu.utils import serving as jax_serving
from differential_equations_resnet_tpu.utils.serving import _config_to_json
from differential_equations_resnet_tpu_torch import cli
from differential_equations_resnet_tpu_torch.models import build_resnet
from differential_equations_resnet_tpu_torch.models.single_block_resnet import map_leaves
from differential_equations_resnet_tpu_torch.train import (
    Checkpointer,
    TrainState,
    gradient_mean_norms,
    gradient_metric_names,
    make_adam,
    make_train_step,
)
from differential_equations_resnet_tpu_torch.utils import weight_utils
from differential_equations_resnet_tpu_torch.utils.serving import (
    config_from_json,
    export_model,
    load_exported,
)

from torch_parity import (
    BOTTLENECK_CASES as CASES,
    BOTTLENECK_IDS as IDS,
    assert_params_close,
    assert_stepped_state_close,
    drawn_bottleneck_trees,
    narrow_bottleneck_config as narrow_config,
    norm_rel,
    port_model,
)

LR = 1e-3
PREDICT_TOL = 1e-5   # served probabilities, norm-relative


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs a worker a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batch(size, seed, classes=5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (size, 32, 32, 3)).astype(np.float32),
            rng.integers(0, classes, size).astype(np.int32))


def jax_and_port_steps(config, seed, accum_steps=1):
    """A JAX train state and jitted step, and the port's model and eager
    step, from the same parameters and running statistics."""
    jax_model = jax_bottleneck.build_resnet(config)
    params, state = drawn_bottleneck_trees(config, seed)
    tx = jax_make_adam()
    train_state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state=state,
                                opt_state=tx.init(params))
    jax_step = jax_make_train_step(jax_model, tx, donate=False, accum_steps=accum_steps)
    model = port_model(config, params, state)
    step = make_train_step(model, make_adam(model.parameters()), accum_steps=accum_steps)
    return (train_state, jax_step), (model, step)


@pytest.mark.parametrize("version,antisymmetric_mid", CASES, ids=IDS)
def test_train_step_matches_jax(version, antisymmetric_mid):
    """One step at batch 8 (L2 on): loss to 1e-5 and the grad-norm row to
    1e-4 relative, correct and count exactly, the parameters and running
    statistics after Adam as `assert_params_close` and
    `assert_stepped_state_close` say; the row's names are JAX's."""
    config = narrow_config(version, antisymmetric_mid, l2_regularization=1e-3)
    (train_state, jax_step), (model, step) = jax_and_port_steps(config, 20)
    x, y = batch(8, 21)
    train_state, jax_metrics, jax_norms = jax_step(train_state, jnp.asarray(x), jnp.asarray(y), LR)
    metrics, norms = step(torch.from_numpy(x), torch.from_numpy(y), LR)
    np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]), rtol=1e-5)
    assert float(metrics["correct"]) == float(jax_metrics["correct"])
    assert float(metrics["count"]) == float(jax_metrics["count"]) == 8
    names = gradient_metric_names(model.config)
    assert names == jax_gradient_metric_names(config) and len(names) == norms.numel() == 6
    np.testing.assert_allclose(norms.numpy(), np.asarray(jax_norms), rtol=1e-4)
    assert_params_close(model.params(), train_state.params, 1, LR)
    assert_stepped_state_close(model.state(), train_state.model_state)


def test_accumulated_step_matches_jax():
    """accum_steps=2 at batch 8: two microbatches of 4, each normalized by
    its own statistics, the running statistics through both in order, one
    update on the averaged gradient, as the JAX step does."""
    config = narrow_config(1.5, True)
    (train_state, jax_step), (model, step) = jax_and_port_steps(config, 22, accum_steps=2)
    x, y = batch(8, 23)
    train_state, jax_metrics, jax_norms = jax_step(train_state, jnp.asarray(x), jnp.asarray(y), LR)
    metrics, norms = step(torch.from_numpy(x), torch.from_numpy(y), LR)
    np.testing.assert_allclose(float(metrics["loss"]), float(jax_metrics["loss"]), rtol=1e-5)
    assert float(metrics["correct"]) == float(jax_metrics["correct"])
    np.testing.assert_allclose(norms.numpy(), np.asarray(jax_norms), rtol=1e-4)
    assert_params_close(model.params(), train_state.params, 1, LR)
    assert_stepped_state_close(model.state(), train_state.model_state)


@pytest.mark.parametrize("preset", ["resnet50", "resnet101", "resnet152"])
def test_telemetry_names_match_jax(preset):
    jax_config = jax_bottleneck.resnet_preset(preset, 257, antisymmetric_mid=True)
    names = gradient_metric_names(config_from_json(_config_to_json(jax_config), "bottleneck"))
    assert names == jax_gradient_metric_names(jax_config)
    assert len(names) == 1 + sum(jax_config.blocks_per_stage)


def test_dense_and_packed_layouts_report_the_same_row():
    """The mean-norm divisor counts the free degrees of freedom, so the
    row of a gradient tree in the dense-lower layout equals that of the
    same gradients in the packed layout."""
    config = config_from_json(_config_to_json(narrow_config(1, True)), "bottleneck")
    model = build_resnet(config, generator=torch.Generator().manual_seed(24), device="cpu")
    x, y = batch(4, 25)
    make_train_step(model, make_adam(model.parameters()))(torch.from_numpy(x), torch.from_numpy(y), LR)
    grads = map_leaves(lambda p: p.grad, model.params())
    packed = weight_utils.convert_antisym_layout(grads, "packed")
    assert type(packed["stages"][0]["identity_blocks"]["conv2"]).__name__ == "Antisym3x3Params"
    np.testing.assert_allclose(gradient_mean_norms(packed, config).numpy(),
                               gradient_mean_norms(grads, config).numpy(), rtol=1e-6)


def test_checkpoint_round_trip_is_bit_for_bit(tmp_path):
    """A trained bottleneck model's parameters, running statistics (in the
    state_dict and the structure fingerprint) and Adam slots restore bit
    for bit into a model drawn from another seed, which then predicts the
    same."""
    config = config_from_json(_config_to_json(narrow_config(1, True)), "bottleneck")
    model = build_resnet(config, generator=torch.Generator().manual_seed(26), device="cpu")
    optimizer = make_adam(model.parameters())
    x, y = batch(4, 27)
    make_train_step(model, optimizer)(torch.from_numpy(x), torch.from_numpy(y), LR)
    path = Checkpointer(str(tmp_path)).save(TrainState(model, optimizer, 1), 1)
    with open(path + ".meta.json") as f:
        assert "stem_bn__var" in json.load(f)["structure"]["model"]
    other = build_resnet(config, generator=torch.Generator().manual_seed(28), device="cpu")
    restored = Checkpointer(str(tmp_path)).restore(TrainState(other, make_adam(other.parameters())), path)
    assert restored.step == 1
    want = model.state_dict()
    assert set(other.state_dict()) == set(want) and any(k.endswith("__mean") for k in want)
    for key, value in other.state_dict().items():
        assert torch.equal(value, want[key]), key
    for a, b in zip(restored.optimizer.state.values(), optimizer.state.values()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a[key], b[key])
    with torch.no_grad():
        assert torch.equal(other(torch.from_numpy(x)), model(torch.from_numpy(x)))


def test_serves_a_jax_bottleneck_export(tmp_path):
    """A JAX package export (config.json and params.pkl with params and
    model_state) of a small bottleneck model loads through the restricted
    unpickler and predicts, in eval mode on its running statistics, what
    the JAX package's loader predicts; the port's own export of it
    round-trips exactly."""
    config = narrow_config(1.5, True)
    jax_model = jax_bottleneck.build_resnet(config)
    params, state = drawn_bottleneck_trees(config, 29)
    export_dir = jax_serving.export_model(jax_model, str(tmp_path / "jax"), params=params,
                                          model_state=state, batch_size=2, stablehlo=False)
    predict, manifest = load_exported(export_dir, device="cpu")
    assert manifest["family"] == "bottleneck"
    want_predict, _ = jax_serving.load_exported(export_dir)
    x, _ = batch(3, 30)
    got = predict(x)
    assert norm_rel(got, want_predict(x)) <= PREDICT_TOL
    model = port_model(config, params, state)
    own = export_model(model, str(tmp_path / "port"))
    np.testing.assert_array_equal(load_exported(own, device="cpu")[0](x), got)


def test_cli_trains_and_exports_resnet50(tmp_path, capsys):
    """``train --model resnet50 --device cpu`` for 2 steps at batch 2 on
    synthetic CIFAR-10 writes the 17-column grad-norm CSV and a checkpoint;
    ``export --checkpoint`` of it serves the trained model."""
    model_flags = ["--model", "resnet50", "--device", "cpu"]
    save_dir, csv_dir = str(tmp_path / "ckpt"), str(tmp_path / "csv")
    assert cli.main(["train", *model_flags, "--epochs", "1", "--steps-per-epoch", "2",
                     "--batch-size", "2", "--synthetic-train-size", "16",
                     "--synthetic-val-size", "4", "--summaries-frequency", "1",
                     "--csv-dir", csv_dir, "--save-dir", save_dir]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["best"]["loss"])
    (train_csv,) = [f for f in os.listdir(csv_dir) if f.endswith("_training.csv")]
    with open(os.path.join(csv_dir, train_csv)) as f:
        header, *rows = f.read().splitlines()
    assert header.split()[3:] == jax_gradient_metric_names(
        jax_bottleneck.resnet_preset("resnet50", 10, antisymmetric_mid=True))
    assert len(rows) == 2 and all(np.isfinite(float(v)) for v in rows[-1].split())
    checkpoint = os.path.join(save_dir, Checkpointer(save_dir).latest())
    assert cli.main(["export", str(tmp_path / "export"), *model_flags,
                     "--checkpoint", checkpoint]) == 0
    export_dir = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["export_dir"]
    predict, manifest = load_exported(export_dir, device="cpu")
    assert manifest["family"] == "bottleneck"
    assert manifest["config"]["filters_per_block"][0] == [64, None, 256]
    trained = build_resnet(config_from_json(manifest["config"], "bottleneck"),
                           generator=torch.Generator().manual_seed(1), device="cpu")
    Checkpointer(save_dir).restore(TrainState(trained, make_adam(trained.parameters())), checkpoint)
    x, _ = batch(2, 31)
    with torch.no_grad():
        np.testing.assert_array_equal(predict(x), trained(torch.from_numpy(x)).numpy())
