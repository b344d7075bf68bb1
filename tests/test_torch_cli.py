"""The port's command line on the CPU (``--device cpu``): train, analyze,
evaluate and predict as a user runs them, ``--bf16`` and the int8 flags
against the JAX package's CLI, for either model
family (the research subcommands:
tests/test_torch_cli_research.py; ``--model resnet50``:
tests/test_torch_bottleneck_training.py)."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from differential_equations_resnet_tpu_torch import cli


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs a worker a core, and small CPU
    convolutions slow down many times over when the workers' threads
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MODEL = ["--num-layers", "2", "--num-filters", "4", "--device", "cpu"]


def run(capsys, *argv):
    assert cli.main(list(argv)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", [[], ["--device-data"], ["--scan-steps", "2"]])
def test_train_analyze_evaluate_predict(tmp_path, capsys, mode):
    csv_dir, save_dir = str(tmp_path / "csv"), str(tmp_path / "ckpt")
    out = run(capsys, "train", *MODEL, "--epochs", "2", "--steps-per-epoch", "4",
              "--synthetic-train-size", "128", "--synthetic-val-size", "40",
              "--summaries-frequency", "2", "--csv-dir", csv_dir, "--save-dir", save_dir, *mode)
    assert np.isfinite(out["best"]["loss"]) and 0 <= out["best"]["accuracy"] <= 1
    (train_csv,) = glob.glob(os.path.join(csv_dir, "single_block_antisymmetric_2-layers_4-filters_*_training.csv"))
    (eval_csv,) = glob.glob(os.path.join(csv_dir, "*_evaluation.csv"))
    report = run(capsys, "analyze", train_csv, "--evaluation-csv", eval_csv)
    assert set(report) == {"gradient_norm_relative_deviation", "gradient_norm_standard_deviation",
                           "gradient_norm_last_first_ratio", "best_val_accuracy",
                           "best_val_mean_loss"}
    assert report["best_val_accuracy"] == out["best"]["accuracy"]
    checkpoint = os.path.join(save_dir, sorted(os.listdir(save_dir))[-1].removesuffix(".meta.json"))
    metrics = run(capsys, "evaluate", *MODEL, "--checkpoint", checkpoint,
                  "--synthetic-train-size", "128", "--synthetic-val-size", "40",
                  *[f for f in mode if f == "--device-data"])
    assert metrics["accuracy"] == out["best"]["accuracy"]
    np.testing.assert_allclose(metrics["mean_loss"], out["best"]["loss"], rtol=1e-5)
    images = np.random.default_rng(0).uniform(0, 255, (5, 32, 32, 3)).astype(np.float32)
    np.save(tmp_path / "x.npy", images)
    pred = run(capsys, "predict", str(tmp_path / "x.npy"), *MODEL, "--checkpoint", checkpoint,
               "--batch-size", "4", "--output", str(tmp_path / "p.npy"))
    assert pred["num_images"] == 5 and len(pred["predictions"]) == 5
    probs = np.load(tmp_path / "p.npy")
    assert probs.shape == (5, 10)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)


def test_resume_continues_from_the_latest_checkpoint(tmp_path, capsys):
    common = [*MODEL, "--epochs", "1", "--steps-per-epoch", "2", "--synthetic-train-size", "64",
              "--synthetic-val-size", "16", "--csv-dir", str(tmp_path / "csv"),
              "--save-dir", str(tmp_path / "ckpt")]
    run(capsys, "train", *common)
    out = run(capsys, "train", *common, "--resume")
    assert np.isfinite(out["best"]["loss"])
    assert "step-00000004" in sorted(os.listdir(tmp_path / "ckpt"))[-1]
    with pytest.raises(SystemExit):
        cli.main(["train", *MODEL, "--resume", "--synthetic-train-size", "8",
                  "--synthetic-val-size", "8"])


@pytest.mark.parametrize("flags,match", [
    (["--int8-forward"], "int8"),
    (["--model", "resnet50", "--int8-forward"], "int8"),
    (["--int8-forward", "--int8-backward", "wgrad"], "wgrad"),
])
def test_flags_the_port_cannot_run_raise(capsys, monkeypatch, flags, match):
    """The int8 flags, which raised naming ROADMAP A13 before the port had
    int8, now evaluate (finite loss) with the config the JAX package's CLI
    builds from them; ``match`` names the int8 field the flags set.  A
    combination the JAX config refuses raises its ValueError."""
    from differential_equations_resnet_tpu import cli as jax_cli
    from differential_equations_resnet_tpu.utils.serving import _config_to_json
    from differential_equations_resnet_tpu_torch.utils.serving import config_from_json

    built = []
    build = cli._build_model
    monkeypatch.setattr(cli, "_build_model", lambda args: built.append(args) or build(args))
    metrics = run(capsys, "evaluate", *MODEL, *flags, "--synthetic-val-size", "8")
    assert np.isfinite(metrics["mean_loss"])
    (args,) = built
    family = "single_block" if args.model == "single_block" else "bottleneck"
    want = config_from_json(_config_to_json(jax_cli._build_model(args).config), family)
    config = build(args).config
    assert config == want and config.int8_forward
    assert config.int8_backward == ("wgrad" if match == "wgrad" else "ste")
    with pytest.raises(ValueError, match="int8_forward requires"):
        cli.main(["evaluate", *MODEL, "--int8-forward", "--use-pallas",
                  "--synthetic-val-size", "8"])


@pytest.mark.parametrize("flags", [["--model", "resnet50", "--bf16"], ["--bf16"]],
                         ids=["resnet50-bf16", "bf16"])
def test_bf16_flag_runs_as_the_jax_cli_builds_it(capsys, monkeypatch, flags):
    """``--bf16`` (which raised naming ROADMAP A5 before the port computed in
    bf16) builds the model the JAX package's CLI builds from the same flags,
    config for config, in bf16, and evaluates it (finite loss)."""
    from differential_equations_resnet_tpu import cli as jax_cli
    from differential_equations_resnet_tpu.utils.serving import _config_to_json
    from differential_equations_resnet_tpu_torch.utils.serving import config_from_json

    built = []
    build = cli._build_model
    monkeypatch.setattr(cli, "_build_model", lambda args: built.append(args) or build(args))
    metrics = run(capsys, "evaluate", *MODEL, *flags, "--synthetic-val-size", "8")
    assert np.isfinite(metrics["mean_loss"])
    (args,) = built
    model = build(args)
    family = "single_block" if args.model == "single_block" else "bottleneck"
    want = config_from_json(_config_to_json(jax_cli._build_model(args).config), family)
    assert model.config == want and model.config.compute_dtype == torch.bfloat16


def test_predict_takes_npy_only_and_other_subcommands_are_not_registered(tmp_path):
    """Image directories and the records and download subcommands wait
    for the host data modules (ROADMAP A8)."""
    with pytest.raises(NotImplementedError, match="A8"):
        cli.main(["predict", str(tmp_path), *MODEL])
    for command in ("convert-records", "fetch-cifar10"):
        with pytest.raises(SystemExit):
            cli.main([command])
