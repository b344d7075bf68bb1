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


def test_predict_takes_npy_only_and_other_subcommands_are_not_registered(tmp_path, capsys):
    """Before the host data modules (ROADMAP A8) were ported, predict took
    only a .npy array and ``convert-records`` and ``fetch-cifar10`` were not
    registered.  Now a directory is read for its images (one without any
    raises, as the JAX CLI does) and both subcommands are registered."""
    with pytest.raises(ValueError, match="at least one array"):
        cli.main(["predict", str(tmp_path), *MODEL])
    for command in ("convert-records", "fetch-cifar10"):
        with pytest.raises(SystemExit) as exit_info:
            cli.main([command, "--help"])
        assert exit_info.value.code == 0
        assert f"usage: deqres-torch {command}" in capsys.readouterr().out


def write_png_tree(root, n=6, size=(20, 24), seed=0):
    """PNGs named `<label>_<n>.png` in ``root`` and a subdirectory."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "sub"), exist_ok=True)
    for i in range(n):
        folder = root if i % 2 else os.path.join(root, "sub")
        Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(
            os.path.join(folder, f"{i % 3}_{i}.png"))


def test_predict_on_an_image_directory_matches_the_jax_cli(tmp_path, capsys, monkeypatch):
    """``predict <dir>``: each PNG of the directory (not of its
    subdirectories, as in the JAX CLI) decoded and resized bilinearly to
    32x32, then the model's probabilities, from the same parameters as the
    JAX CLI's model (its `Training` draws them from seed 0): within 1e-5."""
    import jax

    from differential_equations_resnet_tpu import cli as jax_cli
    from differential_equations_resnet_tpu.models import (
        build_single_block_resnet as jax_build,
        cifar10_single_block_config as jax_config,
    )
    from torch_parity import port_model

    monkeypatch.setenv("DEQRES_COMPILE_CACHE", "0")
    write_png_tree(str(tmp_path / "images"))
    config = jax_config(num_layers=2, num_filters=4, s2d_block=0)
    jax_model = jax_build(config)
    params, _ = jax_model.init(jax.random.key(0))
    monkeypatch.setattr(jax_cli, "_build_model", lambda args: jax_model)
    monkeypatch.setattr(cli, "_build_model", lambda args: port_model(config, params))
    outputs = {}
    for name, module, flags in (("jax", jax_cli, []), ("torch", cli, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.npy")
        assert module.main(["predict", str(tmp_path / "images"), "--batch-size", "4",
                            "--output", out, *flags]) == 0
        outputs[name] = (json.loads(capsys.readouterr().out.strip().splitlines()[-1]), np.load(out))
    (got_json, got), (want_json, want) = outputs["torch"], outputs["jax"]
    assert got.shape == (3, 10) and got_json["num_images"] == 3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got_json["predictions"] == want_json["predictions"]


def record_set(directory):
    """({split directory: (sorted shard names, record count)}, sorted (label,
    name, image bytes) of every record) of a converted tree."""
    from differential_equations_resnet_tpu_torch.data.records import read_record_file

    splits, items = {}, []
    for root, _, names in os.walk(directory):
        shards = sorted(n for n in names if n.endswith(".dert"))
        if shards:
            found = [(r["label"], r["filename"], bytes(np.asarray(r["image"])))
                     for n in shards for r in read_record_file(os.path.join(root, n))]
            splits[os.path.relpath(root, directory)] = (shards, len(found))
            items += found
    return splits, sorted(items)


@pytest.mark.parametrize("flags", [[], ["--val-split", "0.25"], ["--raw", "--val-split", "0.5"]],
                         ids=["all", "split", "raw-split"])
def test_convert_records_matches_the_jax_cli(tmp_path, flags):
    """``convert-records`` shuffles with an unseeded `random.Random`, in
    either CLI, so the two are compared by the set of records, and each
    split by its shards' names and its size."""
    from differential_equations_resnet_tpu import cli as jax_cli

    write_png_tree(str(tmp_path / "images"), n=9)
    for name, module in (("jax", jax_cli), ("torch", cli)):
        assert module.main(["convert-records", str(tmp_path / "images"), str(tmp_path / name),
                            "--prefix", "p", "--shard-size", "2", *flags]) == 0
    got, want = record_set(tmp_path / "torch"), record_set(tmp_path / "jax")
    assert got == want
    assert len(got[1]) == 9


def cifar_archive(path, extra=b""):
    """A tar.gz laid out as the CIFAR-10 python release (tiny batches);
    returns its sha256."""
    import hashlib
    import io
    import pickle
    import tarfile

    with tarfile.open(path, "w:gz") as tar:
        for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch", "batches.meta"]:
            data = pickle.dumps({b"name": name.encode(), b"extra": extra})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("case", ["no-verify", "checksum-ok", "checksum-bad", "downloaded",
                                  "download-corrupt", "already-extracted"])
def test_fetch_cifar10_on_a_test_built_archive_matches_the_jax_cli(tmp_path, capsys,
                                                                   monkeypatch, case):
    """Checksum and extraction of ``fetch-cifar10`` as the JAX CLI's, on an
    archive this test builds; the download is replaced by a copy of a local
    file or by an error, so nothing leaves the machine."""
    import shutil
    import urllib.error
    import urllib.request

    from differential_equations_resnet_tpu import cli as jax_cli
    from differential_equations_resnet_tpu.data import cifar10 as jax_cifar10
    from differential_equations_resnet_tpu_torch.data import cifar10

    source = str(tmp_path / "source.tar.gz")
    digest = cifar_archive(source)
    corrupt = str(tmp_path / "corrupt.tar.gz")
    cifar_archive(corrupt, extra=b"x")
    if case != "checksum-bad":  # the release's published checksum, otherwise
        for module in (cifar10, jax_cifar10):
            monkeypatch.setattr(module, "CIFAR10_TGZ_SHA256", digest)

    def fake_download(url, target):
        if case in ("downloaded", "download-corrupt"):
            shutil.copy(source if case == "downloaded" else corrupt, target)
            return target, None
        raise urllib.error.URLError("no network in tests")

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_download)
    results = {}
    for name, module in (("jax", jax_cli), ("torch", cli)):
        dest = tmp_path / name
        dest.mkdir()
        if case not in ("downloaded", "download-corrupt"):
            shutil.copy(source, dest / "cifar-10-python.tar.gz")
        if case == "already-extracted":
            (dest / "cifar-10-batches-py").mkdir()
            (dest / "cifar-10-batches-py" / "data_batch_1").write_bytes(b"kept")
        flags = ["--no-verify"] if case == "no-verify" else []
        try:
            module.main(["fetch-cifar10", "--dest", str(dest), *flags])
            out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            results[name] = ("ok", os.path.relpath(out["cifar10_dir"], dest),
                             sorted(os.listdir(dest / "cifar-10-batches-py")),
                             (dest / "cifar-10-batches-py" / "data_batch_1").read_bytes())
        except RuntimeError as e:
            results[name] = ("error", str(e).replace(str(dest), "<dest>").split(" (")[0])
    assert results["torch"] == results["jax"]
    expect = "error" if case in ("checksum-bad", "download-corrupt") else "ok"
    assert results["torch"][0] == expect
    if expect == "ok":
        assert results["torch"][1] == "cifar-10-batches-py"
        assert len(results["torch"][2]) == (1 if case == "already-extracted" else 7)
