"""The port's research subcommands as a user runs them, in subprocesses on the
CPU (``--device cpu``) at tiny sizes: benchmark, deep-stability, sweep,
reproduce --synthetic, and export --checkpoint followed by load_exported.
Each prints the JSON keys the JAX package's command prints
(`differential_equations_resnet_tpu/cli.py`), except the MFU key, which
names the card's peak for the compute dtype (``mfu_vs_fp32_peak``, or
``mfu_vs_bf16_peak`` with ``--bf16``) where the JAX package's names a
TPU's bf16 peak."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from differential_equations_resnet_tpu_torch.models import (
    build_single_block_resnet,
    cifar10_single_block_config,
)
from differential_equations_resnet_tpu_torch.train import Checkpointer, TrainState, make_adam
from differential_equations_resnet_tpu_torch.utils.serving import load_exported

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--num-layers", "2", "--num-filters", "4", "--device", "cpu"]
BENCHMARK_KEYS = {"train_steps_per_sec", "train_img_per_sec", "inference_latency_batch1_ms",
                  "inference_fps_batch1", "device", "model_flops_per_step", "model_tflops",
                  "mfu_vs_fp32_peak"}
SWEEP_KEYS = {"steps_per_sec", "images_per_sec", "step_ms", "model_tflops", "mfu_vs_fp32_peak"}
GAMMA_KEYS = {"final_loss", "final_accuracy", "grad_norm_relative_deviation",
              "grad_norm_std_over_layers", "grad_norm_last_first_ratio"}
RUN_KEYS = {"run", "data", "best_val_accuracy", "best_val_loss", "baseline_accuracy", "delta",
            "within_half_percent", "gradient_flow"}


def cli(*args, cwd=None, check=True):
    """``python -m differential_equations_resnet_tpu_torch.cli <args>`` in a
    new process with one torch thread: its last line of output as JSON, or
    the finished process where ``check=False``."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "differential_equations_resnet_tpu_torch.cli", *map(str, args)],
        cwd=cwd or REPO, env=env, capture_output=True, text=True, timeout=600)
    if not check:
        return proc
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [
    ["--profile-dir", "{tmp}"],
    ["--kernel-type", "regular"],
    ["--kernel-type", "centrosymmetric", "--kernel-size", "5", "--integrator", "rk4", "--remat"],
])
def test_benchmark(tmp_path, flags):
    """Its JSON keys on every kernel type and integrator; --profile-dir
    writes a profiler trace of the timed steps."""
    flags = [f.format(tmp=tmp_path) for f in flags]
    out = cli("benchmark", *TINY, "--batch-size", "2", "--steps", "2", *flags)
    assert set(out) == BENCHMARK_KEYS
    if "--profile-dir" in flags:
        assert (tmp_path / "benchmark.trace.json").stat().st_size > 0
    assert out["device"] == "cpu: cpu"
    assert out["train_steps_per_sec"] > 0 and out["inference_latency_batch1_ms"] > 0
    assert np.isfinite(out["mfu_vs_fp32_peak"])


def test_deep_stability():
    out = cli("deep-stability", "--num-layers", "2", "--num-filters", "4", "--steps", "2",
              "--grid", "3", "--gammas", "0.0,0.1", "--device", "cpu")
    assert set(out) == {"gamma_sweep", "spectrum"}
    assert set(out["gamma_sweep"]) == {"0.0", "0.1"}
    for row in out["gamma_sweep"].values():
        assert set(row) == GAMMA_KEYS and all(np.isfinite(v) for v in row.values())
    assert set(out["spectrum"]) == {"gamma", "real_part_error", "antisymmetry_defect"}
    assert out["spectrum"]["gamma"] == 0.1
    assert out["spectrum"]["real_part_error"] < 1e-6
    assert out["spectrum"]["antisymmetry_defect"] < 1e-6


def test_sweep():
    out = cli("sweep", "--widths", "4", "--depths", "1,2", "--batch-size", "2", "--num-classes",
              "10", "--steps", "2", "--kernel-type", "regular", "--device", "cpu")
    assert set(out) == {"4x1", "4x2"}
    for row in out.values():
        assert set(row) == SWEEP_KEYS and all(np.isfinite(v) for v in row.values())
    # --bf16 (which raised naming ROADMAP A5 before the port computed in
    # bf16): MFU against the bf16 peak.
    out = cli("sweep", "--bf16", "--widths", "4", "--depths", "1", "--batch-size", "2",
              "--num-classes", "10", "--steps", "2", "--device", "cpu")
    assert set(out) == {"4x1"}
    row = out["4x1"]
    assert set(row) == SWEEP_KEYS - {"mfu_vs_fp32_peak"} | {"mfu_vs_bf16_peak"}
    assert all(np.isfinite(v) for v in row.values())


def test_reproduce_synthetic_and_its_refusal_without_data(tmp_path):
    """--synthetic runs the three published 64-layer configurations (here cut
    to 4 steps each on 128 images) and reports each beside its baseline, the
    measured gradient flow from its CSV rows; without CIFAR-10 on disk and
    without --synthetic it exits, downloading nothing."""
    out = cli("reproduce", "--synthetic", "--synthetic-train-size", "128",
              "--synthetic-val-size", "32", "--epochs", "1", "--device-data",
              "--summaries-frequency", "2", "--csv-dir", tmp_path / "csv", "--device", "cpu",
              cwd=tmp_path)
    assert out["data"] == "synthetic"
    assert [r["run"] for r in out["runs"]] == [
        "single_block_antisymmetric_64-layers_16-filters",
        "single_block_regular_64-layers_16-filters",
        "single_block_regular_64-layers_8-filters"]
    for run in out["runs"]:
        assert set(run) == RUN_KEYS
        measured = run["gradient_flow"]["measured"]
        assert set(measured) == {"relative_deviation", "standard_deviation", "last_first_ratio"}
        assert all(np.isfinite(v) for v in measured.values())
    proc = cli("reproduce", "--device", "cpu", cwd=tmp_path, check=False)
    assert proc.returncode != 0
    assert "--synthetic only for pipeline smoke-testing" in proc.stderr


@pytest.mark.parametrize("kernel_type,k", [("regular", 3), ("centrosymmetric", 5)])
def test_export_from_a_checkpoint_then_load_exported(tmp_path, kernel_type, k):
    """train --save-dir, export --checkpoint, load_exported: the export
    predicts what the checkpoint's model predicts."""
    model = ["--kernel-type", kernel_type, "--kernel-size", str(k), *TINY]
    cli("train", *model, "--epochs", "1", "--steps-per-epoch", "2", "--synthetic-train-size", "64",
        "--synthetic-val-size", "8", "--save-dir", tmp_path / "ckpt", "--csv-dir", tmp_path / "csv")
    save_dir = str(tmp_path / "ckpt")
    checkpoint = os.path.join(save_dir, Checkpointer(save_dir).latest())
    out = cli("export", tmp_path / "export", *model, "--checkpoint", checkpoint, "--no-stablehlo")
    predict, manifest = load_exported(out["export_dir"], device="cpu")
    assert manifest["config"]["kernel_type"] == kernel_type
    assert manifest["config"]["kernel_size"] == k
    config = cifar10_single_block_config(num_layers=2, num_filters=4, kernel_type=kernel_type,
                                         kernel_size=k)
    trained = build_single_block_resnet(config, generator=torch.Generator().manual_seed(9),
                                        device="cpu")
    Checkpointer(save_dir).restore(TrainState(trained, make_adam(trained.parameters())), checkpoint)
    images = np.random.default_rng(0).uniform(0, 255, (3, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want = trained(torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(predict(images), want)
    # --int8 (which failed naming ROADMAP A13 before the port served int8):
    # at 4 filters, under the 128 gate, the int8 export serves the fp answer.
    out = cli("export", tmp_path / "int8", *model, "--checkpoint", checkpoint, "--int8")
    predict, manifest = load_exported(out["export_dir"], device="cpu")
    assert manifest["quantize"] == "int8"
    np.testing.assert_array_equal(predict(images), want)
