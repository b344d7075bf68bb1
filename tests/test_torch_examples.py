"""The port's examples of this slice, each run on the CPU at a tiny size
through its ``main(argv)``: each prints what its JAX original prints (the
same JSON keys, read off ``examples/<name>.py``); the kernel-property checks
pass on the port's kernels and fail on a broken one; depth doubling matches
the JAX package's `double_model_depth` on converted weights."""

import json

import numpy as np
import jax
import pytest
import torch

from differential_equations_resnet_tpu.models import (
    build_single_block_resnet as jax_build,
    cifar10_single_block_config as jax_cifar10_config,
)
from differential_equations_resnet_tpu.utils import double_model_depth as jax_double
from differential_equations_resnet_tpu_torch.examples import (
    antisymmetric_kernel_properties,
    cifar10_gradient_flow_experiment,
    depth_doubling_continuation,
    int8_full_nan_repro,
    large_batch_training,
)
from differential_equations_resnet_tpu_torch.models import build_single_block_resnet
from differential_equations_resnet_tpu_torch.models.single_block_resnet import _named_leaves
from differential_equations_resnet_tpu_torch.ops.antisymmetric import materialize_3x3_stacked
from differential_equations_resnet_tpu_torch.utils import double_model_depth
from differential_equations_resnet_tpu_torch.utils.serving import config_from_json
from differential_equations_resnet_tpu_torch.utils.weight_utils import params_from_jax
from differential_equations_resnet_tpu.utils.serving import _config_to_json
from torch_parity import jax_params_with_biases, to_numpy

CPU = ["--device", "cpu"]
# The keys each JAX example prints (examples/<name>.py).
GRADIENT_FLOW_KEYS = {"best_val_accuracy", "best_val_mean_loss", "grad_norm_relative_deviation",
                      "grad_norm_std_over_layers", "grad_norm_last_first_ratio", "training_csv"}
DEPTH_ROW_KEYS = {"layers", "h", "epoch", "step", "mean_loss", "accuracy"}
LARGE_BATCH_RUN_KEYS = {"batch", "accum_steps", "dtype", "int8_forward", "int8_backward", "lr",
                        "steps", "final_train_loss", "final_train_acc", "eval_loss", "eval_acc",
                        "wall_s", "img_per_sec_incl_compile", "mfu_vs_bf16_peak_incl_compile"}
LARGE_BATCH_DELTA_KEYS = {"batch", "dtype", "int8_forward", "int8_backward", "train_loss_delta",
                          "eval_loss_delta", "eval_acc_delta"}
# The int8 probe's JAX keys, with the residual stack in bytes (not GB) and
# steps/s added; "expected" (a TPU memory-fraction rule) is not carried over.
NAN_REPRO_KEYS = {"config", "residual_stack_bytes", "lr", "losses", "verdict", "steps_per_s",
                  "versions"}


def printed_json(capsys):
    """The JSON an example printed last (indented or on one line)."""
    lines = capsys.readouterr().out.strip().splitlines()
    start = max(i for i, line in enumerate(lines) if line in ("{", "[") or line.startswith("{\""))
    return json.loads("\n".join(lines[start:]))


def test_kernel_properties_example(capsys):
    assert antisymmetric_kernel_properties.main(
        ["--num-layers", "2", "--num-filters", "4", "--steps", "2", *CPU]) == 0
    out = capsys.readouterr().out
    assert out.count("skew-consistent") == 3 and "after training" in out


def test_kernel_property_checks_fail_on_a_broken_kernel():
    """The checks pass on the port's materialized kernels and fail once one
    element of a channel pair, or a diagonal block's centre, is moved."""
    model = build_single_block_resnet(
        config_from_json(_config_to_json(jax_cifar10_config(num_layers=2, num_filters=5,
                                                            gamma=0.02))),
        generator=torch.Generator().manual_seed(4), device="cpu")
    with torch.no_grad():
        kernel = materialize_3x3_stacked(model.params()["stages"][0]["blocks"], 0.02)[0].numpy()
    check = antisymmetric_kernel_properties.check_kernel_properties
    check(kernel, 0.02, "intact")
    for index in ((0, 2, 1, 3), (1, 1, 2, 2)):
        broken = kernel.copy()
        broken[index] += 1e-3
        with pytest.raises(AssertionError):
            check(broken, 0.02, "broken")


def test_gradient_flow_example(tmp_path, capsys):
    assert cifar10_gradient_flow_experiment.main(
        ["--num-layers", "2", "--num-filters", "4", "--epochs", "1", "--batch-size", "4",
         "--synthetic-train-size", "48", "--synthetic-val-size", "8", "--device-data",
         "--out-dir", str(tmp_path), *CPU]) == 0
    out = printed_json(capsys)
    assert set(out) == {"antisymmetric", "regular"}
    for row in out.values():
        assert set(row) == GRADIENT_FLOW_KEYS
        assert np.isfinite(row["grad_norm_relative_deviation"])


def test_depth_doubling_example(capsys):
    assert depth_doubling_continuation.main(
        ["--start-layers", "1", "--doublings", "2", "--num-filters", "4", "--batch-size", "8",
         "--synthetic-train-size", "16", "--synthetic-val-size", "8", *CPU]) == 0
    rows = printed_json(capsys)
    assert [r["layers"] for r in rows] == [1, 2, 4]
    assert [r["h"] for r in rows] == [8.0, 4.0, 2.0]
    assert all(set(r) == DEPTH_ROW_KEYS for r in rows)


def test_depth_doubling_matches_jax_on_converted_weights():
    config = jax_cifar10_config(num_layers=2, num_filters=4)
    params, _ = jax_params_with_biases(jax_build(config), 17)
    want_params, want_config = jax_double(to_numpy(params), config)
    got_params, got_config = double_model_depth(params_from_jax(to_numpy(params)),
                                                config_from_json(_config_to_json(config)))
    assert got_config.blocks_per_stage == want_config.blocks_per_stage == (4,)
    assert got_config.h == want_config.h
    got = dict(_named_leaves(got_params))
    want = dict(_named_leaves(params_from_jax(jax.tree.map(np.asarray, want_params))))
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert torch.equal(got[name].detach(), leaf), name


def test_large_batch_example(capsys):
    assert large_batch_training.main(
        ["--epochs", "1", "--train-size", "32", "--val-size", "8", "--batches", "8,16",
         "--num-layers", "2", "--num-filters", "4", "--compare-bf16", "--compare-int8",
         "--int8-backward", "wgrad", *CPU]) == 0
    out = printed_json(capsys)
    assert len(out["runs"]) == 8 and all(set(r) == LARGE_BATCH_RUN_KEYS for r in out["runs"])
    assert [r["lr"] for r in out["runs"]] == [2.5e-4] * 4 + [5e-4] * 4
    assert {r["dtype"] for r in out["runs"]} == {"float32", "bfloat16"}
    assert all(set(d) == LARGE_BATCH_DELTA_KEYS for d in out["convergence_delta_vs_base"])


def test_int8_nan_repro_example(capsys):
    """Three 'full' steps at 2L x 8F, batch 4: clean; the residual stack is
    the int8 activations and bool masks of both layers plus the two int8
    kernels (the JAX example's 2 bytes an element, and the kernels)."""
    assert int8_full_nan_repro.main(
        ["--num-layers", "2", "--num-filters", "8", "--batch", "4", "--steps", "3", *CPU]) == 0
    out = printed_json(capsys)
    assert set(out) == NAN_REPRO_KEYS
    assert out["verdict"] == "clean" and len(out["losses"]) == 3
    assert out["residual_stack_bytes"] == 2 * (2 * 4 * 32 * 32 * 8) + 2 * 9 * 8 * 8
    assert out["versions"]["device"] == "cpu"
