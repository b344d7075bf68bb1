"""The control on the card: the reference in the next precision below the
configuration's (TF32 for fp32 with TF32 off), put in the program's
place, must fail the cell's limits; and so must the planted half-batch
fault.  At a size a test run holds: each cell's model at its published
widths, its data set cut.  Skips where there is no card."""

import pytest
import torch

from perfbench import calibrate, checks

TRAIN_CELLS = ["sb-antisym-64x16.train-resident", "resnet50-224.train-resident",
               "sb-antisym-64x16.train-stream"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is TF32, which only the card has")


def _cell(bench, name, images):
    cell = bench.cell(name)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    config["train_images"] = images
    config["data"]["serve_pool"] = images
    return config, traffic, bench.kind(traffic["kind"]), bench.limits(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN_CELLS)
@pytest.mark.parametrize("seed", [7_000_000_001, 7_000_000_002, 7_000_000_003])
def test_training_control_and_fault_fail_the_limits(card, bench, name, seed):
    config, traffic, kind, limits = _cell(bench, name, 256)
    row = calibrate.train_readings(kind, config, traffic, seed, "cuda", controls=True)
    assert checks.judge(row["sound"], limits), row["sound"]
    assert not checks.judge(row["control"], limits), row["control"]
    assert not checks.judge(row["half_batch"], limits), row["half_batch"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7_000_000_004, 7_000_000_005, 7_000_000_006])
def test_serving_control_fails_the_limit(card, bench, seed):
    name = "sb-antisym-64x16.serve-b1-poisson"
    config, traffic, kind, limits = _cell(bench, name, 1000)
    traffic["warmup_requests"] = 5
    row = calibrate.serve_readings(kind, config, traffic, seed, 0.5, "cuda", controls=True)
    assert checks.judge(row["sound"], limits), row["sound"]
    assert not checks.judge(row["control"], limits), row["control"]
