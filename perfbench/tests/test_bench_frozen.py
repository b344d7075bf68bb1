"""The benchmark's frozen copies against the port's current functions, at
small sizes: a change to the program that moves one shows here."""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import frozen, fused, reference, trace
from perfbench.program import MetricContext
from differential_equations_resnet_tpu_torch.data.jit_augment import standard_cifar_augment
from differential_equations_resnet_tpu_torch.ops.antisymmetric import (
    dense_from_packed,
    init_antisym_3x3,
    materialize_3x3_from_dense,
    materialize_3x3_stacked,
)
from differential_equations_resnet_tpu_torch.models.single_block_resnet import (
    stack_trees,
    stage_plans,
)
from differential_equations_resnet_tpu_torch.train import training
from differential_equations_resnet_tpu_torch.utils import flops as port_flops
from differential_equations_resnet_tpu_torch.utils.serving import config_from_json

from conftest import TINY_MULTI_STAGE

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
HEADLINE = json.loads((CONFIGS / "sb-antisym-64x16-cifar10.json").read_text())


def _multi_stage():
    """The headline configuration with the multi-stage model."""
    config = json.loads(json.dumps(HEADLINE))
    config["model"].update(TINY_MULTI_STAGE)
    return config


@pytest.mark.parametrize("name", sorted(p.name for p in CONFIGS.glob("*.json")) + ["multi-stage"])
@pytest.mark.parametrize("batch", [1, 32])
def test_train_flops_match_the_port(name, batch):
    config = _multi_stage() if name == "multi-stage" else json.loads((CONFIGS / name).read_text())
    port = port_flops.train_flops(config_from_json(config["model"], config["family"]), batch)
    assert frozen.train_flops(config["family"], config["model"], batch) == port


@pytest.mark.parametrize("model", [{}, TINY_MULTI_STAGE, dict(
    TINY_MULTI_STAGE, num_stages=5, blocks_per_stage=[2, 3, 1, 2], filters_per_block=[4, 4, 8, 8],
    strides=[[1, 1], [1, 1], [2, 2], [1, 1]], use_max_pooling=[False, True, False, False])])
def test_stage_plans_match_the_port(model):
    """The headline's one stage, the multi-stage model, and one with an
    identity-only later stage, a pooled stage and a stage of one block."""
    config = _multi_stage() if model else HEADLINE
    config["model"].update(model)
    port = stage_plans(config_from_json(config["model"], config["family"]))
    assert [tuple(plan) for plan in frozen.stage_plans(config["model"])] == [
        (p.pool, p.has_conv_block, p.num_identity, p.filters, tuple(p.strides), p.in_channels)
        for p in port]


@pytest.mark.parametrize("shape", [(32, 32, 32, 16, 64), (1, 32, 32, 16, 64), (8, 28, 28, 8, 4)])
@pytest.mark.parametrize("backward", [False, True])
def test_kernel_bounds_match_chip_smoke(shape, backward):
    smoke = importlib.import_module("chip_smoke")
    assert frozen.kernel_bounds(*shape, backward=backward) == smoke.kernel_bounds(
        *shape, backward=backward)


def test_headline_bounds_are_the_recorded_ones():
    """B1 9.664 GFLOP and B2 28.991 GFLOP at 32x32x16, L = 64, batch 32."""
    assert round(frozen.kernel_bounds(32, 32, 32, 16, 64)["flops"] / 1e9, 3) == 9.664
    assert round(frozen.kernel_bounds(32, 32, 32, 16, 64, True)["flops"] / 1e9, 3) == 28.991


class _Trace:
    """A trace in which the matched operations took ``used_us`` in all."""

    def __init__(self, used_us):
        self.used_us = used_us

    def device_time_us(self, match):
        return self.used_us, 1


@pytest.mark.parametrize("backward", [False, True])
def test_fused_bound_is_the_sum_over_the_stages(backward):
    """One step's B1 (B2) bound: the headline's own stage alone, as
    recorded; a multi-stage model's the sum over its identity stacks at
    their shapes (8x8x4, 4x4x8, 2x2x16; 2, 1 and 1 layers)."""
    headline = frozen.kernel_bounds(32, 32, 32, 16, 64, backward)["bound_ms"]
    assert fused.bound_ms(HEADLINE["model"], 32, backward) == headline
    model = _multi_stage()["model"]
    stages = sum(frozen.kernel_bounds(32, *shape, backward)["bound_ms"]
                 for shape in ((8, 8, 4, 2), (4, 4, 8, 1), (2, 2, 16, 1)))
    assert fused.bound_ms(model, 32, backward) == stages
    for config, bound in ((HEADLINE, headline), (_multi_stage(), stages)):
        ctx = MetricContext(_Trace(2000.0), config, {}, {"kind": "train", "batch": 32, "calls": 4})
        assert fused.roofline_pct(ctx, fused.B2_NAMES, backward) == 100.0 * bound / 0.5


@pytest.mark.parametrize("seed,step", [(0, 0), (5, 3), (2 ** 40 + 7, 1561)])
def test_fold_in_matches_training(seed, step):
    assert frozen.fold_in(seed, step) == training._fold_in(seed, step)


@pytest.mark.parametrize("padding,flip", [(4, True), (2, False), (0, True)])
def test_cifar_augment_matches_the_port(padding, flip):
    images = torch.rand(6, 10, 12, 3) * 255
    got = frozen.cifar_augment(padding, flip)(torch.Generator().manual_seed(3), images)
    want = standard_cifar_augment(flip=flip, crop_padding=padding)(
        torch.Generator().manual_seed(3), images)
    assert torch.equal(got, want)


@pytest.mark.parametrize("channels", [1, 2, 5])
def test_materializations_match_the_port(channels):
    g = torch.Generator().manual_seed(channels)
    layers = [init_antisym_3x3(g, channels) for _ in range(3)]
    packed = stack_trees(layers)
    got = reference.antisym_from_packed(packed.a, packed.b, packed.c, packed.d, packed.cross, 0.25)
    assert torch.equal(got, materialize_3x3_stacked(packed, 0.25))
    dense = dense_from_packed(packed)
    got = reference.antisym_from_dense_lower(dense.a, dense.b, dense.c, dense.d, dense.cross, 0.25)
    assert torch.allclose(got, materialize_3x3_from_dense(dense, 0.25), rtol=0, atol=0)


def profile_window_busy(device_intervals, windows):
    """``chip_smoke.py::profile_window``'s own loop: the union of the
    device intervals, and the windows' summed length."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(device_intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy, sum(e - s for s, e in windows)


def test_window_arithmetic_matches_profile_window():
    rng = np.random.default_rng(0)
    starts = np.sort(rng.uniform(0, 1000, 300))
    intervals = [(float(s), float(s + d)) for s, d in zip(starts, rng.uniform(0, 8, 300))]
    t = trace.Trace([("k", s, e) for s, e in intervals], {"window": [(-1.0, 1010.0)]}, [],
                    "window")
    busy, window = profile_window_busy(intervals, [(-1.0, 1010.0)])
    assert t.busy_us == pytest.approx(busy, rel=1e-12)
    assert t.window_us == window
