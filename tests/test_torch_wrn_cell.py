"""The WRN-40-4 configuration (``perfbench/configs/wrn-40-4-antisym-cifar10.
json``: Zagoruyko and Komodakis's layout with the antisymmetric Euler step,
widths 64, 128 and 256, batch 128) on the CPU, the per-layer stack's entry
in the port's record of hand-kernel calls (`utils.tracing.STACKS`), and the
readers of the wide variants' and the band B1's roofline shares
(``perfbench/metrics/wide_b?_roofline.train.py``,
``band_b1_roofline.train.py``).

The configuration built through the benchmark's path gives two fused
stacks and one past the kernels' reach, which runs layer by layer; the
port's planners run the fused ones at batch 128 in the band and wide
variants; the cell's harness at a small three-stage size with a per-layer
third stage agrees with the plain reference and a planted fault does not;
the CPU path records the per-layer stack between the B1 and the B2 calls;
each wide reader gives its kernel the device time of the wide operations
at its places in a step, and the band reader holds the band B1's time to
the band stacks' bound alone.  Imports no JAX."""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

from differential_equations_resnet_tpu_torch.models import single_block_resnet as sbr
from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi
from differential_equations_resnet_tpu_torch.train import make_adam, make_train_step, train_step
from differential_equations_resnet_tpu_torch.utils import tracing
from differential_equations_resnet_tpu_torch.utils.tracing import StackEntry

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import frozen, program, run  # noqa: E402
from perfbench.program import MetricContext  # noqa: E402
from perfbench.registry import Benchmark  # noqa: E402
from perfbench.trace import Trace  # noqa: E402

CELL = "wrn-40-4.train-resident"
STACKS = [(32, 32, 64, 12), (16, 16, 128, 11), (8, 8, 256, 11)]
READERS = ("wide_b1_roofline.train", "wide_b2_roofline.train")
BAND_READER = "band_b1_roofline.train"
# At batch 128, by stack: B1's and B2's (variant, bands an image, grid) as
# `launch_plan` gives them (the band grid in blocks, the wide one the
# conv's and, for B2, the dK pass's), or None past the kernels' reach.
PLANS = {
    (32, 32, 64): (("band", 16, 2048), ("wide", 0, (1024, 1), (9, 58))),
    (16, 16, 128): (("wide", 0, (256, 1)), ("wide", 0, (256, 1), (9, 29))),
    (8, 8, 256): None,
}
# The cell at a size the CPU trains in seconds: three stages of two blocks,
# the third past the reach (C = 136 > 128), so it runs layer by layer.
SMALL = dict(image_shape=[8, 8, 3], filters_per_block=[8, 16, 136], blocks_per_stage=[2, 2, 2])


@pytest.fixture
def bench():
    return Benchmark(ROOT)


@pytest.fixture
def record():
    """The port's record of hand-kernel calls, cleared before and after."""
    tracing.STACKS.clear()
    yield tracing.STACKS
    tracing.STACKS.clear()


def test_the_configuration_builds_three_stacks_on_their_routes(bench, record, monkeypatch):
    config = bench.config(bench.cell(CELL)["config"])
    assert config["train"]["batch_size"] == 128 and config["reduced"] == []
    assert frozen.identity_stacks(config["model"]) == STACKS
    monkeypatch.setattr(sbr, "route_counts", {"fused": 0, "per_layer": 0})
    monkeypatch.setattr(sbr, "per_layer_counts", {"int8": 0, "s2d": 0, "direct": 0})
    model, shapes = program.build(config, 4_000_000_017, "cpu")
    assert sum(torch.Size(s).numel() for s in shapes.values()) == 4_693_450
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 3))
    assert list(record.eager) == [StackEntry("B1", STACKS[0], "plain", 0, 0),
                                  StackEntry("B1", STACKS[1], "plain", 0, 0),
                                  StackEntry("per_layer", STACKS[2], "direct", 0, 0)]
    assert sbr.route_counts == {"fused": 2, "per_layer": 1}
    assert sbr.per_layer_counts == {"int8": 0, "s2d": 0, "direct": 1}


@pytest.mark.parametrize("stack", STACKS, ids=lambda s: "x".join(map(str, s)))
def test_the_planners_run_each_stack_at_batch_128(stack):
    height, width, channels, _ = stack
    shape = (128, height, width, channels)
    plans = PLANS[(height, width, channels)]
    if plans is None:
        assert not fi.in_reference_reach(shape)
        assert fi._declined(torch.empty(shape)) == f"C={channels} > 128"
        return
    assert fi.in_reference_reach(shape)
    for backward, (variant, bands, *grids) in zip((False, True), plans):
        plan = fi.launch_plan(shape, backward)
        assert fi.kernel_variant(shape, backward) == plan["variant"] == variant
        if variant == "band":
            assert (plan["bands"], plan["blocks"]) == (bands, grids[0])
        else:
            assert plan["conv_grid"] == grids[0]
            assert plan.get("dk_grid") == (grids[1] if backward else None)


def small_run(bench, seed=4_000_000_017):
    cell = bench.cell(CELL)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    config["model"].update(SMALL)
    config["train_images"], config["train"]["batch_size"] = 16, 4
    return run.execute(bench, cell, seed, 0.2, False, "cpu", time.perf_counter(),
                       config=config, traffic=traffic)


def test_the_small_wide_cell_matches_the_reference(bench, record):
    result = small_run(bench)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert record.calls("per_layer", "direct") > 0


def test_half_the_batch_left_out_fails_with_a_per_layer_stack(bench, monkeypatch):
    whole = train_step.cross_entropy_from_logits

    def half(logits, labels):
        n = logits.shape[0] // 2
        return whole(logits[:n], labels[:n])

    monkeypatch.setattr(train_step, "cross_entropy_from_logits", half)
    assert not small_run(bench)["correct"]


def test_the_cpu_path_records_the_per_layer_stack_between_b1_and_b2(bench, record):
    config = bench.config(bench.cell(CELL)["config"])
    config["model"].update(SMALL)
    model, _ = program.build(config, 7, "cpu")
    step = make_train_step(model, make_adam(model.parameters()))
    step(torch.zeros(2, 8, 8, 3), torch.zeros(2, dtype=torch.long), 1e-3)
    fused = [(8, 8, 8, 2), (4, 4, 16, 1)]
    want = ([StackEntry("B1", s, "plain", 0, 0) for s in fused]
            + [StackEntry("per_layer", (2, 2, 136, 1), "direct", 0, 0)]
            + [StackEntry("B2", s, "plain", 0, 0) for s in reversed(fused)])
    assert list(record.eager) == want
    assert record.graphs == [] and record.graph("train step") is None
    assert (record.calls("per_layer"), record.launches("per_layer")) == (1, 0)
    assert (record.calls("B1", "plain"), record.calls("B2", "plain")) == (2, 2)


@pytest.mark.parametrize("form, config", [
    ("direct", dict(integrator="midpoint")),
    ("s2d", dict(integrator="midpoint", s2d_force=True, s2d_block=2)),
    ("int8", dict(int8_forward=True)),
])
def test_a_per_layer_stack_records_its_form(record, form, config):
    model = sbr.build_single_block_resnet(
        sbr.cifar10_single_block_config(num_layers=2, num_filters=4, **config),
        generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 3))
    assert list(record.eager) == [StackEntry("per_layer", (32, 32, 4, 2), form, 0, 0)]
    assert record.calls("per_layer", form) == 1


# -- the readers, on a hand-built trace of a replayed WRN step (us) ------------

STEPS, BATCH = 3, 128
STEP_RECORD = [StackEntry("B1", STACKS[0], "band", 16, 2),
               StackEntry("B1", STACKS[1], "wide", 0, 11),
               StackEntry("per_layer", STACKS[2], "direct", 0, 0),
               StackEntry("B2", STACKS[1], "wide", 0, 33),
               StackEntry("B2", STACKS[0], "wide", 0, 36)]
CONV = "void (anonymous namespace)::wide_conv<128, 2, false>(ConvArgs, Wide)"
DK = "void (anonymous namespace)::wide_dk<2>(DkArgs, Wide)"


def wide_b2(layers: int, us: float):
    """A wide B2 call's launches: the recompute, then dK and conv a layer."""
    return [(CONV, us)] * layers + [(DK, 2 * us), (CONV, us)] * layers


STEP_OPS = ([("void (anonymous namespace)::euler_fwd<false, 0, 1>", 300.0)] * 2
            + [(CONV, 25.0)] * 11
            + [("sm90_xmma_fprop_implicit_gemm_f32f32", 40.0)] * 11
            + [("sm90_xmma_dgrad_implicit_gemm_f32f32", 45.0)] * 11
            + wide_b2(11, 60.0) + wide_b2(12, 90.0))
B1_US = 11 * 25.0
BAND_B1_US = 2 * 300.0
B2_US = 11 * 4 * 60.0 + 12 * 4 * 90.0


def step_trace():
    ops, t = [], 0.0
    for _ in range(STEPS):
        for name, us in STEP_OPS:
            ops.append((name, t, t + us))
            t += us + 1.0
    ops.reverse()  # the profiler's order is not the device's
    return Trace(ops, {"window": [(0.0, t)]}, [], "window")


def reading(bench, name, info=None):
    config = bench.config(bench.cell(CELL)["config"])
    info = info or {"kind": "train", "batch": BATCH, "calls": STEPS}
    return bench.reader(name).read(MetricContext(step_trace(), config, {}, info))


def capture(record, entries):
    with record.capture("train step"):
        for entry in entries:
            record.add(entry, captured=True)


@pytest.mark.parametrize("name, backward, stacks, us", [
    ("wide_b1_roofline.train", False, [STACKS[1]], B1_US),
    ("wide_b2_roofline.train", True, [STACKS[1], STACKS[0]], B2_US),
])
def test_a_wide_reader_takes_its_kernels_launches(bench, record, name, backward, stacks, us):
    capture(record, STEP_RECORD)
    bound = sum(frozen.kernel_bounds(BATCH, *s, backward)["bound_ms"] for s in stacks)
    assert reading(bench, name) == pytest.approx(100 * bound / (us / 1e3), rel=1e-12)
    assert reading(bench, name, {"kind": "serve", "batch": 1, "calls": STEPS}) is None


@pytest.mark.parametrize("name", READERS)
def test_a_wide_reader_without_its_entries_gives_none(bench, record, monkeypatch, name):
    assert reading(bench, name) is None  # nothing captured
    capture(record, [e._replace(variant="band") if e.variant == "wide" else e
                     for e in STEP_RECORD])
    assert reading(bench, name) is None  # band entries only
    capture(record, [e._replace(launches=e.launches + 1) if e.variant == "wide" else e
                     for e in STEP_RECORD])
    assert reading(bench, name) is None  # launches that are not the trace's
    capture(record, [e._replace(shape=(16, 16, 128, 12)) if e.variant == "wide" else e
                     for e in STEP_RECORD])
    assert reading(bench, name) is None  # stacks that are not the model's
    capture(record, [e for e in STEP_RECORD if e.kernel != "per_layer"])
    assert reading(bench, name) is None  # a record blind to the per-layer stack
    capture(record, STEP_RECORD)
    assert reading(bench, name) is not None
    monkeypatch.delattr(tracing, "STACKS")  # a port without the record
    assert reading(bench, name) is None


def test_the_band_reader_holds_the_band_time_to_the_band_stacks(bench, record):
    capture(record, STEP_RECORD)
    bound = frozen.kernel_bounds(BATCH, *STACKS[0], False)["bound_ms"]
    assert reading(bench, BAND_READER) == pytest.approx(100 * bound / (BAND_B1_US / 1e3),
                                                        rel=1e-12)
    assert reading(bench, BAND_READER, {"kind": "serve", "batch": 1, "calls": STEPS}) is None


def test_the_band_reader_without_its_entries_gives_none(bench, record, monkeypatch):
    assert reading(bench, BAND_READER) is None  # nothing captured
    capture(record, [e._replace(variant="wide", bands=0) if e.variant == "band" else e
                     for e in STEP_RECORD])
    assert reading(bench, BAND_READER) is None  # wide entries only
    capture(record, [e._replace(launches=3) if e.variant == "band" else e
                     for e in STEP_RECORD])
    assert reading(bench, BAND_READER) is None  # launches that are not the trace's
    capture(record, [e for e in STEP_RECORD if e.kernel != "per_layer"])
    assert reading(bench, BAND_READER) is None  # a record blind to the per-layer stack
    capture(record, STEP_RECORD)
    assert reading(bench, BAND_READER) is not None
    monkeypatch.delattr(tracing, "STACKS")  # a port without the record
    assert reading(bench, BAND_READER) is None


def test_the_cell_reports_its_metrics(bench):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in (*READERS, BAND_READER):
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "train_images_per_s"
        assert entries[name]["layer"] == entries["b1_roofline.train"]["layer"]
    assert [m["name"] for m in bench.end_to_end(CELL)] == ["setup_s", "train_images_per_s"]
    assert {m["name"] for m in bench.per_layer(CELL)} == {
        "device_idle_pct.train", "step_device_ms.train", "step_device_ops.train",
        "train_mfu_pct", "step_host_ms.train", "epoch_host_ms.train",
        "graph_replays_per_step.train", "graph_captures.train", *READERS, BAND_READER}
    cell = bench.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "wrn-40-4-antisym-cifar10", "train-resident", 1)
