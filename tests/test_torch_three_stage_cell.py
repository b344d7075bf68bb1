"""The three-stage CIFAR configuration (``perfbench/configs/sb-antisym-3x18-
cifar10.json``: He et al.'s layout with the antisymmetric Euler block, batch
128) on the CPU, the port's record of hand-kernel calls
(`utils.tracing.STACKS`), and the two readers of one stack's roofline share
(``perfbench/metrics/b?_roofline.last_stack.train.py``).

The configuration built through the benchmark's path gives three fused
stacks, which the port's planners run at batch 128 in one band an image, or
two; the cell's harness at a small three-stage size agrees with the plain
reference and a planted fault does not; the CPU path records its stacks in
launch order; each reader gives a stack the device time of the operations
at its places in a step.  Imports no JAX."""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi
from differential_equations_resnet_tpu_torch.train import make_adam, make_train_step, train_step
from differential_equations_resnet_tpu_torch.utils import tracing
from differential_equations_resnet_tpu_torch.utils.tracing import StackEntry, StackRecord

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import frozen, program, run  # noqa: E402
from perfbench.program import MetricContext  # noqa: E402
from perfbench.registry import Benchmark  # noqa: E402
from perfbench.trace import Trace  # noqa: E402

CELL = "sb-antisym-3x18.train-resident"
HEADLINE = "sb-antisym-64x16.train-resident"
STACKS = [(32, 32, 16, 18), (16, 16, 32, 17), (8, 8, 64, 17)]
# (variant, bands an image) of B1 and B2 at batch 128, by stack.
PLANS = {(32, 32, 16): (("band", 1), ("band", 2)),
         (16, 16, 32): (("band", 1), ("band", 1)),
         (8, 8, 64): (("band", 1), ("band", 2))}
# The cell at a size the CPU trains in seconds: three stages of two blocks.
SMALL = dict(image_shape=[8, 8, 3], filters_per_block=[4, 8, 16], blocks_per_stage=[2, 2, 2])


@pytest.fixture
def bench():
    return Benchmark(ROOT)


@pytest.fixture
def record():
    """The port's record of hand-kernel calls, cleared before and after."""
    tracing.STACKS.clear()
    yield tracing.STACKS
    tracing.STACKS.clear()


def test_the_configuration_builds_three_stacks(bench, record):
    config = bench.config(bench.cell(CELL)["config"])
    assert config["train"]["batch_size"] == 128
    assert frozen.identity_stacks(config["model"]) == STACKS
    model, _ = program.build(config, 4_000_000_017, "cpu")
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 3))
    assert [(e.kernel, e.shape) for e in record.eager] == [("B1", s) for s in STACKS]


@pytest.mark.parametrize("stack", STACKS, ids=lambda s: "x".join(map(str, s)))
def test_the_planners_run_each_stack_at_batch_128(stack):
    height, width, channels, _ = stack
    shape = (128, height, width, channels)
    for backward, (variant, bands) in zip((False, True), PLANS[(height, width, channels)]):
        assert fi.kernel_variant(shape, backward) == variant
        assert fi.kernel_bands(shape, backward) == bands
        assert fi.launch_plan(shape, backward)["blocks"] == 128 * bands


def small_run(bench, limits_cell, seed=4_000_000_017):
    cell = bench.cell(CELL)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    config["model"].update(SMALL)
    config["train_images"], config["train"]["batch_size"] = 32, 8
    return run.execute(bench, cell, seed, 0.2, False, "cpu", time.perf_counter(),
                       config=config, traffic=traffic, limits=bench.limits(limits_cell))


@pytest.mark.parametrize("limits", [HEADLINE, CELL])
def test_the_small_three_stage_cell_matches_the_reference(bench, limits):
    result = small_run(bench, limits)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("limits", [HEADLINE, CELL])
def test_half_the_batch_left_out_fails_at_three_stages(bench, monkeypatch, limits):
    whole = train_step.cross_entropy_from_logits

    def half(logits, labels):
        n = logits.shape[0] // 2
        return whole(logits[:n], labels[:n])

    monkeypatch.setattr(train_step, "cross_entropy_from_logits", half)
    assert not small_run(bench, limits)["correct"]


def test_the_cpu_path_records_its_stacks_in_launch_order(bench, record):
    config = bench.config(bench.cell(CELL)["config"])
    config["model"].update(SMALL)
    model, _ = program.build(config, 7, "cpu")
    step = make_train_step(model, make_adam(model.parameters()))
    step(torch.zeros(2, 8, 8, 3), torch.zeros(2, dtype=torch.long), 1e-3)
    shapes = [(8, 8, 4, 2), (4, 4, 8, 1), (2, 2, 16, 1)]
    want = ([StackEntry("B1", s, "plain", 0, 0) for s in shapes]
            + [StackEntry("B2", s, "plain", 0, 0) for s in reversed(shapes)])
    assert list(record.eager) == want
    assert record.graphs == [] and record.graph("train step") is None


def test_the_record_groups_calls_by_capture():
    record = StackRecord()
    a, b, c = (StackEntry("B1", (8, 8, 4, n), "band", 1, n) for n in (1, 2, 3))
    record.add(a, captured=False)
    with record.capture("train step"):
        record.add(b, captured=True)
        record.add(a, captured=False)  # a warm-up call on another stream
    record.add(c, captured=True)  # a capture the port did not open
    with record.capture("train step"):
        record.add(c, captured=True)
    assert list(record.eager) == [a, a]
    assert record.graphs == [("train step", [b]), (None, [c]), ("train step", [c])]
    assert record.graph("train step") == [c] and record.graph("eval batch") is None
    for _ in range(tracing.EAGER_CALLS + 5):
        record.add(b, captured=False)
    assert len(record.eager) == tracing.EAGER_CALLS
    record.clear()
    assert not record.eager and record.graphs == []


# -- the readers, on a hand-built trace of a replayed step: B1 one launch a
# stack, B2 two launches at 32x32x16 and 8x8x64 (us) ----------------------------

STEPS, BATCH = 3, 128
STEP_RECORD = ([StackEntry("B1", s, "band", 1, 1) for s in STACKS]
               + [StackEntry("B2", s, "band", n, n) for s, n in zip(STACKS[::-1], (2, 1, 2))])
# Device time of each launch a step, in launch order.
B1_US = [50.0, 30.0, 20.0]
B2_US = [40.0, 41.0, 60.0, 70.0, 71.0]


def step_trace():
    ops, t = [], 0.0
    for _ in range(STEPS):
        for name, times in (("void deqres::euler_fwd<false, 16, 1>", B1_US),
                            ("void cudnn::conv", [5.0]),
                            ("void deqres::euler_bwd<false, 16, 1>", B2_US)):
            for us in times:
                ops.append((name, t, t + us))
                t += us + 1.0
    ops.reverse()  # the profiler's order is not the device's
    return Trace(ops, {"window": [(0.0, t)]}, [], "window")


def reading(bench, name, info=None):
    config = bench.config(bench.cell(CELL)["config"])
    info = info or {"kind": "train", "batch": BATCH, "calls": STEPS}
    return bench.reader(name).read(MetricContext(step_trace(), config, {}, info))


@pytest.mark.parametrize("name, backward, last_us", [
    ("b1_roofline.last_stack.train", False, B1_US[2]),
    ("b2_roofline.last_stack.train", True, B2_US[0] + B2_US[1]),  # B2 runs it first
])
def test_a_reader_takes_the_last_stacks_launches(bench, record, name, backward, last_us):
    with record.capture("train step"):
        for entry in STEP_RECORD:
            record.add(entry, captured=True)
    bound = frozen.kernel_bounds(BATCH, *STACKS[-1], backward)["bound_ms"]
    assert reading(bench, name) == pytest.approx(100 * bound / (last_us / 1e3), rel=1e-12)
    assert reading(bench, name, {"kind": "serve", "batch": 1, "calls": STEPS}) is None


def test_batch_norm_entries_leave_the_step_the_readers_see(bench, record):
    """A captured step whose record also holds batch norm's calls ("BN"
    entries before, between and after the stacks) gives, filtered to B1 and
    B2, exactly the step without them, and the readers the same readings."""
    readings = []
    for with_bn in (False, True):
        bn = [StackEntry("BN", (BATCH, 32, 32, 16), v, 0, n) for v, n in (("forward", 1),
                                                                         ("backward", 3))]
        with record.capture("train step"):
            for entry in STEP_RECORD:
                for extra in (bn if with_bn else []):
                    record.add(extra, captured=True)
                record.add(entry, captured=True)
        entries = record.graph("train step")
        assert len(entries) == len(STEP_RECORD) * (3 if with_bn else 1)
        assert [e for e in entries if e.kernel in ("B1", "B2")] == STEP_RECORD
        readings.append([reading(bench, name) for name in ("b1_roofline.last_stack.train",
                                                           "b2_roofline.last_stack.train")])
    assert readings[0] == readings[1] and None not in readings[1]


@pytest.mark.parametrize("name", ["b1_roofline.last_stack.train",
                                  "b2_roofline.last_stack.train"])
def test_a_reader_without_the_record_gives_none(bench, record, monkeypatch, name):
    assert reading(bench, name) is None  # nothing captured
    with record.capture("train step"):
        for entry in STEP_RECORD:
            if entry.shape != STACKS[1]:  # a stack missing
                record.add(entry, captured=True)
    assert reading(bench, name) is None
    with record.capture("train step"):
        for entry in STEP_RECORD:
            record.add(entry._replace(launches=entry.launches + 1), captured=True)
    assert reading(bench, name) is None  # launches that are not the trace's
    monkeypatch.delattr(tracing, "STACKS")  # a port without the record
    assert reading(bench, name) is None


def test_the_readers_have_their_entries(bench):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in ("b1_roofline.last_stack.train", "b2_roofline.last_stack.train"):
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "train_images_per_s"
    assert CELL not in entries["feed_wait_ms.train"]["workloads"]
    assert [m["name"] for m in bench.end_to_end(CELL)] == ["setup_s", "train_images_per_s"]
