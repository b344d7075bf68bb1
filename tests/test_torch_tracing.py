"""The port's named host ranges (`utils.tracing`) under `torch.profiler`, and
the benchmark's readers of them (`perfbench/metrics/`).

A tiny model's two epochs record each span the expected number of times on
both feeds, and enter no `record_function` where no profiler is open; a
served request records its two copies; ``profile_dir``'s chrome trace
holds the epoch's telemetry; each reader takes only the ranges inside the
traced window.  The CUDA case (graph replays and captures) skips itself
without a card."""

import collections
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from differential_equations_resnet_tpu_torch.data import synthetic_cifar10
from differential_equations_resnet_tpu_torch.models import (
    build_single_block_resnet,
    cifar10_single_block_config,
)
from differential_equations_resnet_tpu_torch.train import Training, make_adam, make_multi_step
from differential_equations_resnet_tpu_torch.utils import tracing
from differential_equations_resnet_tpu_torch.utils.serving import export_model, load_exported

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.program import MetricContext  # noqa: E402
from perfbench.registry import Benchmark  # noqa: E402
from perfbench.trace import Trace  # noqa: E402

EPOCHS, STEPS, BATCH = 2, 3, 4


def tiny_model(device="cpu"):
    return build_single_block_resnet(cifar10_single_block_config(num_layers=1, num_filters=4),
                                     generator=torch.Generator().manual_seed(0), device=device)


def tiny_trainer(tmp_path):
    x, y, _, _, _ = synthetic_cifar10(4 * BATCH, 4, seed=0)
    return Training(tiny_model(), train_features=x, train_labels=y, batch_size=BATCH,
                    csv_logger_dir=str(tmp_path / "csv"), summaries_dir=str(tmp_path / "sum"))


def train(trainer, device_data, **kw):
    trainer.train(EPOCHS, STEPS, lambda step: 1e-3, eval_frequency=None, summaries_frequency=1,
                  device_data=device_data, verbose=False, **kw)
    trainer.close()


def span_counts(prof):
    """The host ranges by name (a CUDA window also puts each range that
    launched work on the device's timeline, under the same name)."""
    return collections.Counter(e.name for e in prof.events() if e.name.startswith("deqres.")
                               and e.device_type == DeviceType.CPU)


def tiny_predictor(tmp_path):
    export_model(tiny_model(), str(tmp_path / "export"), batch_size=2)
    predict, _ = load_exported(str(tmp_path / "export"), device="cpu")
    request = np.random.default_rng(0).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    return lambda: predict(request)


@pytest.mark.parametrize("device_data", [True, False], ids=["resident", "streaming"])
def test_an_epoch_records_each_span(tmp_path, device_data):
    trainer = tiny_trainer(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train(trainer, device_data)
    # The resident epoch's begin is two ranges: Training's (the rates and
    # the generator), then make_device_epoch's (the rates tensor, the shuffle).
    want = {"deqres.step": EPOCHS * STEPS, "deqres.epoch.log": EPOCHS,
            "deqres.epoch.begin": EPOCHS * (2 if device_data else 1)}
    if not device_data:
        want["deqres.feed.wait"] = EPOCHS * (STEPS + 1)  # a get a batch, then the end
    assert span_counts(prof) == want


@pytest.mark.parametrize("path", ["resident", "streaming", "serving"])
def test_no_range_is_entered_without_a_profiler(tmp_path, monkeypatch, path):
    def refuse(name):
        raise AssertionError(f"{name} entered with no profiler open")

    monkeypatch.setattr(tracing, "record_function", refuse)
    with profile(activities=[ProfilerActivity.CPU]), pytest.raises(AssertionError):
        tracing.span("deqres.step")  # the patch is where the helper enters
    if path == "serving":
        request = tiny_predictor(tmp_path)
        for _ in range(3):
            request()
    else:
        train(tiny_trainer(tmp_path), path == "resident")


def test_a_request_records_its_two_copies(tmp_path):
    request = tiny_predictor(tmp_path)
    request()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            request()
    assert span_counts(prof) == {"deqres.predict.h2d": 3, "deqres.predict.d2h": 3}


def test_the_profiled_epoch_trace_holds_its_telemetry(tmp_path):
    trainer = tiny_trainer(tmp_path)
    train(trainer, False, profile_dir=str(tmp_path / "prof"), profile_epoch=2)
    with open(tmp_path / "prof" / "epoch_2.trace.json") as f:
        names = collections.Counter(e.get("name") for e in json.load(f)["traceEvents"])
    assert names["deqres.step"] == STEPS
    assert names["deqres.epoch.log"] == 1


# -- the readers, on hand-built traces: two windows, ranges inside, outside
# and across an edge (us) ------------------------------------------------------

WINDOWS = [(0.0, 1000.0), (2000.0, 3000.0)]
TRAIN = {"kind": "train", "batch": BATCH, "calls": 4}
SERVE = {"kind": "serve", "batch": 1, "calls": 3}


def ranges(name, *spans):
    return [(name, float(s), float(e)) for s, e in spans]


HOST_OPS = (
    ranges("deqres.step", (10, 30), (40, 70), (2010, 2050), (1100, 1900), (990, 1010))
    + ranges("deqres.feed.wait", (5, 10), (2000, 2010), (1500, 1600))
    + ranges("deqres.epoch.begin", (0, 5), (2000, 2002), (1200, 1300))
    + ranges("deqres.epoch.log", (900, 1000), (2900, 3000), (1300, 1500))
    + ranges("deqres.replay", (12, 28), (42, 68), (2012, 2048), (2060, 2070), (1110, 1120))
    + ranges("deqres.capture", (2051, 2059), (1130, 1140))
    + ranges("deqres.predict.h2d", (100, 110), (200, 230), (2100, 2120), (1700, 1800))
    + ranges("deqres.predict.d2h", (120, 160), (240, 250), (2130, 2150), (1800, 1900))
    + ranges("aten::mm", (50, 60))
    # the host waiting for the device: a full launch queue inside a step, the
    # rows' copy back inside an epoch's log; an issued copy inside a step
    # is the step's own work
    + ranges("Command Buffer Full", (45, 65))
    + ranges("cudaMemcpyAsync", (950, 990), (2020, 2030))
)
ONLY_OTHERS = (ranges("aten::mm", (50, 60)) + ranges("deqres.predict.h2d", (1001, 1002))
               + ranges("Command Buffer Full", (45, 65)))

READINGS = [
    ("step_host_ms.train", TRAIN, 0.020),          # median of 20, 30 - 20, 40 us
    ("feed_wait_ms.train", TRAIN, 15 / 4 / 1e3),   # 5 + 10 us over 4 steps
    ("epoch_host_ms.train", TRAIN, 167 / 2 / 1e3),  # 5 + (100 - 40) + 2 + 100 us, 2 epochs
    ("graph_replays_per_step.train", TRAIN, 1.0),  # 4 replays, 4 steps
    ("graph_captures.train", TRAIN, 1.0),
    ("request_h2d_ms.serve", SERVE, 0.020),        # median of 10, 30, 20 us
    ("request_d2h_ms.serve", SERVE, 0.020),        # median of 40, 10, 20 us
]


def reading(name, info, host_ops):
    trace = Trace([], {"window": WINDOWS}, host_ops, "window")
    return Benchmark(ROOT).reader(name).read(MetricContext(trace, {}, {}, info))


@pytest.mark.parametrize("name, info, want", READINGS, ids=[r[0] for r in READINGS])
def test_a_reader_counts_only_ranges_inside_the_window(name, info, want):
    assert reading(name, info, HOST_OPS) == pytest.approx(want, rel=1e-12)
    other = SERVE if info is TRAIN else TRAIN
    assert reading(name, other, HOST_OPS) is None


@pytest.mark.parametrize("name, info, want", READINGS, ids=[r[0] for r in READINGS])
def test_a_reader_of_an_absent_span_gives_none(name, info, want):
    assert reading(name, info, ONLY_OTHERS) is None


def test_a_replayed_window_without_a_capture_reads_zero_captures():
    host_ops = [op for op in HOST_OPS if op[0] != "deqres.capture"]
    assert reading("graph_captures.train", TRAIN, host_ops) == 0.0


def test_every_reader_has_its_entry():
    """The five training readers in BENCHMARK.json, the two serving ones in
    their pending fragment, each where its spans are recorded."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    pending = json.loads((ROOT / "perfbench" / "pending" / "serve-request-spans.json").read_text())
    entries = {m["name"]: m for m in spec["per_layer"] + pending["per_layer"]}
    for name, info, _ in READINGS:
        assert entries[name]["source"] == "device_trace"
        assert entries[name]["moves"] == ("train_images_per_s" if info is TRAIN
                                          else "request_p50_ms")
    assert entries["feed_wait_ms.train"]["workloads"] == ["sb-antisym-64x16.train-stream"]
    assert list(pending) == ["per_layer"]


@pytest.mark.cuda
def test_a_replayed_step_records_its_replays_and_captures():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CPU runs the step eagerly, with no graph")
    model = tiny_model("cuda")
    multi = make_multi_step(model, make_adam(model.parameters()))
    rng = np.random.default_rng(0)

    def steps(k, batch):
        x = torch.from_numpy(rng.uniform(0, 255, (k, batch, 32, 32, 3)).astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 10, (k, batch)))
        multi(x.cuda(), y.cuda(), [1e-3] * k)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps(3, 4)  # the first call captures at batch 4
        steps(2, 2)  # a new shape: one more capture
        steps(2, 4)
        torch.cuda.synchronize()
    assert span_counts(prof) == {"deqres.step": 7, "deqres.replay": 7, "deqres.capture": 2}
