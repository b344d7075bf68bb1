"""The checkout's root on the path, so that the benchmark, the port and
`chip_smoke` import from any working directory."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import time  # noqa: E402

import pytest  # noqa: E402

# Each cell at a size the CPU runs in seconds: its configuration's model
# shrunk in depth, width and data, every other key as the cell has it.
TINY_MODEL = {
    "single_block": dict(blocks_per_stage=[4], filters_per_block=[4], h=0.5),
    "bottleneck": dict(image_shape=[32, 32, 3], num_classes=5, blocks_per_stage=[2, 1, 2, 1],
                       filters_per_block=[[4, None, 8], [4, None, 8], [8, None, 16],
                                          [8, None, 16]]),
}

# A single-block model of three stages (He et al.'s CIFAR layout, cut): an
# identity stack, then two stages that each open with a strided conv block.
TINY_MULTI_STAGE = dict(image_shape=[8, 8, 3], num_stages=4, blocks_per_stage=[2, 2, 2],
                        filters_per_block=[4, 8, 16], strides=[[1, 1], [2, 2], [2, 2]], h=0.5)


def train_cases(cells):
    """pytest params (cell, model update) of each training cell, and of the
    multi-stage model under the first cell's traffic and limits."""
    return [pytest.param(name, None, id=name) for name in cells] + [
        pytest.param(cells[0], TINY_MULTI_STAGE, id="multi-stage")]


def tiny_cell(bench, name, model=None):
    """(cell, config, traffic) of ``name`` at the CPU's size, its model
    further updated by ``model``."""
    cell = bench.cell(name)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    config["model"].update(TINY_MODEL[config["family"]])
    config["model"].update(model or {})
    config["train_images"] = 32
    config["train"]["batch_size"] = 8
    config["data"]["serve_pool"] = 40
    if traffic["kind"] == "serve":
        traffic.update(rate_per_s=400, trace_requests=30, warmup_requests=2)
    return cell, config, traffic


def full_bench():
    """The benchmark with the cells kept under ``perfbench/pending/`` (a
    fragment of ``BENCHMARK.json`` each, defined and tested but not yet
    in ``BENCHMARK.json``) merged in."""
    import json

    from perfbench.registry import Benchmark

    bench = Benchmark(Path(ROOT))
    for fragment in sorted((Path(ROOT) / "perfbench" / "pending").glob("*.json")):
        for key, entries in json.loads(fragment.read_text()).items():
            if key in bench.spec:
                bench.spec[key] = bench.spec[key] + entries
    return bench


@pytest.fixture
def bench():
    return full_bench()


@pytest.fixture
def run_tiny(bench):
    """``run_tiny(cell name, trace=False, model=None) -> result line``, on
    the CPU with the cell's own limits, the model updated by ``model``; the
    harness's look for a card is skipped."""
    from perfbench import run

    def go(name, trace=False, seed=4_000_000_017, seconds=0.2, model=None):
        cell, config, traffic = tiny_cell(bench, name, model)
        return run.execute(bench, cell, seed, seconds, trace, "cpu", time.perf_counter(),
                           config=config, traffic=traffic)

    return go
