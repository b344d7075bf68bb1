"""The harness on the CPU at small sizes: data-driven lookup, the seeded
schedule, the reference against the port's CPU path, and no JAX."""

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from perfbench import run
from perfbench.kinds import serve
from perfbench.registry import Benchmark

from conftest import ROOT, train_cases

TRAIN_CELLS = ["sb-antisym-64x16.train-resident", "resnet50-224.train-resident",
               "sb-antisym-64x16.train-stream"]
SERVE_CELLS = ["sb-antisym-64x16.serve-b1-poisson"]
TRAIN_CASES = train_cases(TRAIN_CELLS)


def test_files_dropped_in_are_found_by_name(tmp_path):
    home = tmp_path / "bench"
    for sub in ("configs", "traffic", "cells", "kinds", "metrics"):
        (home / sub).mkdir(parents=True)
    (home / "configs" / "m.json").write_text(json.dumps({"model": {"width": 3}}))
    (home / "traffic" / "t.json").write_text(json.dumps({"kind": "k", "rate": 5}))
    (home / "cells" / "m.t.json").write_text(json.dumps({"limits": {"gap": 0.5}}))
    (home / "kinds" / "k.py").write_text("def run(**kw):\n    return 'ran'\n")
    (home / "metrics" / "x.k.py").write_text("def read(ctx):\n    return 42.0\n")
    spec = {"configs": [{"name": "m", "file": "bench/configs/m.json"}],
            "workloads": [{"name": "m.t", "config": "m", "traffic": "t", "chips": 1}],
            "end_to_end": [{"name": "setup_s", "unit": "s"},
                           {"name": "rate", "unit": "1/s", "workloads": ["m.t"]},
                           {"name": "other", "unit": "1/s", "workloads": ["z"]}],
            "per_layer": [{"name": "x.k", "unit": "%", "moves": "rate"},
                          {"name": "y.k", "unit": "%", "moves": "other"}]}
    bench = Benchmark(tmp_path, home, spec)
    cell = bench.cell("m.t")
    assert bench.config(cell["config"]) == {"model": {"width": 3}}
    assert bench.traffic(cell["traffic"])["rate"] == 5
    assert bench.limits("m.t") == {"gap": 0.5}
    assert bench.kind("k").run() == "ran"
    assert [m["name"] for m in bench.end_to_end("m.t")] == ["setup_s", "rate"]
    assert [m["name"] for m in bench.per_layer("m.t")] == ["x.k"]
    assert bench.reader("x.k").read(None) == 42.0
    with pytest.raises(KeyError):
        bench.cell("nope")


def test_every_cell_has_its_files(bench):
    for cell in bench.spec["workloads"]:
        bench.config(cell["config"])
        bench.kind(bench.traffic(cell["traffic"])["kind"])
        assert bench.limits(cell["name"])
        for metric in bench.per_layer(cell["name"]):
            assert callable(bench.reader(metric["name"]).read)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 9_876_543_210_123])
def test_poisson_schedule_repeats_and_keeps_its_gaps(seed):
    due = serve.arrivals(5000, 2000.0, seed)
    assert np.array_equal(due, serve.arrivals(5000, 2000.0, seed))
    assert np.array_equal(serve.picks(5000, 100, seed), serve.picks(5000, 100, seed))
    other = serve.arrivals(5000, 2000.0, seed + 1)
    assert not np.array_equal(due, other)
    # Every seed offers the same gaps in another order: the same window.
    assert due[-1] == pytest.approx(other[-1], rel=1e-12)
    gaps = np.diff(due, prepend=0.0)
    assert gaps.mean() == pytest.approx(1 / 2000.0, rel=0.01)
    assert np.std(gaps) == pytest.approx(1 / 2000.0, rel=0.05)  # exponential: sd = mean


@pytest.mark.parametrize("name,model", TRAIN_CASES)
def test_reference_matches_the_port_training_on_the_cpu(run_tiny, name, model):
    result = run_tiny(name, model=model)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    for check in result["checks"].values():
        assert check["value"] <= 1e-4
    assert set(result["metrics"]) == {"setup_s", "train_images_per_s"}


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_reference_matches_the_port_serving_on_the_cpu(run_tiny, name):
    result = run_tiny(name)
    assert result["correct"], result["checks"]
    assert result["checks"]["prob_gap"]["value"] <= 1e-6
    assert set(result["metrics"]) == {"setup_s", "request_p50_ms", "request_p95_ms"}


@pytest.mark.parametrize("name", TRAIN_CELLS + SERVE_CELLS)
def test_traced_run_reports_per_layer_metrics_and_a_breakdown(run_tiny, bench, name):
    result = run_tiny(name, trace=True)
    assert result["correct"]
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    allowed = {m["name"] for m in bench.per_layer(name)}
    assert set(result["metrics"]) <= allowed
    assert list(result)[-1] == "checks"


def test_a_run_loads_no_jax():
    """A whole CPU run of each kind, then the forbidden top-level names,
    compared whole: the port's own name begins with the JAX package's."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{ROOT!r}, {ROOT + '/perfbench/tests'!r}]
        from perfbench import run
        from conftest import full_bench, tiny_cell
        bench = full_bench()
        for name in {TRAIN_CELLS[:1] + SERVE_CELLS!r}:
            cell, config, traffic = tiny_cell(bench, name)
            run.execute(bench, cell, 5, 0.1, False, "cpu", time.perf_counter(),
                        config=config, traffic=traffic)
        loaded = sorted({{m.split(".")[0] for m in sys.modules}})
        print("LOADED", " ".join(loaded))
        print("FORBIDDEN", run.forbidden_loaded())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("LOADED", "FORBIDDEN")))
    assert lines["FORBIDDEN"] == "[]"
    loaded = lines["LOADED"].split()
    assert "differential_equations_resnet_tpu_torch" in loaded
    assert not set(loaded) & set(run.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "differential_equations_resnet_tpu_torchx", sys)
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_loaded() == ["jax"]
