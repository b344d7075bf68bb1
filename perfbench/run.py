"""One run of one cell of the benchmark.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number that decides ``correct``
beside its limit, which also end standard error.  Exits non-zero, printing
no result, where CUDA or the cell's cards are missing, the program cannot
be imported, or JAX or the JAX package was loaded.
"""

import time

PROCESS_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "perfbench" / ".cache"
# Top-level module names that must not be loaded in a run, compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "differential_equations_resnet_tpu")


def pin_caches() -> None:
    """Every build and kernel cache in a fixed directory of the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded() -> list:
    """The forbidden top-level names among the loaded modules."""
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def finite(value):
    """JSON-safe: a non-finite float as its name."""
    if isinstance(value, float) and not math.isfinite(value):
        return repr(value)
    if isinstance(value, dict):
        return {k: finite(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [finite(v) for v in value]
    return value


def execute(bench, cell: dict, seed: int, seconds: float, trace: bool, device: str,
            start: float, config=None, traffic=None, limits=None) -> dict:
    """Run ``cell`` and return its result line as a dict.  ``config``,
    ``traffic`` and ``limits`` default to the cell's files."""
    from perfbench import checks
    from perfbench.program import MetricContext
    from perfbench.trace import device_block

    config = config if config is not None else bench.config(cell["config"])
    traffic = traffic if traffic is not None else bench.traffic(cell["traffic"])
    limits = limits if limits is not None else bench.limits(cell["name"])
    kind = bench.kind(traffic["kind"])
    out = kind.run(config=config, traffic=traffic, seed=seed, seconds=seconds, trace=trace,
                   device=device, start=start)
    if trace:
        ctx = MetricContext(out["trace"], config, traffic, out["info"])
        metrics = {}
        for metric in bench.per_layer(cell["name"]):
            value = bench.reader(metric["name"]).read(ctx)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    else:
        wanted = {m["name"]: m["unit"] for m in bench.end_to_end(cell["name"])}
        metrics = {name: {"value": out["metrics"][name], "unit": unit}
                   for name, unit in wanted.items()}
    correct = checks.judge(out["numbers"], limits) and out["failed"] == 0
    result = {
        "correct": bool(correct),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": out["device_kind"], "count": 1,
                   "memory_peak_bytes": out["memory_peak_bytes"],
                   **device_block(out.get("trace"))},
    }
    if trace and out.get("trace") is not None:
        result["breakdown"] = {"device_ops": out["trace"].top_device_ops(),
                               "idle_gaps": out["trace"].idle_gaps()}
    result["checks"] = checks.report(out["numbers"], limits)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    pin_caches()
    import json

    import torch

    from perfbench.registry import Benchmark

    bench = Benchmark(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    from differential_equations_resnet_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache(str(CACHE / "kernels"))
    result = execute(bench, cell, args.seed % 2 ** 63, args.seconds, bool(args.trace), "cuda",
                     PROCESS_START)
    leaked = forbidden_loaded()
    if leaked:
        print(f"perfbench: the run loaded {', '.join(leaked)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
