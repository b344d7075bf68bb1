"""The serving knee: a sweep of offered rates over one predictor.

    python3 -m perfbench.knee --workload <serving cell> --seed <n> \\
        --rates 1000,2000,... [--seconds 5]

Builds the cell's predictor once (`kinds.serve.prepare`), then offers each
rate for ``--seconds`` (open loop, the cell's Poisson schedule) and prints
one JSON line a rate: the latency's median and 95th percentile, the
completed requests a second, and the backlog's growth, the mean latency of
the window's last quarter over its first.  The knee is the highest rate at
which the backlog does not grow; a cell offers a fixed rate below it.
Runs on the card, once, when a serving cell is defined; not part of a
benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from perfbench.registry import Benchmark
from perfbench.run import CACHE, ROOT, pin_caches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)
    pin_caches()
    from differential_equations_resnet_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache(str(CACHE / "kernels"))
    bench = Benchmark(ROOT)
    cell = bench.cell(args.workload)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    serve = bench.kind("serve")
    predict, pool, *_ = serve.prepare(config, traffic, args.seed, "cuda", time.perf_counter())
    batch, classes = traffic["batch"], config["model"]["num_classes"]
    for rate in (float(r) for r in args.rates.split(",")):
        count = max(4, round(rate * args.seconds))
        due = serve.arrivals(count, rate, args.seed)
        chosen = serve.picks(count * batch, len(pool), args.seed).reshape(count, batch)
        requests = [np.ascontiguousarray(pool[c]) for c in chosen]
        torch.cuda.synchronize()
        _, latency, failed, _ = serve.play(predict, requests, due, classes, trace=False)
        quarter = count // 4
        done = due + latency
        print(json.dumps({
            "rate_per_s": rate, "requests": count, "failed": failed,
            "p50_ms": float(np.percentile(latency, 50)) * 1e3,
            "p95_ms": float(np.percentile(latency, 95)) * 1e3,
            "completed_per_s": count / float(done.max()),
            "backlog_growth": float(latency[-quarter:].mean() / latency[:quarter].mean()),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
