"""Serving cells: requests under open-loop Poisson arrivals through the port's
serving export.

Set-up builds the model holding the seed's weights, exports it at the
traffic's batch (`utils.serving.export_model`: ``forward.pt2``, under
``TMPDIR``), loads the export (`load_exported`) and warms up its predictor,
whose first call at the export's batch captures the CUDA graph that every
request replays.  Requests are drawn from a pool of images made from the
seed (NumPy float32 on the host, as a caller holds them).

Arrivals: every seed offers the same ``rate_per_s * seconds`` requests with
the same inter-arrival gaps (the quantiles of the exponential
distribution at that rate), in the seed's order, and each request's image
drawn from the seed.  One loop plays both sides: it waits for a request's
due time (or not, when the previous answer came late), calls ``predict``
and takes the time its answer is back; a request's latency runs from its
due time, so the wait behind a slow answer counts.  With ``trace``, the
traffic's first ``trace_requests`` requests run under the profiler.

Once the window has closed and the predictor is freed, the reference's
probabilities of every request's image are compared with its answer.

Traffic keys: ``kind`` "serve", ``batch``, ``rate_per_s``,
``warmup_requests``, ``trace_requests``.  Configuration keys used:
``family``, ``model``, ``data`` (``serve_pool``).
"""

from __future__ import annotations

import gc
import math
import shutil
import tempfile
import time

import numpy as np
import torch

from perfbench import program, reference
from perfbench import weights as seeded
from perfbench.trace import span, traced


def arrivals(count: int, rate: float, seed: int) -> np.ndarray:
    """Due times (s, from 0) of ``count`` requests at ``rate`` a second:
    the exponential's ``count`` quantiles as gaps, in the seed's order."""
    gaps = -np.log1p(-(np.arange(count) + 0.5) / count) / rate
    rng = np.random.default_rng([int(seed) % (2 ** 63), 1])
    return np.cumsum(rng.permutation(gaps))


def picks(count: int, pool: int, seed: int) -> np.ndarray:
    """Each request's image in the pool, drawn from the seed."""
    return np.random.default_rng([int(seed) % (2 ** 63), 2]).integers(0, pool, count)


def prepare(config: dict, traffic: dict, seed: int, device: str, start: float):
    """(predict, the request pool, the weights' shapes, the running
    statistics' shapes, the export directory)."""
    from differential_equations_resnet_tpu_torch.utils.serving import export_model, load_exported

    model_d = config["model"]
    pool_u8, _ = seeded.images_and_labels(config["data"]["serve_pool"], model_d["image_shape"],
                                          model_d["num_classes"], seed, "serve", device)
    pool = pool_u8.to(torch.float32).cpu().numpy()
    del pool_u8
    program.stamp("pool", start)
    model, shapes = program.build(config, seed, device)
    program.stamp("model", start)
    state_shapes = {n: tuple(b.shape) for n, b in model.named_buffers()}
    export = tempfile.mkdtemp(prefix="perfbench-serve-")
    export_model(model, export, batch_size=traffic["batch"])
    del model
    program.stamp("export", start)
    predict, _ = load_exported(export, device=device)
    program.stamp("load", start)
    batch = traffic["batch"]
    for i in range(traffic["warmup_requests"]):
        predict(pool[i * batch:(i + 1) * batch])
    program.stamp("warm-up", start)
    return predict, pool, shapes, state_shapes, export


def play(predict, requests, due, classes: int, trace: bool):
    """Offer ``requests`` at their ``due`` times (s from now); returns
    (answers, latencies in s, failures, the trace or None)."""
    count = len(requests)
    answers = np.full((count, len(requests[0]), classes), np.nan, np.float32)
    latency = np.empty(count)
    failed = 0

    def window():
        nonlocal failed
        with span("window", trace):
            t0 = time.perf_counter() + 1e-3
            for i in range(count):
                due_i = t0 + due[i]
                while time.perf_counter() < due_i:
                    pass
                try:
                    with span("request", trace):
                        answers[i] = predict(requests[i])
                except RuntimeError:
                    failed += 1
                latency[i] = time.perf_counter() - due_i

    the_trace = traced(window, "window", ("request",)) if trace else window()
    return answers, latency, failed, the_trace


def run(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str,
        start: float) -> dict:
    model_d = config["model"]
    batch, classes = traffic["batch"], model_d["num_classes"]
    predict, pool, shapes, state_shapes, export = prepare(config, traffic, seed, device, start)
    count = traffic["trace_requests"] if trace else max(1, round(traffic["rate_per_s"] * seconds))
    due = arrivals(count, traffic["rate_per_s"], seed)
    chosen = picks(count * batch, len(pool), seed).reshape(count, batch)
    requests = [np.ascontiguousarray(pool[c]) for c in chosen]
    if device == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()  # what set-up made is not the collector's to walk during the window
    setup_s = time.perf_counter() - start
    answers, latency, failed, the_trace = play(predict, requests, due, classes, trace)
    gc.unfreeze()
    memory = program.memory_peak(device)
    kind = program.device_kind(device)

    # -- the reference, once the predictor is freed -------------------------------
    del predict
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(export, ignore_errors=True)
    want = reference.probabilities(
        config["family"], model_d, program.initial_weights(config, shapes, seed, device),
        reference.initial_state(state_shapes, device),
        torch.from_numpy(np.concatenate(requests)).to(device)).cpu().numpy()
    gap = float(np.max(np.abs(answers.reshape(-1, classes) - want)))
    return {
        "metrics": {"setup_s": setup_s,
                    "request_p50_ms": float(np.percentile(latency, 50)) * 1e3,
                    "request_p95_ms": float(np.percentile(latency, 95)) * 1e3},
        "attempted": count, "failed": failed,
        "numbers": {"prob_gap": gap if math.isfinite(gap) else math.inf},
        "trace": the_trace,
        "info": {"kind": "serve", "batch": batch, "calls": count},
        "memory_peak_bytes": memory, "device_kind": kind,
    }
