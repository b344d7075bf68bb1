"""The readings that a cell's correctness limits are set from.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 2] [--out FILE]

For each of ``--seeds``: the program's sound run against the reference
(the numbers of `perfbench.checks`), from the cell's own runner at the
cell's own sizes: a training cell's first three steps with no window, a
serving cell's answers over a short window of ``--seconds`` at the cell's
load.  For each of ``--control-seeds``: the control, the reference in the
next precision below the configuration's (TF32 for fp32 with TF32 off)
put in the program's place, against the reference; and for a training
cell the planted fault "half of each batch left out, the mean taken over
the rest", in the reference put in the program's place.  A state left
unchanged reads 1 on the parameters' change by its measure and needs no
run.  `limits` proposes each number's limit from the readings.

Runs on the card; not part of a benchmark run.  Prints one JSON line a
reading and, last, the proposal.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from perfbench import checks, program, reference
from perfbench import weights as seeded
from perfbench.registry import Benchmark
from perfbench.run import CACHE, ROOT, finite, pin_caches

# Where the limit sits between the lower reading L and the upper U, in
# log space: L^(1 - ABOVE) * U^ABOVE, so more room above L than below U.
ABOVE = 2 / 3


def limits(sound: dict, control: dict, faults: dict) -> dict:
    """Per number: the lower reading (the largest of the sound runs), the
    upper (the least of the control's readings where it is 3x the lower or
    more, of a fault's where it is 10x or more, and, on the parameters'
    change, the 1 of a state left unchanged) and the limit between them;
    None where no upper reading holds."""
    out = {}
    for name in sound[0]:
        lower = max(r[name] for r in sound)
        uppers = []
        ctl = min((r[name] for r in control), default=math.nan)
        if ctl >= 3 * lower:
            uppers.append(ctl)
        for readings in faults.values():
            f = min((r[name] for r in readings), default=math.nan)
            if f >= 10 * lower:
                uppers.append(f)
        if name == "change" and 1.0 >= 3 * lower:
            uppers.append(1.0)
        upper = min(uppers) if uppers else None
        limit = None
        if upper is not None and lower > 0:
            limit = float(f"{lower ** (1 - ABOVE) * upper ** ABOVE:.2g}")
        out[name] = {"lower": lower, "upper": upper, "limit": limit,
                     "control_min": ctl,
                     **{f"{k}_min": min((r[name] for r in v), default=math.nan)
                        for k, v in faults.items()}}
    return out


def train_readings(kind, config, traffic, seed, device, controls: bool) -> dict:
    out = kind.run(config=config, traffic=traffic, seed=seed, seconds=0, trace=False,
                   device=device, start=time.perf_counter())
    got, want = out["readings"]["program"], out["readings"]["reference"]
    row = {"seed": seed, "sound": out["numbers"],
           "worst": {k: checks.worst_leaves(got[k], want[k], checks.moving(want) if k == "change"
                                            else None) for k in ("grad", "change", "bn") if k in want}}
    if controls:
        model_d, recipe = config["model"], config["train"]
        images, labels = seeded.images_and_labels(
            config["train_images"], model_d["image_shape"], model_d["num_classes"], seed,
            "train", device)
        model, shapes = program.build(config, seed, device)
        state = reference.initial_state({n: tuple(b.shape) for n, b in model.named_buffers()},
                                        device)
        del model
        feed = kind.batches(traffic, config, images, labels, seed)

        def replay(**fault):
            return reference.first_steps(
                config["family"], model_d, program.initial_weights(config, shapes, seed, device),
                state, feed, recipe["learning_rate"], recipe["adam_epsilon"], **fault)

        row["control"] = checks.training_numbers(replay(tf32=True), want)
        row["half_batch"] = checks.training_numbers(replay(half_batch=True), want)
    return row


def serve_readings(kind, config, traffic, seed, seconds, device, controls: bool) -> dict:
    out = kind.run(config=config, traffic=traffic, seed=seed, seconds=seconds, trace=False,
                   device=device, start=time.perf_counter())
    row = {"seed": seed, "sound": out["numbers"],
           "p50_ms": out["metrics"]["request_p50_ms"], "p95_ms": out["metrics"]["request_p95_ms"]}
    if controls:
        model_d, batch = config["model"], traffic["batch"]
        pool, _ = seeded.images_and_labels(config["data"]["serve_pool"], model_d["image_shape"],
                                           model_d["num_classes"], seed, "serve", device)
        count = max(1, round(traffic["rate_per_s"] * seconds))
        chosen = torch.from_numpy(kind.picks(count * batch, len(pool), seed)).to(device)
        images = pool.index_select(0, chosen).to(torch.float32)
        model, shapes = program.build(config, seed, device)
        state = reference.initial_state({n: tuple(b.shape) for n, b in model.named_buffers()},
                                        device)
        del model
        weights = program.initial_weights(config, shapes, seed, device)
        probs = [reference.probabilities(config["family"], model_d, weights, state, images,
                                         tf32=tf32) for tf32 in (False, True)]
        row["control"] = {"prob_gap": float((probs[1] - probs[0]).abs().max())}
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    pin_caches()
    device = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cuda":
        from differential_equations_resnet_tpu_torch.utils.compile_cache import (
            enable_compile_cache,
        )

        enable_compile_cache(str(CACHE / "kernels"))
    bench = Benchmark(ROOT)
    cell = bench.cell(args.workload)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    kind = bench.kind(traffic["kind"])
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")] + sorted(controls)
    rows = []
    sink = open(args.out, "a") if args.out else None
    for seed in dict.fromkeys(seeds):
        if traffic["kind"] == "train":
            row = train_readings(kind, config, traffic, seed, device, seed in controls)
        else:
            row = serve_readings(kind, config, traffic, seed, args.seconds, device,
                                 seed in controls)
        rows.append(row)
        line = json.dumps(finite({"workload": args.workload, **row}))
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    sound = [r["sound"] for r in rows]
    control = [r["control"] for r in rows if "control" in r]
    faults = {"half_batch": [r["half_batch"] for r in rows if "half_batch" in r]}
    faults = {k: v for k, v in faults.items() if v}
    proposal = json.dumps(finite({"workload": args.workload, "device": program.device_kind(device),
                                  "limits": limits(sound, control, faults)}))
    print(proposal, flush=True)
    if sink:
        sink.write(proposal + "\n")
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
