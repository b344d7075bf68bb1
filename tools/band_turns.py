#!/usr/bin/env python3
"""Time this checkout's band B1/B2 against another checkout's, in turns.

Unpack the commit to compare with into a directory of this checkout that
git ignores, for example ``git archive <commit> | tar -x -C build/parent``,
then on a CUDA machine, from the root of this checkout:

    python3 tools/band_turns.py --parent build/parent --out build/band_turns.json

1. kernels, in one process: the other checkout's B1 and B2 (its
   ``fused_integrator`` module with its libraries built from its sources)
   and this one's, in the order other, this, this, other (``--rounds``
   times over), at 32x32x16 L = 64 batch 32 and batch 1, 32x32x8 regular
   kernels batch 32 and 28x28x16 L = 8 batch 32; then B2 alone at shapes
   where the two checkouts' gates may differ: shapes that the band B2
   takes and the wide B2 took before its reverse sweep's layout changed,
   and shapes that it now runs in fewer bands.  CUDA events around
   back-to-back calls (25, or 200 for the short L = 8 call), the median of
   5 windows;
2. the 64L x 16F antisymmetric train step at batch 32 (three windows of 200
   replayed steps) and a 1562-step device-resident epoch (three, the
   first a warm-up), each checkout in a process of its own, in the order
   other, this, this, other.

Every figure is one turn's; each line printed and the JSON file name the
card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CASES = (  # label, batch, H, W, C, L, unstructured kernels, kernels timed, calls a window
    ("32x32x16 B=32 L=64", 32, 32, 32, 16, 64, False, ("B1", "B2"), 25),
    ("32x32x16 B=1 L=64", 1, 32, 32, 16, 64, False, ("B1", "B2"), 25),
    ("32x32x8 regular B=32 L=64", 32, 32, 32, 8, 64, True, ("B1", "B2"), 25),
    ("28x28x16 B=32 L=8", 32, 28, 28, 16, 8, False, ("B1", "B2"), 200),
    # B2 on the band variant here, on the wide one before.
    ("81x45x32 B=32 L=16", 32, 81, 45, 32, 16, False, ("B2",), 25),
    ("129x23x40 B=32 L=16", 32, 129, 23, 40, 16, False, ("B2",), 25),
    ("3x85x36 B=32 L=16", 32, 3, 85, 36, 16, False, ("B2",), 25),
    ("1x88x44 B=32 L=16", 32, 1, 88, 44, 16, False, ("B2",), 25),
    # B2 in one band here, in two before (the batch fills the card).
    ("64x40x4 B=256 L=16", 256, 64, 40, 4, 16, False, ("B2",), 25),
    ("2x825x1 B=256 L=16", 256, 2, 825, 1, 16, False, ("B2",), 25),
)


def other_kernels(checkout: Path):
    """The other checkout's fused_integrator module, without its
    torch.library op (this process registers this checkout's), its kernel
    libraries built from its own sources under their own names."""
    from differential_equations_resnet_tpu_torch.ops.kernels import _build

    package = checkout / "differential_equations_resnet_tpu_torch"
    src = (package / "ops" / "kernels" / "fused_integrator.py").read_text()
    src = (src[:src.index("_LIBRARY = torch.library.Library")] + "fused_euler_fwd_op = None\n\n\n"
           + src[src.index("def _forward("):])
    module = types.ModuleType("other_fused_integrator")
    exec(compile(src, str(package / "fused_integrator.py"), "exec"), module.__dict__)
    alias = {}
    for name in ("fused_euler_fwd", "fused_euler_bwd"):
        alias[name] = "other_" + name
        _build.SOURCES[alias[name]] = _build.Source(package / "csrc" / f"{name}.cu", "nvcc",
                                                    _build.NVCC_FLAGS, "kernels", ("*.cuh",))
        module._SIGNATURES[alias[name]] = module._SIGNATURES[name]
    library = module._library
    module._library = lambda name: library(alias.get(name, name))
    return module, list(alias.values())


def kernel_turns(checkout: Path, smi: str, rounds: int) -> dict:
    import torch

    import chip_smoke as cs
    from differential_equations_resnet_tpu_torch.ops.kernels import _build
    from differential_equations_resnet_tpu_torch.ops.kernels import fused_integrator as fi

    other, names = other_kernels(checkout)
    _build.build(["fused_euler_fwd", "fused_euler_bwd"] + names)
    out = {}
    for label, batch, height, width, channels, layers, unstructured, kernels, calls in CASES:
        x, k, bias, g = cs.make_case(batch, height, width, channels, layers, 5,
                                     unstructured=unstructured)
        h = 1.0 / layers
        runs = {
            "B1": {"other": lambda: other._launch(x, k, bias, h, torch.float32),
                   "this": lambda: fi._launch(x, k, bias, h, torch.float32)},
            "B2": {"other": lambda: other._launch_bwd(x, k, bias, g, h, torch.float32),
                   "this": lambda: fi._launch_bwd(x, k, bias, g, h, torch.float32)},
        }
        for kernel in kernels:
            fns, times = runs[kernel], {"other": [], "this": []}
            for who in ("other", "this", "this", "other") * rounds:
                times[who].append(round(cs.cuda_time_ms(fns[who], runs=calls), 4))
            bound = cs.kernel_bounds(batch, height, width, channels, layers, kernel == "B2")
            key = f"{kernel} {label}"
            out[key] = {"ms": times, "bound_ms": bound["bound_ms"], "device": smi,
                        "variant": fi.kernel_variant(x.shape, kernel == "B2"),
                        "other_variant": other.kernel_variant(x.shape, kernel == "B2"),
                        "bands": fi.kernel_bands(x.shape, kernel == "B2"),
                        "other_bands": other.kernel_bands(x.shape, kernel == "B2")}
            print(json.dumps({key: out[key]}), flush=True)
    return out


STEP_SCRIPT = r"""
import json, statistics, sys, time
import numpy as np
import torch
from differential_equations_resnet_tpu_torch.data import synthetic_cifar10
from differential_equations_resnet_tpu_torch.models import (
    build_single_block_resnet, cifar10_single_block_config)
from differential_equations_resnet_tpu_torch.train import Training, make_adam, make_multi_step

def model(seed):
    return build_single_block_resnet(cifar10_single_block_config(num_layers=64, num_filters=16),
                                     generator=torch.Generator().manual_seed(seed), device="cuda")

out, net = {}, model(0)
rng = np.random.default_rng(3)
images = torch.from_numpy(rng.uniform(0, 255, (32, 32, 32, 3)).astype(np.float32)).cuda()
labels = torch.from_numpy(rng.integers(0, 10, 32)).cuda()
multi = make_multi_step(net, make_adam(net.parameters()))
run = lambda n: multi(images.expand(n, *images.shape), labels.expand(n, *labels.shape), [1e-3] * n)
run(3)
windows = []
for _ in range(3):
    torch.cuda.synchronize(); t0 = time.perf_counter(); run(200); torch.cuda.synchronize()
    windows.append((time.perf_counter() - t0) / 200 * 1e3)
out["replayed_step_ms"] = windows
train_x, train_y, val_x, val_y, _ = synthetic_cifar10(50000, 10000, seed=0)
trainer = Training(model(1), train_features=train_x, train_labels=train_y, val_features=val_x,
                   val_labels=val_y, batch_size=32, record_summaries=False)
epochs = []
for _ in range(3):
    torch.cuda.synchronize(); t0 = time.perf_counter()
    trainer.train(epochs=1, steps_per_epoch=1562, learning_rate_schedule=lambda s: 1e-3,
                  eval_frequency=None, device_data=True, verbose=False)
    torch.cuda.synchronize()
    epochs.append(time.perf_counter() - t0)
out["device_epoch_s"] = epochs
trainer.close()
print("STEP " + json.dumps(out), flush=True)
"""


def step_turns(checkout: Path, smi: str) -> dict:
    """The train step and the epoch, each checkout in its own process."""
    out = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        tree = checkout if who == "other" else ROOT
        env = dict(os.environ, PYTHONPATH=str(tree))
        result = subprocess.run([sys.executable, "-c", STEP_SCRIPT], cwd=tree, env=env,
                                capture_output=True, text=True, timeout=900)
        if result.returncode != 0:
            raise RuntimeError(f"the step run of {tree} failed:\n{result.stderr[-4000:]}")
        line = [l for l in result.stdout.splitlines() if l.startswith("STEP ")][-1]
        out[who].append(json.loads(line[5:]))
        print(json.dumps({"train step and epoch": who, **out[who][-1], "device": smi}), flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=ROOT / "build" / "parent",
                        help="root of the other checkout (default build/parent)")
    parser.add_argument("--out", type=Path, default=None, help="JSON file for the results")
    parser.add_argument("--kernels-only", action="store_true", help="skip the train step and epoch")
    parser.add_argument("--rounds", type=int, default=1,
                        help="times over the kernels' order other, this, this, other")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("band_turns: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    results = {"device": smi, "kernels": kernel_turns(args.parent.resolve(), smi, args.rounds)}
    if not args.kernels_only:
        results["steps"] = step_turns(args.parent.resolve(), smi)
    results["seconds"] = time.perf_counter() - t0
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    summary = {k: {w: [min(v["ms"][w]), max(v["ms"][w])] for w in ("other", "this")}
               for k, v in results["kernels"].items()}
    print(json.dumps({"summary_ms": summary, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
