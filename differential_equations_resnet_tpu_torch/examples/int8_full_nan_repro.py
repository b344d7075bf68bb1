"""One int8 train-step configuration a run, with fixed seeds and a
clean/NaN verdict: the probe of the int8 'full' backward without remat at
a large int8 residual stack.

Port of the JAX package's ``examples/int8_full_nan_repro.py``, which pins a
defect of the TPU toolchain: a finite first step and NaN from step 2 once
the saved int8 residuals grow past a fraction of the TPU's memory.  The
port asks the same question of the card: it trains `imagenet32_config`
(bf16 compute, 1000 classes) with ``int8_forward`` for ``--steps`` steps
of one seeded batch and reports each loss, the verdict, the steps a second
after the first, and the bytes of the int8 residuals the backward keeps
(the int8 tensors and bool masks saved by the forward, counted by a
saved-tensors hook during the first step).  It sets no memory-fraction
threshold: the TPU's does not carry over.  The JSON pins the torch and
CUDA versions and the card it ran on.

    python -m differential_equations_resnet_tpu_torch.examples.int8_full_nan_repro
    python -m differential_equations_resnet_tpu_torch.examples.int8_full_nan_repro --remat
"""

import argparse
import json
import time

import numpy as np
import torch


def _residual_counter():
    """(saved-tensors hooks, a one-item list holding the int8 and bool
    bytes they saw)."""
    seen = [0]

    def pack(t):
        if t.dtype in (torch.int8, torch.bool):
            seen[0] += t.numel() * t.element_size()
        return t

    return torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), seen


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--num-layers", type=int, default=192)
    parser.add_argument("--num-filters", type=int, default=128)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--remat", action="store_true", help="the rematerialized twin")
    parser.add_argument("--int8-backward", default="full", choices=["dgrad", "wgrad", "full"],
                        help="backward mode to probe")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    from differential_equations_resnet_tpu_torch.experiments import imagenet32_config
    from differential_equations_resnet_tpu_torch.models import build_single_block_resnet
    from differential_equations_resnet_tpu_torch.train import make_adam, make_train_step

    device = torch.device(args.device)
    versions = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
    }
    config = imagenet32_config(num_layers=args.num_layers, num_filters=args.num_filters,
                               int8_forward=True, int8_backward=args.int8_backward,
                               remat=args.remat)
    model = build_single_block_resnet(config, generator=torch.Generator().manual_seed(0),
                                      device=device)
    step = make_train_step(model, make_adam(model.parameters()))
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(0, 255, (args.batch, 32, 32, 3)), dtype=torch.float32,
                        device=device)
    y = torch.as_tensor(rng.integers(0, 1000, (args.batch,)), dtype=torch.int64, device=device)

    losses, times = [], []
    hooks, residual_bytes = _residual_counter()
    for i in range(args.steps):
        t0 = time.perf_counter()
        if i == 0:
            with hooks:
                metrics, _ = step(x, y, args.lr)
        else:
            metrics, _ = step(x, y, args.lr)
        losses.append(float(metrics["loss"]))  # waits for the step
        times.append(time.perf_counter() - t0)

    finite = [bool(np.isfinite(v)) for v in losses]
    if all(finite):
        verdict = "clean"
    elif finite[0]:
        verdict = f"finite-then-NaN-from-step-{finite.index(False) + 1}"
    else:
        verdict = "NaN-from-step-1"
    later = times[1:]
    print(json.dumps({
        "config": f"{args.num_layers}Lx{args.num_filters}F_b{args.batch}"
                  f"_int8{args.int8_backward}_remat={args.remat}",
        "residual_stack_bytes": residual_bytes[0],
        "lr": args.lr,
        "losses": [round(v, 4) for v in losses],
        "verdict": verdict,
        "steps_per_s": (len(later) / sum(later)) if later else None,
        "versions": versions,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
