"""Large-batch device-resident training A/B: the headline 64L x 16F
antisymmetric model at several batch sizes for equal epochs on the same
data, learning rates scaled linearly with the batch (Goyal et al.), every
epoch device-resident (the uint8 dataset on the card, each step a CUDA-graph
replay), with convergence (final train loss, a full-pass evaluation) beside
throughput (img/s).

Port of the JAX package's ``examples/large_batch_training.py``, with its
bf16 and int8 arms.  Its layout gate and measured figures were the TPU's
and are not carried over: here every arm runs on the route the port picks
from the model's shapes (the fused kernels B1/B2 for an fp32 Euler stack).
The kernels' builds go to the compile cache (`utils.compile_cache`).
Prints one JSON object: {"runs": [...], "convergence_delta_vs_base": [...]}.

    python -m differential_equations_resnet_tpu_torch.examples.large_batch_training --epochs 3
"""

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--train-size", type=int, default=20000)
    parser.add_argument("--val-size", type=int, default=2000)
    parser.add_argument("--batches", default="32,128", help="comma-separated batch sizes to A/B")
    parser.add_argument("--base-lr", type=float, default=1e-3,
                        help="learning rate at batch 32 (scaled linearly)")
    parser.add_argument("--warmup-steps", type=int, default=0,
                        help="linear lr warmup steps (0 = off)")
    parser.add_argument("--num-layers", type=int, default=64)
    parser.add_argument("--num-filters", type=int, default=16)
    parser.add_argument("--cifar10-dir", default=None)
    parser.add_argument("--accum-steps", type=int, default=1,
                        help="gradient accumulation: each effective batch in this many "
                             "sequential microbatches (the same numerics)")
    parser.add_argument("--compare-bf16", action="store_true",
                        help="run each batch size in fp32 and in bfloat16 compute")
    parser.add_argument("--dtypes", default=None,
                        help="comma-separated compute dtypes for the arms (e.g. 'bfloat16'); "
                             "overrides --compare-bf16")
    parser.add_argument("--compare-int8", action="store_true",
                        help="add int8-forward arms (dynamic-w8a8 forward convs)")
    parser.add_argument("--int8-backward", default="ste",
                        help="backward mode(s) of the --compare-int8 arms, comma-separated "
                             "from {ste,dgrad,wgrad,full}: one int8 arm a mode")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    from differential_equations_resnet_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from differential_equations_resnet_tpu_torch.data.cifar10 import (
        build_cifar10_dataset,
        find_cifar10_directory,
        synthetic_cifar10,
    )
    from differential_equations_resnet_tpu_torch.models import (
        build_single_block_resnet,
        cifar10_single_block_config,
    )
    from differential_equations_resnet_tpu_torch.models.single_block_resnet import (
        DTYPES,
        dtype_name,
    )
    from differential_equations_resnet_tpu_torch.train import Training, linear_warmup_schedule
    from differential_equations_resnet_tpu_torch.utils.flops import (
        PEAK_FLOPS,
        mfu,
        single_block_train_flops,
    )

    cifar_dir = args.cifar10_dir or find_cifar10_directory()
    if cifar_dir:
        print(f"# loading CIFAR-10 from {cifar_dir}", file=sys.stderr)
        train_x, train_y, test_x, test_y, _ = build_cifar10_dataset(cifar_dir)
        train_x, train_y = train_x[:args.train_size], train_y[:args.train_size]
        test_x, test_y = test_x[:args.val_size], test_y[:args.val_size]
    else:
        print("# synthetic data (CIFAR-10 not on disk)", file=sys.stderr)
        train_x, train_y, test_x, test_y, _ = synthetic_cifar10(args.train_size, args.val_size,
                                                                seed=0)

    if args.dtypes:
        dtypes = tuple(DTYPES[d] for d in args.dtypes.split(","))
    elif args.compare_bf16:
        dtypes = (torch.float32, torch.bfloat16)
    else:
        dtypes = (torch.float32,)
    int8_modes = args.int8_backward.split(",")
    for m in int8_modes:
        if m not in ("ste", "dgrad", "wgrad", "full"):
            parser.error(f"--int8-backward: unknown mode {m!r}")
    arms = [(int(b), dtype, int8)
            for b in args.batches.split(",")
            for dtype in dtypes
            for int8 in ((None, *int8_modes) if args.compare_int8 else (None,))]
    runs = []
    for batch, compute_dtype, int8_mode in arms:
        int8_forward = int8_mode is not None
        lr = args.base_lr * batch / 32.0
        config = cifar10_single_block_config(
            num_layers=args.num_layers, num_filters=args.num_filters,
            compute_dtype=compute_dtype, int8_forward=int8_forward,
            int8_backward=int8_mode if int8_forward else "ste",
        )
        model = build_single_block_resnet(config, generator=torch.Generator().manual_seed(0),
                                          device=args.device)
        trainer = Training(model, train_features=train_x, train_labels=train_y,
                           val_features=test_x, val_labels=test_y, batch_size=batch,
                           record_summaries=False, seed=0, data_seed=0,
                           accum_steps=args.accum_steps)
        steps_per_epoch = len(train_x) // batch
        t0 = time.time()
        history = trainer.train(epochs=args.epochs, steps_per_epoch=steps_per_epoch,
                                learning_rate_schedule=linear_warmup_schedule(
                                    lr, args.warmup_steps),
                                eval_frequency=args.epochs,  # one eval, at the end
                                device_data=True, verbose=True)
        wall = time.time() - t0
        steps = args.epochs * steps_per_epoch
        flops = single_block_train_flops(config, batch)
        runs.append({
            "batch": batch,
            "accum_steps": args.accum_steps,
            "dtype": dtype_name(compute_dtype),
            "int8_forward": int8_forward,
            "int8_backward": int8_mode,
            "lr": lr,
            "steps": steps,
            "final_train_loss": history["train"][-1]["mean_loss"],
            "final_train_acc": history["train"][-1]["accuracy"],
            "eval_loss": history["eval"][-1]["mean_loss"],
            "eval_acc": history["eval"][-1]["accuracy"],
            # Wall time includes the graph captures and the kernels' builds.
            "wall_s": round(wall, 1),
            "img_per_sec_incl_compile": round(steps * batch / wall, 1),
            "mfu_vs_bf16_peak_incl_compile": round(
                mfu(flops, steps / wall, PEAK_FLOPS["h100_sxm_bf16"]), 4),
        })
        trainer.close()

    base = runs[0]
    out = {"runs": runs}
    if len(runs) > 1:
        out["convergence_delta_vs_base"] = [
            {
                "batch": r["batch"],
                "dtype": r["dtype"],
                "int8_forward": r["int8_forward"],
                "int8_backward": r["int8_backward"],
                "train_loss_delta": round(r["final_train_loss"] - base["final_train_loss"], 4),
                "eval_loss_delta": round(r["eval_loss"] - base["eval_loss"], 4),
                "eval_acc_delta": round(r["eval_acc"] - base["eval_acc"], 4),
            }
            for r in runs[1:]
        ]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
