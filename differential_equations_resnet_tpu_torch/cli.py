"""Command-line interface of the port.

Port of `differential_equations_resnet_tpu/cli.py` for the subcommands this
package serves, with the same flags and defaults:

    train            headline CIFAR-10 single-block runs (v7 notebook cells 1-8)
    evaluate         restore a checkpoint and evaluate
    predict          batch inference from a .npy array
    analyze          TrainingHistory gradient-flow diagnostics (v7 cell 27)

    python -m differential_equations_resnet_tpu_torch.cli train --num-layers 64 --epochs 1

``--device {cuda,cpu}`` (default cuda) picks where the model runs, as
``JAX_PLATFORMS`` does for the JAX package.  A model flag the port cannot
run yet (``--model resnet50``, ``--bf16``, ``--int8-forward``,
``--integrator rk4``, ``--kernel-type regular``, ...) raises
`NotImplementedError` when the model is built.  ``predict`` takes only a
.npy array: image directories need the host preprocessors and records
(ROADMAP A8).  The other subcommands of the JAX package are not registered
yet (ROADMAP A16).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--model",
        choices=["single_block", "resnet50", "resnet101", "resnet152"],
        default="single_block",
        help="single-block ODE-ResNet; the bottleneck presets wait for ROADMAP A12",
    )
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--resnet-version", type=float, default=1, choices=[1, 1.5],
                   help="bottleneck striding variant")
    p.add_argument("--num-layers", type=int, default=64)
    p.add_argument("--num-filters", type=int, default=16)
    p.add_argument("--final-time", type=float, default=8.0)
    p.add_argument("--gamma", type=float, default=0.0)
    p.add_argument("--kernel-type", choices=["antisymmetric", "regular", "centrosymmetric"],
                   default="antisymmetric",
                   help="the port runs antisymmetric; the others wait for ROADMAP A2 and A5")
    p.add_argument("--kernel-size", type=int, default=3)
    p.add_argument("--integrator", choices=["euler", "midpoint", "rk4"], default="euler")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--use-pallas", action="store_true",
                   help="accepted; on the card the hand-written kernels are always the path")
    p.add_argument("--s2d-block", type=int, default=2,
                   help="accepted and ignored: space-to-depth stays off on CUDA")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute (ROADMAP A5)")
    p.add_argument("--int8-forward", action="store_true", help="int8 convolutions (ROADMAP A13)")
    p.add_argument("--int8-backward", choices=["ste", "dgrad", "wgrad", "full"], default="ste")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs (default cuda)")


def _build_model(args):
    """The model of the flags, drawn from seed 0 on ``--device``."""
    import torch

    from differential_equations_resnet_tpu_torch.models import (
        build_single_block_resnet,
        cifar10_single_block_config,
    )

    if args.model != "single_block":
        raise NotImplementedError(
            f"--model {args.model}: the bottleneck family waits for its port (ROADMAP A12)."
        )
    config = cifar10_single_block_config(
        num_layers=args.num_layers,
        final_time=args.final_time,
        num_filters=args.num_filters,
        kernel_type=args.kernel_type,
        kernel_size=args.kernel_size,
        gamma=args.gamma,
        integrator=args.integrator,
        remat=args.remat,
        use_pallas=args.use_pallas,
        s2d_block=args.s2d_block,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        int8_forward=args.int8_forward,
        int8_backward=args.int8_backward,
    )
    return build_single_block_resnet(config, generator=torch.Generator().manual_seed(0),
                                     device=args.device)


def _load_data(args):
    from differential_equations_resnet_tpu_torch.data.cifar10 import (
        build_cifar10_dataset,
        find_cifar10_directory,
        synthetic_cifar10,
    )

    cifar_dir = getattr(args, "cifar10_dir", None) or find_cifar10_directory()
    if cifar_dir:
        print(f"# loading CIFAR-10 from {cifar_dir}", file=sys.stderr)
        return build_cifar10_dataset(cifar_dir)
    print("# CIFAR-10 not found on disk; using synthetic data", file=sys.stderr)
    return synthetic_cifar10(
        num_train=getattr(args, "synthetic_train_size", None) or 50000,
        num_test=getattr(args, "synthetic_val_size", None) or 10000,
    )


def cmd_train(args) -> int:
    from differential_equations_resnet_tpu_torch.train import (
        Checkpointer,
        Training,
        linear_warmup_schedule,
    )

    model = _build_model(args)
    train_x, train_y, test_x, test_y, _ = _load_data(args)
    trainer = Training(
        model,
        train_features=train_x,
        train_labels=train_y,
        val_features=test_x,
        val_labels=test_y,
        batch_size=args.batch_size,
        csv_logger_dir=args.csv_dir,
        csv_logger_name=f"single_block_{args.kernel_type}_{args.num_layers}-layers_{args.num_filters}-filters",
        summaries_dir=args.summaries_dir,
        accum_steps=args.accum_steps,
    )
    if args.resume:
        if not args.save_dir:
            raise SystemExit("--resume requires --save-dir")
        checkpointer = Checkpointer(args.save_dir)
        latest = checkpointer.latest()
        if latest is not None:
            ckpt_path = os.path.join(args.save_dir, latest)
            trainer.load_variables(ckpt_path)
            # Restore the best-metric watermark, from the sidecar or, for a
            # checkpoint without one, from the metric-encoded name.
            meta = checkpointer.read_meta(ckpt_path)
            if meta and meta.get("metrics"):
                metrics = meta["metrics"]
                if "loss" in metrics:
                    trainer.best_metrics["loss"] = float(metrics["loss"])
                if "accuracy" in metrics:
                    trainer.best_metrics["accuracy"] = float(metrics["accuracy"])
            else:
                m = re.search(r"loss-([0-9.eE+-]+)_accuracy-([0-9.eE+-]+)", latest)
                if m:
                    trainer.best_metrics["loss"] = float(m.group(1))
                    trainer.best_metrics["accuracy"] = float(m.group(2))
            print(f"# resumed from {latest} at step {trainer.global_step}", file=sys.stderr)
        else:
            print("# --resume: no checkpoint found, starting fresh", file=sys.stderr)
    steps_per_epoch = args.steps_per_epoch or ((len(train_x) + args.batch_size - 1) // args.batch_size)
    if args.device_data:
        # A device-resident epoch draws without replacement: at most the dataset.
        steps_per_epoch = min(steps_per_epoch, len(train_x) // args.batch_size)
    trainer.train(
        epochs=args.epochs,
        steps_per_epoch=steps_per_epoch,
        learning_rate_schedule=linear_warmup_schedule(args.learning_rate, args.warmup_steps),
        eval_dataset=args.eval_dataset,
        eval_steps=args.eval_steps,
        save_during_training=args.save_dir is not None,
        save_dir=args.save_dir,
        monitor=args.monitor,
        summaries_frequency=args.summaries_frequency,
        scan_steps=args.scan_steps,
        device_data=args.device_data,
        save_frequency=args.save_frequency,
    )
    print(json.dumps({"best": trainer.best_metrics}))
    trainer.close()
    return 0


def cmd_evaluate(args) -> int:
    from differential_equations_resnet_tpu_torch.train import Training

    model = _build_model(args)
    _, _, test_x, test_y, _ = _load_data(args)
    trainer = Training(model, val_features=test_x, val_labels=test_y,
                       batch_size=args.batch_size, record_summaries=False)
    if args.checkpoint:
        trainer.load_variables(args.checkpoint)
    if args.device_data:
        print(json.dumps(trainer.evaluate("val", device_data=True)))
        return 0
    steps = (len(test_x) + args.batch_size - 1) // args.batch_size
    print(json.dumps(trainer.evaluate("val", num_steps=steps)))
    return 0


def cmd_predict(args) -> int:
    """Batch inference: a .npy array of images -> class probabilities."""
    import numpy as np

    from differential_equations_resnet_tpu_torch.train import Training

    if not args.input.endswith(".npy"):
        raise NotImplementedError(
            "predict takes a .npy array; image directories need the host preprocessors "
            "and records (ROADMAP A8)."
        )
    model = _build_model(args)
    trainer = Training(model, batch_size=args.batch_size, record_summaries=False)
    if args.checkpoint:
        trainer.load_variables(args.checkpoint)
    images = np.load(args.input)
    if images.ndim == 3:
        images = images[None]
    probs = trainer.predict(images.astype(np.float32))
    if args.output:
        np.save(args.output, probs)
        print(f"# wrote {probs.shape} -> {args.output}", file=sys.stderr)
    print(json.dumps({
        "num_images": int(len(probs)),
        "predictions": np.argmax(probs, axis=-1)[:32].tolist(),
        "max_prob_mean": float(np.max(probs, axis=-1).mean()),
    }))
    return 0


def _gradient_flow_diagnostics(th):
    """The reference's three gradient-flow diagnostics (v7 notebook cells
    30/34/38) from a TrainingHistory."""
    return {
        "relative_deviation": float(th.gradient_norm_relative_deviation()),
        "standard_deviation": float(th.gradient_norm_standard_deviation()),
        "last_first_ratio": float(th.gradient_norm_relative_comparison()),
    }


def cmd_analyze(args) -> int:
    from differential_equations_resnet_tpu_torch.train import TrainingHistory

    th = TrainingHistory(training_history_filepath=args.training_csv,
                         evaluation_history_filepath=args.evaluation_csv)
    out = {f"gradient_norm_{k}": v for k, v in _gradient_flow_diagnostics(th).items()}
    if args.evaluation_csv:
        out["best_val_accuracy"] = float(th.evaluation_accuracy.max())
        out["best_val_mean_loss"] = float(th.evaluation_mean_loss.min())
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="deqres-torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train")
    _add_model_args(p)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--eval-steps", type=int, default=None,
                   help="evaluation batches per eval (default: one full pass)")
    p.add_argument("--eval-dataset", choices=["train", "val"], default="val")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--accum-steps", type=int, default=1,
                   help="split each batch into this many microbatches and apply one "
                        "averaged update (the monolithic step's numerics)")
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear lr warmup over this many steps (0 = off)")
    p.add_argument("--cifar10-dir", default=None)
    p.add_argument("--synthetic-train-size", type=int, default=None,
                   help="synthetic-fallback dataset size (default 50000)")
    p.add_argument("--synthetic-val-size", type=int, default=None)
    p.add_argument("--csv-dir", default="./local/csv_logger")
    p.add_argument("--summaries-dir", default=None)
    p.add_argument("--save-dir", default=None)
    p.add_argument("--monitor", choices=["loss", "accuracy"], default="loss")
    p.add_argument("--summaries-frequency", type=int, default=10)
    p.add_argument("--scan-steps", type=int, default=0,
                   help="accepted as in the JAX package; changes nothing here, where "
                        "every step is already one CUDA-graph replay")
    p.add_argument("--device-data", action="store_true",
                   help="device-resident mode: upload the dataset once and run each "
                        "epoch on the device (shuffle, gather, CUDA-graph replays)")
    p.add_argument("--save-frequency", type=int, default=1,
                   help="checkpoint every N epochs (when --save-dir is set)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint in --save-dir (Adam slots "
                        "included) before training")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate")
    _add_model_args(p)
    p.add_argument("--device-data", action="store_true",
                   help="full-pass device-resident evaluation")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--cifar10-dir", default=None)
    p.add_argument("--synthetic-train-size", type=int, default=None)
    p.add_argument("--synthetic-val-size", type=int, default=None)
    p.add_argument("--checkpoint", default=None)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("predict")
    _add_model_args(p)
    p.add_argument("input", help=".npy image array (N,H,W,3)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--output", default=None, help="write probabilities .npy")
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("analyze")
    p.add_argument("training_csv")
    p.add_argument("--evaluation-csv", default=None)
    p.set_defaults(fn=cmd_analyze)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
