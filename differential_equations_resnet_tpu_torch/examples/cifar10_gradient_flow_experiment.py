"""The headline experiment: gradient flow over depth for antisymmetric
against regular 64-layer single-block ResNets on CIFAR-10.

Port of the JAX package's ``examples/cifar10_gradient_flow_experiment.py``
(the script form of the reference's experiments_antisymmetric_resnet_v7
notebook): train both variants, log per-layer gradient mean norms to CSV,
then compute the three gradient-flow diagnostics and the accuracy table
through `train.TrainingHistory`.  On the card both 64L x 16F stacks train
on the fused kernels B1 and B2.  Prints one JSON object, a row a variant.

    python -m differential_equations_resnet_tpu_torch.examples.cifar10_gradient_flow_experiment \
        [--cifar10-dir DIR] [--epochs 20] [--num-layers 64]

Without CIFAR-10 on disk it runs on seeded synthetic data (a pipeline smoke
test; the published numbers need the real dataset).
"""

import argparse
import glob
import json
import os

import torch

from differential_equations_resnet_tpu_torch.data.cifar10 import (
    build_cifar10_dataset,
    find_cifar10_directory,
    synthetic_cifar10,
)
from differential_equations_resnet_tpu_torch.models import (
    build_single_block_resnet,
    cifar10_single_block_config,
)
from differential_equations_resnet_tpu_torch.train import Training, TrainingHistory


def run_variant(kernel_type, args, data, out_dir):
    train_x, train_y, test_x, test_y = data
    name = f"single_block_{kernel_type}_{args.num_layers}-layers_{args.num_filters}-filters"
    model = build_single_block_resnet(
        cifar10_single_block_config(num_layers=args.num_layers, num_filters=args.num_filters,
                                    kernel_type=kernel_type),
        generator=torch.Generator().manual_seed(0), device=args.device,
    )
    trainer = Training(model, train_features=train_x, train_labels=train_y,
                       val_features=test_x, val_labels=test_y, batch_size=args.batch_size,
                       csv_logger_dir=out_dir, csv_logger_name=name)
    steps_per_epoch = (len(train_x) + args.batch_size - 1) // args.batch_size
    if args.device_data:
        # Device-resident epochs draw batches without replacement.
        steps_per_epoch = len(train_x) // args.batch_size
    eval_steps = (len(test_x) + args.batch_size - 1) // args.batch_size
    trainer.train(epochs=args.epochs, steps_per_epoch=steps_per_epoch,
                  learning_rate_schedule=lambda step: 1e-3, eval_steps=eval_steps,
                  summaries_frequency=10, scan_steps=args.scan_steps,
                  device_data=args.device_data)
    trainer.close()
    train_csv = sorted(glob.glob(os.path.join(out_dir, f"{name}_*_training.csv")))[-1]
    eval_csv = sorted(glob.glob(os.path.join(out_dir, f"{name}_*_evaluation.csv")))[-1]
    history = TrainingHistory(train_csv, eval_csv)
    return {
        "best_val_accuracy": float(history.evaluation_accuracy.max()),
        "best_val_mean_loss": float(history.evaluation_mean_loss.min()),
        "grad_norm_relative_deviation": float(history.gradient_norm_relative_deviation()),
        "grad_norm_std_over_layers": float(history.gradient_norm_standard_deviation()),
        "grad_norm_last_first_ratio": float(history.gradient_norm_relative_comparison()),
        "training_csv": train_csv,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--cifar10-dir", default=None)
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--num-layers", type=int, default=64)
    parser.add_argument("--num-filters", type=int, default=16)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--out-dir", default="./local/gradient_flow")
    parser.add_argument("--device-data", action="store_true",
                        help="device-resident epochs, each step a CUDA-graph replay "
                             "(steps_per_epoch is floor(N/batch) instead of ceil)")
    parser.add_argument("--scan-steps", type=int, default=0,
                        help="accepted as in the JAX example; changes nothing here")
    parser.add_argument("--synthetic-train-size", type=int, default=50000,
                        help="size of the synthetic fallback's training split")
    parser.add_argument("--synthetic-val-size", type=int, default=10000)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    cifar_dir = args.cifar10_dir or find_cifar10_directory()
    if cifar_dir:
        train_x, train_y, test_x, test_y, _ = build_cifar10_dataset(cifar_dir)
    else:
        print("# CIFAR-10 not found; running on synthetic data")
        train_x, train_y, test_x, test_y, _ = synthetic_cifar10(
            args.synthetic_train_size, args.synthetic_val_size)
    data = (train_x, train_y, test_x, test_y)
    results = {}
    for kernel_type in ("antisymmetric", "regular"):
        print(f"== training {kernel_type} ==")
        results[kernel_type] = run_variant(kernel_type, args, data, args.out_dir)
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
