"""Depth-doubling continuation: train a coarse L-step model, double it to
2L steps with h halved (warm start), and go on training — the
ODE-refinement workflow of the reference's `double_load_weights` driven
from its v6/v7 notebooks.

Port of the JAX package's ``examples/depth_doubling_continuation.py``,
through `utils.double_model_depth`.  Reads CIFAR-10 from --cifar10-dir or
the usual places when present, else seeded synthetic data.  Prints one JSON
list, a row a stage: {"layers", "h", and the stage's last evaluation}.

    python -m differential_equations_resnet_tpu_torch.examples.depth_doubling_continuation \
        [--start-layers 8]
"""

import argparse
import json

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
from differential_equations_resnet_tpu_torch.train import Training
from differential_equations_resnet_tpu_torch.utils import double_model_depth


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--start-layers", type=int, default=8)
    parser.add_argument("--doublings", type=int, default=2)
    parser.add_argument("--epochs-per-stage", type=int, default=1)
    parser.add_argument("--num-filters", type=int, default=16)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--cifar10-dir", default=None)
    parser.add_argument("--synthetic-train-size", type=int, default=8192)
    parser.add_argument("--synthetic-val-size", type=int, default=2048)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    cifar_dir = args.cifar10_dir or find_cifar10_directory()
    if cifar_dir:
        train_x, train_y, test_x, test_y, _ = build_cifar10_dataset(cifar_dir)
    else:
        print("# CIFAR-10 not found; running on synthetic data")
        train_x, train_y, test_x, test_y, _ = synthetic_cifar10(
            args.synthetic_train_size, args.synthetic_val_size)

    config = cifar10_single_block_config(num_layers=args.start_layers,
                                         num_filters=args.num_filters)
    params = None
    report = []
    for stage in range(args.doublings + 1):
        if params is None:
            model = build_single_block_resnet(config, generator=torch.Generator().manual_seed(0),
                                              device=args.device)
        else:  # warm start from the doubled coarse solution
            model = build_single_block_resnet(config, params=params, device=args.device)
        trainer = Training(model, train_features=train_x, train_labels=train_y,
                           val_features=test_x, val_labels=test_y,
                           batch_size=args.batch_size, record_summaries=False)
        steps = (len(train_x) + args.batch_size - 1) // args.batch_size
        eval_steps = (len(test_x) + args.batch_size - 1) // args.batch_size
        history = trainer.train(epochs=args.epochs_per_stage, steps_per_epoch=steps,
                                learning_rate_schedule=lambda s: 1e-3, eval_steps=eval_steps)
        report.append({"layers": config.blocks_per_stage[0], "h": config.h,
                       **history["eval"][-1]})
        if stage < args.doublings:
            params, config = double_model_depth(model.params(), config)
        trainer.close()
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
