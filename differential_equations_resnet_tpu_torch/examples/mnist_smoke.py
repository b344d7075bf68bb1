"""MNIST smoke workflow — the reference's `antisymmetric_conv_kernel.ipynb`
cells 8-11: build the simplified antisymmetric ResNet on (28, 28, 1), fit one
epoch with Adam + sparse categorical cross-entropy, evaluate on the test
split, then predict class probabilities for a single image.

Port of the JAX package's ``examples/mnist_smoke.py``.  The simplified net is
a `SingleBlockResNetConfig` (`mnist_single_block_config`, 8 layers x 16
filters: on the card its Euler stack runs on the fused kernels B1/B2) driven
through the same `Training` harness as the CIFAR-10 experiments.  Reads the
standard IDX files from --mnist-dir when present; otherwise uses the
deterministic synthetic fallback.

    python -m differential_equations_resnet_tpu_torch.examples.mnist_smoke [--epochs 1]
"""

import argparse

import numpy as np
import torch

from differential_equations_resnet_tpu_torch.data.mnist import (
    build_mnist_dataset,
    find_mnist_directory,
    mnist_single_block_config,
    synthetic_mnist,
)
from differential_equations_resnet_tpu_torch.models import build_single_block_resnet
from differential_equations_resnet_tpu_torch.train import Training


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mnist-dir", default=None)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-layers", type=int, default=8)
    ap.add_argument("--num-filters", type=int, default=16)
    ap.add_argument("--kernel-type", default="antisymmetric",
                    choices=["antisymmetric", "regular"])
    ap.add_argument("--steps-per-epoch", type=int, default=None)
    ap.add_argument("--scan-steps", type=int, default=0,
                    help="accepted as in the JAX example; changes nothing here")
    ap.add_argument("--synthetic-train-size", type=int, default=60000,
                    help="size of the synthetic fallback's training split")
    ap.add_argument("--synthetic-test-size", type=int, default=10000)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    mnist_dir = args.mnist_dir or find_mnist_directory()
    if mnist_dir:
        print(f"# loading MNIST from {mnist_dir}")
        tr_x, tr_y, te_x, te_y, _ = build_mnist_dataset(mnist_dir)
    else:
        print("# MNIST not found on disk; using synthetic data")
        tr_x, tr_y, te_x, te_y, _ = synthetic_mnist(args.synthetic_train_size,
                                                    args.synthetic_test_size)

    model = build_single_block_resnet(
        mnist_single_block_config(
            num_layers=args.num_layers,
            num_filters=args.num_filters,
            kernel_type=args.kernel_type,
        ),
        generator=torch.Generator().manual_seed(0),
        device=args.device,
    )
    trainer = Training(
        model,
        train_features=tr_x,
        train_labels=tr_y,
        val_features=te_x,
        val_labels=te_y,
        batch_size=args.batch_size,
    )
    steps = args.steps_per_epoch or len(tr_x) // args.batch_size
    trainer.train(
        epochs=args.epochs,
        steps_per_epoch=steps,
        eval_steps=len(te_x) // args.batch_size,
        learning_rate_schedule=lambda step: 1e-3,
        scan_steps=args.scan_steps,
    )
    metrics = trainer.evaluate("val")
    print(f"# test loss {metrics['mean_loss']:.4f} "
          f"accuracy {metrics['accuracy']:.4f}")

    # Single-image prediction (nb cell 11): class probabilities for one digit.
    i = int(np.random.default_rng(0).integers(len(tr_x)))
    probs = trainer.predict(tr_x[i : i + 1].astype(np.float32), batch_size=1)[0]
    print(f"# image {i} probabilities:")
    for k, p in enumerate(probs):
        print(f"#   {k}:\t{p:.4f}")
    trainer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
