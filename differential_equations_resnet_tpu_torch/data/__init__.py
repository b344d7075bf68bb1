"""Data of the port: the NumPy dataset pipeline, CIFAR-10 loading and the
on-device augmentations (the JAX package's `data/` up to its MNIST loader,
host preprocessors, records and `native/` codec, which are ROADMAP A8's
remainder)."""

from differential_equations_resnet_tpu_torch.data import jit_augment
from differential_equations_resnet_tpu_torch.data.cifar10 import (
    build_cifar10_dataset,
    fetch_cifar10,
    find_cifar10_directory,
    synthetic_cifar10,
    unpickle,
)
from differential_equations_resnet_tpu_torch.data.pipeline import (
    NumpyDataset,
    create_dataset_from_arrays,
)

__all__ = [
    "NumpyDataset",
    "build_cifar10_dataset",
    "create_dataset_from_arrays",
    "fetch_cifar10",
    "find_cifar10_directory",
    "jit_augment",
    "synthetic_cifar10",
    "unpickle",
]
