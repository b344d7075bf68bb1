"""Data of the port: the NumPy dataset pipeline, CIFAR-10 and MNIST
loading, the host preprocessors, the sharded binary records and the
on-device augmentations (the JAX package's `data/`)."""

from differential_equations_resnet_tpu_torch.data import jit_augment
from differential_equations_resnet_tpu_torch.data.cifar10 import (
    build_cifar10_dataset,
    fetch_cifar10,
    find_cifar10_directory,
    synthetic_cifar10,
    unpickle,
)
from differential_equations_resnet_tpu_torch.data.mnist import (
    build_mnist_dataset,
    find_mnist_directory,
    mnist_single_block_config,
    synthetic_mnist,
)
from differential_equations_resnet_tpu_torch.data.pipeline import (
    NumpyDataset,
    create_dataset_from_arrays,
)
from differential_equations_resnet_tpu_torch.data.preprocessors import (
    ConvertLabelsToOneHot,
    DecodeImages,
    DecodeJPEGImages,
    RandomBrightness,
    RandomCrop,
    RandomFlipLeftRight,
    RandomSaturation,
    Resize,
    ResizeWithPad,
    UnpackImagesLabels,
)
from differential_equations_resnet_tpu_torch.data.records import (
    RecordDatasetCreator,
    RecordGenerator,
    get_record_paths,
)

__all__ = [
    "ConvertLabelsToOneHot",
    "DecodeImages",
    "DecodeJPEGImages",
    "NumpyDataset",
    "RandomBrightness",
    "RandomCrop",
    "RandomFlipLeftRight",
    "RandomSaturation",
    "RecordDatasetCreator",
    "RecordGenerator",
    "Resize",
    "ResizeWithPad",
    "UnpackImagesLabels",
    "build_cifar10_dataset",
    "build_mnist_dataset",
    "create_dataset_from_arrays",
    "fetch_cifar10",
    "find_cifar10_directory",
    "find_mnist_directory",
    "get_record_paths",
    "jit_augment",
    "mnist_single_block_config",
    "synthetic_cifar10",
    "synthetic_mnist",
    "unpickle",
]
