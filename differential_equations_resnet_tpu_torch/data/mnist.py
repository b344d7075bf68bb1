"""MNIST loading — the dataset of the reference's smoke-test workflow
(`antisymmetric_conv_kernel.ipynb` cells 9-10: `tf.keras.datasets.mnist` +
a 1-epoch fit of the simplified antisymmetric ResNet).

The rebuild reads the standard IDX ubyte files (optionally gzipped) from a
local directory, with a deterministic synthetic fallback for zero-egress
hosts, mirroring the CIFAR-10 module's structure (`data/cifar10.py`).

Port of `differential_equations_resnet_tpu/data/mnist.py`, kept in the port
so that it imports no JAX: `synthetic_mnist` gives the same bytes for a seed
as the JAX package's.  `mnist_single_block_config` builds the port's config
and, unlike the JAX package, does not default to ``s2d_block=2``: that
default was chosen on a TPU.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}

# Relative to the working directory only: the port reads nothing outside
# its checkout unless a directory is passed.
_SEARCH_PATHS = (
    "./mnist",
    "./data/mnist",
)


def _open(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def _read_idx(path: str) -> np.ndarray:
    """Read an IDX ubyte file (images magic 2051, labels magic 2049)."""
    with _open(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        if magic == 2051:
            n, rows, cols = struct.unpack(">III", f.read(12))
            data = np.frombuffer(f.read(n * rows * cols), np.uint8)
            return data.reshape(n, rows, cols)
        if magic == 2049:
            (n,) = struct.unpack(">I", f.read(4))
            return np.frombuffer(f.read(n), np.uint8)
        raise ValueError(f"{path}: unrecognized IDX magic {magic}")


def find_mnist_directory(extra: Tuple[str, ...] = ()) -> Optional[str]:
    """First directory containing the four IDX files (plain or .gz)."""
    for cand in tuple(extra) + _SEARCH_PATHS:
        d = os.path.expanduser(cand)
        if all(
            os.path.exists(os.path.join(d, f))
            or os.path.exists(os.path.join(d, f + ".gz"))
            for f in _FILES.values()
        ):
            return d
    return None


def build_mnist_dataset(
    directory: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """(train_images (60000,28,28,1) uint8, train_labels, test_images,
    test_labels, label_names) — NHWC with an explicit channel axis, matching
    the reference's `np.expand_dims(x_train, axis=-1)` (nb cell 9)."""
    d = os.path.expanduser(directory)
    tr_x = _read_idx(os.path.join(d, _FILES["train_images"]))[..., None]
    tr_y = _read_idx(os.path.join(d, _FILES["train_labels"])).astype(np.int64)
    te_x = _read_idx(os.path.join(d, _FILES["test_images"]))[..., None]
    te_y = _read_idx(os.path.join(d, _FILES["test_labels"])).astype(np.int64)
    return tr_x, tr_y, te_x, te_y, [str(i) for i in range(10)]


def synthetic_mnist(
    num_train: int = 60000, num_test: int = 10000, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Deterministic MNIST-shaped synthetic data (class-dependent blob
    position + noise) for zero-egress hosts."""
    rng = np.random.default_rng(seed)

    def make(n):
        labels = rng.integers(0, 10, size=(n,), dtype=np.int64)
        # Class-dependent mean intensity + noise (GAP-visible, linearly
        # separable enough for smoke training — same scheme as
        # synthetic_cifar10), plus a bright center patch for digit flavor.
        base = (labels[:, None, None, None] * 25 + 5).astype(np.float32)
        images = base + rng.normal(0.0, 24.0, size=(n, 28, 28, 1))
        images[:, 10:18, 10:18, :] += 40.0
        return np.clip(images, 0, 255).astype(np.uint8), labels

    tr_x, tr_y = make(num_train)
    te_x, te_y = make(num_test)
    return tr_x, tr_y, te_x, te_y, [str(i) for i in range(10)]


def mnist_single_block_config(
    num_layers: int = 8,
    final_time: float = 1.0,
    num_filters: int = 16,
    kernel_type: str = "antisymmetric",
    **overrides,
):
    """Single-block config for the MNIST smoke workflow — the functional
    analogue of the reference's `build_simplified_resnet(image_size=(28,28,1),
    ...)` (antisymmetric_conv_kernel.ipynb cells 7-8), with the depth run as
    one integrator scan instead of hand-enumerated stages."""
    from differential_equations_resnet_tpu_torch.models.single_block_resnet import (
        SingleBlockResNetConfig,
    )

    return SingleBlockResNetConfig(
        image_shape=(28, 28, 1),
        kernel_type=kernel_type,
        kernel_size=3,
        h=final_time / num_layers,
        num_stages=2,
        blocks_per_stage=(num_layers,),
        filters_per_block=(num_filters,),
        strides=((1, 1),),
        include_top=True,
        fc_activation="softmax",
        num_classes=10,
        subtract_mean=127.5,
        divide_by_stddev=127.5,
        **overrides,
    )
