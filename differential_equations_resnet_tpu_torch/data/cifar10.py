"""CIFAR-10 loading (parity with `dataset_utils/cifar10_utils.py:24-80`).

A copy of `differential_equations_resnet_tpu/data/cifar10.py`, kept in the
port so that it imports no JAX: `synthetic_cifar10` gives the same bytes for
a given seed as the JAX package's.  `fetch_cifar10` downloads into
``./data`` by default and `find_cifar10_directory` looks in ``$CIFAR10_DIR``,
``./data``, ``~/data`` and the working directory."""

from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np


def unpickle(filename: str) -> dict:
    with open(filename, "rb") as f:
        return pickle.load(f, encoding="bytes")


def build_cifar10_dataset(
    cifar10_directory: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Load the Python-pickle CIFAR-10 release and return
    (train_images (N,32,32,3) uint8, train_labels (N,),
     test_images (M,32,32,3), test_labels (M,), label_names) — N=50000,
    M=10000 for the real release; whatever rows are on disk otherwise.

    Identical semantics to the reference loader: (N,3072) CHW-packed rows are
    reshaped to (N,3,32,32) and transposed to NHWC.  Archive integrity
    (truncation protection) is `fetch-cifar10`'s sha256 check, not a row
    count here."""
    train_pickle_filenames = [f"data_batch_{i}" for i in range(1, 6)]

    train_images, train_labels = [], []
    for filename in train_pickle_filenames:
        d = unpickle(os.path.join(cifar10_directory, filename))
        train_images.append(d[b"data"])
        train_labels.append(d[b"labels"])
    train_images = np.concatenate(train_images, axis=0)
    train_labels = np.concatenate(train_labels, axis=0)

    d = unpickle(os.path.join(cifar10_directory, "test_batch"))
    test_images = d[b"data"]
    test_labels = np.asarray(d[b"labels"])

    train_images = np.transpose(train_images.reshape(-1, 3, 32, 32), (0, 2, 3, 1))
    test_images = np.transpose(
        np.asarray(test_images).reshape(-1, 3, 32, 32), (0, 2, 3, 1)
    )

    d = unpickle(os.path.join(cifar10_directory, "batches.meta"))
    label_names = [str(b, "utf-8") for b in d[b"label_names"]]

    return train_images, train_labels, test_images, test_labels, label_names


def synthetic_cifar10(
    num_train: int = 50000, num_test: int = 10000, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Deterministic CIFAR-10-shaped synthetic data (class-dependent means +
    noise, linearly separable enough for smoke training) — used for tests and
    benchmarks when the real dataset is not on disk (zero-egress hosts)."""
    rng = np.random.default_rng(seed)

    def make(n):
        labels = rng.integers(0, 10, size=(n,), dtype=np.int64)
        base = (labels[:, None, None, None] * 25 + 5).astype(np.float32)
        noise = rng.normal(0.0, 24.0, size=(n, 32, 32, 3)).astype(np.float32)
        images = np.clip(base + noise, 0, 255).astype(np.uint8)
        return images, labels

    train_images, train_labels = make(num_train)
    test_images, test_labels = make(num_test)
    label_names = [f"class_{i}" for i in range(10)]
    return train_images, train_labels, test_images, test_labels, label_names


CIFAR10_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
# Published checksums of the official cifar-10-python.tar.gz release.
CIFAR10_TGZ_MD5 = "c58f30108f718f92721af3b95e74349a"
CIFAR10_TGZ_SHA256 = (
    "6d958be074577803d12ecdefd02955f39262c83c16fe9348329d7fe0b5c001ce"
)


def fetch_cifar10(
    dest_dir: str = "data",
    url: str = CIFAR10_URL,
    verify: bool = True,
) -> str:
    """Download + checksum-verify + extract the official CIFAR-10 python
    release.  Returns the extracted `cifar-10-batches-py` directory.

    Idempotent: if the batches directory already exists, it is returned
    as-is; if the tarball exists but fails verification it is re-downloaded.
    On zero-egress hosts this raises with a message describing the manual
    fallback (copy the tarball to <dest_dir> yourself, or set CIFAR10_DIR)."""
    import hashlib
    import tarfile
    import urllib.error
    import urllib.request

    batches = os.path.join(dest_dir, "cifar-10-batches-py")
    if os.path.isfile(os.path.join(batches, "data_batch_1")):
        return batches
    os.makedirs(dest_dir, exist_ok=True)
    tgz = os.path.join(dest_dir, "cifar-10-python.tar.gz")

    def _verified() -> bool:
        if not os.path.isfile(tgz):
            return False
        if not verify:
            return True
        sha = hashlib.sha256()
        with open(tgz, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                sha.update(chunk)
        return sha.hexdigest() == CIFAR10_TGZ_SHA256

    if not _verified():
        try:
            tmp = tgz + ".part"
            urllib.request.urlretrieve(url, tmp)
            os.replace(tmp, tgz)
        except (urllib.error.URLError, OSError) as e:
            raise RuntimeError(
                f"Could not download CIFAR-10 from {url} ({e}). On a "
                f"zero-egress host, copy cifar-10-python.tar.gz into "
                f"{dest_dir} manually (sha256 {CIFAR10_TGZ_SHA256}) or set "
                f"CIFAR10_DIR to an extracted cifar-10-batches-py directory."
            ) from e
        if not _verified():
            raise RuntimeError(
                f"{tgz} failed sha256 verification (expected "
                f"{CIFAR10_TGZ_SHA256}); refusing to extract."
            )
    with tarfile.open(tgz, "r:gz") as tf:
        tf.extractall(dest_dir, filter="data")
    if not os.path.isfile(os.path.join(batches, "data_batch_1")):
        raise RuntimeError(f"Extraction produced no data batches under {batches}.")
    return batches


def find_cifar10_directory() -> str | None:
    """Look in the usual places for an extracted cifar-10-batches-py."""
    candidates = [
        os.environ.get("CIFAR10_DIR"),
        os.path.join("data", "cifar-10-batches-py"),
        os.path.expanduser("~/data/cifar-10-batches-py"),
        "./cifar-10-batches-py",
    ]
    for path in candidates:
        if path and os.path.isfile(os.path.join(path, "data_batch_1")):
            return path
    return None
