"""A tiny tf.data-free dataset pipeline over NumPy arrays.

A copy of `differential_equations_resnet_tpu/data/pipeline.py`, kept in the
port so that it imports no JAX (the JAX package's `data/__init__.py` pulls
JAX in).  It is NumPy-only: the same seed gives the same batches in the same
order as the JAX package's.

Provides the same composable surface the reference builds on tf.data
(`dataset_utils/tf_dataset_creator_from_arrays.py:22-58`): map / shuffle /
repeat / batch / prefetch, with preprocessors as callables that transform a
dataset into a new dataset.  Device feeding is the caller's job (the harness copies
each NumPy batch to the card); `prefetch` overlaps host-side preparation with device
compute on a background thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np


class NumpyDataset:
    """Lazily evaluated pipeline of elements (tuples/dicts of NumPy arrays)."""

    def __init__(self, source: Callable[[], Iterator[Any]]):
        self._source = source

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_tensor_slices(arrays) -> "NumpyDataset":
        """Elements are aligned slices along axis 0 (tf.data parity)."""
        if isinstance(arrays, dict):
            keys = list(arrays)
            n = len(arrays[keys[0]])

            def gen():
                for i in range(n):
                    yield {k: arrays[k][i] for k in keys}

        else:
            arrays = tuple(arrays) if isinstance(arrays, (tuple, list)) else (arrays,)
            n = len(arrays[0])
            single = len(arrays) == 1

            def gen():
                for i in range(n):
                    yield arrays[0][i] if single else tuple(a[i] for a in arrays)

        return NumpyDataset(gen)

    @staticmethod
    def from_generator(fn: Callable[[], Iterator[Any]]) -> "NumpyDataset":
        return NumpyDataset(fn)

    # -- transforms ---------------------------------------------------------

    def map(self, fn: Callable, num_parallel_calls: Optional[int] = None) -> "NumpyDataset":
        """Apply fn to each element.  Tuple elements are splatted into fn like
        tf.data's map (fn(image, label)); other element types are passed
        whole.  `num_parallel_calls` is accepted for API parity (host NumPy
        transforms are cheap; parallelism is provided by `prefetch`)."""
        src = self._source

        def gen():
            for elem in src():
                if isinstance(elem, tuple):
                    yield fn(*elem)
                else:
                    yield fn(elem)

        return NumpyDataset(gen)

    def filter(self, pred: Callable) -> "NumpyDataset":
        src = self._source

        def gen():
            for elem in src():
                ok = pred(*elem) if isinstance(elem, tuple) else pred(elem)
                if ok:
                    yield elem

        return NumpyDataset(gen)

    def shuffle(self, buffer_size: int, seed: Optional[int] = None) -> "NumpyDataset":
        """Streaming reservoir shuffle with the same semantics as
        tf.data.Dataset.shuffle (buffer of `buffer_size`, sample uniformly)."""
        src = self._source

        def gen():
            rng = np.random.default_rng(seed)
            buf = []
            for elem in src():
                buf.append(elem)
                if len(buf) >= buffer_size:
                    idx = rng.integers(len(buf))
                    buf[idx], buf[-1] = buf[-1], buf[idx]
                    yield buf.pop()
            rng.shuffle(buf)
            yield from buf

        return NumpyDataset(gen)

    def repeat(self, count: Optional[int] = None) -> "NumpyDataset":
        src = self._source

        def gen():
            n = 0
            while count is None or n < count:
                yield from src()
                n += 1

        return NumpyDataset(gen)

    def batch(self, batch_size: int, drop_remainder: bool = False) -> "NumpyDataset":
        src = self._source

        def stack(elems):
            first = elems[0]
            if isinstance(first, tuple):
                return tuple(np.stack([e[i] for e in elems]) for i in range(len(first)))
            if isinstance(first, dict):
                return {k: np.stack([e[k] for e in elems]) for k in first}
            return np.stack(elems)

        def gen():
            batch = []
            for elem in src():
                batch.append(elem)
                if len(batch) == batch_size:
                    yield stack(batch)
                    batch = []
            if batch and not drop_remainder:
                yield stack(batch)

        return NumpyDataset(gen)

    def prefetch(self, buffer_size: int = 1) -> "NumpyDataset":
        """Produce elements on a daemon thread, buffered in a queue."""
        src = self._source

        def gen():
            q: queue.Queue = queue.Queue(maxsize=max(1, buffer_size))
            stop = object()
            err: list = []

            def worker():
                try:
                    for elem in src():
                        q.put(elem)
                except BaseException as e:  # propagate to consumer
                    err.append(e)
                finally:
                    q.put(stop)

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            while True:
                elem = q.get()
                if elem is stop:
                    if err:
                        raise err[0]
                    return
                yield elem

        return NumpyDataset(gen)

    def take(self, count: int) -> "NumpyDataset":
        src = self._source

        def gen():
            for i, elem in enumerate(src()):
                if i >= count:
                    return
                yield elem

        return NumpyDataset(gen)

    def shard(self, num_shards: int, index: int) -> "NumpyDataset":
        """Per-host sharding for multi-host input pipelines."""
        src = self._source

        def gen():
            for i, elem in enumerate(src()):
                if i % num_shards == index:
                    yield elem

        return NumpyDataset(gen)

    def apply(self, transform: Callable[["NumpyDataset"], "NumpyDataset"]) -> "NumpyDataset":
        return transform(self)

    def __iter__(self) -> Iterator[Any]:
        return self._source()

    def as_numpy_iterator(self) -> Iterator[Any]:
        return self._source()


def _fast_array_batches(
    features: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    shuffle: bool,
    repeat: bool,
    drop_remainder: bool,
    seed: Optional[int],
) -> NumpyDataset:
    """Vectorized batch assembly for in-memory arrays: one permutation per
    epoch + fancy-indexed gathers — orders of magnitude faster than
    per-element iteration (the accelerator step is ~sub-millisecond; the
    host pipeline must not be the bottleneck)."""
    n = len(features)

    def gen():
        rng = np.random.default_rng(seed)
        while True:
            idx = rng.permutation(n) if shuffle else None
            for start in range(0, n, batch_size):
                stop = start + batch_size
                if drop_remainder and stop > n:
                    break
                if idx is None:
                    yield features[start:stop], labels[start:stop]
                else:
                    sel = idx[start:stop]
                    yield features[sel], labels[sel]
            if not repeat:
                return

    return NumpyDataset.from_generator(gen)


def create_dataset_from_arrays(
    features: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    preprocessors: Sequence[Callable] = (),
    shuffle: bool = True,
    repeat: bool = True,
    prefetch_buffer: int = 2,
    drop_remainder: bool = False,
    seed: Optional[int] = None,
) -> NumpyDataset:
    """In-memory (features, labels) -> batched pipeline.

    Parity with `dataset_utils/tf_dataset_creator_from_arrays.py:22-58`:
    preprocessor chain, full-size shuffle, repeat, batch, prefetch.  The
    pipeline takes the vectorized whole-batch gather path (epoch-level
    permutation, identical distribution to a full-size shuffle buffer)
    whenever every preprocessor exposes ``apply_batch`` — random augmentation
    params are still drawn per image, so the distribution matches the
    per-element path; only the host cost changes (per-element Python map
    cannot feed the ~9k img/s the device consumes at headline throughput)."""
    if all(hasattr(p, "apply_batch") for p in preprocessors):
        dataset = _fast_array_batches(
            features, labels, batch_size, shuffle, repeat, drop_remainder, seed
        )
        for preprocessor in preprocessors:
            fn = preprocessor.apply_batch
            dataset = dataset.map(lambda x, y, _fn=fn: _fn(x, y))
        return dataset.prefetch(prefetch_buffer)
    dataset = NumpyDataset.from_tensor_slices((features, labels))
    for preprocessor in preprocessors:
        dataset = preprocessor(dataset)
    if shuffle:
        dataset = dataset.shuffle(buffer_size=len(features), seed=seed)
    if repeat:
        dataset = dataset.repeat()
    dataset = dataset.batch(batch_size, drop_remainder=drop_remainder)
    return dataset.prefetch(prefetch_buffer)
