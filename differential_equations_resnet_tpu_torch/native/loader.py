"""ctypes bindings for the native threaded record loader (dert_loader.cc).

Port of `differential_equations_resnet_tpu/native/loader.py`.
`NativeRecordLoader` iterates `(images (B,h,w,c) uint8, labels (B,) int64)`
batches produced by C++ worker threads (shard-parallel reads, bounded-ring
prefetch, per-epoch file shuffle, reservoir record shuffle) — the role the
reference delegates to tf.data's C++ runtime
(`dataset_utils/tfrecord_dataset_creator.py:35-36,66-71`: num_parallel_reads /
shuffle / prefetch).

The C++ source is a verbatim copy of the JAX package's, compiled on first
use into ``build/native/`` (`ops.kernels._build`); callers should check
`native_loader_available()` and fall back to the Python reader.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from differential_equations_resnet_tpu_torch.ops.kernels import _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

_ERROR_NAMES = {
    -1: "open failed",
    -2: "bad magic",
    -3: "unsupported version",
    -4: "truncated record",
    -5: "CRC mismatch (corrupt record)",
    -6: "shape mismatch",
    -7: "non-raw encoding",
}


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            lib = _build.load("dert_loader")
        except (RuntimeError, OSError):
            _load_failed = True
            return None
        lib.dert_loader_open.restype = ctypes.c_void_p
        lib.dert_loader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # paths
            ctypes.c_int64,                   # n_paths
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # h, w, c
            ctypes.c_int64,                   # batch
            ctypes.c_int64,                   # num_epochs (0 = infinite)
            ctypes.c_int32,                   # shuffle_files
            ctypes.c_int32,                   # verify_crc
            ctypes.c_int32,                   # num_threads
            ctypes.c_int64,                   # shuffle_buffer
            ctypes.c_uint64,                  # seed
            ctypes.c_int64,                   # ring_capacity
        ]
        lib.dert_loader_next.restype = ctypes.c_int64
        lib.dert_loader_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.dert_loader_close.restype = None
        lib.dert_loader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_loader_available() -> bool:
    return _load() is not None


class NativeRecordLoader:
    """Iterator of (images, labels) batches over raw fixed-shape DERT shards,
    fed by C++ worker threads.

    Args mirror `RecordDatasetCreator`: `shuffle_files` reshuffles the shard
    order every epoch (seeded); `shuffle_buffer_size` adds a record-level
    reservoir shuffle; `num_epochs` bounds the number of passes (None =
    forever when `repeat` else one pass), ending with a short final batch
    then StopIteration.  With shuffling off and `num_threads=1` the record
    order is deterministic and matches the shard list.  Where torch sees a
    CUDA device, each batch's images are filled into a fresh page-locked
    buffer (a NumPy view of a pinned `torch` tensor, which the view keeps
    alive), so a copy to the card needs no staging copy; elsewhere into a
    NumPy array.
    """

    def __init__(
        self,
        record_paths: Sequence[str],
        image_shape: Tuple[int, int, int],
        batch_size: int,
        repeat: bool = True,
        num_epochs: Optional[int] = None,
        shuffle_files: bool = True,
        verify_crc: bool = True,
        num_threads: int = 4,
        shuffle_buffer_size: int = 0,
        seed: int = 0,
        ring_capacity: int = 4096,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native loader unavailable (no g++ / load failed); use the "
                "Python RecordDatasetCreator instead"
            )
        if not record_paths:
            raise ValueError("No record_paths specified.")
        self._lib = lib
        self._handle = None
        self.image_shape = tuple(image_shape)
        self.batch_size = int(batch_size)
        self._pinned = torch.cuda.is_available()
        encoded = [os.path.abspath(p).encode() for p in record_paths]
        arr = (ctypes.c_char_p * len(encoded))(*encoded)
        h, w, c = self.image_shape
        if num_epochs is None:
            num_epochs = 0 if repeat else 1
        self._handle = lib.dert_loader_open(
            arr, len(encoded), h, w, c, self.batch_size,
            int(num_epochs), 1 if shuffle_files else 0,
            1 if verify_crc else 0,
            int(num_threads), int(shuffle_buffer_size), int(seed) & (2**64 - 1),
            int(ring_capacity),
        )
        if not self._handle:
            raise RuntimeError("dert_loader_open failed")

    def __iter__(self):
        return self

    def _image_buffer(self) -> np.ndarray:
        shape = (self.batch_size, *self.image_shape)
        if self._pinned:
            return torch.empty(shape, dtype=torch.uint8, pin_memory=True).numpy()
        return np.empty(shape, dtype=np.uint8)

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._handle is None:
            raise StopIteration
        images = self._image_buffer()
        labels = np.empty((self.batch_size,), dtype=np.int64)
        n = self._lib.dert_loader_next(
            self._handle,
            images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if n < 0:
            raise ValueError(_ERROR_NAMES.get(n, f"loader error {n}"))
        if n == 0:
            raise StopIteration
        return images[:n], labels[:n]

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dert_loader_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
