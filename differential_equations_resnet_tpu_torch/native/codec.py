"""ctypes bindings for the native DERT record codec (dert_codec.cc).

Port of `differential_equations_resnet_tpu/native/codec.py`.  The C++
source is the JAX package's codec with bounds checks added to its bulk read
(`dert_read_raw`), so the two write the same bytes; it is compiled on first
use into ``build/native/`` (`ops.kernels._build`).
Where it does not build (no ``g++``), every entry point degrades to the
pure-Python codec in `data/records.py`, as the JAX package's does: this is
host code, and the Python codec reads and writes the same format.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

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
    -8: "write failed",
}

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            lib = _build.load("dert_codec")
        except (RuntimeError, OSError):
            _load_failed = True
            return None
        lib.dert_count.restype = ctypes.c_int64
        lib.dert_count.argtypes = [ctypes.c_char_p]
        lib.dert_read_raw.restype = ctypes.c_int64
        lib.dert_read_raw.argtypes = [ctypes.c_char_p, _U8P, _I64P, ctypes.c_int64,
                                      ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                      ctypes.c_int32]
        lib.dert_write_raw.restype = ctypes.c_int64
        lib.dert_write_raw.argtypes = [ctypes.c_char_p, _U8P, _I64P, ctypes.c_int64,
                                       ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        _lib = lib
        return _lib


def native_codec_available() -> bool:
    return _load() is not None


def count_records(path: str) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec unavailable")
    n = lib.dert_count(path.encode())
    if n < 0:
        raise ValueError(f"{path}: {_ERROR_NAMES.get(n, n)}")
    return int(n)


def read_raw_shard(
    path: str, shape: Tuple[int, int, int], verify_crc: bool = True
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Bulk-read a shard of fixed-shape raw records.

    Returns (images (N, h, w, c) uint8, labels (N,) int64), or None when the
    native codec is unavailable.  Raises ValueError on corrupt shards and on
    shards containing non-raw / differently-shaped records (callers fall back
    to the Python codec for those)."""
    lib = _load()
    if lib is None:
        return None
    h, w, c = shape
    n = lib.dert_count(path.encode())
    if n < 0:
        raise ValueError(f"{path}: {_ERROR_NAMES.get(n, n)}")
    images = np.empty((n, h, w, c), dtype=np.uint8)
    labels = np.empty((n,), dtype=np.int64)
    got = lib.dert_read_raw(path.encode(), images.ctypes.data_as(_U8P),
                            labels.ctypes.data_as(_I64P), n, h, w, c, 1 if verify_crc else 0)
    if got < 0:
        raise ValueError(f"{path}: {_ERROR_NAMES.get(got, got)}")
    return images[:got], labels[:got]


def write_raw_shard(path: str, images: np.ndarray, labels: np.ndarray) -> bool:
    """Write one shard of raw fixed-shape records.  Returns False when the
    native codec is unavailable (callers fall back to the Python writer)."""
    lib = _load()
    if lib is None:
        return False
    images = np.ascontiguousarray(images, dtype=np.uint8)
    labels = np.ascontiguousarray(labels, dtype=np.int64)
    n, h, w, c = images.shape
    wrote = lib.dert_write_raw(path.encode(), images.ctypes.data_as(_U8P),
                               labels.ctypes.data_as(_I64P), n, h, w, c)
    if wrote < 0:
        raise ValueError(f"{path}: {_ERROR_NAMES.get(wrote, wrote)}")
    return True
