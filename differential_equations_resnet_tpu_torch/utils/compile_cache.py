"""Where the port keeps its compiled kernels between runs.

Port of `differential_equations_resnet_tpu/utils/compile_cache.py`, which
turns on XLA's persistent compilation cache.  The port compiles nothing with
XLA: its only compiled artifacts are the native libraries that
`ops.kernels._build` builds at first use (the CUDA kernels with nvcc, the
record codec and loader with g++), each named by a hash of its source, its
headers and its flags.  Without a call they go to ``build/`` beside the
package.  `enable_compile_cache` points the builder at a cache directory
instead, so that an installed, read-only package builds there and every
later run that finds a library already built starts no compiler.

The CLI calls it for the subcommands that use the card, never for
``--help`` or host-only subcommands; the tests do not.  Opt out with
``DEQRES_COMPILE_CACHE=0`` (or ``false``, ``no``); the directory is
``DEQRES_COMPILE_CACHE_DIR``, default ``~/.cache/deqres/cuda``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch

from differential_equations_resnet_tpu_torch.ops.kernels import _build

_ENABLED: Optional[str] = None


def enable_compile_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Idempotently point the kernels' builder at the cache directory:
    ``cache_dir``, else ``DEQRES_COMPILE_CACHE_DIR``, else
    ``~/.cache/deqres/cuda``.  Returns that directory (the first call's,
    once one has set it), or None where ``DEQRES_COMPILE_CACHE`` opts out
    or no CUDA device is present (as the JAX one returns None on XLA:CPU).
    Libraries already loaded stay loaded; every later build or load reads
    the new root."""
    global _ENABLED
    if os.environ.get("DEQRES_COMPILE_CACHE", "1") in ("0", "false", "no"):
        return None
    if not torch.cuda.is_available():
        return None
    if _ENABLED is not None:
        return _ENABLED
    if cache_dir is None:
        cache_dir = os.environ.get(
            "DEQRES_COMPILE_CACHE_DIR",
            os.path.join(os.path.expanduser("~"), ".cache", "deqres", "cuda"),
        )
    os.makedirs(cache_dir, exist_ok=True)
    _build.BUILD_ROOT = Path(cache_dir).resolve()
    _ENABLED = str(_build.BUILD_ROOT)
    return _ENABLED
