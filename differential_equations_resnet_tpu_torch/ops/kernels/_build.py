"""Build the port's CUDA sources into plain-C shared libraries at first use.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout, keyed by
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags, and
loaded with `ctypes`.  Nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {
    "fused_euler_fwd": "fused_euler_fwd.cu",
    "fused_euler_bwd": "fused_euler_bwd.cu",
    "fused_euler_wide": "fused_euler_wide.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc was not found on PATH or under /usr/local/cuda/bin.")


def library_path(name: str) -> Path:
    source = (CSRC / SOURCES[name]).read_bytes()
    headers = b"".join(path.read_bytes() for path in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(source + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together.  Returns each build's seconds (0.0 where the
    library already existed); raises `RuntimeError` with nvcc's output if
    any build fails.  ptxas's register and shared-memory report is kept
    beside each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    seconds = {}
    for name in names:
        target = library_path(name)
        if target.is_file():
            seconds[name] = 0.0
            continue
        nvcc = _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {SOURCES[name]} (exit {proc.returncode}):\n{log}")
            continue
        target.with_suffix(".so.log").write_text(log)
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if need be."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
