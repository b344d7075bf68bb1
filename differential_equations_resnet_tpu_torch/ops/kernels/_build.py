"""Build the port's native sources into plain-C shared libraries at first use.

Each source is compiled into ``build/<subdir>/lib<name>-<hash>.so`` at the
root of the checkout, keyed by a hash of the source, its shared headers and
the flags, and loaded with `ctypes`:

- the CUDA kernels under ``csrc/`` by ``nvcc`` for ``sm_90a`` into
  ``build/kernels/`` (their headers are ``csrc/*.cuh``);
- the record codec and loader under ``native/`` by ``g++`` into
  ``build/native/``.

A build goes to a temporary file that is renamed into place, so processes
that build at once (test workers) never load a half-written library.
Nothing is compiled when this module is imported.
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
from typing import Dict, Iterable, NamedTuple, Tuple

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
NATIVE = PACKAGE / "native"
BUILD_ROOT = PACKAGE.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-shared", "-fPIC")


class Source(NamedTuple):
    path: Path  # the source file
    compiler: str  # "nvcc" or "g++"
    flags: Tuple[str, ...]
    subdir: str  # the library goes to build/<subdir>/
    headers: Tuple[str, ...] = ()  # globs beside the source whose bytes key the hash too


def _cuda(file: str) -> Source:
    return Source(CSRC / file, "nvcc", NVCC_FLAGS, "kernels", ("*.cuh",))


SOURCES = {
    "fused_euler_fwd": _cuda("fused_euler_fwd.cu"),
    "fused_euler_bwd": _cuda("fused_euler_bwd.cu"),
    "fused_euler_wide": _cuda("fused_euler_wide.cu"),
    "dert_codec": Source(NATIVE / "dert_codec.cc", "g++", CXX_FLAGS, "native"),
    "dert_loader": Source(NATIVE / "dert_loader.cc", "g++", CXX_FLAGS + ("-pthread",), "native"),
}

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _compiler(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    default = Path("/usr/local/cuda/bin") / name
    if name == "nvcc" and default.is_file():
        return str(default)
    raise RuntimeError(f"{name} was not found on PATH"
                       + (" or under /usr/local/cuda/bin." if name == "nvcc" else "."))


def library_path(name: str) -> Path:
    source = SOURCES[name]
    headers = b"".join(path.read_bytes() for pattern in source.headers
                       for path in sorted(source.path.parent.glob(pattern)))
    digest = hashlib.sha256(source.path.read_bytes() + headers
                            + " ".join(source.flags).encode()).hexdigest()[:16]
    return BUILD_ROOT / source.subdir / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile every named source that is not built yet, one compiler
    process each, all started together.  Returns each build's seconds (0.0
    where the library already existed); raises `RuntimeError` with the
    compiler's output if any build fails or a compiler is missing.  The
    compiler's output (for nvcc, ptxas's register and shared-memory report)
    is kept beside each library as ``<library>.log``."""
    todo = {name: library_path(name) for name in names}
    seconds = {name: 0.0 for name, target in todo.items() if target.is_file()}
    compilers = {name: _compiler(SOURCES[name].compiler) for name in todo if name not in seconds}
    started = {}
    for name, compiler in compilers.items():
        source, target = SOURCES[name], todo[name]
        target.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
        os.close(fd)
        cmd = [compiler, *source.flags, "-o", tmp, str(source.path)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, time.perf_counter())
    failures = []
    for name, (proc, tmp, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        source = SOURCES[name]
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{source.compiler} failed on {source.path.name} "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        todo[name].with_suffix(".so.log").write_text(log)
        os.replace(tmp, todo[name])
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
