"""Named host ranges at the port's layer boundaries, for `torch.profiler`.

``with span("deqres.step"): ...`` opens a `torch.profiler.record_function`
range only while a profiler window is open on the calling thread
(`torch.autograd._profiler_enabled`); otherwise it enters a shared no-op
context and creates no profiler op, generator or object.  Tracing is
therefore on exactly while a `torch.profiler.profile` window is open: any
window an operator opens, ``Training.train(profile_dir=...)``, or the CLI's
``benchmark --profile-dir``.  The ranges share the profiler's clock with
the CUDA device trace and appear by name in its chrome trace.

The spans (fixed names; a span's parent is the span that encloses it on
the same thread):

``deqres.epoch.begin``
    An epoch's host work before its first step: on the device-resident
    path the rates list and the generator (`Training`), then the rates
    tensor and the shuffle (`make_device_epoch`), two ranges an epoch; on
    the streaming path the producer thread's start.
``deqres.step``
    One train step's host work, in the loops of `make_device_epoch`,
    `make_multi_step` and `Training`'s streaming epoch: the gather, cast
    and augmentation or the host-to-device copy, the step, the copy of its
    telemetry row.  It leaves out the wait for the feed.
``deqres.feed.wait``
    The streaming epoch's dispatch loop blocked on the producer's queue,
    one range a ``get``.
``deqres.replay``
    A captured CUDA graph's static-input copies and ``graph.replay()``:
    a train step, an eval or predict batch, a serving forward.
``deqres.capture``
    The warm-up calls and the capture of a new graph (a new input shape).
``deqres.epoch.log``
    `Training`'s end of an epoch: the telemetry rows' copy to the host,
    the CSV rows and the summary scalars.
``deqres.predict.h2d``, ``deqres.predict.d2h``
    A served request's conversion and copy to the device, and the wait for
    its answer with the copy back to NumPy (`utils.serving.load_exported`).

The fused stacks (`STACKS`, a `StackRecord`): every call of a fused Euler
stack's kernel, B1 or B2 (`ops.kernels.fused_integrator`), appends one
`StackEntry` (the kernel, (H, W, C, L), the variant, bands an image, the
launches the call made), in launch order: a call run eagerly to
``STACKS.eager`` (the latest `EAGER_CALLS`), a call recorded into a CUDA
graph to that graph's list in ``STACKS.graphs``, which `train.train_step`
opens at each capture under the graph's name ("train step", "eval batch",
...).  A replay adds nothing: ``STACKS.graph("train step")`` lists what
each replay of the last captured train step launches, so a reader of a
device trace can tell which stack each kernel of a replayed window ran.
The plain CPU path records its calls too, as variant "plain" with no
launch.

No span is opened inside what a CUDA graph captures: the graph holds
kernels only.  The streaming producer thread's batch assembly and staging
are not traced: `torch.profiler` records ranges on the thread that opened
the window, so a range opened on the producer thread is not recorded.  The
producer shows through ``deqres.feed.wait`` on the dispatch side.
"""

from __future__ import annotations

import collections
import contextlib
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.autograd.profiler import record_function

_OFF = contextlib.nullcontext()
# Eager fused-stack calls the record keeps, the latest.
EAGER_CALLS = 4096


def span(name: str):
    """A `record_function` range named ``name`` where the profiler is on
    for this thread, else a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF


class StackEntry(NamedTuple):
    """One call of a fused Euler stack's kernel."""

    kernel: str                       # "B1" (forward) or "B2" (backward)
    shape: Tuple[int, int, int, int]  # (H, W, C, L)
    variant: str                      # "band", "wide", or "plain" (the CPU's)
    bands: int                        # bands an image of the band variant, else 0
    launches: int                     # kernel launches made or captured


class StackRecord:
    """The fused-stack calls of the process, grouped by capture (the
    module's docstring)."""

    def __init__(self):
        self.eager = collections.deque(maxlen=EAGER_CALLS)
        self.graphs: List[Tuple[Optional[str], List[StackEntry]]] = []
        self._open: Optional[List[StackEntry]] = None

    def add(self, entry: StackEntry, captured: bool) -> None:
        """``entry`` to the graph being captured where ``captured`` (to an
        unnamed graph where the capture was not opened by `capture`), else
        to the eager calls."""
        if not captured:
            self.eager.append(entry)
            return
        if self._open is None:
            self.graphs.append((None, []))
            self._open = self.graphs[-1][1]
        self._open.append(entry)

    @contextlib.contextmanager
    def capture(self, what: str):
        """The calls captured inside, as the graph named ``what``."""
        self.graphs.append((what, []))
        self._open = self.graphs[-1][1]
        try:
            yield
        finally:
            self._open = None

    def graph(self, what: str) -> Optional[List[StackEntry]]:
        """The calls of the last graph captured as ``what``, or None."""
        for name, entries in reversed(self.graphs):
            if name == what:
                return entries
        return None

    def clear(self) -> None:
        self.eager.clear()
        self.graphs.clear()
        self._open = None


STACKS = StackRecord()
