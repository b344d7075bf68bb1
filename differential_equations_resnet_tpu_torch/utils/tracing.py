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

The hand-kernel calls (`STACKS`, a `StackRecord`), the port's only count
of kernel launches: every call of a hand-written kernel, B1 or B2 of a
fused Euler stack (`ops.kernels.fused_integrator`) or batch norm's
forward or backward ("BN", `ops.kernels.batch_norm`), reports one
`StackEntry` (the kernel, its shape, the variant, bands an image, the
launches the call made), in launch order: a call run eagerly to
``STACKS.eager`` (the latest `EAGER_CALLS`) and at once to the totals, a
call recorded into a CUDA graph to that graph's list in ``STACKS.graphs``,
which `train.train_step` opens at each capture under the graph's name
("train step", "eval batch", ...).  ``STACKS.capture(what)`` gives back
the graph (a `CapturedGraph`), whose totals by (kernel, variant) are
summed once when the capture ends; ``STACKS.replay(graph)`` adds them to
the record's, one add a key, so the totals count each replay's launches
and never the capture's.  ``STACKS.graph("train step")`` lists what each
replay of the last captured train step launches, so a reader of a device
trace can tell which stack each kernel of a replayed window ran.
``STACKS.calls(kernel, variant=None)`` and ``STACKS.launches(kernel,
variant=None)`` read the totals (over every variant where ``variant`` is
None), ``STACKS.reset()`` sets them to 0 and ``STACKS.clear()`` empties
the whole record.  The plain CPU path records its B1/B2 calls too, as
variant "plain" with no launch.  An identity stack that the single-block
model runs layer by layer without batch norm (its "per_layer" route on
one rank) reports one entry too, on any device, where its forward runs:
kernel "per_layer", its (H, W, C, L), variant its form ("direct", "s2d"
or "int8", `models.single_block_resnet.per_layer_form`), bands 0 and
launches 0 (its cuDNN convs are not counted).  So a captured step's list
holds every identity stack of the forward, in order, with its route.

No span is opened inside what a CUDA graph captures: the graph holds
kernels only.  The streaming producer thread's batch assembly and staging
are not traced: `torch.profiler` records ranges on the thread that opened
the window, so a range opened on the producer thread is not recorded.  The
producer shows through ``deqres.feed.wait`` on the dispatch side.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

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
    """One call of a hand-written kernel, or one identity stack run layer by
    layer."""

    kernel: str             # "B1" (forward), "B2" (backward), "BN" (batch norm) or
                            # "per_layer" (an identity stack run layer by layer)
    shape: Tuple[int, ...]  # (H, W, C, L) of B1/B2 and per_layer; batch norm's x shape
    variant: str            # "band", "wide", "plain" (the CPU's); BN's "forward", "backward",
                            # or either with "+relu" / "+add_relu", the epilogue the kernels ran;
                            # per_layer's form, "direct", "s2d" or "int8"
    bands: int              # bands an image of the band variant, else 0
    launches: int           # kernel launches made or captured


def _totals(entries) -> Tuple[Tuple[Tuple[str, str], int, int], ...]:
    """((kernel, variant), calls, launches) of ``entries``, by key."""
    totals: Dict[Tuple[str, str], List[int]] = {}
    for e in entries:
        total = totals.setdefault((e.kernel, e.variant), [0, 0])
        total[0] += 1
        total[1] += e.launches
    return tuple((key, calls, launches) for key, (calls, launches) in totals.items())


class CapturedGraph:
    """A graph captured under `StackRecord.capture`: its entries, and once
    the capture has ended their totals (`_totals`), which each replay adds."""

    def __init__(self):
        self.entries: List[StackEntry] = []
        self.totals = ()


class StackRecord:
    """The hand-kernel calls of the process, grouped by capture, and their
    totals (the module's docstring)."""

    def __init__(self):
        self.eager = collections.deque(maxlen=EAGER_CALLS)
        self.graphs: List[Tuple[Optional[str], List[StackEntry]]] = []
        self._open: Optional[CapturedGraph] = None
        self.reset()

    def add(self, entry: StackEntry, captured: bool) -> None:
        """``entry`` to the graph being captured where ``captured`` (to an
        unnamed graph, never replayed into the totals, where the capture
        was not opened by `capture`), else to the eager calls and the
        totals."""
        if not captured:
            self.eager.append(entry)
            key = (entry.kernel, entry.variant)
            self._calls[key] += 1
            self._launches[key] += entry.launches
            return
        if self._open is None:
            self._open = CapturedGraph()
            self.graphs.append((None, self._open.entries))
        self._open.entries.append(entry)

    @contextlib.contextmanager
    def capture(self, what: str):
        """The calls captured inside, as the graph named ``what``; yields
        its `CapturedGraph`."""
        graph = self._open = CapturedGraph()
        self.graphs.append((what, graph.entries))
        try:
            yield graph
        finally:
            self._open = None
            graph.totals = _totals(graph.entries)

    def replay(self, graph: CapturedGraph) -> None:
        """One replay of ``graph``: its totals added to the record's."""
        for key, calls, launches in graph.totals:
            self._calls[key] += calls
            self._launches[key] += launches

    def graph(self, what: str) -> Optional[List[StackEntry]]:
        """The calls of the last graph captured as ``what``, or None."""
        for name, entries in reversed(self.graphs):
            if name == what:
                return entries
        return None

    def calls(self, kernel: str, variant: Optional[str] = None) -> int:
        """Calls of ``kernel`` (in ``variant``, or in any) run eagerly or
        replayed since the last `reset`."""
        return self._total(self._calls, kernel, variant)

    def launches(self, kernel: str, variant: Optional[str] = None) -> int:
        """Launches of ``kernel`` (in ``variant``, or in any) made eagerly or
        replayed since the last `reset`."""
        return self._total(self._launches, kernel, variant)

    @staticmethod
    def _total(counts, kernel, variant) -> int:
        if variant is not None:
            return counts[(kernel, variant)]
        return sum(n for (k, _), n in counts.items() if k == kernel)

    def reset(self) -> None:
        """The totals set to 0; the entries and the captured graphs' own
        totals stay."""
        self._calls = collections.Counter()
        self._launches = collections.Counter()

    def clear(self) -> None:
        """The whole record emptied: entries, graphs and totals."""
        self.eager.clear()
        self.graphs.clear()
        self._open = None
        self.reset()


STACKS = StackRecord()
