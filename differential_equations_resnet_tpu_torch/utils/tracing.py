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

No span is opened inside what a CUDA graph captures: the graph holds
kernels only.  The streaming producer thread's batch assembly and staging
are not traced: `torch.profiler` records ranges on the thread that opened
the window, so a range opened on the producer thread is not recorded.  The
producer shows through ``deqres.feed.wait`` on the dispatch side.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A `record_function` range named ``name`` where the profiler is on
    for this thread, else a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF
