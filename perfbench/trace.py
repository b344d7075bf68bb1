"""The profiler window and its arithmetic.

`traced` runs a callable under `torch.profiler` (CPU and CUDA activities)
and returns a `Trace`: the device operations' intervals, the host spans the
benchmark opened with `torch.profiler.record_function`, and the host
operations that label idle gaps.  The arithmetic is a frozen copy of
``chip_smoke.py::profile_window``: device busy time is the union of the
device operations' intervals (annotations left out), and the window is the
sum of the host ranges of the benchmark's window spans, each of which ends
in a synchronize.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Interval = Tuple[float, float]  # (start, end) in microseconds

# Idle gaps shorter than this are summed under one label and not placed.
SHORT_GAP_US = 10.0


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of intervals, as sorted disjoint intervals."""
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def covered(merged: Sequence[Interval], start: float, end: float) -> float:
    """The length of [start, end] that the disjoint sorted ``merged``
    intervals cover."""
    i = bisect.bisect_right(merged, (start, float("inf"))) - 1
    i = max(i, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < end:
        s, e = merged[i]
        total += max(0.0, min(e, end) - max(s, start))
        i += 1
    return total


class Trace:
    """What one profiled window recorded."""

    def __init__(self, device_ops: List[Tuple[str, float, float]],
                 spans: Dict[str, List[Interval]],
                 host_ops: List[Tuple[str, float, float]], window_label: str):
        self.device_ops = device_ops              # (name, start, end), device activity
        self.spans = spans                        # the benchmark's record_function ranges
        self.host_ops = sorted(host_ops, key=lambda e: e[1])
        self.window_label = window_label
        self.busy_intervals = union([(s, e) for _, s, e in device_ops])

    @property
    def windows(self) -> List[Interval]:
        return self.spans.get(self.window_label, [])

    @property
    def window_us(self) -> float:
        return sum(e - s for s, e in self.windows)

    @property
    def busy_us(self) -> float:
        return sum(covered(self.busy_intervals, s, e) for s, e in self.windows)

    def ops_within_window(self) -> int:
        return sum(1 for _, s, _ in self.device_ops
                   if any(ws <= s < we for ws, we in self.windows))

    def device_time_us(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """(summed device time, count) of the device operations whose name
        ``match`` accepts."""
        total, count = 0.0, 0
        for name, s, e in self.device_ops:
            if match(name):
                total += e - s
                count += 1
        return total, count

    def top_device_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations (by name) with the most time, in
        seconds."""
        sums: Dict[str, float] = collections.defaultdict(float)
        for name, s, e in self.device_ops:
            sums[name] += e - s
        top = sorted(sums.items(), key=lambda kv: kv[1], reverse=True)[:n]
        return [[name[:160], us / 1e6] for name, us in top]

    def _host_label(self, t: float) -> str:
        """The innermost host operation or span running at time ``t``: the
        latest-starting one that covers it."""
        starts = self._host_starts
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 200, -1), -1):
            name, s, e = self.host_ops[j]
            if e >= t:
                return name
        return "(no host operation)"

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time inside the window, in seconds, summed by what the host
        was doing at the middle of each gap; gaps under `SHORT_GAP_US`
        summed apart.  The ``n`` largest sums."""
        self._host_starts = [s for _, s, _ in self.host_ops]
        sums: Dict[str, float] = collections.defaultdict(float)
        for ws, we in self.windows:
            reach = ws
            for s, e in self.busy_intervals:
                if e <= ws or s >= we:
                    continue
                s, e = max(s, ws), min(e, we)
                if s > reach:
                    self._add_gap(sums, reach, s)
                reach = max(reach, e)
            if we > reach:
                self._add_gap(sums, reach, we)
        top = sorted(sums.items(), key=lambda kv: kv[1], reverse=True)[:n]
        return [[name[:160], us / 1e6] for name, us in top]

    def _add_gap(self, sums, start: float, end: float) -> None:
        if end - start < SHORT_GAP_US:
            sums[f"(gaps under {SHORT_GAP_US:g} us)"] += end - start
        else:
            sums[self._host_label((start + end) / 2)] += end - start


@contextlib.contextmanager
def span(label: str, on: bool):
    """A `record_function` range named ``label`` where ``on``, else
    nothing."""
    if not on:
        yield
        return
    with torch.profiler.record_function(label):
        yield


def traced(run: Callable[[], None], window_label: str,
           span_labels: Sequence[str] = ()) -> Trace:
    """``run()`` under `torch.profiler`; ``run`` opens a ``window_label``
    span around each part of the window (each ending in a synchronize) and
    may open spans named in ``span_labels``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    labels = {window_label, *span_labels}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    device_ops, host_ops = [], []
    spans: Dict[str, List[Interval]] = collections.defaultdict(list)
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # record_function ranges, which Kineto also puts on the device timeline
            if e.name in labels or getattr(e, "is_user_annotation", False):
                continue
            device_ops.append((e.name, start, end))
        elif e.name in labels:
            spans[e.name].append((start, end))
        else:
            host_ops.append((e.name, start, end))
    for label in labels:  # the labels themselves name what the host did
        host_ops.extend((label, s, e) for s, e in spans.get(label, []))
    return Trace(device_ops, dict(spans), host_ops, window_label)


def device_block(trace: Optional[Trace]) -> dict:
    """The ``device`` keys a traced run adds: busy and window seconds."""
    if trace is None:
        return {}
    return {"busy_s": trace.busy_us / 1e6, "window_s": trace.window_us / 1e6}
