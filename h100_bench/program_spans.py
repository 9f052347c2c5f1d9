"""Readings of the program's own spans: the `record_function` ranges named
`mspl.*` that `mspl_tpu_torch/utils/profiling.py::span` opens while a
profiler runs.  The traced run's profiler records them beside the device
operations on one clock, so a device-idle stretch of the window can be put
down to the host phase it falls in.

A program without such spans (a commit before them) gives every reading
None, and its metrics are left out of the line.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from h100_bench.trace import TraceView

Intervals = List[Tuple[float, float]]


def _merged(iv: Iterable[Tuple[float, float]]) -> Intervals:
    out: Intervals = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def _measure(iv: Intervals) -> float:
    return sum(b - a for a, b in iv)


def _spans(view: TraceView, prefixes: Sequence[str]) -> Intervals:
    """The union over every thread of the host intervals of events whose
    names start with one of `prefixes`, clipped to the window."""
    lo, hi = view.window
    want = tuple(prefixes)
    return _merged((max(a, lo), min(b, hi)) for n, a, b, _ in view.cpu
                   if n.startswith(want))


def _idle(view: TraceView) -> Intervals:
    """The window less the union of its device intervals, each clipped to
    the window (as `TraceView.busy_us` takes them)."""
    lo, hi = view.window
    busy = _merged((max(a, lo), min(b, hi)) for _, a, b, _ in view.dev)
    out, end = [], lo
    for a, b in busy:
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if hi > end:
        out.append((end, hi))
    return out


def _overlap(x: Intervals, y: Intervals) -> float:
    """The measure of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            total += b - a
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_us(view: TraceView, prefixes: Sequence[str]) -> Optional[float]:
    """Host us in the union of the spans named by `prefixes`; None where
    the window holds none."""
    spans = _spans(view, prefixes)
    return _measure(spans) if spans else None


def idle_us_in(view: TraceView, prefixes: Sequence[str]
               ) -> Optional[float]:
    """Device-idle us of the window that lies inside the union of the
    spans named by `prefixes`; None where the window holds none of them or
    no device operation."""
    spans = _spans(view, prefixes)
    if not spans or not view.dev or view.window_us <= 0:
        return None
    return _overlap(_idle(view), spans)
