"""The traced run's instruments: a span around the fine-tuned model's
forward, opened by forward hooks that the benchmark registers on it (the
program's own `mspl.*` spans mark the rest), a bounded `torch.profiler`
window inside the measured window, and the reading of its events, kept in
memory.

Device time under a span is the time of the device operations whose launch
(the runtime call that shares the operation's correlation id) fell inside
one of the span's host intervals on the same thread.  Busy time is the
union of kernel, copy and set intervals inside the profiled window.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType
from torch.autograd.profiler import record_function

WINDOW = "h100_bench.window"
PREFIX = "h100_bench."


class Spans:
    """`record_function` ranges opened by a module's forward pre-hook and
    closed by its forward hook."""

    def __init__(self):
        self.handles = []

    def wrap(self, module: torch.nn.Module, name: str) -> None:
        stack = []

        def pre(mod, args):
            rf = record_function(PREFIX + name)
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out):
            stack.pop().__exit__(None, None, None)

        self.handles += [module.register_forward_pre_hook(pre),
                         module.register_forward_hook(post)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


class Profiled:
    """A `torch.profiler` window: `start()`, the work, `stop()` -> the
    events' reading.  Both ends wait for the device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.rf = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.rf = record_function(WINDOW)
        self.rf.__enter__()

    def stop(self) -> "TraceView":
        self._sync()
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        view = TraceView(self.prof.events())
        self.prof = None
        print(f"trace: {len(view.dev)} device operations, {len(view.launch)}"
              f" launches, window {view.window_us / 1e3:.3f} ms, busy "
              f"{view.busy_us() / 1e3:.3f} ms, kernels "
              f"{view.kernels_us() / 1e3:.3f} ms", flush=True)
        return view


def _is_kernel(name: str) -> bool:
    """A kernel, not a copy or a set (`Memcpy ...`, `Memset ...`)."""
    return not name.startswith("Mem")


def kernel_base(name: str) -> str:
    """`void ns::(anonymous namespace)::name<T, 4>(Args)` -> `name`."""
    s = name.replace("(anonymous namespace)::", "")
    s = s.split("<")[0].split("(")[0].strip()
    return (s.split()[-1] if s else name).split("::")[-1] or name


def _union(intervals: Iterable[Tuple[float, float]]) -> float:
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


class TraceView:
    """The profiled window's events, in microseconds."""

    def __init__(self, events):
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        cpu_names = {e.name for e in cpu}
        self.cpu = [(e.name, e.time_range.start, e.time_range.end, e.thread)
                    for e in cpu]
        # device events that project a host range (user annotations) carry
        # the range's name; kernels, copies and sets never share one
        self.dev = [(e.name, e.time_range.start, e.time_range.end, e.id)
                    for e in events if e.device_type == DeviceType.CUDA
                    and e.name not in cpu_names
                    and not getattr(e, "is_user_annotation", False)]
        self.launch = {e.id: (e.time_range.start, e.thread) for e in cpu
                       if e.name.startswith("cu")}
        win = [(a, b) for n, a, b, _ in self.cpu if n == WINDOW]
        self.window = win[0] if win else (0.0, 0.0)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def _clipped(self):
        lo, hi = self.window
        for name, a, b, cid in self.dev:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                yield name, a, b, cid

    def busy_us(self) -> float:
        return _union((a, b) for _, a, b, _ in self._clipped())

    def kernel_us(self, bases: Sequence[str]) -> Tuple[float, int]:
        """Total device time and count of the kernels named `bases`."""
        want = set(bases)
        hits = [b - a for n, a, b, _ in self.dev if kernel_base(n) in want]
        return sum(hits), len(hits)

    def kernels_us(self) -> float:
        """Device time of every kernel (copies and sets left out)."""
        return sum(b - a for n, a, b, _ in self.dev if _is_kernel(n))

    def _intervals(self, match) -> Dict[int, List[Tuple[float, float]]]:
        """Per thread, the merged host intervals of events that `match`."""
        by_thread = defaultdict(list)
        for name, a, b, t in self.cpu:
            if match(name):
                by_thread[t].append((a, b))
        merged = {}
        for t, iv in by_thread.items():
            out = []
            for a, b in sorted(iv):
                if out and a <= out[-1][1]:
                    out[-1] = (out[-1][0], max(out[-1][1], b))
                else:
                    out.append((a, b))
            merged[t] = out
        return merged

    def device_us_under(self, match, kernels_only: bool = False) -> float:
        """Device time launched inside host events whose name `match`es
        (with `kernels_only`, of kernels alone, as `kernels_us` takes
        them).  A CUDA graph's replayed kernels share the correlation id
        of their `cudaGraphLaunch`, so they fall under the span that holds
        the launch."""
        spans = self._intervals(match)
        starts = {t: [a for a, _ in iv] for t, iv in spans.items()}
        total = 0.0
        for name, a, b, cid in self.dev:
            if kernels_only and not _is_kernel(name):
                continue
            hit = self.launch.get(cid)
            if hit is None or hit[1] not in spans:
                continue
            t0, thread = hit
            i = bisect.bisect_right(starts[thread], t0) - 1
            if i >= 0 and spans[thread][i][1] >= t0:
                total += b - a
        return total

    def host_us(self, name: str) -> float:
        """Host time in events named `name`, outermost only."""
        iv = sorted((a, b) for n, a, b, _ in self.cpu if n == name)
        return _union(iv)

    def top_device_ops(self, n: int = 10) -> List[List]:
        agg = Counter()
        for name, a, b, _ in self._clipped():
            agg[kernel_base(name) if not name.startswith("Mem")
                else name] += (b - a) / 1e6
        return [[k, v] for k, v in agg.most_common(n)]

    def idle_gaps(self, n: int = 10, min_us: float = 50.0) -> List[List]:
        """The `n` longest idle gaps, each named by the host operations
        that overlap it most."""
        lo, hi = self.window
        iv = sorted((a, b) for _, a, b, _ in self._clipped())
        gaps, end = [], lo
        for a, b in iv:
            if a - end > min_us:
                gaps.append((end, a))
            end = max(end, b)
        if hi - end > min_us:
            gaps.append((end, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        host = [(nm, a, b) for nm, a, b, _ in self.cpu
                if not nm.startswith(PREFIX)]
        out = []
        for a, b in gaps[:n]:
            over = Counter()
            for nm, x, y in host:
                ov = min(y, b) - max(x, a)
                if ov > 0:
                    over[nm[:60]] += ov
            label = " + ".join(k for k, _ in over.most_common(2)) or "python"
            out.append([label, (b - a) / 1e6])
        return out


def breakdown(view: Optional[TraceView]) -> Optional[Dict]:
    if view is None:
        return None
    return {"device_ops": view.top_device_ops(),
            "idle_gaps": view.idle_gaps()}
