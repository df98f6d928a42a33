"""The profiler's trace of the measured window, read into device
operations, each tied to the benchmark span of the program call that
launched it.

The window runs under ``torch.profiler`` (CPU and CUDA activities) inside
a ``bench.window`` range; each program call sits in a ``bench.<call>``
range (runners/). A device operation (kernel, copy or memset) carries
the correlation id of the runtime call that launched it; that call's host
time falls inside the span of the program call that made it.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

from torch.profiler import ProfilerActivity, profile

WINDOW = "bench.window"


def profiler():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start: int  # ns, the profiler's clock
    end: int
    span: str | None  # the program call that launched it ("filter:l_discount"), None if outside any


@dataclasses.dataclass
class Trace:
    start: int  # the window's range on the host, ns
    end: int
    ops: list  # DeviceOp inside the window, by start
    spans: list  # (start, end, name) of the program calls, by start
    span_starts: list = dataclasses.field(default_factory=list)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def busy(self) -> list[tuple[int, int]]:
        """The window's device-busy intervals: the union of its operations."""
        out = []
        for op in self.ops:
            s, e = max(op.start, self.start), min(op.end, self.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_seconds(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def span_at(self, t: int) -> str | None:
        """The program call whose span holds host time ``t``, if any."""
        i = bisect.bisect_right(self.span_starts, t) - 1
        if i >= 0 and t < self.spans[i][1]:
            return self.spans[i][2]
        return None


def _is_device(e) -> bool:
    return not str(e.device_type()).endswith("CPU")


def read(prof) -> Trace:
    """The trace of a finished ``profiler()`` whose window ran in a
    ``bench.window`` range."""
    events = prof.profiler.kineto_results.events()
    window = None
    spans, launches, device = [], {}, []
    for e in events:
        name = e.name()
        if e.is_user_annotation():
            if _is_device(e) or not name.startswith("bench."):
                continue
            if name == WINDOW:
                window = (e.start_ns(), e.end_ns())
            else:
                spans.append((e.start_ns(), e.end_ns(), name[len("bench."):]))
        elif _is_device(e):
            device.append(e)
        elif name.startswith("cu"):  # a CUDA API call: cudaLaunchKernel, cudaMemcpyAsync, ...
            launches[e.correlation_id()] = e.start_ns()
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    spans.sort()
    trace = Trace(window[0], window[1], [], spans, [s for s, _, _ in spans])
    ops = []
    for e in device:
        s, d = e.start_ns(), e.duration_ns()
        if s + d <= window[0] or s >= window[1]:
            continue
        t = launches.get(e.correlation_id())
        ops.append(DeviceOp(e.name(), s, s + d, None if t is None else trace.span_at(t)))
    ops.sort(key=lambda op: op.start)
    trace.ops = ops
    return trace


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most of the window, by name, and
    the device's idle time by what the host was doing when each idle gap
    began (the program call, or "between calls")."""
    by_op = collections.Counter()
    for op in trace.ops:
        by_op[op.name] += (min(op.end, trace.end) - max(op.start, trace.start)) / 1e9
    gaps = collections.Counter()
    t = trace.start
    for s, e in trace.busy() + [(trace.end, trace.end)]:
        if s > t:
            gaps[trace.span_at(t) or "between calls"] += (s - t) / 1e9
        t = max(t, e)
    return {
        "device_ops": [[name[:160], sec] for name, sec in by_op.most_common(top)],
        "idle_gaps": [[name, sec] for name, sec in gaps.most_common(top)],
    }
