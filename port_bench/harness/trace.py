"""Spans from the benchmark's own files and the profiler's trace.

``Spans`` puts CUDA events (host clocks on the CPU) around the calls a
driver makes or wraps; ``Trace`` holds ``torch.profiler`` over a stretch
of the window and reduces its events: device busy time, kernel time by
name, kernel durations in launch order, and the idle gaps between device
operations labelled by what the host was running when each began.
"""

from __future__ import annotations

import collections
import contextlib
import heapq
import time

TOP = 10


class _HostEvent:
    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Spans:
    """Named spans of device (or host) milliseconds. A span is labelled
    in the profiler's trace whenever the profiler is on, and timed only
    outside the traced stretch (whose units the profiler slows)."""

    def __init__(self, torch, cuda: bool, tracing):
        self.torch, self.cuda = torch, cuda
        self.tracing = tracing
        self.pairs = collections.defaultdict(list)
        self.enabled = True

    def event(self):
        ev = (self.torch.cuda.Event(enable_timing=True) if self.cuda
              else _HostEvent())
        ev.record()
        return ev

    def label(self, name: str):
        """The span's label in the trace while the profiler is on."""
        if self.tracing():
            return self.torch.profiler.record_function("bench:" + name)
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled or self.tracing():
            with self.label(name):
                yield
            return
        start = self.event()
        yield
        self.pairs[name].append((start, self.event()))

    def add(self, name: str, start, end) -> None:
        if self.enabled and not self.tracing():
            self.pairs[name].append((start, end))

    def ms(self) -> dict:
        """{name: [ms, ...]}; synchronises the device first."""
        if self.cuda:
            self.torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v]
                for k, v in self.pairs.items()}


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """``torch.profiler`` over the ``with`` block; ``window_s`` is the
    block's host time between two device synchronisations. Without
    ``host_ops`` the profiler records the device and the CUDA runtime
    calls only, not the host's operators and the benchmark's labels: a
    tenth of the events where a unit launches ~10^5 kernels, and the
    idle gaps are then labelled by the runtime call alone."""

    def __init__(self, torch, cuda: bool, host_ops: bool = True):
        self.torch, self.cuda = torch, cuda
        acts = ([torch.profiler.ProfilerActivity.CPU]
                if host_ops or not cuda else [])
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.window_s = None

    def _sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(*exc)
        return False

    def reduce(self) -> "TraceSummary":
        """Device operations (kernels, copies, fills; not the device
        side of the benchmark's own labels) and host operations."""
        from torch.autograd import DeviceType
        cpu = DeviceType.CPU
        device, host = [], []
        self.events = self.prof.profiler.kineto_results.events()
        for e in self.events:
            start, name = e.start_ns(), e.name()
            item = (start, start + e.duration_ns(), name)
            if e.device_type() == cpu:
                host.append(item)
            elif not name.startswith("bench:"):
                device.append(item)
        return TraceSummary(device, host, self.window_s)


class TraceSummary:
    def __init__(self, device, host, window_s):
        self.device = sorted(device)
        self.window_s = window_s
        merged = _merge([(s, e) for s, e, _ in self.device])
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        by_name = collections.Counter()
        for s, e, name in self.device:
            by_name[name] += (e - s) * 1e-9
        self.by_name = by_name
        gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1])
                for i in range(len(merged) - 1)]
        self.idle_gaps = self._label(gaps, host)

    def durations(self, match) -> list:
        """Seconds of each device operation whose name ``match`` accepts,
        in launch order."""
        return [(e - s) * 1e-9 for s, e, name in self.device if match(name)]

    def device_ops(self) -> list:
        return [[name[:200], secs] for name, secs in
                self.by_name.most_common(TOP)]

    @staticmethod
    def _label(gaps, host) -> list:
        """Total idle seconds by the host activity at each gap's start:
        the innermost benchmark span and the innermost host operation
        that were running then."""
        host = sorted(host)
        spans = [h for h in host if h[2].startswith("bench:")]
        ops = [h for h in host if not h[2].startswith("bench:")]
        totals = collections.Counter()

        def innermost(events):
            heap, i = [], 0

            def at(t):
                nonlocal i
                while i < len(events) and events[i][0] <= t:
                    heapq.heappush(heap, (-events[i][0], events[i][1],
                                          events[i][2]))
                    i += 1
                while heap and heap[0][1] < t:
                    heapq.heappop(heap)
                return heap[0][2] if heap else "python"
            return at

        span_at, op_at = innermost(spans), innermost(ops)
        for length, t in sorted(gaps, key=lambda g: g[1]):
            totals[f"{span_at(t)}/{op_at(t)}"[:200]] += length * 1e-9
        return [[name, secs] for name, secs in totals.most_common(TOP)]
