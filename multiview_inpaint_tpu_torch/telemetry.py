"""Spans and counters of the port's layers.

``span(name)`` times one layer boundary, as a ``with`` block::

    with telemetry.span("render.project"):
        proj = project(...)

Off (the default) it makes one boolean check and returns a shared null
context: nothing is allocated and nothing recorded. On (``enable``) each
span records its name, its start and end on the host in Unix-epoch
nanoseconds (``time.time_ns``, the clock of ``torch.profiler``'s events,
so spans line up with a device trace), the span it opened inside, and its
unit: the sequence number of its root span, so every span of one train
step, frame or evaluation shares one number. ``enable(device_events=True)``
also records a pair of CUDA events on the current stream around each
span, which give its device time. While a ``torch.profiler`` session is
active an enabled span also enters ``torch.profiler.record_function`` of
its name, so the chrome trace shows it.

``count(name, n)`` adds to a counter whether telemetry is on or not. The
CUDA kernel wrappers count their launches as ``launch.<kernel>``
(``kernels.LAUNCHES`` is the same table keyed by kernel name); the
rasterizer counts the pairs it bins as ``render.pairs`` and the
projections it runs as plain ops, where K6 does not engage, as
``project.plain``.

``host_read`` spans mark where the host waits for the device: a read of a
device value (``.tolist()``, ``float(tensor)``) or a blocking copy to the
card. While the host waits there it queues nothing, so their host time is
what a layer's host time holds besides queueing work.

Records live in memory in a buffer of at most ``MAX_RECORDS`` spans;
spans past it are counted as dropped. ``snapshot()`` synchronises the
device once and sums the records per name; ``records()`` returns them
one by one. Spans are recorded from one thread, the one that drives the
device.

``start_profile`` and ``write_profile`` bracket a stretch of a pipeline
(``train_gs --profile_dir``, ``svd_test --profile_dir``): a
``torch.profiler`` session with the spans on, written out as
``trace.json`` (the chrome trace, which shows each span) and
``spans.json`` (``snapshot()`` and ``records()``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from collections.abc import MutableMapping

import torch

HOST_READ = "host_read"
LAUNCH = "launch."
MAX_RECORDS = 1 << 20

_NULL = contextlib.nullcontext()


class _State:
    def __init__(self):
        self.on = False
        self.device_events = False
        self.records = []       # [name, start_ns, end_ns, parent, unit, ev]
        self.stack = []         # indices of the open spans (-1: dropped)
        self.units = 0
        self.dropped = 0
        self.counters = {}


_state = _State()


class _Span:
    __slots__ = ("index", "events", "label")

    def __init__(self, name: str):
        st = _state
        if not st.stack:
            st.units += 1
        parent = st.stack[-1] if st.stack else -1
        self.events = self.label = None
        if len(st.records) >= MAX_RECORDS:
            st.dropped += 1
            self.index = -1
        else:
            self.index = len(st.records)
            st.records.append([name, 0, 0, parent, st.units, None])
        st.stack.append(self.index)
        if torch._C._autograd._profiler_enabled():
            self.label = torch.profiler.record_function(name)
        if st.device_events and self.index >= 0:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        if self.index >= 0:
            _state.records[self.index][1] = time.time_ns()
        if self.label is not None:
            self.label.__enter__()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        if self.label is not None:
            self.label.__exit__(*exc)
        st = _state
        st.stack.pop()
        if self.index >= 0:
            rec = st.records[self.index]
            rec[2] = time.time_ns()
            rec[5] = self.events
        return False


def span(name: str):
    """A ``with`` block timed as the span ``name`` while telemetry is
    on; a shared null context while it is off."""
    if not _state.on:
        return _NULL
    return _Span(name)


# The span of a host wait for the device.
host_read = functools.partial(span, HOST_READ)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (counters always count)."""
    c = _state.counters
    c[name] = c.get(name, 0) + n


def enable(device_events: bool = False) -> None:
    """Record spans from now on; with ``device_events`` also a pair of
    CUDA events around each (needs a CUDA device)."""
    if device_events and not torch.cuda.is_available():
        raise RuntimeError("device events need a CUDA device")
    _state.device_events = bool(device_events)
    _state.on = True


def disable() -> None:
    """Record no more spans (what was recorded stays until ``reset``)."""
    _state.on = False


def reset() -> None:
    """Forget every record and set every counter to zero; whether
    telemetry is on stays as it was. Call it between units, not inside
    an open span."""
    st = _state
    st.records, st.stack, st.units, st.dropped = [], [], 0, 0
    for k in st.counters:
        st.counters[k] = 0


def _device_ms(events):
    return None if events is None else events[0].elapsed_time(events[1])


def _sync():
    if _state.device_events:
        torch.cuda.synchronize()


def records() -> list:
    """The closed spans in the order they opened, each a dict: ``name``,
    ``start_ns``, ``end_ns`` (host, Unix epoch), ``parent`` (the index of
    the span it opened inside in this list, or -1), ``unit`` and
    ``device_ms`` (None without device events). Synchronises the device
    when device events are on."""
    _sync()
    out, index = [], {}
    for i, (name, start, end, parent, unit, ev) in enumerate(
            _state.records):
        if not end:
            continue
        index[i] = len(out)
        out.append({"name": name, "start_ns": start, "end_ns": end,
                    "parent": index.get(parent, -1), "unit": unit,
                    "device_ms": _device_ms(ev)})
    return out


def snapshot() -> dict:
    """Sums over the closed spans, after one device synchronisation:
    ``spans`` maps each name to ``count``, ``host_ms``, ``self_host_ms``
    (host ms less the part its child spans cover), ``read_ms`` (host ms
    of the ``host_read`` spans inside it, at any depth) and ``device_ms``
    (None without device events); also ``counters``, ``units`` (root
    spans) and ``dropped`` (spans past the buffer)."""
    recs = records()
    child_ms = [0.0] * len(recs)
    read_ms = [0.0] * len(recs)
    for r in recs:
        ms = (r["end_ns"] - r["start_ns"]) * 1e-6
        if r["parent"] >= 0:
            child_ms[r["parent"]] += ms
        if r["name"] == HOST_READ:
            p = r["parent"]
            while p >= 0:
                read_ms[p] += ms
                p = recs[p]["parent"]
    spans = {}
    for i, r in enumerate(recs):
        ms = (r["end_ns"] - r["start_ns"]) * 1e-6
        s = spans.setdefault(r["name"], {
            "count": 0, "host_ms": 0.0, "self_host_ms": 0.0,
            "read_ms": 0.0, "device_ms": None})
        s["count"] += 1
        s["host_ms"] += ms
        s["self_host_ms"] += ms - child_ms[i]
        s["read_ms"] += read_ms[i]
        if r["device_ms"] is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + r["device_ms"]
    return {"spans": spans, "counters": dict(_state.counters),
            "units": _state.units, "dropped": _state.dropped}


class _Launches(MutableMapping):
    """Kernel name -> launches: a view of the ``launch.<kernel>``
    counters, not a second count."""

    def __getitem__(self, kernel):
        return _state.counters[LAUNCH + kernel]

    def __setitem__(self, kernel, n):
        _state.counters[LAUNCH + kernel] = n

    def __delitem__(self, kernel):
        del _state.counters[LAUNCH + kernel]

    def __iter__(self):
        return (k[len(LAUNCH):] for k in list(_state.counters)
                if k.startswith(LAUNCH))

    def __len__(self):
        return sum(1 for _ in self)


LAUNCHES = _Launches()


def reset_launches() -> None:
    """Set every ``launch.<kernel>`` counter to zero."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def start_profile(device):
    """Start a ``torch.profiler`` session (CPU, and CUDA on a card) with
    the spans on from a reset, device events on a card; returns it."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    reset()
    enable(device_events=device.type == "cuda")
    prof.start()
    return prof


def write_profile(prof, profile_dir) -> str:
    """Stop ``prof`` and the spans; write ``trace.json`` and
    ``spans.json`` (``snapshot``, ``records``) under ``profile_dir`` and
    return the trace's path."""
    prof.stop()
    spans = {"snapshot": snapshot(), "records": records()}
    disable()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(os.path.join(profile_dir, "spans.json"), "w") as f:
        json.dump(spans, f)
    return path
