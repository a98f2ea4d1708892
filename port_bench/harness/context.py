"""What a driver gets for one run: the seed, the window, the spans, the
traced stretch, and the record of what the run compared."""

from __future__ import annotations

import hashlib
import time

from .trace import Spans, Trace


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed (the weights, clip 7's
    inputs, ...), the same for the same seed and tags."""
    text = ":".join([str(int(seed))] + [str(t) for t in tags])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


class Readings:
    """The raw material of the per-layer metrics of one traced run."""

    def __init__(self, config, traffic):
        self.config, self.traffic = config, traffic
        self.spans = {}         # name -> [ms, ...] over the window
        self.trace = None       # TraceSummary of the traced stretch
        self.traced_units = 0
        self.captures = {}      # what the driver's wrappers kept
        self.units = 0
        self.window_s = None
        self.memo = {}          # shared by readers (walk counts, FLOPs)

    def unit_s(self):
        """Mean host seconds of the window's units (the traced ones come
        after the window), or None."""
        return self.window_s / self.units if self.units else None


class Run:
    def __init__(self, torch, device, *, seed, seconds, trace, config,
                 traffic, cell, t_start):
        self.torch, self.device = torch, device
        self.cuda = device.type == "cuda"
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.config, self.traffic, self.cell = config, traffic, cell
        self.t_start = t_start
        self.spans = Spans(torch, self.cuda, lambda: self.tracer is not None)
        self.spans.enabled = trace
        self.readings = Readings(config, traffic)
        self.checks = []        # (name, value, limit)
        self.setup_s = None
        self.tracer = None
        self.device_info = None

    def note(self, what: str) -> None:
        """A line on standard error: seconds since the process began, and
        what was just done (the set-up's parts)."""
        import sys
        print(f"[{time.perf_counter() - self.t_start:.3f} s] {what}",
              file=sys.stderr, flush=True)

    def seed_for(self, *tags) -> int:
        return sub_seed(self.seed, *tags)

    def generator(self, *tags):
        return self.torch.Generator(device=self.device).manual_seed(
            self.seed_for(*tags))

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def window(self, unit, traced=1):
        """Run ``unit(i)`` for i = 0, 1, ... from now until the first unit
        that ends at or after ``seconds``; returns (units, window_s).
        Set-up ends here. With tracing on, ``traced`` more units run
        after the window under the profiler, which slows them and leaves
        the window's own units untouched; the traffic's
        ``trace_host_ops`` (default true) says whether it records the
        host's operators too."""
        self.sync()
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_start
        n = 0
        while True:
            unit(n)
            n += 1
            if time.perf_counter() - t0 >= self.seconds:
                break
        self.sync()
        window_s = time.perf_counter() - t0
        self.readings.units, self.readings.window_s = n, window_s
        self.readings.spans = self.spans.ms()
        if self.trace:
            self.tracer = Trace(self.torch, self.cuda,
                                self.traffic.get("trace_host_ops", True)
                                ).__enter__()
            for i in range(n, n + traced):
                unit(i)
            self.note(f"{traced} traced units")
            done, self.tracer = self.tracer, None
            done.__exit__(None, None, None)
            self.note("profiler stopped")
            self.readings.traced_units = traced
            self.readings.trace = done.reduce()
            self.note(f"trace reduced: {len(done.events)} device and host "
                      f"events")
        return n, window_s

    @property
    def tracing(self) -> bool:
        """Whether the profiler is on now (the drivers' wrappers keep
        their captures to the traced units)."""
        return self.tracer is not None

    def close_program(self) -> None:
        """Record the card's state at the end of the program's part (the
        memory peak), then free the device memory the program held."""
        import gc
        from . import device as dev
        if self.cuda:
            self.device_info = dev.describe(self.torch,
                                            self.cell["chips"])
        gc.collect()
        if self.cuda:
            self.torch.cuda.synchronize()
            self.torch.cuda.empty_cache()

    def compare(self, name: str, value: float, limit: float) -> bool:
        """Record one number compared with its limit; True if within."""
        self.checks.append((name, float(value), float(limit)))
        return value <= limit
