"""Per-step device times of the program's own spans (``telemetry``) in
a traced SDS run: the driver keeps the window's ``snapshot()`` in
``captures["telemetry"]``, with device events on; ``sds.step`` is the
unit."""

from __future__ import annotations


def per_step(r, name: str):
    """Device ms a step of the spans ``name`` (all of them in a step,
    summed), or None where the program has no such span or no device
    events were recorded."""
    snap = r.captures.get("telemetry")
    if not snap:
        return None
    spans = snap["spans"]
    steps = spans.get("sds.step", {}).get("count")
    ms = spans.get(name, {}).get("device_ms")
    if not steps or ms is None:
        return None
    return ms / steps
