"""The device's idle share of the window: 100 x (1 - the seconds per
unit in which some operation ran on the card, from the profiler's trace
of the traced units, / the untraced window's mean unit time). The
profiler slows the traced units' host side, so their own host time would
count its overhead as idle; their device time it leaves as it is."""

LAYER = "device"
MOVES = "gs_step_ms"


def read(r):
    if r.trace is None or not r.trace.busy_s or not r.traced_units:
        return None
    seconds = r.unit_s()
    if not seconds:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.traced_units / seconds)
