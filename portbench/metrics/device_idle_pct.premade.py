"""device_idle_pct.premade (%, layer: device). The share of the traced
stretch's wall time in which no kernel, copy or memset ran on the card,
from the profiler's device events; it should fall as ingest_msps rises."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
