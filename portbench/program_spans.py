"""The program's own host spans in a traced stretch: the tsdr/ spans that
tempestsdr_tpu_torch/utils/profiling.py span() records inside the session's
loop (tsdr/source, tsdr/dispatch and under it tsdr/upload, tsdr/replay,
tsdr/fetch, tsdr/download, tsdr/fanout, tsdr/callback), read from the
trace's host spans (portbench/tracing.py) on the clock of its device
events.

A span's self time is its time in the stretch less the part its tsdr/
children cover: each instant of the stretch counts once, for the innermost
tsdr/ span open then. The benchmark's own spans (portbench/...) are no
tsdr/ children, so portbench/source counts in tsdr/source and
portbench/on_frame in tsdr/callback. A program without these spans (the
parent of the change that added them) reads None, not 0."""

PREFIX = "tsdr/"


def self_us(trace) -> dict:
    """Microseconds of self time by span name, each tsdr/ span clipped to
    the stretch [t0, t1] (the trace clips device events, not spans)."""
    edges = []
    for name, s, e in trace.spans:
        if not name.startswith(PREFIX):
            continue
        s, e = max(s, trace.t0), min(e, trace.t1)
        if e > s:
            # at one instant: ends first, then starts, the longer span first
            edges.append((s, 1, -e, name))
            edges.append((e, 0, 0.0, name))
    edges.sort()
    by, open_, last = {}, [], None
    for t, starts, _, name in edges:
        if open_:
            by[open_[-1]] = by.get(open_[-1], 0.0) + t - last
        last = t
        if starts:
            open_.append(name)
        else:  # the latest opened of that name: spans nest
            del open_[len(open_) - 1 - open_[::-1].index(name)]
    return by


def ms_per_block(run, name: str):
    """The self time of the spans called `name` in the stretch, in ms per
    block traced; None without a trace or without a tsdr/dispatch span."""
    if run.trace is None or not run.blocks_traced:
        return None
    by = self_us(run.trace)
    if "tsdr/dispatch" not in by:
        return None
    return by.get(name, 0.0) / 1e3 / run.blocks_traced
