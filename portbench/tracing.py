"""The traced stretch of a `--trace 1` run: torch.profiler (CPU and CUDA
activity) over a run of blocks inside the window, read back from its Chrome
trace into device events, the benchmark's own host spans, and the device's
busy time.

The harness names what the host does with spans of its own
(record_function): portbench/source around each call into the source,
portbench/on_frame and portbench/on_plot around the callbacks,
portbench/snapshot around the check's state copies, portbench/traced around
the whole stretch. Everything else the host does inside the stretch is the
session's (Session.run or MultiSession.run)."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def span(name: str, on: bool):
    """A host span in the trace (a no-op outside a traced run)."""
    if not on:
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


class Profiled:
    """Starts and stops torch.profiler around a stretch of blocks."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._rf = None
        self.blocks = 0

    def warm_up(self):
        """One short profile, so that the traced stretch's start does not pay
        the profiler's first initialisation."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            (self._torch.zeros(1, device="cuda") + 1).sum().item()

    def start(self):
        self._torch.cuda.synchronize()
        self.prof.start()
        # the trace keeps the device events it times inside its window
        time.sleep(0.02)
        self._rf = self._torch.profiler.record_function("portbench/traced")
        self._rf.__enter__()

    def stop(self):
        self._torch.cuda.synchronize()
        self._rf.__exit__(None, None, None)
        time.sleep(0.02)
        self.prof.stop()

    def read(self) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return Trace(events)


class Trace:
    """Device events, host spans and the stretch's bounds, in microseconds."""

    def __init__(self, events: list):
        self.device = []  # (name, cat, start, end)
        self.spans = []  # (name, start, end) the benchmark's own, and cpu ops
        t0 = t1 = None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            cat, name = e.get("cat", ""), e.get("name", "")
            if cat in DEVICE_CATS:
                self.device.append((name, cat, start, end))
            elif name == "portbench/traced":
                t0, t1 = start, end
            elif cat in ("user_annotation", "cpu_op", "cuda_runtime"):
                self.spans.append((name, start, end))
        if t0 is None:
            raise RuntimeError("the trace holds no portbench/traced span")
        self.t0, self.t1 = t0, t1
        self.device = [(n, c, max(s, t0), min(e, t1)) for n, c, s, e in self.device
                       if e > t0 and s < t1]
        self.device.sort(key=lambda d: d[2])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        merged = []
        for _, _, s, e in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_us(self, cats=DEVICE_CATS, name_has: str = "") -> tuple[float, int]:
        """(device microseconds, events) of the events of these categories
        whose name holds name_has."""
        ev = [e - s for n, c, s, e in self.device if c in cats and name_has in n]
        return sum(ev), len(ev)

    def top_device_ops(self, k: int = 10) -> list:
        by = {}
        for n, _, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s) * 1e-6
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle time in the stretch, summed by what the host was
        doing at each gap's middle: the innermost benchmark span, else the
        innermost host operation of the session, else the session's Python."""
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [s[1] for s in spans]
        edges = [self.t0]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.t1)
        by = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid)
            # the spans open at mid, latest first (a host span is short next
            # to the stretch, so the last few hundred to start hold them)
            cover = [(s, name) for name, s, e in spans[max(i - 500, 0):i] if e >= mid]
            mine = [c for c in cover if c[1].startswith("portbench/")]
            if mine:
                label = max(mine)[1]
            elif cover:
                label = "session: " + max(cover)[1]
            else:
                label = "session: python"
            by[label] = by.get(label, 0.0) + (b - a) * 1e-6
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]
