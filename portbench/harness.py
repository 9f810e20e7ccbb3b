"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result.

The harness makes what every feed shares: the cell's streams from the seed
(`gen/emanation.py`), every channel's receiver configuration, the window
and the recorder of frames and plots. The traffic file's `driver` names the
module that feeds the receiver through the window, `traffic/<driver>.py`,
found by name as the metric readers are. The configuration's `session`
names the module that builds the receiver, `sessions/<session>.py`
(`default.py`: `Session` for one channel, `MultiSession` for several). The
driver reads from `ctx`:

  cfg, traffic, seed, seconds, device, n (block samples), n_ch, params
  channel_pcs, channel_periods   each channel's PipelineConfig and period
  pc, period     the same, where every channel has one mode; else None
  periods, loops each channel's period of raw IQ, and its looped stream
                 (gen/emanation.py)
  window, recorder, clock, sync, t_process
  make_session(sources, timed)   the session module's make; the timed
                                 receiver goes in ctx.timed

Its `drive(ctx)` warms up, runs the timed receiver until the window ends
and returns:

  setup_s    process start to the first timed block
  t_end      the clock when the receiver was done (after a device sync)
  error      the traceback of a step that raised, or None
  attempted, failed   blocks
  metrics    the cell's end-to-end metrics
  raw_for    raw_for(channel, k) -> (block k's raw IQ, samples dropped
             before it), the bytes the receiver was given, for the check

Every parameter comes from the cell's configuration and traffic files.
"""

from __future__ import annotations

import sys
import time
import types

import numpy as np

from . import modes, tracing
from .gen import emanation as em
from .manifest import FORBIDDEN
from .reference import check as ck
from .reference.geometry import Geometry

clock = time.monotonic


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class Window:
    """The measured window, seen from the source: before each block the
    source asks it whether to go on. It starts at the first block, ends at
    the first block asked for after `seconds`, opens the check's stretches at
    times drawn from the seed (the first at block 0), takes the receiver's
    state before and after each and once after the first `from_start`
    blocks (or at the window's end, where that comes first), and starts and
    stops the traced stretch. get_state() -> each channel's state leaves."""

    def __init__(self, seconds: float, seed: int, cfg: dict, traffic: dict, trace: bool,
                 get_state):
        self.seconds = seconds
        self.m = cfg["check"]["blocks"]
        self.from_start = cfg["check"]["from_start"]
        if self.from_start < self.m:
            raise ValueError("check.from_start is shorter than a stretch")
        self.channels = cfg["channels"]
        rng = np.random.default_rng([seed, 2])
        self.open_at = sorted(rng.uniform(0.05, 0.9, size=cfg["check"]["stretches"]) * seconds)
        self.get_state = get_state
        self.stretches = []  # dict(start, blocks, before, after)
        self.open = None
        self.anchor = None  # (k, the receiver's state after its first k blocks)
        self.t0 = None
        self.k = -1
        self.blocks = 0
        self.frame_times = []  # (k, t)
        self.asked = []  # when each block was asked for
        self.trace = traffic["trace"] if trace else None
        self.prof = tracing.Profiled() if trace else None
        self.traced_from = self.traced_to = None

    @property
    def profiling(self) -> bool:
        return self.traced_from is not None and self.traced_to is None

    def _snapshot(self):
        with tracing.span("portbench/snapshot", self.profiling):
            return [[x.clone() for x in leaves] for leaves in self.get_state()]

    def _close_stretch(self, k: int):
        s = self.open
        s["blocks"] = k - s["start"]
        s["after"] = self._snapshot()
        self.stretches.append(s)
        self.open = None

    def before_block(self, k: int) -> bool:
        now = clock()
        if k == 0:
            self.t0 = now
        self.asked.append(now)
        if self.open is not None and k == self.open["start"] + self.m:
            self._close_stretch(k)
        if self.anchor is None and k == self.from_start:
            self.anchor = (k, self._snapshot())
        if now - self.t0 >= self.seconds:
            self.blocks = k
            if self.open is not None:
                self._close_stretch(k)
            if self.anchor is None:
                self.anchor = (k, self._snapshot())
            if self.profiling:
                self.traced_to = k
                self.prof.stop()
            return False
        if self.prof is not None:
            if self.traced_from is None and self.open is None and \
                    now - self.t0 >= self.trace["start_at"] * self.seconds:
                self.prof.start()
                self.traced_from = k
            elif self.profiling and "channel_blocks" in self.trace and \
                    k - self.traced_from >= -(-self.trace["channel_blocks"] // self.channels):
                self.prof.stop()
                self.traced_to = k
        if self.open is None and not self.profiling and (
                k == 0 or (self.open_at and now - self.t0 >= self.open_at[0])):
            if k:
                self.open_at.pop(0)
            self.open = dict(start=k, before=None if k == 0 else self._snapshot())
        self.k = k
        return True

    def keep(self) -> bool:
        """Whether the block under way is one the check compares."""
        return self.open is not None


class Recorder:
    """The callbacks' side: each frame's arrival and block, and the frames
    and plots of the blocks the check compares."""

    def __init__(self, window: Window):
        self.w = window
        self.frames, self.plots = {}, {}

    def frame(self, channel: int, frame) -> None:
        w = self.w
        with tracing.span("portbench/on_frame", w.profiling):
            w.frame_times.append((w.k, clock()))
            if w.keep():
                self.frames.setdefault((w.k, channel), []).append(frame)

    def plot(self, channel: int, ev) -> None:
        w = self.w
        with tracing.span("portbench/on_plot", w.profiling):
            if w.keep():
                self.plots.setdefault((w.k, channel), []).append(np.asarray(ev.values))


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_process: float | None = None) -> dict:
    """One run; returns the result line's fields and what the check reads."""
    t_process = clock() if t_process is None else t_process
    cfg = cell.config
    import torch

    from tempestsdr_tpu_torch.config import PipelineConfig
    from tempestsdr_tpu_torch.params import Params

    n, n_ch = cfg["block_samples"], cfg["channels"]
    channels = range(n_ch)
    channel_periods = [em.channel_period_samples(cfg, c) for c in channels]
    receiver_modes = modes.receiver_modes(cfg)
    pcs = {mode: PipelineConfig(samplerate=float(cfg["samplerate"]), height=mode[0],
                                refreshrate=float(mode[1]), block_samples=n)
           for mode in set(receiver_modes)}
    channel_pcs = [pcs[mode] for mode in receiver_modes]
    one_mode = len(pcs) == 1
    periods = [em.channel_period(cfg, c, seed) for c in channels]
    params = Params(**cfg["params"])
    ctx = types.SimpleNamespace(
        cfg=cfg, traffic=cell.traffic, seed=seed, seconds=seconds, device=device, n=n,
        n_ch=n_ch, channel_periods=channel_periods, channel_pcs=channel_pcs,
        period=channel_periods[0] if one_mode else None,
        pc=channel_pcs[0] if one_mode else None, periods=periods,
        loops=[em.looped(p, n) for p in periods], params=params, t_process=t_process,
        clock=clock, sync=lambda: _sync(device), timed=None)

    def get_state():
        return [cell.session.channel_leaves(ctx.timed, c) for c in channels]

    window = Window(seconds, seed, cfg, cell.traffic, trace, get_state)
    rec = Recorder(window)
    if trace:
        window.prof.warm_up()

    def make_session(sources, timed: bool):
        return cell.session.make(ctx, sources, timed)

    ctx.window, ctx.recorder, ctx.make_session = window, rec, make_session
    out = cell.driver.drive(ctx)
    if window.profiling:  # the window ended first
        window.traced_to = window.blocks
        window.prof.stop()

    mem_peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    ctx.timed = None
    geometries = [Geometry.of(cfg, c) for c in channels]
    return dict(blocks=window.blocks, window_s=out["t_end"] - window.t0,
                setup_s=out["setup_s"], error=out["error"], attempted=out["attempted"],
                failed=out["failed"], metrics=out["metrics"], raw_for=out["raw_for"],
                mem_peak=mem_peak, window=window, recorder=rec, geometry=geometries[0],
                geometries=geometries, reference=cell.reference, n_channels=n_ch)


def check_run(res: dict, cfg: dict, device: str) -> dict:
    """The check over the run's stretches and its state after the first
    `from_start` blocks (see reference/check.py), each channel at its own
    geometry against the configuration's reference."""
    w, rec, n_ch = res["window"], res["recorder"], res["n_channels"]

    def rows(leaves, c):  # channel c's part of a snapshot
        return None if leaves is None else leaves[c]

    stretches = []
    for s in w.stretches:
        if s["blocks"] <= 0:
            continue
        for c in range(n_ch):
            anchor = None
            if s["start"] == 0 and w.anchor is not None:
                anchor = (w.anchor[0], rows(w.anchor[1], c))
            stretches.append(ck.Stretch(c, s["start"], s["blocks"], rows(s["before"], c),
                                        rows(s["after"], c), anchor))
    plots = {key: (v[0], v[1]) for key, v in rec.plots.items()}
    return ck.check(res["geometries"], stretches, res["raw_for"], rec.frames, plots,
                    cfg["raw_format"], device=device, params=cfg["params"],
                    reference=res["reference"])
