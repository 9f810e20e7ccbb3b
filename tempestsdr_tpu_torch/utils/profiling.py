"""Profiling and throughput observability.

The reference's only instrumentation is a GUI FPS overlay
(ImageVisualizer.java:141-154) and an unthrottled-replay compile flag. Here:
  - profile_trace: context manager around torch.profiler that writes a
    Chrome trace of the run (host calls, and kernels and copies on a card);
  - span: the program's own host spans (tsdr/...) in that trace, on the
    clock of its device events, and one check when no profiler records;
  - measure_dispatch_floor / auto_batch_blocks: the per-dispatch cost of the
    device and the session batch size it asks for; measure_replay_floor, a
    one-block batch of the session's own (a graph replay and its fetch);
  - IngestMeter: samples/s + frames/s rates with exponential smoothing, fed
    by the session loop or any block consumer.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from ..device import resolve_device


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the enclosed code with torch.profiler and write a Chrome
    trace (chrome://tracing, Perfetto) into logdir; yields the profiler.
    Device activity is recorded when a CUDA device is present."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# What span() returns when no profiler records on the calling thread: one
# object, reentrant, so that a span costs one check and no allocation.
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A host span of the program's loop, as a context manager: a
    torch.profiler.record_function(name) while a profiler records on the
    calling thread (a profiler records the spans of the thread that started
    it), else one shared no-op context. The profiler keeps the spans in
    memory and exports them as user_annotation events on the timeline of
    the card's kernels and copies (profile_trace, portbench/tracing.py).

    The session's spans tile its loop: each iteration lies inside a
    tsdr/source span (a block's arrival) or a tsdr/dispatch span (one
    runner call and all it leads to: tsdr/upload, tsdr/replay, tsdr/fetch,
    tsdr/download, tsdr/fanout, and tsdr/callback around the caller's
    callbacks). tsdr/capture marks a graph's capture."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


_FLOOR_CACHE: dict = {}


def measure_dispatch_floor(repeats: int = 3, *, device="cuda") -> float:
    """Measured per-dispatch floor of `device`, seconds: one small kernel
    launch (x + 1 on a scalar) plus the host fetch of its result (.item()),
    the round trip every block of a session pays at least once (the step's
    one packed fetch). The constant that decides how many blocks a live
    session should batch per dispatch. Minimum of `repeats` round trips
    after one untimed; cached per device. On "cpu" it times the CPU call."""
    dev = resolve_device(device)
    key = str(dev)
    if key in _FLOOR_CACHE:
        return _FLOOR_CACHE[key]
    x = torch.zeros((), dtype=torch.float32, device=dev)
    x = x + 1.0
    x.item()  # first launch and fetch outside the timing
    best = float("inf")
    for _ in range(max(repeats, 1)):
        t0 = time.monotonic()
        x = x + 1.0
        x.item()
        best = min(best, time.monotonic() - t0)
    _FLOOR_CACHE[key] = best
    return best


def measure_replay_floor(config, params=None, repeats: int = 3, *, device="cuda") -> float:
    """Seconds of the least batch a session dispatches: one block of zeros
    (uint8) copied up, one replay of a one-block CUDA graph of the device
    step (stream/graph.py; on "cpu" one eager step) and the batch's packed
    fetch, on a runner of its own. The step's whole per-block cost at
    batch_blocks=1, beside measure_dispatch_floor's bare round trip.
    Minimum of `repeats` after one untimed call (which captures)."""
    from ..params import Params
    from ..stream.graph import BlockRunner, host_controls
    from ..stream.state import init_state

    dev = resolve_device(device)
    params = params or Params()
    runner = BlockRunner(config, params, 1, dev)
    state = init_state(config, params.fir_lowpass_taps, dev)
    raws = np.zeros((1, 2 * config.block_samples), np.uint8)
    ctl = host_controls([0], 0, 0.0)
    best = float("inf")
    for i in range(max(repeats, 1) + 1):
        t0 = time.monotonic()
        state, _, packed = runner.run(state, raws, ctl)
        packed.tolist()
        if i:
            best = min(best, time.monotonic() - t0)
    return best


def auto_batch_blocks(config, *, latency_s: float = 0.25,
                      floor_s: float | None = None,
                      floor_ratio: float = 10.0,
                      max_batch: int = 256, device="cuda") -> int:
    """Pick batch_blocks for a live session from the measured dispatch
    floor vs the block's real-time duration (a batch=1 session caps at
    ~1/floor dispatches/s).

    Two constraints, latency winning on conflict:
      - amortization: the stream-time per dispatch should be >= floor_ratio
        x the dispatch floor (floor overhead <= ~1/floor_ratio of the
        real-time cadence);
      - control latency: a throttled (real-time) source fills a batch in
        batch * block_s seconds — that fill time plus one dispatch floor is
        the worst-case delay before an interactive control (sync shift,
        motion blur, param flip) takes effect, and must stay <= latency_s.
        (Unthrottled replay fills near-instantly and is latency-bound only
        by the dispatch wall — callers benchmarking replay should size
        batches explicitly.)
    floor_s=None measures the floor of `device`.
    """
    if floor_s is None:
        floor_s = measure_dispatch_floor(device=device)
    block_s = config.block_samples / config.samplerate
    want = -(-floor_ratio * floor_s // block_s)  # ceil
    cap = (latency_s - floor_s) / block_s
    return int(max(1, min(want, cap, max_batch)))


class IngestMeter:
    def __init__(self, alpha: float = 0.2):
        self._alpha = alpha
        self._t = None
        self._sps = 0.0
        self._fps = 0.0
        self.total_samples = 0
        self.total_frames = 0

    def update(self, samples: int, frames: int = 0) -> None:
        now = time.monotonic()
        self.total_samples += samples
        self.total_frames += frames
        if self._t is not None:
            dt = max(now - self._t, 1e-9)
            self._sps += self._alpha * (samples / dt - self._sps)
            self._fps += self._alpha * (frames / dt - self._fps)
        self._t = now

    @property
    def samples_per_sec(self) -> float:
        return self._sps

    @property
    def frames_per_sec(self) -> float:
        return self._fps

    def __repr__(self) -> str:
        return (f"IngestMeter({self._sps/1e6:.2f} MS/s, {self._fps:.1f} fps, "
                f"total {self.total_samples/1e6:.1f} MS / {self.total_frames} frames)")
