"""Multi-target streaming session: N independent emitters on one card
(BASELINE config 5) as a product API.

The reference's JNI layer is a hard singleton (TSDRLibraryNDK.c:24
`tsdr_instance`): one process, one receiver. Here N channels run through one
multi-channel step (stream/pipeline.py make_channels_step_hybrid: per
channel the single-channel `pre`, one 2-D ring write, the round and emit
bodies behind selects), each with its own state rows, drop accounting and
frame cadence.

The step runs through a ChannelRunner (stream/graph.py), cached per
(config, params, N, cond_mode, device): on the card one CUDA-graph replay a
block, as the JAX MultiSession dispatches one jitted block per call; on the
CPU the same step eagerly. Per block, Session's dispatch (stream/session.py
_dispatch_rows): the N raw blocks staged row by row in the runner's
pinned buffer, each row's copy to the card queued at once, the replay,
ONE packed fetch of [N, PACKED + K] (every channel's frame-valid flags
and round flag), then the valid frames and, where a round
completed and on_plot is set, those channels' plots, copied to the host. A
session holds its runner while it runs (session._lease_runner) and takes
its state back in tensors of its own when the run ends. Under a profiler
the loop carries Session's spans: tsdr/source for each channel's block,
tsdr/dispatch from the drop counts to the end of the fan-out.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np

from ..config import PipelineConfig
from ..device import resolve_device
from ..errors import TSDRError, TSDRStatus
from ..params import Params
from ..parallel.channels import stack_states
from ..sources.base import Source
from ..utils.profiling import span
from .graph import ChannelRunner, UploadStats
from .session import DownloadStats, _cached_runner, _dispatch_rows, _lease_runner

# the frames come down through stream.session._download; the name stays
# here because portbench/tests/test_bench_run.py patches it in both modules
from .session import _download  # noqa: F401


class MultiSession:
    """Drive N sources through one multi-channel step.

    on_frame(channel: int, frame: np.ndarray) fires per completed frame;
    on_plot(channel, PlotEvent) per estimation round (both autocorr
    windows), mirroring the single-channel Session's event surface.
    All sources must share the config's samplerate (one geometry per
    session — independent geometries belong in separate sessions).
    """

    def __init__(
        self,
        config: PipelineConfig,
        params: Params,
        sources: Sequence[Source],
        on_frame: Optional[Callable[[int, np.ndarray], None]] = None,
        on_plot=None,
        cond_mode: str = "unrolled",
        device="cuda",
    ):
        if not sources:
            raise TSDRError(TSDRStatus.ERR_PLUGIN, "no sources")
        for s in sources:
            if abs(s.samplerate() - config.samplerate) > 1e-6:
                raise TSDRError(
                    TSDRStatus.WRONG_VIDEOPARAMS,
                    f"source '{s.name()}' samplerate {s.samplerate()} != "
                    f"config {config.samplerate} (one geometry per session)",
                )
        self.config = config
        self.params = params
        self.device = resolve_device(device)
        self.sources = list(sources)
        self.on_frame = on_frame
        self.on_plot = on_plot
        self.n_channels = len(sources)
        self.cond_mode = cond_mode
        self._runner = _cached_runner(*self._runner_key())
        self.state = stack_states(config, self.n_channels, params.fir_lowpass_taps, self.device)
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.samples_dropped_total = [0] * self.n_channels
        self.frames_total = [0] * self.n_channels
        self.download_stats = DownloadStats()

    @property
    def upload_stats(self) -> UploadStats:
        """The uploads of the session's runner (stream/graph.py), counted
        across every holder of that runner."""
        return self._runner.upload_stats

    def _runner_key(self) -> tuple:
        """The session's runner key and the maker of its ChannelRunner."""
        return (("channels", self.config, self.params, self.n_channels, self.cond_mode,
                 self.device),
                lambda: ChannelRunner(self.config, self.params, self.n_channels, self.device,
                                      cond_mode=self.cond_mode))

    def run(self, max_blocks: Optional[int] = None,
            max_frames: Optional[int] = None) -> int:
        """Stream until a source ends or limits hit. max_frames counts the
        total across channels. Returns that total."""
        self._running = True
        streams = [iter(s.stream(self.config.block_samples))
                   for s in self.sources]
        ctl = np.zeros((self.n_channels, 3), np.float64)  # drops; no sync shift, no motion blur
        blocks = 0
        frames = 0
        self._runner = _lease_runner(*self._runner_key())
        try:
            while self._running:
                raws = []
                for c, st in enumerate(streams):
                    with span("tsdr/source"):
                        blk = next(st, None)
                        if blk is None:
                            return frames  # a source ended: stop the group
                        raws.append(np.asarray(blk.samples).reshape(-1))
                        ctl[c, 0] = int(blk.dropped)
                frames += self._dispatch(raws, ctl)
                blocks += 1
                if max_blocks is not None and blocks >= max_blocks:
                    break
                if max_frames is not None and frames >= max_frames:
                    break
        finally:
            self._running = False
            self.state = self._runner.release(self.state)
            for s in self.sources:
                s.stop()
        return frames

    def _dispatch(self, raws: list, ctl: np.ndarray) -> int:
        """One dispatch (a tsdr/dispatch span): one block of every channel
        through _dispatch_rows, then every channel's frames and the plots
        of the channels whose round completed, to the callbacks; returns
        the frames emitted."""
        with span("tsdr/dispatch"):
            for c in range(self.n_channels):
                self.samples_dropped_total[c] += int(ctl[c, 0])
            self.state, rows = _dispatch_rows(self._runner, self.state, raws, ctl,
                                              self.download_stats, plots=self.on_plot is not None)
            total = 0
            with span("tsdr/fanout"):
                for c, (_, frames, _) in enumerate(rows):
                    self.frames_total[c] += len(frames)
                    total += len(frames)
                    if self.on_frame:
                        for frame in frames:
                            with span("tsdr/callback"):
                                self.on_frame(c, frame)
                for c, (_, _, plots) in enumerate(rows):
                    for ev in plots or ():
                        with span("tsdr/callback"):
                            self.on_plot(c, ev)
            return total

    def start_async(self, **kw) -> None:
        """run(**kw) on a worker thread. Marked running before the thread
        starts, as Session.start_async is: a caller polling is_running right
        after this must not take a loop not yet scheduled for one that
        ended."""
        if self._thread is not None and self._thread.is_alive():
            raise TSDRError(TSDRStatus.ALREADY_RUNNING, "session already streaming")
        self._running = True
        self._thread = threading.Thread(target=self.run, kwargs=kw, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    @property
    def is_running(self) -> bool:
        return self._running
