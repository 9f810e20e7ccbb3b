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
CPU the same step eagerly. Per block: one stacked upload of the N raw
blocks into the runner, the replay, ONE packed fetch of [N, PACKED + K]
(every channel's frame-valid flags and round flag), then the valid frames
and, where a round completed and on_plot is set, those channels' plots,
copied to the host as Session copies them (stream/session.py
_download_outputs). A session holds its runner while it runs and takes its
state back in tensors of its own when the run ends. Under a profiler the loop carries
Session's spans (stream/session.py): tsdr/source for each channel's block,
tsdr/dispatch from the drop counts to the end of the fan-out.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np

from ..config import PipelineConfig
from ..device import resolve_device
from ..errors import TSDRError, TSDRStatus
from ..events import PLOT_ID, PlotEvent
from ..params import Params
from ..parallel.channels import stack_states
from ..sources.base import Source
from ..utils.profiling import span
from .graph import PACKED, ChannelRunner
from .session import DownloadStats, _cached_runner, _download, _download_outputs


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
        self._runner = _cached_runner(
            ("channels", config, params, self.n_channels, cond_mode, self.device),
            lambda: ChannelRunner(config, params, self.n_channels, self.device,
                                  cond_mode=cond_mode))
        self.state = stack_states(config, self.n_channels, params.fir_lowpass_taps, self.device)
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.samples_dropped_total = [0] * self.n_channels
        self.frames_total = [0] * self.n_channels
        self.download_stats = DownloadStats()

    def _hold_runner(self) -> None:
        """Lease the cached runner; another session holding it gets one of
        its own."""
        if not self._runner.lease():
            self._runner = ChannelRunner(self.config, self.params, self.n_channels, self.device,
                                         cond_mode=self.cond_mode)
            self._runner.lease()

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
        self._hold_runner()
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
                with span("tsdr/dispatch"):
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
        """One block of every channel through the runner, the one packed
        fetch, the valid frames in one download, the completed rounds'
        plots in another, fanned out to the callbacks; returns the frames
        emitted."""
        kf = self.config.frames_per_block
        h, w = self.config.height, self.config.width
        for c in range(self.n_channels):
            self.samples_dropped_total[c] += int(ctl[c, 0])
        self.state, out, packed = self._runner.run(self.state, raws, ctl)
        with span("tsdr/fetch"):
            rows = packed.tolist()  # the one fetch of the block
        slots = [(c, k) for c, row in enumerate(rows) for k in range(kf)
                 if row[len(PACKED) + k]]
        done = [c for c, row in enumerate(rows)
                if self.on_plot and row[PACKED.index("ac_plot_valid")]]
        got, plots = _download_outputs(out, (h, w), [c * kf + k for c, k in slots], done,
                                       self.download_stats, _download)
        with span("tsdr/fanout"):
            for (c, _), frame in zip(slots, got):
                self.frames_total[c] += 1
                if self.on_frame:
                    with span("tsdr/callback"):
                        self.on_frame(c, frame)
            if done:
                f_off, f_len = self.config.ac_frame_window
                l_off, _ = self.config.ac_line_window
                sr = self.config.samplerate
                for row, c in zip(plots, done):
                    with span("tsdr/callback"):
                        self.on_plot(c, PlotEvent(PLOT_ID.FRAME, f_off, row[:f_len], sr))
                    with span("tsdr/callback"):
                        self.on_plot(c, PlotEvent(PLOT_ID.LINE, l_off, row[f_len:], sr))
        return len(slots)

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
