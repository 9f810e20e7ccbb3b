"""Multi-target streaming session: N independent emitters on one card
(BASELINE config 5) as a product API.

The reference's JNI layer is a hard singleton (TSDRLibraryNDK.c:24
`tsdr_instance`): one process, one receiver. Here N channels run through one
multi-channel step (stream/pipeline.py make_channels_step_hybrid: the
single-channel device part per channel, one host fetch for all channels, a
shared ring write, the boundary bodies only for the channels that cross a
boundary), each with its own state rows, drop accounting and frame cadence.

Per block: one stacked upload of the N raw blocks, the step (its one fetch),
and, on a block where any channel completed a frame, one download of the
whole frame stack; on a block where any round completed, one download of
those channels' plots. Which frames and plots completed is read from the
host values the step already fetched (its `last`), not from the card.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import resolve_device
from ..errors import TSDRError, TSDRStatus
from ..events import PLOT_ID, PlotEvent
from ..params import Params
from ..parallel.channels import stack_states
from ..sources.base import Source
from .pipeline import StepControls, make_channels_step_hybrid


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
        self._step = make_channels_step_hybrid(config, params, self.n_channels,
                                               cond_mode=cond_mode, device=self.device)
        self.state = stack_states(config, self.n_channels, params.fir_lowpass_taps, self.device)
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.samples_dropped_total = [0] * self.n_channels
        self.frames_total = [0] * self.n_channels

    def run(self, max_blocks: Optional[int] = None,
            max_frames: Optional[int] = None) -> int:
        """Stream until a source ends or limits hit. max_frames counts the
        total across channels. Returns that total."""
        self._running = True
        streams = [iter(s.stream(self.config.block_samples))
                   for s in self.sources]
        n_ch = self.n_channels
        sync0, mb = [0] * n_ch, [0.0] * n_ch
        blocks = 0
        frames = 0
        try:
            while self._running:
                raws = []
                dropped = []
                for st in streams:
                    blk = next(st, None)
                    if blk is None:
                        return frames  # a source ended: stop the group
                    raws.append(np.asarray(blk.samples).reshape(-1))
                    dropped.append(int(blk.dropped))
                for c, d in enumerate(dropped):
                    self.samples_dropped_total[c] += d
                ctrl = StepControls(dropped, sync0, mb)
                raw = torch.from_numpy(np.stack(raws)).to(self.device)
                self.state, out = self._step(self.state, raw, ctrl)
                blocks += 1
                hosts = self._step.last
                # (C, K): one flag per emit slot (K == 1 for one frame per
                # block); the frame stack comes down in ONE transfer
                fv = np.array([h.frame_valid for h in hosts], dtype=bool)
                stack = out.frame.cpu().numpy() if fv.any() else None
                for c, k in np.argwhere(fv):
                    c = int(c)
                    self.frames_total[c] += 1
                    frames += 1
                    if self.on_frame:
                        self.on_frame(c, stack[c] if stack.ndim == 3 else stack[c, int(k)])
                done = [c for c, h in enumerate(hosts) if h.round_done]
                if self.on_plot and done:
                    f_off, f_len = self.config.ac_frame_window
                    l_off, _ = self.config.ac_line_window
                    sr = self.config.samplerate
                    plots = torch.cat([out.ac_frame_plot[done], out.ac_line_plot[done]],
                                      dim=1).cpu().numpy()
                    for row, c in zip(plots, done):
                        self.on_plot(c, PlotEvent(PLOT_ID.FRAME, f_off, row[:f_len], sr))
                        self.on_plot(c, PlotEvent(PLOT_ID.LINE, l_off, row[f_len:], sr))
                if max_blocks is not None and blocks >= max_blocks:
                    break
                if max_frames is not None and frames >= max_frames:
                    break
        finally:
            self._running = False
            for s in self.sources:
                s.stop()
        return frames

    def start_async(self, **kw) -> None:
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
