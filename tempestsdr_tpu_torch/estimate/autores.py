"""Auto-resolution: argmax peak picking + 3-round convergence.

Mirrors the Java GUI's AUT mode (Main.java:1232-1277):
  fps    = samplerate / (frame_offset + frame_argmax)          (:1301-1303)
  height = round(frame_lag / line_lag)                         (:1253,1346-1349)
accepted after the same (fps, height) pair — hashed as int(fps*height)
(:1228-1230) — wins AUTO_FRAMERATE_CONVERGANCE_ITERATIONS (=3, :82)
consecutive-ish rounds, then snapped to the nearest VESA mode (:818-827).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..config import MAX_HEIGHT, MIN_HEIGHT, ac_fft_size_for
from ..events import PLOT_ID, PlotEvent
from .vesa import VideoMode, find_closest_mode

AUTO_FRAMERATE_CONVERGANCE_ITERATIONS = 3  # Main.java:82


class Estimate(NamedTuple):
    refreshrate: float
    height: int
    frame_lag: int  # samples per frame at the autocorr peak
    line_lag: int
    mode: Optional[VideoMode]


def estimate_from_plots(
    frame_plot: np.ndarray,
    line_plot: np.ndarray,
    frame_offset: int,
    line_offset: int,
    samplerate: float,
) -> Estimate:
    """One-round estimate from the two autocorrelation windows.

    Improvement over the reference's bare argmax (Main.java:1232-1277): the
    estimator's autocorrelation is CIRCULAR (fft.c:49-64, no zero padding),
    so R(j) == R(N - j) exactly — when the frame window spans past
    ac_fft_size/2 (it does whenever maxlength > fft/2, e.g. any sub-61 Hz
    mode), the true lag and its mirror alias tie to the bit and the
    reference's pick is decided by FFT rounding noise (bistable 60 <-> 62.1
    Hz detections). Here a tied mirror pair is broken deterministically:
    prefer the candidate whose implied height lies in the reference's own
    plausibility bounds [MIN_HEIGHT, MAX_HEIGHT] (internaldefinitions /
    frameratedetector.c:21-23), then the one closer to a VESA mode.
    """
    frame_lag = frame_offset + int(np.argmax(frame_plot))
    line_lag = line_offset + int(np.argmax(line_plot))

    fft_size = ac_fft_size_for(samplerate)
    jm = fft_size - frame_lag
    if frame_offset <= jm < frame_offset + len(frame_plot) and jm != frame_lag:
        vj = float(frame_plot[frame_lag - frame_offset])
        vm = float(frame_plot[jm - frame_offset])
        if abs(vm - vj) <= 1e-3 * max(abs(vj), 1e-30):  # exact-math tie
            def plausible(j: int) -> bool:
                return MIN_HEIGHT <= round(j / line_lag) <= MAX_HEIGHT

            def mode_dist(j: int) -> float:
                fps_c = samplerate / j
                m = find_closest_mode(fps_c, int(round(j / line_lag)))
                if m is None:
                    return float("inf")
                return abs(m.height - j / line_lag) + abs(m.refreshrate - fps_c)

            if plausible(jm) != plausible(frame_lag):
                frame_lag = jm if plausible(jm) else frame_lag
            elif mode_dist(jm) < mode_dist(frame_lag):
                frame_lag = jm

    fps = samplerate / frame_lag
    height = int(round(frame_lag / line_lag))
    return Estimate(fps, height, frame_lag, line_lag, find_closest_mode(fps, height))


class AutoResolution:
    """Stateful convergence tracker; feed it PlotEvents, it returns an
    Estimate once the same (fps, height) has been seen
    AUTO_FRAMERATE_CONVERGANCE_ITERATIONS+1 times (Main.java:1255-1268)."""

    def __init__(self, samplerate: float):
        self.samplerate = samplerate
        self._counts: dict[int, int] = {}
        self._pending_frame: Optional[tuple[np.ndarray, int]] = None
        self.result: Optional[Estimate] = None

    def reset(self) -> None:
        self._counts.clear()
        self._pending_frame = None
        self.result = None

    def feed(self, ev: PlotEvent) -> Optional[Estimate]:
        if self.result is not None:
            return self.result
        if ev.plot_id == PLOT_ID.FRAME:
            self._pending_frame = (np.asarray(ev.values), ev.offset)
            return None
        if ev.plot_id != PLOT_ID.LINE or self._pending_frame is None:
            return None
        fplot, foff = self._pending_frame
        est = estimate_from_plots(fplot, np.asarray(ev.values), foff, ev.offset, self.samplerate)
        key = int(est.refreshrate * est.height)  # hashHeightAndFPS
        n = self._counts.get(key, 0)
        if n == AUTO_FRAMERATE_CONVERGANCE_ITERATIONS:
            self.result = est
            return est
        self._counts[key] = n + 1
        return None
