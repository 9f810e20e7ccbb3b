"""Interactive peak utilities — the plot widget's selection logic
(PlotVisualizer.java) as plain functions for API/CLI clients.

The GUI flow being mirrored: the user clicks a plot, the click snaps to the
strongest bin within the "area around cursor" window (getBestIdAround,
PlotVisualizer.java:144-163; area spinner Main.java:563-572), and the
transformer callbacks derive the geometry — frame-plot clicks pick the
refresh rate and re-derive the height from the line plot's selection
(Main.java:1315-1321), line-plot clicks pick the height at the current rate
(Main.java:1357-1361).
"""

from __future__ import annotations

import numpy as np


def get_best_id_around(data: np.ndarray, idx: int, area: int) -> int:
    """PlotVisualizer.getBestIdAround (:144-163), exact semantics.

    `idx`/`area` are in data-index units (the widget converts cursor pixels
    through its x scale first; headless callers already hold indices).
    Returns the index of the largest value in [idx - area//2, idx + area//2)
    with the widget's clamping, or -1 when the window lies outside the data.
    Ties resolve to the lowest index (`>` comparison keeps the first max).
    """
    data = np.asarray(data)
    size = len(data)
    start_id = idx - area // 2
    if start_id >= size:
        return -1
    if start_id < 0:
        start_id = 0
    end_id = idx + area // 2
    if end_id < 0:
        return -1
    if end_id > size:
        end_id = size
    # the Java loop seeds at start_id and scans (start_id, end_id); an empty
    # scan range still returns start_id (area 0 = take the exact bin)
    if end_id <= start_id + 1:
        return start_id
    return start_id + int(np.argmax(data[start_id:end_id]))


def best_peak_around(values: np.ndarray, idx: int, area: int) -> int:
    """Snap a selection to the strongest bin in a window around `idx`,
    always returning a valid index (callers that want the widget's -1
    out-of-range contract use get_best_id_around directly)."""
    n = len(values)
    best = get_best_id_around(values, int(np.clip(idx, 0, n - 1)), area)
    return best if best >= 0 else int(np.clip(idx, 0, n - 1))


def fps_from_lag(lag: int, samplerate: float) -> float:
    """Frame plot index -> refresh rate (Main.java:1301-1303 fps transformer)."""
    return samplerate / lag


def lag_from_fps(fps: float, samplerate: float) -> int:
    return int(round(samplerate / fps))


def height_from_lags(frame_lag: int, line_lag: int) -> int:
    """Line plot index + frame lag -> total line count
    (Main.java:1346-1349 height transformer)."""
    return int(round(frame_lag / line_lag))


def select_fps(values: np.ndarray, offset: int, samplerate: float,
               around_lag: int, area: int) -> tuple[int, float] | None:
    """Frame-plot click at `around_lag` (absolute lag, samples): snap to the
    best peak within `area` lags and return (frame_lag, fps)
    (fps_transofmer.executeIdSelected, Main.java:1315-1321). None when the
    window misses the plotted range."""
    sel = get_best_id_around(values, around_lag - offset, area)
    if sel < 0:
        return None
    lag = offset + sel
    return lag, fps_from_lag(lag, samplerate)


def select_height(values: np.ndarray, offset: int, frame_lag: float,
                  around_lag: int, area: int) -> tuple[int, int] | None:
    """Line-plot click at `around_lag`: snap within `area` lags and return
    (line_lag, height = round(frame_lag / line_lag))
    (TransformerAndCallbackHeight.executeIdSelected, Main.java:1357-1361;
    frame_lag defaults to samplerate/framerate when no frame-plot selection
    exists, :1352-1354)."""
    sel = get_best_id_around(values, around_lag - offset, area)
    if sel < 0:
        return None
    lag = offset + sel
    return lag, height_from_lags(frame_lag, lag)
