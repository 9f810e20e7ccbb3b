"""Autocorrelation plot rendering — the GUI plot widget's drawing pipeline
(JavaGUI/src/martin/tempest/gui/PlotVisualizer.java) as a headless image
renderer.

Reproduces the widget's two-stage pipeline exactly:
  1. per-pixel-column max decimation of R(j) with running lowest/highest
     tracking (PlotVisualizer.populateData, :200-247);
  2. log-dB y mapping  px = H - (10*log10(v) - lo_db) * H / span_db
     (LogScale.valtodb/valtopx, scale/LogScale.java:113-134,
     DB_MULTIPLIER = 10), with the scale bounds taken from the decimated
     data (LogScale.setLowestHighestValue, :162-171).

The interactive parts (zoom/pan, mouse selection) stay host-side logic in
`peaks.py`; this module covers the rendering capability so plot events can
be dumped as images from the CLI (Main.java's plot panels, headless).
"""

from __future__ import annotations

import numpy as np

DB_MULTIPLIER = 10.0  # LogScale.java:28


def decimate_max(data: np.ndarray, nwidth: int):
    """Per-pixel-column max decimation (PlotVisualizer.populateData
    :200-247).

    Returns (visdata f64[nwidth], lowest, highest, max_index) with the
    widget's exact semantics: columns are filled with the running local max
    at each column boundary, lowest/highest track only those boundary
    values (seeded from data[0]), and max_index is the global argmax.

    Vectorized (reduceat over column segments) — the widget's scalar loop
    costs seconds of host time at 64 MS/s window sizes (~430k lags); the
    literal transliteration lives in tests/test_estimate.py as the oracle.
    """
    data = np.asarray(data, np.float64)
    size = len(data)
    # px(idx) = idx*nwidth//size (value_to_pixel_absolute, unzoomed) is
    # nondecreasing: each distinct px value is one column segment
    px = (np.arange(size, dtype=np.int64) * nwidth) // size
    starts = np.flatnonzero(np.r_[True, px[1:] != px[:-1]])
    m = np.maximum.reduceat(data, starts)  # per-column running local max
    cols = px[starts]
    # a flush at column boundary p_k fills [p_{k-1}, p_k) with the previous
    # column's max; skipped columns inherit it. Final fill covers the tail.
    visdata = np.repeat(m, np.diff(np.r_[cols, nwidth]))
    # lowest/highest are seeded from data[0] and updated ONLY with flushed
    # column maxima — the last column is never flushed (widget quirk)
    flushed = m[:-1]
    highest = float(max(data[0], flushed.max())) if flushed.size else float(data[0])
    lowest = float(min(data[0], flushed.min())) if flushed.size else float(data[0])
    max_index = int(np.argmax(data))  # first occurrence, like `val > max`
    return visdata, lowest, highest, max_index


def decimate_max_zoomed(data: np.ndarray, nwidth: int, scale):
    """populateData under a ZoomableXScale (PlotVisualizer.java:200-247):
    the zoomed/panned variant of decimate_max, preserving the widget's exact
    quirks — lowest/highest and the running max are seeded from data[0]
    (not the first visible value); localmax seeds from data[first_id]; the
    left margin before the first visible column is filled with that seed;
    max_index scans the [first_id, last_id) range whether or not each id is
    on-screen; the last visible column never updates lowest/highest.

    `scale` is an estimate.scales.ZoomableXScale whose value domain is the
    data index (the widget calls setMinMaxValue(0, size)).
    """
    data = np.asarray(data, np.float64)
    size = len(data)
    first_id = int(min(max(scale.pixels_to_value_absolute(0), 0), size))
    last_id = int(min(max(scale.pixels_to_value_absolute(nwidth) + 1, 0), size))

    highest = lowest = float(data[0])
    seed = float(data[min(first_id, size - 1)])
    visdata = np.full(nwidth, seed)

    # max_index: running `val > max` over [first_id, last_id), seeded data[0]
    sub = data[first_id:last_id]
    if sub.size and sub.max() > data[0]:
        max_index = first_id + int(np.argmax(sub))
    else:
        max_index = 0

    if sub.size == 0:
        return visdata, lowest, highest, max_index

    ids = np.arange(first_id, last_id, dtype=np.int64)
    # value_to_pixel_absolute with Java's trunc-toward-zero int cast
    a = scale._val_in_pixels
    px = np.trunc((ids - scale.min_value) * a).astype(np.int64) - scale.offset_px
    m = (px >= 0) & (px < nwidth)
    if not m.any():
        return visdata, lowest, highest, max_index
    v0, v1 = int(np.argmax(m)), int(len(m) - np.argmax(m[::-1]))  # valid span
    vpx = px[v0:v1]
    dvals = sub[v0:v1]

    starts = np.flatnonzero(np.r_[True, vpx[1:] != vpx[:-1]])
    gmax = np.maximum.reduceat(dvals, starts)
    cols = vpx[starts]
    p0 = int(cols[0])
    flushed = []
    if p0 > 0:
        # first flush writes the pre-visible localmax (the seed) to the left
        # margin and tracks it in lowest/highest
        visdata[:p0] = seed
        flushed.append(seed)
    else:
        # no flush at column 0: the seed merges into its running max
        gmax[0] = max(gmax[0], seed)
    counts = np.diff(np.r_[cols, nwidth])
    visdata[p0:] = np.repeat(gmax, counts)
    flushed.extend(gmax[:-1])  # the last column is never flushed
    if flushed:
        highest = max(highest, max(flushed))
        lowest = min(lowest, min(flushed))
    return visdata, lowest, highest, max_index


def db_to_px(vals_db: np.ndarray, lo_db: float, hi_db: float, nheight: int):
    """LogScale.valtopx (LogScale.java:131-134)."""
    span = max(hi_db - lo_db, 1e-12)
    return (nheight - (vals_db - lo_db) * nheight / span).astype(np.int64)


def render_plot(
    data: np.ndarray,
    *,
    offset: int,
    samplerate: float,
    nwidth: int = 640,
    nheight: int = 240,
    kind: str = "frame",
    frame_lag: int | None = None,
    scale=None,
) -> tuple[np.ndarray, dict]:
    """Render one autocorrelation window as a u8 grayscale image.

    data: the plot-event values (our PLOT_ID_FRAME / PLOT_ID_LINE windows,
    frameratedetector.c:121-122). kind selects the value transformer for the
    peak annotation: "frame" -> fps = samplerate/lag (Main.java:1301-1303),
    "line" -> height = frame_lag/line_lag (Main.java:1346-1349; frame_lag
    defaults to samplerate/60 like the widget's default length).

    scale: optional estimate.scales.ZoomableXScale over the index domain
    [0, len(data)] for a zoomed/panned view (the widget's wheel/drag state).

    Returns (img u8[nheight, nwidth] with 0=black background, 255=curve,
    160=peak marker column, 64=baseline) and an info dict
    {max_index, lag, value, label, lowest_db, highest_db}.
    """
    if scale is not None:
        visdata, lowest, highest, max_index = decimate_max_zoomed(
            data, nwidth, scale)
    else:
        visdata, lowest, highest, max_index = decimate_max(data, nwidth)
    # log floor = smallest positive decimated value (the widget's
    # data-derived bound); 1e-12 only when no positive value exists
    pos = visdata[visdata > 0]
    floor = float(pos.min()) if pos.size else 1e-12
    with np.errstate(divide="ignore"):
        vals_db = DB_MULTIPLIER * np.log10(np.maximum(visdata, floor))
    lo_db = DB_MULTIPLIER * np.log10(max(lowest, floor))
    hi_db = DB_MULTIPLIER * np.log10(max(highest, floor))
    ys = np.clip(db_to_px(vals_db, lo_db, hi_db, nheight), 0, nheight - 1)

    img = np.zeros((nheight, nwidth), np.uint8)
    img[nheight - 1, :] = 64
    # connected polyline: each column fills between its own y and the
    # previous column's y (the widget's drawPolyline equivalent)
    prev_y = ys[0]
    for x in range(nwidth):
        y = ys[x]
        lo, hi = (y, prev_y) if y <= prev_y else (prev_y, y)
        img[lo : hi + 1, x] = 255
        prev_y = y

    if scale is not None:
        peak_px = scale.value_to_pixel_absolute(max_index)
    else:
        peak_px = int(max_index * nwidth / len(data))
    if 0 <= peak_px < nwidth:  # zoomed views may scroll the peak off-screen
        marker = img[:, peak_px] == 0
        img[marker, peak_px] = 160

    lag = offset + max_index
    # lag 0 (offset 0, peak at bin 0): Java's double division yields
    # Infinity rather than raising — match that
    if kind == "frame":
        value = samplerate / lag if lag else float("inf")
        label = f"{value:.1f} fps"  # Main.java:1299
    else:
        flag = frame_lag if frame_lag is not None else samplerate / 60.0
        value = flag / lag if lag else float("inf")
        if np.isfinite(value):
            err_lo = abs(flag / (lag + 1) - value)
            err_hi = abs(flag / (lag - 1) - value) if lag > 1 else err_lo
            err = int(round(max(err_lo, err_hi))) - 1  # Main.java:1338-1343
            label = (
                f"{int(round(value))} (±{err}) px" if err > 0
                else f"{int(round(value))} px"
            )
        else:
            label = "inf px"
    info = {
        "max_index": int(max_index),
        "lag": int(lag),
        "value": float(value),
        "label": label,
        "lowest_db": float(lo_db),
        "highest_db": float(hi_db),
    }
    return img, info


def save_plot(img: np.ndarray, path: str) -> None:
    """Write a rendered plot image (.pgm dependency-free, .png via PIL,
    .npy raw) using the snapshot writer's format dispatch."""
    from ..snapshot import save_frame

    # save_frame expects floats in [0,1]
    save_frame(img.astype(np.float32) / 255.0, path)
