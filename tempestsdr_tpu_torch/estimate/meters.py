"""Headless autogain / SNR meter rendering — the GUI's two value-feed
widgets (AutoScaleVisualizer.java, SNRVisualizer.java) as image renderers.

Both widgets share one fixed dB scale [−50.7, 0.6] (AutoScaleVisualizer
LOWEST_DB/HIGHEST_DB :24-25, SNRVisualizer :26-27; LogScale.valtodb =
10·log10, scale/LogScale.java:113-114):

  - the autogain meter paints a vertical grayscale gradient between the
    current min/max autogain bounds, colour = 255·(val−min)/span clamped
    (AutoScaleVisualizer.pxtocol :117-121) — the VALUE_ID_AUTOGAIN_VALUES
    feed (dsp.c:231-233);
  - the SNR meter draws a marker line at the current SNR's dB position when
    inside the scale (SNRVisualizer.paint :111-119) — the VALUE_ID_SNR feed
    (dsp.c:93, reporting enabled here unlike the ref's commented-out :234).
"""

from __future__ import annotations

import numpy as np

LOWEST_DB = -50.7  # AutoScaleVisualizer.java:24 / SNRVisualizer.java:26
HIGHEST_DB = 0.6  # AutoScaleVisualizer.java:25 / SNRVisualizer.java:27
DB_MULTIPLIER = 10.0  # LogScale.java:28


def val_to_db(val: float) -> float:
    """LogScale.valtodb (LogScale.java:113-114)."""
    with np.errstate(divide="ignore"):
        return float(DB_MULTIPLIER * np.log10(val)) if val > 0 else -np.inf


def db_to_px(db: float, nheight: int) -> int:
    """LogScale.valtopx on the fixed meter scale (LogScale.java:131-134)."""
    span = HIGHEST_DB - LOWEST_DB
    return int(nheight - (db - LOWEST_DB) * nheight / span)


def px_to_val(px: int, nheight: int) -> float:
    """LogScale.pxtoval — inverse of db_to_px then dB→linear."""
    span = HIGHEST_DB - LOWEST_DB
    db = LOWEST_DB + (nheight - px) * span / nheight
    return float(10.0 ** (db / DB_MULTIPLIER))


def render_autogain_meter(
    ag_min: float, ag_max: float, nwidth: int = 32, nheight: int = 240
) -> np.ndarray:
    """AutoScaleVisualizer.paint (:124-160): grayscale gradient between the
    autogain bounds on the fixed dB scale; background elsewhere (96)."""
    img = np.full((nheight, nwidth), 96, np.uint8)
    span = ag_max - ag_min
    if span <= 0 or ag_max <= 0:
        return img
    for py in range(nheight):
        val = px_to_val(py, nheight)
        col = min(max(int(255 * (val - ag_min) / span), 0), 255)
        if ag_min <= val <= ag_max:
            img[py, :] = col
    return img


def render_snr_meter(snr: float, nwidth: int = 32, nheight: int = 240) -> np.ndarray:
    """SNRVisualizer.paint (:107-121): marker line at the SNR's dB position
    when it falls inside the scale; plain background otherwise."""
    img = np.full((nheight, nwidth), 96, np.uint8)
    db = val_to_db(snr)
    if LOWEST_DB < db < HIGHEST_DB:
        py = min(max(db_to_px(db, nheight), 0), nheight - 1)
        img[py, :] = 255
    return img
