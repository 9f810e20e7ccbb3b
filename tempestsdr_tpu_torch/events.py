"""Telemetry event types — the reference's two push-callback channels
(TSDRLibrary.h:57-59 tsdr_value_changed_callback /
tsdr_on_plot_ready_callback with VALUE_ID_* / PLOT_ID_* ids :45-53)."""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np


class VALUE_ID(enum.IntEnum):
    PLL_FRAMERATE = 0
    AUTOCORRECT_RESET = 1
    AUTOCORRECT_FRAMES_COUNT = 2
    AUTOGAIN_VALUES = 3
    SNR = 4
    AUTOCORRECT_DUMPED = 5


class PLOT_ID(enum.IntEnum):
    FRAME = 0
    LINE = 1


class ValueEvent(NamedTuple):
    value_id: VALUE_ID
    arg0: float
    arg1: float


class PlotEvent(NamedTuple):
    """announce_plotready payload (TSDRLibrary.c:166-171): the plot window
    with its lag offset and samplerate so clients can map index -> fps/lines
    (Main.java:1295-1371 transformers)."""

    plot_id: PLOT_ID
    offset: int
    values: np.ndarray
    samplerate: float
