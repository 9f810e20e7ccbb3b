"""Runtime parameter registry.

Mirrors the reference's typed int-parameter registry
(TempestSDR/src/include/TSDRLibrary.h:32-43, setters TSDRLibrary.c:604-620)
as a frozen dataclass. A step is built for one Params value; toggling a
flag builds a new step, which removes the reference's unlocked cross-thread
reads of `params_int` (SURVEY.md §5.2) by construction.
"""

from __future__ import annotations

import dataclasses
import enum


class PARAM(enum.IntEnum):
    """Reference PARAM_* ids (TSDRLibrary.h:32-41) for API compatibility."""

    AUTOSHIFT = 0
    FRAMERATE_PLL = 1
    AUTOCORR_PLOTS_RESET = 2
    AUTOCORR_PLOTS_OFF = 3
    AUTOCORR_SUPERRESOLUTION = 4
    NEAREST_NEIGHBOUR_RESAMPLING = 5
    LOW_PASS_BEFORE_SYNC = 6
    AUTOGAIN_AFTER_PROCESSING = 7
    AUTOCORR_DUMP = 8


class DIRECTION(enum.IntEnum):
    """Manual sync shift directions (TSDRLibrary.h:26-30)."""

    CUSTOM = 0
    UP = 1
    DOWN = 2
    LEFT = 3
    RIGHT = 4


@dataclasses.dataclass(frozen=True)
class Params:
    """Static pipeline flags (recompile boundary when changed)."""

    autoshift: bool = False
    framerate_pll: bool = True
    autocorr_plots_off: bool = False
    superresolution: bool = False
    nearest_neighbour: bool = False
    lowpass_before_sync: bool = False
    autogain_after_proc: bool = False
    # TPU-native extras (not in the reference's registry):
    debug_markers: bool = False  # draw green sync crosshairs with the
    # reference's special pixel values (TSDRLibrary.h:20-24,
    # syncdetector.c:209-218); off by default so frames are clean data.
    fir_lowpass_taps: int = 0  # 0 = no FIR (reference has none); >0 enables a
    # windowed-sinc anti-alias FIR before resampling.
    fast_sync: bool = False  # False (default) = the sweet-spot sync search
    # runs in f64 like the reference's double math (syncdetector.c:26-58) —
    # exact near-tie parity. True = f32 profiles end-to-end through the
    # search (collapse stays unwidened, metric/argmax in f32; each window
    # sum is rounded to f32 once from a running sum kept in f64, where the
    # JAX package's f32 running sum lets near-ties differ by device): the
    # search is the dominant, emulated-f64-bound emit cost on TPU
    # (ROOFLINE.md round-4 update 4), so this trades exact near-tie
    # behaviour vs the reference for narrowband speed. Detected positions
    # on real signals (clear blanking strips) are unchanged; only
    # floating-point near-ties between candidate strips can resolve
    # differently.
    resampler: str = "auto"  # box-resampler implementation: "auto" (strided
    # when the geometry is near-rational, else chunked), "strided", "chunked",
    # "pallas_strided" (Mosaic kernel: DMA'd windows + dynamic lane-roll
    # alignment; m==2 geometries, falls back otherwise), "pallas" (in-kernel
    # DMA per pixel-chunk), or "pallas_windows" (Mosaic weight+reduce on
    # XLA-gathered windows). All produce identical carries;
    # nearest_neighbour=True overrides. Static (recompile boundary).

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)

    _BY_ID = {
        PARAM.AUTOSHIFT: "autoshift",
        PARAM.FRAMERATE_PLL: "framerate_pll",
        PARAM.AUTOCORR_PLOTS_OFF: "autocorr_plots_off",
        PARAM.AUTOCORR_SUPERRESOLUTION: "superresolution",
        PARAM.NEAREST_NEIGHBOUR_RESAMPLING: "nearest_neighbour",
        PARAM.LOW_PASS_BEFORE_SYNC: "lowpass_before_sync",
        PARAM.AUTOGAIN_AFTER_PROCESSING: "autogain_after_proc",
    }

    def with_int_param(self, pid: int, value: int) -> "Params":
        """Apply a reference-style integer param set (tsdr_setparameter_int,
        TSDRLibrary.c:604-611). RESET/DUMP are one-shot actions handled by the
        session, not stored flags."""
        field = self._BY_ID.get(PARAM(pid))
        if field is None:
            return self
        return self.replace(**{field: bool(value)})
