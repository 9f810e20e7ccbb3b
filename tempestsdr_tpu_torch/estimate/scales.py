"""Zoomable x-axis scale — the plot widget's zoom/pan mapping
(JavaGUI/src/martin/tempest/gui/scale/ZoomableXScale.java) as a headless
class, completing the G7 scale math (the log-dB y scale lives in
plotrender/meters).

Semantics matched to the widget (cited by method):
  - `scale` is the zoom factor: one screen covers (max-min)*scale values
    (calculateValues, ZoomableXScale.java:164-176);
  - zooming is clamped so the screen never shows fewer than max_zoom_val
    values (:170-174);
  - offsets are stored both in pixels and values, each derived from the
    other through the CURRENT zoom (setPxOffset/setValOffset :152-160), and
    auto-fixed into range after every pan/zoom (:186-197): left edge clamps
    to 0, right edge clamps so the last value sits at the screen edge, and
    an impossible state resets the scale;
  - zoomAround keeps the value under the cursor stationary (:107-119);
  - pixel<->value conversion uses Java's int cast (truncation toward zero,
    value_to_pixel_absolute :143-147).
"""

from __future__ import annotations

import math


def _java_int(x: float) -> int:
    """Java (int) cast: truncation toward zero."""
    return int(math.trunc(x))


class ZoomableXScale:
    def __init__(self, min_value: float = 0.0, max_value: float = 100.0,
                 max_zoom_val: float = 1.0, max_pixels: int = 800):
        self.max_pixels = max_pixels
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.max_zoom_val = float(max_zoom_val)
        self.offset_val = 0.0
        self.offset_px = 0
        self.scale = 1.0
        self.autofix = True
        self._recalc()

    # ---- setup ----

    def set_max_pixels(self, max_pixels: int) -> None:
        self.max_pixels = int(max_pixels)
        self._recalc()

    def set_min_max_value(self, min_value: float, max_value: float,
                          max_zoom_val: float | None = None) -> None:
        if max_zoom_val is not None:
            self.max_zoom_val = float(max_zoom_val)
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self._recalc()

    # ---- interaction (mouse drag / wheel / right-click) ----

    def move_offset_with_pixels(self, offset: int) -> None:
        """Pan by screen pixels (mouseDragged, PlotVisualizer.java:71-85)."""
        self._set_px_offset(self.offset_px - offset)
        if self.autofix:
            self._auto_fix_offset()

    def move_offset_with_value(self, value: float) -> None:
        self._set_val_offset(self.offset_val - value)
        if self.autofix:
            self._auto_fix_offset()

    def zoom_around(self, px: int, coeff: float) -> None:
        """Zoom by coeff keeping the value under `px` stationary
        (mouseWheelMoved, PlotVisualizer.java:97-110; ZOOM_AMOUNT=0.95^±1
        per the widget's wheel constants)."""
        val = self.pixels_to_value_absolute(px)
        self.scale *= coeff
        self._recalc()
        newval = self.pixels_to_value_absolute(px)
        self._set_val_offset(self.offset_val - newval + val)
        if self.autofix:
            self._auto_fix_offset()

    def fix_offset(self) -> None:
        self._auto_fix_offset()

    def reset(self) -> None:
        self.scale = 1.0
        self.offset_val = 0.0
        self.offset_px = 0
        self._recalc()

    # ---- conversions ----

    def pixels_to_value_absolute(self, pixels: int) -> float:
        return pixels * self._px_in_values + self.offset_val + self.min_value

    def pixels_to_value_relative(self, pixels: int) -> float:
        return pixels * self._px_in_values

    def value_to_pixel_absolute(self, val: float) -> int:
        return _java_int((val - self.min_value) * self._val_in_pixels) - self.offset_px

    def value_to_pixel_relative(self, val: float) -> int:
        return _java_int(val * self._val_in_pixels)

    # ---- internals ----

    def _set_px_offset(self, offset_px: int) -> None:
        self.offset_px = int(offset_px)
        self.offset_val = self.pixels_to_value_relative(self.offset_px)

    def _set_val_offset(self, offset_val: float) -> None:
        self.offset_val = float(offset_val)
        self.offset_px = self.value_to_pixel_relative(self.offset_val)

    def _recalc(self) -> None:
        span = (self.max_value - self.min_value) * self.scale
        self._val_in_pixels = self.max_pixels / span
        self._px_in_values = span / self.max_pixels
        # max-zoom clamp: never show fewer than max_zoom_val values
        if self.pixels_to_value_relative(self.max_pixels) < self.max_zoom_val:
            self.scale = self.max_zoom_val / (self.max_value - self.min_value)
            span = (self.max_value - self.min_value) * self.scale
            self._val_in_pixels = self.max_pixels / span
            self._px_in_values = span / self.max_pixels

    def _auto_fix_offset(self) -> None:
        if self.offset_px < 0:
            self._set_px_offset(0)
        max_val = self.pixels_to_value_absolute(self.max_pixels)
        if max_val > self.max_value:
            self._set_val_offset(
                self.max_value
                - self.pixels_to_value_relative(self.max_pixels)
                - self.min_value
            )
        if self.offset_px < 0:
            self.reset()
