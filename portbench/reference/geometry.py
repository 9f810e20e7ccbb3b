"""A receiver geometry's derived sizes, worked out from the configuration's
numbers alone (the reference TempestSDR's set_internal_samplerate,
TSDRLibrary.c:540-550, and the estimator's sizes, frameratedetector.c:20-24,
91-95, 160), in the receiver's own float operation order so that every
size is the receiver's to the sample."""

from __future__ import annotations

import math

from ..modes import channel_mode

FRAC_BITS = 40  # fixed-point bits of the resampler's phase
PLL_HEADROOM_FRAC = 0.002  # the PLL's refresh-rate delta is clamped to this share
NORMALISATION_LOWPASS_COEFF = 0.1  # TSDRLibrary.c:37
MIN_FRAMERATE, MAX_FRAMERATE = 55, 87
MIN_HEIGHT, MAX_HEIGHT = 590, 1500
FRAMES_TO_CAPTURE = 3.1


def floor_pow2(n: int) -> int:
    return 0 if n < 1 else 1 << (n.bit_length() - 1)


class Geometry:
    def __init__(self, samplerate, height: int, refreshrate, block_samples: int):
        self.samplerate = float(samplerate)
        self.height = int(height)
        self.refreshrate = float(refreshrate)
        self.n = int(block_samples)
        real_width = self.samplerate / (self.refreshrate * self.height)
        self.width = int(2 * real_width)
        self.fp = self.width * self.height
        pixelrate = self.width * self.height * self.refreshrate
        self.samples_per_pixel = self.samplerate / pixelrate
        self.inv0_fix = round(self.samples_per_pixel * (1 << FRAC_BITS))
        self.mp = int(self.n * (pixelrate / self.samplerate) * 1.02) + 2
        self.taps = int(math.ceil(self.samples_per_pixel * 1.02)) + 1
        self.k_frames = 1 + (self.mp + self.taps) // self.fp
        self.ac_round = int(FRAMES_TO_CAPTURE * self.samplerate / MIN_FRAMERATE)
        self.ac_fft = floor_pow2(self.ac_round)
        fmax, fmin = int(self.samplerate / MIN_FRAMERATE), int(self.samplerate / MAX_FRAMERATE)
        self.frame_window = (fmin, fmax - fmin)
        lmax = int(self.samplerate / (MIN_HEIGHT * MIN_FRAMERATE))
        lmin = int(self.samplerate / (MAX_HEIGHT * MAX_FRAMERATE))
        self.line_window = (lmin, lmax - lmin)
        self.block2 = int(round(2 * self.fp * self.samples_per_pixel))
        k = self.k_frames
        self.framebuf_len = self.fp + self.mp if k == 1 else max(self.fp + self.mp,
                                                                  (k + 1) * self.fp)
        self.pixels_per_sample = pixelrate / self.samplerate

    @property
    def key(self) -> tuple:
        """What the sizes follow from: equal keys, equal geometries."""
        return self.samplerate, self.height, self.refreshrate, self.n

    @classmethod
    def of(cls, cfg: dict, channel: int = 0) -> "Geometry":
        """Channel `channel`'s receiver geometry (modes.py)."""
        m = channel_mode(cfg, channel)
        return cls(cfg["samplerate"], m["height"], m["refreshrate"], cfg["block_samples"])
