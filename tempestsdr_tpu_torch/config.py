"""Static pipeline configuration — the recompile boundary.

Geometry derivation follows the reference's `set_internal_samplerate`
(TempestSDR/src/TSDRLibrary.c:540-550): the user supplies (height,
refreshrate); width is derived as 2x horizontal oversampling of the line
time, and pixelrate = width*height*refreshrate (~= 2*samplerate). The
frame-rate PLL nudges refreshrate continuously at runtime
(syncdetector.c:149-151); in the TPU design that is a *traced* f32 delta
against the static nominal rate here, so geometry (and therefore every array
shape) stays static under jit.

Autocorrelation estimator sizing follows frameratedetector.c:20-24,91-95,160
(3.1-frame capture rounds, pow2-truncated FFT per fft.c:5-11, frame-lag and
line-lag search windows).
"""

from __future__ import annotations

import dataclasses
import math

FRAC_BITS = 40  # fixed-point fractional bits for resampler phase arithmetic

# Static headroom for the frame-rate PLL's refresh-rate excursion, as a
# fraction of the nominal rate. Every statically-sized resampler buffer
# (max_block_pixels, strided taps_eff, sharded pixel ownership) is derived
# assuming |refresh_delta| <= PLL_HEADROOM_FRAC * refreshrate; framerate_pll
# clamps its delta to this bound (the reference instead re-derives geometry
# on every nudge, set_internal_samplerate TSDRLibrary.c:540-550 — here
# geometry is static, so an unbounded walk would silently truncate frames).
PLL_HEADROOM_FRAC = 0.002

# Estimator constants (frameratedetector.c:20-24)
MIN_FRAMERATE = 55
MAX_FRAMERATE = 87
MIN_HEIGHT = 590
MAX_HEIGHT = 1500
FRAMES_TO_CAPTURE = 3.1

# Autogain IIR coefficient (TSDRLibrary.c:37 NORMALISATION_LOWPASS_COEFF)
NORMALISATION_LOWPASS_COEFF = 0.1

# Special debug pixel values (TSDRLibrary.h:20-24)
PIXEL_SPECIAL_VALUE_R = 256.0
PIXEL_SPECIAL_VALUE_G = 512.0
PIXEL_SPECIAL_VALUE_B = 1024.0
PIXEL_SPECIAL_VALUE_TRANSPARENT = 2048.0

# Reference hard limits (TSDRLibrary.c:31-32)
MAX_ARR_SIZE = 4000 * 4000
MAX_SAMP_RATE = 500e6


def floor_pow2(n: int) -> int:
    """Largest power of two <= n (fft.c:5-11 fft_getrealsize)."""
    if n < 1:
        return 0
    return 1 << (n.bit_length() - 1)


def ac_fft_size_for(samplerate: float) -> int:
    """Estimator FFT size as a function of samplerate alone — the same
    formula as PipelineConfig.ac_fft_size (frameratedetector.c:160 round
    length, fft.c:55 pow2 truncation), for consumers that only see plot
    events (e.g. the auto-resolution tracker's mirror disambiguation)."""
    return floor_pow2(int(FRAMES_TO_CAPTURE * samplerate / MIN_FRAMERATE))


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    samplerate: float  # device sample rate, Hz
    height: int  # total lines per frame (incl. blanking)
    refreshrate: float  # nominal refresh rate, Hz (PLL delta is traced)
    block_samples: int = 1 << 16  # IQ samples per streaming step
    autocorr: bool = True  # build the estimator path
    high_precision_sync: bool = True  # f64 frame collapse (reference parity);
    # False = f32 accumulate, avoiding the one megapixel-scale emulated-f64
    # op on TPU (profiles still widen to f64 downstream)

    def __post_init__(self):
        if self.height <= 0 or self.refreshrate <= 0:
            raise ValueError("invalid height/refreshrate")
        if self.samplerate <= 0 or self.samplerate > MAX_SAMP_RATE:
            raise ValueError("invalid samplerate")
        if self.width * self.height > MAX_ARR_SIZE:
            raise ValueError("frame too large")

    # ---- geometry (TSDRLibrary.c:540-550) ----

    @property
    def width(self) -> int:
        real_width = self.samplerate / (self.refreshrate * self.height)
        return int(2 * real_width)

    @property
    def frame_pixels(self) -> int:
        return self.width * self.height

    @property
    def pixelrate(self) -> float:
        return self.width * self.height * self.refreshrate

    @property
    def samples_per_pixel(self) -> float:
        """pixeltimeoversampletime (TSDRLibrary.c:549): ~0.5."""
        return self.samplerate / self.pixelrate

    @property
    def inv0_fix(self) -> int:
        """Nominal samples-per-pixel in FRAC_BITS fixed point (exact int)."""
        return round(self.samples_per_pixel * (1 << FRAC_BITS))

    @property
    def max_block_pixels(self) -> int:
        """Static upper bound on pixels completed per block (2% PLL headroom)."""
        r = self.pixelrate / self.samplerate
        return int(self.block_samples * r * 1.02) + 2

    @property
    def resample_taps(self) -> int:
        """Input samples a single output pixel's box window can span."""
        return int(math.ceil(self.samples_per_pixel * 1.02)) + 1

    @property
    def frames_per_block(self) -> int:
        """Static upper bound K on whole frames completed per step.

        K == 1 reproduces the round-1..3 single-emit step bit-exactly
        (max_block_pixels + taps < frame_pixels — the old hard limit). K > 1
        builds the multi-emit step: big blocks amortize the measured ~0.5 ms
        per-block fixed cost (scan floor + cond plumbing + per-kernel
        launches, ROOFLINE.md) across several frames, which is the lever the
        round-3 block-size sweep hit the one-frame wall on."""
        return 1 + (self.max_block_pixels + self.resample_taps) // self.frame_pixels

    # ---- autocorrelation estimator (frameratedetector.c) ----

    @property
    def ac_round_samples(self) -> int:
        """Samples consumed per estimation round (frameratedetector.c:160)."""
        return int(FRAMES_TO_CAPTURE * self.samplerate / MIN_FRAMERATE)

    @property
    def ac_fft_size(self) -> int:
        """pow2 FFT size actually transformed (fft.c:55)."""
        return floor_pow2(self.ac_round_samples)

    @property
    def ac_frame_window(self):
        """(offset, length) of frame-rate lag window (frameratedetector.c:91-92,118)."""
        maxlength = int(self.samplerate / MIN_FRAMERATE)
        minlength = int(self.samplerate / MAX_FRAMERATE)
        return minlength, maxlength - minlength

    @property
    def ac_line_window(self):
        """(offset, length) of line-rate lag window (frameratedetector.c:94-95,119)."""
        maxlength = int(self.samplerate / (MIN_HEIGHT * MIN_FRAMERATE))
        minlength = int(self.samplerate / (MAX_HEIGHT * MAX_FRAMERATE))
        return minlength, maxlength - minlength
