"""The benchmark's own emanation generator: a monitor's raster, amplitude
modulated onto a carrier at baseband, sampled by a receiver, quantized to
the receiver's raw format. A frozen copy of the port's synthetic source
(its raster and IQ model), made exactly periodic so that a loop of the
stream has no seam.

Receiver sample k sees raster position

    p(k) = floor(k * npix * refresh / fs) mod npix        (integers, exact)

so the stream repeats after `period_frames` frames whenever
period_frames * fs / refresh is a whole number of samples (3 frames at
60 Hz: 3,200,000 samples at 64 MS/s, 800,000 at 16 MS/s). Noise is drawn
from the seed once per period, so the period itself repeats exactly.

Each channel has its own mode where the configuration gives one
(`modes.py`): its refresh rate sets its period, its raster its pixels.
Everything here is numpy on the host and a function of (config, seed).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..modes import channel_mode


def period_samples(samplerate, refreshrate, period_frames: int) -> int:
    """Samples in `period_frames` frames; raises unless it is whole."""
    n = Fraction(samplerate) * period_frames / Fraction(refreshrate)
    if n.denominator != 1:
        raise ValueError(f"{period_frames} frames at {refreshrate} Hz are not a whole "
                         f"number of samples at {samplerate} S/s")
    return int(n)


def render_raster(lines: int, total_width: int, active_width: int, active_lines: int,
                  seed: int) -> np.ndarray:
    """A [lines, total_width] raster in [0, 1]: gradient bars and random
    'text' cells (2 x 2 pixel cells of 0.9 or 0.1, 2 rows of every 4) in the
    active area, 0 in the blanking to the right and below it, as a display's
    timings have it."""
    rng = np.random.default_rng(seed)
    img = np.zeros((lines, total_width), np.float32)
    bars = (np.arange(active_width) * 8 // max(active_width, 1)) % 2
    img[:active_lines, :active_width] = 0.25 + 0.5 * bars[None, :]
    cell = rng.random((active_lines // 4, active_width // 4)) > 0.5
    text = np.kron(cell, np.ones((2, 2), np.float32))
    img[: text.shape[0], : text.shape[1]] = np.where(text, 0.9, 0.1)
    return img


def raster_positions(samplerate, refreshrate, npix: int, n: int) -> np.ndarray:
    """p(k) for k in [0, n): floor(k * npix * refresh / fs) mod npix, in
    exact integer arithmetic (refresh and fs as fractions)."""
    ratio = Fraction(npix) * Fraction(refreshrate) / Fraction(samplerate)
    k = np.arange(n, dtype=np.int64)
    # k * num stays below 2^63 for every geometry the configurations name
    return (k * ratio.numerator // ratio.denominator) % npix


def quantize(iq: np.ndarray, raw_format: str) -> np.ndarray:
    """float32 IQ in about [-1, 1] -> a recording's raw values (the inverse of
    the RawFile plugin's normalisation)."""
    if raw_format == "uint8":
        return np.clip(np.round(iq * 128.0 + 128.0), 0, 255).astype(np.uint8)
    if raw_format == "int8":
        return np.clip(np.round(iq * 128.0), -128, 127).astype(np.int8)
    if raw_format == "int16":
        return np.clip(np.round(iq * 32767.0), -32768, 32767).astype(np.int16)
    if raw_format == "float32":
        return iq.astype(np.float32)
    raise ValueError(f"unknown raw format {raw_format!r}")


def channel_period_samples(cfg: dict, channel: int) -> int:
    """Samples in one period of channel `channel`'s stream."""
    return period_samples(cfg["samplerate"], channel_mode(cfg, channel)["refreshrate"],
                          cfg["period_frames"])


def channel_period(cfg: dict, channel: int, seed: int) -> np.ndarray:
    """One period of channel `channel`'s interleaved raw IQ, [2 * period]."""
    em = cfg["emanation"]
    mode = channel_mode(cfg, channel)
    active_w, active_h = mode["active"]
    period = channel_period_samples(cfg, channel)
    raster = render_raster(mode["lines"], mode["total_width"], active_w, active_h,
                           seed=(seed * 1000003 + 17 * channel) % (1 << 63))
    pos = raster_positions(cfg["samplerate"], mode["refreshrate"], raster.size, period)
    v = raster.reshape(-1)[pos] * np.float32(em["gain"]) + np.float32(em["dc"])
    rng = np.random.default_rng([seed, channel])
    noise = rng.normal(scale=em["noise"], size=(period, 2)).astype(np.float32)
    iq = np.empty((period, 2), np.float32)
    iq[:, 0] = v + noise[:, 0]
    iq[:, 1] = noise[:, 1]
    return quantize(iq.reshape(-1), cfg["raw_format"])


def looped(period_iq: np.ndarray, block_samples: int) -> np.ndarray:
    """The period followed by its first block again: every block of the
    looped stream is then one contiguous slice, at (k * block) mod period."""
    return np.concatenate([period_iq, period_iq[: 2 * block_samples]])


def block_at(looped_iq: np.ndarray, period: int, block_samples: int, k: int) -> np.ndarray:
    """Block k of the looped stream (a view)."""
    at = k * block_samples % period
    return looped_iq[2 * at: 2 * (at + block_samples)]

