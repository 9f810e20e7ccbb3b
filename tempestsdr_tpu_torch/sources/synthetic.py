"""Synthetic emanation generator — the deterministic test fixture.

The reference has no automated tests; its de-facto fixture is replaying
recorded files (SURVEY.md §4). This source goes further: it *renders* a known
raster (test pattern or text-like blocks) and synthesizes the IQ a receiver
would capture from a monitor emitting it — luminance amplitude-modulated onto
a carrier offset, stepped at the display pixel clock, plus optional AWGN —
so end-to-end tests have pixel-level ground truth (dissertation emanation
model, documentation/acs-dissertation.tex:296-400).

Signal model per receiver sample k (sample rate fs, pixel clock fp):
    p(k)   = floor(k * fp / fs) mod (lines * twidth)   # raster position
    v(k)   = raster.flat[p(k)]                          # luminance 0..1
    s(k)   = (dc + v(k)) * exp(2j*pi*f_off*k/fs) + noise
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from .base import Source, SourceBlock, register_source


def render_test_pattern(lines: int, twidth: int, *, active_frac: float = 0.82, seed: int = 0) -> np.ndarray:
    """A raster with blanking borders, gradient bars and random 'text' blocks.

    Returns float raster [lines, twidth] in [0, 1]; the blanking region
    (right and bottom margins, like real video timings) is 0.
    """
    rng = np.random.default_rng(seed)
    active_h = int(lines * active_frac)
    active_w = int(twidth * active_frac)
    img = np.zeros((lines, twidth), np.float32)
    # vertical gradient bars
    bars = (np.arange(active_w) * 8 // max(active_w, 1)) % 2
    img[:active_h, :active_w] = 0.25 + 0.5 * bars[None, :]
    # "text" = random bright/dark cells, 2px tall rows with gaps
    cell = rng.random((active_h // 4, active_w // 4)) > 0.5
    text = np.kron(cell, np.ones((2, 2), np.float32))
    img[: text.shape[0], : text.shape[1]] = np.where(text, 0.9, 0.1)
    return img


def synth_iq(
    raster: np.ndarray,
    *,
    samplerate: float,
    pixelclock: float,
    n_samples: int,
    start_sample: int = 0,
    carrier_offset: float = 0.0,
    dc: float = 0.5,
    noise: float = 0.0,
    seed: int = 1,
    dtype=np.float32,
) -> np.ndarray:
    """Interleaved IQ for samples [start, start+n). Deterministic in
    start_sample, so blocks can be generated independently."""
    lines, twidth = raster.shape
    npix = lines * twidth
    k = np.arange(start_sample, start_sample + n_samples, dtype=np.int64)
    # pixel position = floor(k * pixelclock / samplerate), in 2^20 fixed point
    step_fix = np.int64(round(pixelclock / samplerate * 2**20))
    pos = ((k * step_fix) >> 20) % npix
    v = raster.reshape(-1)[pos] + dc
    if carrier_offset != 0.0:
        ph = 2 * np.pi * carrier_offset * (k / samplerate)
        i = (v * np.cos(ph)).astype(np.float32)
        q = (v * np.sin(ph)).astype(np.float32)
    else:
        i = v.astype(np.float32)
        q = np.zeros_like(i)
    if noise > 0.0:
        rng = np.random.default_rng(seed + start_sample % (2**31))
        i = i + rng.normal(scale=noise, size=i.shape).astype(np.float32)
        q = q + rng.normal(scale=noise, size=q.shape).astype(np.float32)
    out = np.empty(2 * n_samples, np.float32)
    out[0::2] = i
    out[1::2] = q
    if dtype == np.float32:
        return out
    # quantize like a recording in the requested format (inverse of
    # TSDRPlugin_RawFile.c:241-261 normalization)
    if dtype == np.uint8:
        return np.clip(out * 128.0 + 128.0, 0, 255).astype(np.uint8)
    if dtype == np.int8:
        return np.clip(out * 128.0, -128, 127).astype(np.int8)
    if dtype == np.int16:
        return np.clip(out * 32767.0, -32768, 32767).astype(np.int16)
    if dtype == np.uint16:
        return np.clip(out * 32767.0 + 32767.0, 0, 65535).astype(np.uint16)
    raise TypeError(dtype)


@register_source("synthetic")
class SyntheticSource(Source):
    """params: "lines twidth refreshrate samplerate [noise]" — pixelclock is
    lines*twidth*refreshrate; carrier at baseband."""

    def __init__(self):
        self._working = False
        self._raster = None
        self._rate = 0.0
        self._pixclock = 0.0
        self._noise = 0.0
        self._pos = 0

    def init(self, params: str) -> None:
        # malformed params -> PLUGIN_PARAMETERS_WRONG, like every plugin's
        # tsdrplugin_init contract (TSDRLibrary.h TSDR_PLUGIN_PARAMETERS_WRONG)
        try:
            toks = params.split()
            lines, twidth = int(toks[0]), int(toks[1])
            refresh, rate = float(toks[2]), float(toks[3])
            self._noise = float(toks[4]) if len(toks) > 4 else 0.0
            if lines <= 0 or twidth <= 0 or refresh <= 0 or rate <= 0:
                raise ValueError("all geometry params must be positive")
        except (ValueError, IndexError) as e:
            from ..errors import TSDRError, TSDRStatus

            raise TSDRError(
                TSDRStatus.PLUGIN_PARAMETERS_WRONG,
                f"synthetic params must be 'lines twidth refresh_hz samplerate "
                f"[noise]', got {params!r}: {e}",
            ) from e
        self._raster = render_test_pattern(lines, twidth)
        self._rate = rate
        self._pixclock = lines * twidth * refresh
        self._pos = 0

    def name(self) -> str:
        return "Synthetic emanation source"

    def samplerate(self) -> float:
        return self._rate

    def stream(self, block_samples: int) -> Iterator[SourceBlock]:
        self._working = True
        while self._working:
            blk = synth_iq(
                self._raster,
                samplerate=self._rate,
                pixelclock=self._pixclock,
                n_samples=block_samples,
                start_sample=self._pos,
                noise=self._noise,
            )
            self._pos += block_samples
            yield SourceBlock(blk, 0)

    def stop(self) -> None:
        self._working = False
