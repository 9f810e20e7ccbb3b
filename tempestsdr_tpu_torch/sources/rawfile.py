"""Recorded-IQ file replay — the reproducibility and benchmark harness.

Functional equivalent of TSDRPlugin_RawFile (TSDRPlugin_RawFile.c):
  - params string "filename samplerate format" with a quote-aware tokenizer
    (:123-162); formats float/int8/uint8/int16/uint16 (:174-190)
  - loop at EOF (:230-235)
  - real-time throttling (tick-tock timer sleep :214-217,265-269), disabled
    in benchmark mode (the PERFORMANCE_BENCHMARK compile flag :35 becomes a
    constructor argument)
  - TIME_STRETCH slow-motion factor (:38)

Unlike the reference (which converts to float32 on the CPU :241-261), blocks
are yielded in the file's raw dtype — normalization runs on the device
(ops.demod.normalize_iq), cutting host->device bandwidth by up to 8x.
With native=None (the default) the file is read by the native file pump
(../native) when it builds, else with numpy.
"""

from __future__ import annotations

import shlex
import time
from typing import Iterator

import numpy as np

from ..errors import TSDRError, TSDRStatus
from .base import Source, SourceBlock, register_source

_FORMATS = {
    "float": np.float32,
    "int8": np.int8,
    "uint8": np.uint8,
    "int16": np.int16,
    "uint16": np.uint16,
}


def sniff_wav(path: str):
    """Detect a WAV recording and extract (samplerate, format) — the GUI's
    file-chooser autodetection (TSDRFileSource.java:43-85: RIFF/WAVE/fmt
    magic, sample rate from the fmt chunk, 8/16 bits -> int8/int16).
    Returns (samplerate, fmt_name, data_offset) or None."""
    try:
        with open(path, "rb") as f:
            hdr = f.read(44)
        if len(hdr) < 44 or hdr[0:4] != b"RIFF" or hdr[8:12] != b"WAVE" or hdr[12:16] != b"fmt ":
            return None
        samplerate = int.from_bytes(hdr[24:28], "little")
        bits = int.from_bytes(hdr[34:36], "little")
        if bits == 8:
            # 8-bit WAV is unsigned by spec; the reference maps it to int8
            # (TSDRFileSource.java:65) — match its behavior
            return samplerate, "int8", 44
        if bits == 16:
            return samplerate, "int16", 44
        return None
    except OSError:
        return None


@register_source("rawfile")
class RawFileSource(Source):
    def __init__(self, loop: bool = True, throttle: bool = False, time_stretch: float = 1.0,
                 native: bool | None = None):
        self._loop = loop
        self._throttle = throttle
        self._stretch = time_stretch
        self._working = False
        self._err = ""
        self._filename = None
        self._rate = 0.0
        self._dtype = None
        self._native = native  # None = auto (use native runtime if it builds)

    def init(self, params: str) -> None:
        try:
            toks = shlex.split(params)
            if len(toks) == 1:
                # bare filename: WAV autodetection (TSDRFileSource.java:43-85)
                wav = sniff_wav(toks[0])
                if wav is None:
                    raise ValueError
                self._filename = toks[0]
                self._rate, fmt, self._data_offset = float(wav[0]), wav[1], wav[2]
                self._dtype = _FORMATS[fmt]
                return
            if len(toks) < 3:
                raise ValueError
            self._filename, rate_s, fmt = toks[:3]
            self._data_offset = 0
            self._rate = float(rate_s)
            if self._rate <= 0:
                raise ValueError
            self._dtype = _FORMATS[fmt]
            # optional trailing tokens (the reference's compile-time knobs
            # PERFORMANCE_BENCHMARK / TIME_STRETCH / ENABLE_LOOP as runtime
            # options): "throttle", "stretch=N", "noloop"
            for tok in toks[3:]:
                if tok == "throttle":
                    self._throttle = True
                elif tok == "noloop":
                    self._loop = False
                elif tok.startswith("stretch="):
                    self._stretch = float(tok.split("=", 1)[1])
                    self._throttle = True
                else:
                    raise ValueError
        except (ValueError, KeyError):
            self._err = (
                "params should be: filename samplerate format "
                "(format: float, int8, uint8, int16 or uint16), or a single "
                "WAV filename for autodetection"
            )
            raise TSDRError(TSDRStatus.PLUGIN_PARAMETERS_WRONG, self._err)

    def name(self) -> str:
        return "RawFile source"

    def samplerate(self) -> float:
        return self._rate

    def block_dtype(self):
        return self._dtype if self._dtype is not None else np.float32

    def stream(self, block_samples: int) -> Iterator[SourceBlock]:
        if self._dtype is None:
            raise TSDRError(TSDRStatus.PLUGIN_PARAMETERS_WRONG, "not initialized")
        use_native = self._native
        if use_native is None:
            from .. import native as native_io

            use_native = native_io.available()
        if use_native:
            yield from self._stream_native(block_samples)
            return
        self._working = True
        values_per_block = 2 * block_samples
        block_seconds = block_samples / self._rate * self._stretch
        next_deadline = time.monotonic()
        try:
            f = open(self._filename, "rb")
        except OSError as e:
            self._err = str(e)
            raise TSDRError(TSDRStatus.PLUGIN_PARAMETERS_WRONG, f"cannot open file: {e}")
        with f:
            offset = getattr(self, "_data_offset", 0)
            if offset:
                f.seek(offset)
            carry = np.empty((0,), self._dtype)
            while self._working:
                need = values_per_block - len(carry)
                data = np.fromfile(f, dtype=self._dtype, count=need)
                if len(data) < need:
                    if not self._loop:
                        break
                    f.seek(offset)
                    data = np.concatenate(
                        [data, np.fromfile(f, dtype=self._dtype, count=need - len(data))]
                    )
                    if len(data) < need:
                        self._err = "file smaller than one block"
                        break
                block = np.concatenate([carry, data]) if len(carry) else data
                carry = np.empty((0,), self._dtype)
                if self._throttle:
                    next_deadline += block_seconds
                    delay = next_deadline - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
                yield SourceBlock(block, 0)

    def _stream_native(self, block_samples: int) -> Iterator[SourceBlock]:
        """Native path: C++ file-pump thread -> byte ring -> raw blocks.

        Disk IO and real-time pacing run off the GIL (the reference's plugin
        reader thread, TSDRPlugin_RawFile.c:219-271); ring overflow converts
        to a samples_dropped report like a hardware source."""
        from .. import native as native_io

        self._working = True
        itemsize = np.dtype(self._dtype).itemsize
        block_bytes = 2 * block_samples * itemsize
        ring = native_io.Ring(max(8 * block_bytes, 1 << 22))
        bps = 0.0
        if self._throttle:
            bps = 2 * self._rate * itemsize / self._stretch
        pump = native_io.FilePump(self._filename, block_bytes, ring,
                                  loop=self._loop, bytes_per_sec=bps,
                                  start_offset=getattr(self, "_data_offset", 0))
        try:
            # matured drops attach to the block AFTER the gap, like the
            # other ring consumers (see sources/live.py). The file pump
            # pushes blocking so drops normally never fire here.
            # take right after each read: strict-< maturation attributes
            # the gap to the first block containing post-gap data
            while self._working:
                buf = bytearray(block_bytes)
                got = ring.read_into(memoryview(buf), blocking=True)
                if got < block_bytes:
                    break  # pump finished (non-loop EOF) or closed
                dropped_bytes = ring.take_dropped()
                arr = np.frombuffer(bytes(buf), dtype=self._dtype)
                yield SourceBlock(arr, int(dropped_bytes // (2 * itemsize)))
        finally:
            pump.stop()

    def stop(self) -> None:
        self._working = False

    def last_error(self) -> str:
        return self._err
