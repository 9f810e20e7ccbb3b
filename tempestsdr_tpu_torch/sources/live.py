"""Simulated live hardware source — exercises the full live-plugin seam.

A real SDR (TSDRPlugin_UHD.cpp) delivers IQ on its own schedule: a receive
thread accumulates ~0.06 s per callback (:38,249) and, when the consumer
falls behind, samples are *lost in hardware* and reported via
`samples_dropped` (timestamp-gap estimation :264-294; the Mirics counter-gap
equivalent TSDRPlugin_Mirics.c:118-128). This source reproduces those
semantics end-to-end against the native IO runtime:

  - a producer thread generates synthetic-emanation IQ at a paced rate and
    pushes each chunk into the native bounded ring with NON-blocking writes
    — a full ring drops the whole chunk and counts it (cb_add CB_FULL,
    circbuff.c:95-134), exactly like a hardware FIFO overflow;
  - the producer's sample position advances regardless, so dropped chunks
    are genuinely missing from the stream (the gap is real, not simulated);
  - `stream()` pops fixed blocks and converts the ring's dropped-byte count
    into the `samples_dropped` field of the block that FOLLOWS the gap: the
    native ring positions each drop in the stream (a chunk dropped at write
    time sits after everything still buffered) and releases its count only
    once the reader has consumed the bytes that preceded it, matching the
    UHD convention of reporting drops with the delivery after the gap
    (TSDRPlugin_UHD.cpp:264-294); the pipeline's whole-frame drop
    compensation consumes it (dsp.c:313-368).

Params string: "lines twidth refresh samplerate noise [pace=N] [ring=N]"
  pace: production rate as a multiple of real time (default 0 = unthrottled,
        i.e. produce as fast as the consumer + ring allow — overload mode);
  ring: ring capacity in chunks (default 8; small values force overflow).
"""

from __future__ import annotations

import shlex
import threading
import time
from typing import Iterator

import numpy as np

from ..errors import TSDRError, TSDRStatus
from .base import Source, SourceBlock, register_source
from .synthetic import render_test_pattern, synth_iq

CHUNK_SECONDS = 0.06  # samples accumulated per delivery (TSDRPlugin_UHD.cpp:38)


@register_source("simlive")
class SimulatedLiveSource(Source):
    def __init__(self):
        self._err = ""
        self._rate = 0.0
        self._producer: threading.Thread | None = None
        self._running = False
        self._ring = None
        self._paused = threading.Event()

    def init(self, params: str) -> None:
        try:
            toks = shlex.split(params)
            if len(toks) < 5:
                raise ValueError
            lines, twidth = int(toks[0]), int(toks[1])
            self._refresh = float(toks[2])
            self._rate = float(toks[3])
            self._noise = float(toks[4])
            self._pace = 0.0
            self._ring_chunks = 8
            for tok in toks[5:]:
                if tok.startswith("pace="):
                    self._pace = float(tok.split("=", 1)[1])
                elif tok.startswith("ring="):
                    self._ring_chunks = int(tok.split("=", 1)[1])
                else:
                    raise ValueError
            if lines <= 0 or twidth <= 0 or self._rate <= 0:
                raise ValueError
            self._raster = render_test_pattern(lines, twidth)
            self._pixclock = lines * twidth * self._refresh
        except (ValueError, IndexError):
            self._err = (
                "params should be: lines twidth refresh samplerate noise "
                "[pace=N] [ring=N]"
            )
            raise TSDRError(TSDRStatus.PLUGIN_PARAMETERS_WRONG, self._err)

    def name(self) -> str:
        return "Simulated live SDR source"

    def samplerate(self) -> float:
        return self._rate

    # test/diagnostic hooks -------------------------------------------------

    def pause_producer(self) -> None:
        """Hold the producer (e.g. to let the consumer drain the ring)."""
        self._paused.set()

    def resume_producer(self) -> None:
        self._paused.clear()

    # ----------------------------------------------------------------------

    def _produce(self, ring, chunk_samples: int):
        """Producer thread: the hardware's receive loop. Never blocks on the
        consumer — a full ring loses the chunk (counted), and the stream
        position advances past it either way."""
        pos = 0
        deadline = time.monotonic()
        chunk_seconds = chunk_samples / self._rate
        while self._running:
            if self._paused.is_set():
                time.sleep(0.001)
                continue
            blk = synth_iq(
                self._raster,
                samplerate=self._rate,
                pixelclock=self._pixclock,
                n_samples=chunk_samples,
                start_sample=pos,
                noise=self._noise,
            )
            pos += chunk_samples  # advances whether or not the push lands
            ring.write(blk.tobytes())  # non-blocking: CB_FULL -> drop+count
            if self._pace > 0:
                deadline += chunk_seconds / self._pace
                delay = deadline - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
        ring.close()

    def stream(self, block_samples: int) -> Iterator[SourceBlock]:
        from .. import native as native_io

        if not native_io.available():
            raise TSDRError(
                TSDRStatus.ERR_PLUGIN, "native IO runtime required for simlive"
            )
        if self._rate <= 0:
            raise TSDRError(TSDRStatus.PLUGIN_PARAMETERS_WRONG, "not initialized")
        chunk_samples = max(int(CHUNK_SECONDS * self._rate), 1024)
        chunk_bytes = 2 * chunk_samples * 4  # f32 interleaved
        block_bytes = 2 * block_samples * 4
        ring = native_io.Ring(self._ring_chunks * chunk_bytes)
        self._ring = ring
        self._running = True
        self._producer = threading.Thread(
            target=self._produce, args=(ring, chunk_samples), daemon=True
        )
        self._producer.start()
        try:
            # take_dropped() matures a gap only once a post-gap byte was
            # consumed (strict <, io_runtime.cpp), so taking right after
            # each read attaches the gap to the first block containing
            # post-gap samples (samples_dropped = gap before this block's
            # samples, TSDRPlugin_UHD.cpp:264-294)
            while self._running:
                buf = bytearray(block_bytes)
                got = ring.read_into(memoryview(buf), blocking=True)
                if got < block_bytes:
                    break  # closed
                dropped_bytes = ring.take_dropped()
                # a fresh bytearray each block: the array over it needs no copy
                arr = np.frombuffer(buf, dtype=np.float32)
                yield SourceBlock(arr, int(dropped_bytes // 8))
        finally:
            self.stop()

    def stop(self) -> None:
        self._running = False
        if self._ring is not None:
            self._ring.close()
        if self._producer is not None and self._producer.is_alive():
            self._producer.join(timeout=5)
            self._producer = None

    def last_error(self) -> str:
        return self._err
