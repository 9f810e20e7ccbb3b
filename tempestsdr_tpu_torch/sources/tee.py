"""Record what a source delivered, and play it back: fixtures for tests and
measurements (chip_smoke.py's live phase, tests/test_torch_live.py), which no
entry point of the receiver uses.

A live source (a radio behind `cplugin`, `simlive`) delivers blocks on its
own clock and drops what the receiver was too slow to take, so no second
run gets the same blocks. `TeeSource` wraps a source and keeps every block
it yields with its `dropped` count, and the host seconds the consumer
waited for each; `RecordedSource` plays such a recording back as a source,
so the same blocks and drops can go through another step (the CPU's, or
another package's) and be held against the live run.

The tee keeps the arrays the source yields, not copies: every ring-backed
source hands out a fresh array per block. `gaps_in` checks such a
recording of a source that replays a known capture: each reported drop
must be in the data, where the data has it.
"""

from __future__ import annotations

import time
from typing import Iterator, Sequence

import numpy as np

from ..errors import TSDRError, TSDRStatus
from .base import Source, SourceBlock


class TeeSource(Source):
    """`source`, with each delivered block kept in `blocks` and the host
    seconds spent waiting for it in `wait_s`."""

    def __init__(self, source: Source):
        self.source = source
        self.blocks: list[SourceBlock] = []
        self.wait_s: list[float] = []

    def init(self, params: str) -> None:
        self.source.init(params)

    def name(self) -> str:
        return self.source.name()

    def samplerate(self) -> float:
        return self.source.samplerate()

    def set_samplerate(self, rate: float) -> float:
        return self.source.set_samplerate(rate)

    def set_basefreq(self, freq: float) -> None:
        self.source.set_basefreq(freq)

    def set_freq_offset(self, offset_hz: float) -> None:
        self.source.set_freq_offset(offset_hz)

    def set_gain(self, gain: float) -> None:
        self.source.set_gain(gain)

    def block_dtype(self):
        return self.source.block_dtype()

    def stream(self, block_samples: int) -> Iterator[SourceBlock]:
        it = iter(self.source.stream(block_samples))
        try:
            while True:
                t0 = time.perf_counter()
                blk = next(it, None)
                if blk is None:
                    return
                self.wait_s.append(time.perf_counter() - t0)
                self.blocks.append(SourceBlock(blk.samples, int(blk.dropped)))
                yield blk
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def stop(self) -> None:
        self.source.stop()

    def last_error(self) -> str:
        return self.source.last_error()

    def cleanup(self) -> None:
        self.source.cleanup()

    @property
    def samples_dropped(self) -> int:
        return sum(b.dropped for b in self.blocks)


class RecordedSource(Source):
    """The blocks of a recording (a TeeSource's `blocks`) as a source at
    `samplerate`; the stream ends after the last block."""

    def __init__(self, blocks: Sequence[SourceBlock], samplerate: float):
        self.blocks = list(blocks)
        self._rate = float(samplerate)

    def init(self, params: str) -> None:
        pass

    def name(self) -> str:
        return "recorded blocks"

    def samplerate(self) -> float:
        return self._rate

    def block_dtype(self):
        return self.blocks[0].samples.dtype.type if self.blocks else np.float32

    def stream(self, block_samples: int) -> Iterator[SourceBlock]:
        for blk in self.blocks:
            if blk.samples.size != 2 * block_samples:
                raise TSDRError(TSDRStatus.WRONG_VIDEOPARAMS,
                                f"recorded block of {blk.samples.size // 2} samples, "
                                f"asked for {block_samples}")
            yield blk

    def stop(self) -> None:
        pass


def _window(cap: np.ndarray, at: int, n: int) -> np.ndarray:
    return np.take(cap, np.arange(at, at + n), axis=0, mode="wrap")


def _find(cap: np.ndarray, piece: np.ndarray, probe: int = 16) -> list[int]:
    """Every capture position where `piece` (IQ pairs) starts, wrapping."""
    n = len(cap)
    at = np.flatnonzero((cap == piece[0]).all(axis=1))
    for j in range(1, min(probe, len(piece))):
        at = at[(cap[(at + j) % n] == piece[j]).all(axis=1)]
    return [int(a) for a in at if np.array_equal(_window(cap, int(a), len(piece)), piece)]


def gaps_in(blocks: Sequence[SourceBlock], capture: np.ndarray,
            push_samples: int) -> list[tuple[int, int, int]]:
    """Where the gaps lie in a recording of a source that replays a known
    capture in a loop from its start (the replay plugin, `rawfile`).
    `capture` holds the values the source delivers (interleaved, as
    normalize_iq gives them); the source delivers whole pushes of
    `push_samples` IQ samples, so a gap can only lie where a push starts.

    Returns (block, sample offset in the block, samples skipped mod the
    capture's length) for each gap. Raises ValueError unless every block is
    the capture with its own reported `dropped` skipped inside it: a gap
    reported once, on the first block that holds data after it."""
    cap = np.asarray(capture).reshape(-1, 2)
    n_cap = len(cap)
    pos = delivered = 0
    gaps = []
    for b, blk in enumerate(blocks):
        arr = np.asarray(blk.samples).reshape(-1, 2)
        skipped = off = 0
        while off < len(arr):
            take = min(push_samples - delivered % push_samples, len(arr) - off)
            piece = arr[off:off + take]
            if not np.array_equal(_window(cap, pos, take), piece):
                if delivered % push_samples:
                    raise ValueError(f"block {b}: samples from {off} are not the capture's, "
                                     "and no push starts there")
                found = _find(cap, piece)
                if not found:
                    raise ValueError(f"block {b}: samples from {off} are nowhere in the capture")
                at = min(found, key=lambda a: (a - pos) % n_cap)
                gaps.append((b, off, (at - pos) % n_cap))
                skipped += (at - pos) % n_cap
                pos = at
            pos = (pos + take) % n_cap
            off += take
            delivered += take
        if (int(blk.dropped) - skipped) % n_cap:
            raise ValueError(f"block {b} reports {blk.dropped} samples dropped; its data skips "
                             f"{skipped} (mod the capture's {n_cap})")
    return gaps
