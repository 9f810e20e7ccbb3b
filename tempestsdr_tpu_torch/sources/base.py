"""Source protocol — the L1 seam.

Mirrors the 10-function plugin ABI (TSDRPlugin.h:49-60):
init/getName/getsamplerate/setsamplerate/setbasefreq/setgain/stop/readasync/
getlasterrortext/cleanup. `readasync`'s push callback becomes a pull
generator of (raw_samples, dropped) blocks — the jitted pipeline is the
natural consumer, and backpressure is implicit.
"""

from __future__ import annotations

import abc
from typing import Iterator, NamedTuple

import numpy as np

from ..errors import TSDRError, TSDRStatus


class SourceBlock(NamedTuple):
    """One block of interleaved raw IQ + the dropped-sample count that
    precedes it (TSDRPlugin.h:49 tsdrplugin_readasync_function)."""

    samples: np.ndarray  # interleaved I/Q, any of the 5 supported dtypes
    dropped: int


class Source(abc.ABC):
    """Capability surface of the reference plugin ABI."""

    @abc.abstractmethod
    def init(self, params: str) -> None: ...

    @abc.abstractmethod
    def name(self) -> str: ...

    @abc.abstractmethod
    def samplerate(self) -> float: ...

    def set_samplerate(self, rate: float) -> float:
        raise TSDRError(TSDRStatus.NOT_IMPLEMENTED, "samplerate is fixed for this source")

    def set_basefreq(self, freq: float) -> None:
        pass  # file/synthetic sources have no tuner

    def set_freq_offset(self, offset_hz: float) -> None:
        """Relative retune around the current base frequency — the
        superbandwidth hop control's shiftfreq (TSDRLibrary.c:208-211).
        Tuner-backed sources override; file/synthetic sources ignore."""

    def set_gain(self, gain: float) -> None:
        pass

    @abc.abstractmethod
    def stream(self, block_samples: int) -> Iterator[SourceBlock]:
        """Yield blocks of exactly 2*block_samples interleaved raw values."""

    def block_dtype(self):
        """dtype of the blocks stream() will yield (used to warm-compile
        steps for a geometry before streaming it). Default float32; raw-file
        sources override with the file's sample format."""
        import numpy as np

        return np.float32

    @abc.abstractmethod
    def stop(self) -> None: ...

    def last_error(self) -> str:
        return ""

    def cleanup(self) -> None:
        self.stop()


_REGISTRY: dict[str, type] = {}


def register_source(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def load_source(name: str, params: str = "") -> Source:
    """Plugin-loader equivalent (TSDRPluginLoader.c:33-72): resolve by name,
    init with an opaque parameter string."""
    cls = _REGISTRY.get(name)
    if cls is None:
        raise TSDRError(
            TSDRStatus.INCOMPATIBLE_PLUGIN,
            f"unknown source '{name}' (have: {sorted(_REGISTRY)})",
        )
    src = cls()
    src.init(params)
    return src
