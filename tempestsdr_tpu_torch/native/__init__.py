"""ctypes bindings for the native IO runtime (io_runtime.cpp): a bounded
byte ring and a file pump thread, host I/O that runs off the GIL.

The shared library is built with g++ on first use into the package's
build/ directory, named by a hash of the source and the flags
(build/libtsdr_io-<hash>.so), so an edited source never loads a stale
build. No pip/pybind dependency. Callers check `available()` and use the
pure-Python path if the toolchain is missing.

`build_replay_plugin()` builds replay_plugin.c, a test fixture to the
reference's binary plugin ABI that the `cplugin` source loads, with gcc
into the same directory (build/tsdrplugin_replay-<hash>.so).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "io_runtime.cpp")
BUILD = os.path.join(os.path.dirname(_DIR), "build")
_FLAGS = ["-O2", "-shared", "-fPIC", "-pthread"]
_lock = threading.Lock()
_lib = None
_err = None


def _hashed(prefix: str, src: str, flags) -> str:
    """build/<prefix>-<hash of the source and the flags>.so"""
    h = hashlib.sha256(" ".join(flags).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD, f"{prefix}-{h.hexdigest()[:12]}.so")


def lib_path() -> str:
    """Where the library for the current source and flags lives."""
    return _hashed("libtsdr_io", _SRC, _FLAGS)


def _build(so: str, compiler: str = "g++", flags=_FLAGS, src: str = _SRC) -> None:
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run([compiler, *flags, src, "-o", tmp], check=True, capture_output=True, text=True)
    os.replace(tmp, so)


_PLUGIN_SRC = os.path.join(_DIR, "replay_plugin.c")
_PLUGIN_FLAGS = ["-O2", "-fPIC", "-shared"]


def build_replay_plugin() -> str:
    """Build the replay plugin (replay_plugin.c, a fixture that stands in
    for a user's compiled TSDRPlugin) with gcc if it is not built yet, and
    return the path of its shared object. Raises RuntimeError with the
    compiler's message when the build fails."""
    so = _hashed("tsdrplugin_replay", _PLUGIN_SRC, _PLUGIN_FLAGS)
    with _lock:
        if not os.path.exists(so):
            try:
                _build(so, "gcc", _PLUGIN_FLAGS, _PLUGIN_SRC)
            except (OSError, subprocess.CalledProcessError) as e:
                raise RuntimeError(f"replay plugin build failed: {getattr(e, 'stderr', e)}")
    return so


REPLAY_STATS = ("pushes", "samples_pushed", "samples_injected", "active", "readasync_calls",
                "setsamplerate_calls", "basefreq", "gain", "first_push_s", "last_push_s")


def replay_plugin_stats(dll) -> dict:
    """What a loaded replay plugin (a ctypes library, e.g. CPluginSource's)
    did since its init: its replay_plugin_stats counters by REPLAY_STATS'
    names ("active" is 1 while its readasync runs; first_push_s and
    last_push_s are the monotonic clock's seconds at its first and last
    push)."""
    out = (ctypes.c_double * len(REPLAY_STATS))()
    dll.replay_plugin_stats(out)
    return dict(zip(REPLAY_STATS, out))


def load():
    """Return the loaded library, building it if needed."""
    global _lib, _err
    with _lock:
        if _lib is not None:
            return _lib
        if _err is not None:
            raise _err
        try:
            so = lib_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError) as e:
            _err = RuntimeError(f"native IO runtime unavailable: {e}")
            raise _err
        lib.tsdr_ring_create.restype = ctypes.c_void_p
        lib.tsdr_ring_create.argtypes = [ctypes.c_size_t]
        lib.tsdr_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.tsdr_ring_read.restype = ctypes.c_size_t
        lib.tsdr_ring_read.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_int,
        ]
        lib.tsdr_ring_write.restype = ctypes.c_int
        lib.tsdr_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.tsdr_ring_write2.restype = ctypes.c_int
        lib.tsdr_ring_write2.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_int,
        ]
        lib.tsdr_ring_note_dropped.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.tsdr_ring_take_dropped.restype = ctypes.c_uint64
        lib.tsdr_ring_take_dropped.argtypes = [ctypes.c_void_p]
        lib.tsdr_ring_close.argtypes = [ctypes.c_void_p]
        lib.tsdr_filepump_start.restype = ctypes.c_void_p
        lib.tsdr_filepump_start.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.c_double,
            ctypes.c_void_p,
            ctypes.c_long,
        ]
        lib.tsdr_filepump_stop.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    try:
        load()
        return True
    except RuntimeError:
        return False


class Ring:
    """Bounded byte ring (native circbuff equivalent)."""

    def __init__(self, capacity_bytes: int):
        self._lib = load()
        self._h = self._lib.tsdr_ring_create(capacity_bytes)

    def read_into(self, buf_view, blocking: bool = True) -> int:
        n = len(buf_view)
        addr = (ctypes.c_uint8 * n).from_buffer(buf_view)
        return self._lib.tsdr_ring_read(self._h, addr, n, int(blocking))

    def write(self, data: bytes, blocking: bool = False) -> bool:
        """Push bytes. blocking=False drops the chunk whole when full
        (CB_FULL live semantics); blocking=True waits for space
        (backpressure into a paced producer)."""
        return self._lib.tsdr_ring_write2(self._h, data, len(data),
                                          int(blocking)) == 0

    def note_dropped(self, nbytes: int) -> None:
        """Record an externally-reported gap (hardware samples_dropped) at
        the current write position — it matures like an overflow drop."""
        self._lib.tsdr_ring_note_dropped(self._h, nbytes)

    def take_dropped(self) -> int:
        return self._lib.tsdr_ring_take_dropped(self._h)

    def close(self) -> None:
        self._lib.tsdr_ring_close(self._h)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.tsdr_ring_destroy(self._h)
                self._h = None
        except Exception:
            pass


class FilePump:
    """Background file reader feeding a Ring (native RawFile reader thread)."""

    def __init__(self, path: str, chunk_bytes: int, ring: Ring,
                 loop: bool = True, bytes_per_sec: float = 0.0,
                 start_offset: int = 0):
        self._lib = load()
        self._ring = ring
        self._h = self._lib.tsdr_filepump_start(
            path.encode(), chunk_bytes, int(loop), float(bytes_per_sec), ring._h,
            int(start_offset)
        )

    def stop(self) -> None:
        if self._h:
            self._lib.tsdr_filepump_stop(self._h)
            self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass
