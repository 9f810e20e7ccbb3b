"""Binary TSDRPlugin loader — run the reference's native source plugins
unchanged.

The reference's L1 contract is a BINARY one: a shared object exporting the
10-function C ABI (TSDRPlugin.h:49-60), resolved with dlopen/dlsym
(TSDRPluginLoader.c:33-72). Users migrating from the reference own compiled
TSDRPlugin_*.so files (RawFile, UHD, Mirics, SDRplay, or third-party); this
source loads those exact binaries through ctypes and adapts their push
callback (`tsdrplugin_readasync_function` — float32 interleaved I/Q plus a
preceding samples_dropped count) onto the framework's pull-based Source
protocol via the native byte ring.

Semantics preserved from the reference loader:
  - missing ABI symbols -> TSDRStatus.INCOMPATIBLE_PLUGIN, any other load
    failure -> ERR_PLUGIN (the TSDR_INCOMPATIBLE_PLUGIN vs TSDR_ERR_PLUGIN
    distinction, TSDRPluginLoader.c:33-72);
  - nonzero plugin status codes surface as TSDRError with the plugin's own
    tsdrplugin_getlasterrortext() message (TSDRLibrary.c:136-159 plumbing);
  - `samples_dropped` precedes the delivered buffer (TSDRPlugin.h:49, UHD
    convention TSDRPlugin_UHD.cpp:264-294): recorded at the ring's write
    position and released to the consumer only after the bytes before the
    gap are consumed;
  - readasync blocks until tsdrplugin_stop() (TSDRLibrary.c:515) — it runs
    on a dedicated thread here, and stop() mirrors tsdr_stop (:213-224);
  - shiftfreq semantics: set_freq_offset retunes to center+offset without
    mutating the center (TSDRLibrary.c:208-211).

Params string:
    "<path-to-plugin.so> [block=0|1] [ring=BYTES] -- <plugin params...>"

block=1 applies backpressure into the plugin callback (drop-free file
replay); block=0 (default) drops whole chunks when the ring is full and
counts them, exactly like cb_add returning CB_FULL (circbuff.c:95-134).
"""

from __future__ import annotations

import ctypes
import shlex
import threading
from typing import Iterator, Optional

import numpy as np

from ..errors import TSDRError, TSDRStatus
from .base import Source, SourceBlock, register_source

# tsdrplugin_readasync_function (TSDRPlugin.h:49): items_count counts FLOAT
# VALUES (I and Q each), samples_dropped counts IQ SAMPLES (process()
# halves items_count but passes dropped through, TSDRLibrary.c:264-286)
_READASYNC_CB = ctypes.CFUNCTYPE(
    None,
    ctypes.POINTER(ctypes.c_float),
    ctypes.c_uint64,
    ctypes.c_void_p,
    ctypes.c_int64,
)

_ABI = (
    "tsdrplugin_getName",
    "tsdrplugin_init",
    "tsdrplugin_setsamplerate",
    "tsdrplugin_getsamplerate",
    "tsdrplugin_setbasefreq",
    "tsdrplugin_stop",
    "tsdrplugin_setgain",
    "tsdrplugin_getlasterrortext",
    "tsdrplugin_readasync",
    "tsdrplugin_cleanup",
)

_BYTES_PER_SAMPLE = 8  # one IQ sample = 2 float32 values in the ring


@register_source("cplugin")
class CPluginSource(Source):
    """dlopen a reference TSDRPlugin .so and stream through its C ABI."""

    def __init__(self):
        self._dll: Optional[ctypes.CDLL] = None
        self._path = ""
        self._plugin_params = ""
        self._blocking = False
        self._ring_bytes = 0
        self._err = ""
        self._freq: Optional[float] = None
        self._freq_offset = 0.0
        self._running = False
        self._ring = None
        self._reader: Optional[threading.Thread] = None
        self._cb_keepalive = None  # CFUNCTYPE object must outlive readasync

    # ---- loading (TSDRPluginLoader.c:33-72) ----

    def init(self, params: str) -> None:
        toks = shlex.split(params)
        if "--" in toks:
            sep = toks.index("--")
            head, rest = toks[:sep], toks[sep + 1:]
        else:
            head, rest = toks[:1], toks[1:]
        if not head:
            raise TSDRError(
                TSDRStatus.PLUGIN_PARAMETERS_WRONG,
                "params should be: /path/to/TSDRPlugin.so [block=0|1] "
                "[ring=BYTES] -- plugin params...",
            )
        self._path = head[0]
        for tok in head[1:]:
            if tok.startswith("block="):
                self._blocking = tok.split("=", 1)[1] not in ("0", "false")
            elif tok.startswith("ring="):
                self._ring_bytes = int(tok.split("=", 1)[1])
            else:
                raise TSDRError(
                    TSDRStatus.PLUGIN_PARAMETERS_WRONG,
                    f"unknown loader option {tok!r}",
                )
        self._plugin_params = " ".join(rest)

        try:
            dll = ctypes.CDLL(self._path)
        except OSError as e:
            self._err = f"cannot load plugin: {e}"
            raise TSDRError(TSDRStatus.ERR_PLUGIN, self._err)
        for sym in _ABI:
            if not hasattr(dll, sym):
                self._err = f"{self._path} does not export {sym}"
                raise TSDRError(TSDRStatus.INCOMPATIBLE_PLUGIN, self._err)
        dll.tsdrplugin_getName.argtypes = [ctypes.c_char_p]
        dll.tsdrplugin_init.argtypes = [ctypes.c_char_p]
        dll.tsdrplugin_init.restype = ctypes.c_int
        dll.tsdrplugin_setsamplerate.argtypes = [ctypes.c_uint32]
        dll.tsdrplugin_setsamplerate.restype = ctypes.c_uint32
        dll.tsdrplugin_getsamplerate.restype = ctypes.c_uint32
        dll.tsdrplugin_setbasefreq.argtypes = [ctypes.c_uint32]
        dll.tsdrplugin_setbasefreq.restype = ctypes.c_int
        dll.tsdrplugin_stop.restype = ctypes.c_int
        dll.tsdrplugin_setgain.argtypes = [ctypes.c_float]
        dll.tsdrplugin_setgain.restype = ctypes.c_int
        dll.tsdrplugin_getlasterrortext.restype = ctypes.c_char_p
        dll.tsdrplugin_readasync.argtypes = [_READASYNC_CB, ctypes.c_void_p]
        dll.tsdrplugin_readasync.restype = ctypes.c_int
        self._dll = dll

        rc = dll.tsdrplugin_init(self._plugin_params.encode())
        if rc != 0:
            self._err = self._plugin_error(rc)
            raise TSDRError(TSDRStatus.PLUGIN_PARAMETERS_WRONG, self._err)

    def _plugin_error(self, rc: int) -> str:
        msg = b""
        try:
            msg = self._dll.tsdrplugin_getlasterrortext() or b""
        except Exception:
            pass
        text = msg.decode("utf-8", "replace").strip()
        return f"plugin rc={rc}" + (f": {text}" if text else "")

    # ---- plugin contract passthrough ----

    def name(self) -> str:
        if self._dll is None:
            return "cplugin (unloaded)"
        buf = ctypes.create_string_buffer(256)
        self._dll.tsdrplugin_getName(buf)
        return buf.value.decode("utf-8", "replace")

    def samplerate(self) -> float:
        self._require_loaded()
        return float(self._dll.tsdrplugin_getsamplerate())

    def set_samplerate(self, rate: float) -> float:
        self._require_loaded()
        return float(self._dll.tsdrplugin_setsamplerate(
            ctypes.c_uint32(int(round(rate)))))

    def set_basefreq(self, freq: float) -> None:
        self._require_loaded()
        self._freq = float(freq)
        self._freq_offset = 0.0  # absolute tune defines a new center
        self._tune()

    def set_freq_offset(self, offset_hz: float) -> None:
        if self._freq is None:
            return
        self._freq_offset = float(offset_hz)
        self._tune()

    def _tune(self) -> None:
        rc = self._dll.tsdrplugin_setbasefreq(
            ctypes.c_uint32(int(round(self._freq + self._freq_offset))))
        if rc != 0:
            self._err = self._plugin_error(rc)
            raise TSDRError(TSDRStatus.ERR_PLUGIN, self._err)

    def set_gain(self, gain: float) -> None:
        self._require_loaded()
        rc = self._dll.tsdrplugin_setgain(ctypes.c_float(gain))
        if rc != 0:
            self._err = self._plugin_error(rc)
            raise TSDRError(TSDRStatus.ERR_PLUGIN, self._err)

    def block_dtype(self):
        return np.float32  # the ABI delivers normalized float32 (TSDRPlugin.h:49)

    def last_error(self) -> str:
        return self._err

    def _require_loaded(self) -> None:
        if self._dll is None:
            raise TSDRError(TSDRStatus.ERR_PLUGIN, "plugin not loaded")

    # ---- streaming ----

    def stream(self, block_samples: int) -> Iterator[SourceBlock]:
        from .. import native as native_io

        self._require_loaded()
        if not native_io.available():
            raise TSDRError(TSDRStatus.ERR_PLUGIN,
                            "native IO runtime required for cplugin source")
        block_bytes = 2 * block_samples * 4  # f32 interleaved
        ring = native_io.Ring(max(self._ring_bytes, 4 * block_bytes,
                                  8 << 20))
        self._ring = ring
        self._running = True
        blocking = self._blocking

        def on_push(buf, items_count, _ctx, samples_dropped):
            if samples_dropped > 0:
                ring.note_dropped(int(samples_dropped) * _BYTES_PER_SAMPLE)
            if items_count:
                ring.write(ctypes.string_at(buf, int(items_count) * 4),
                           blocking=blocking)

        cb = _READASYNC_CB(on_push)
        self._cb_keepalive = cb

        def read_loop():
            try:
                rc = self._dll.tsdrplugin_readasync(cb, None)
                if rc != 0 and self._running:
                    self._err = self._plugin_error(rc)
            finally:
                ring.close()

        t = threading.Thread(target=read_loop, daemon=True)
        t.start()
        self._reader = t
        try:
            # take_dropped() matures a gap only once a post-gap byte has
            # been consumed (strict <, io_runtime.cpp), so taking right
            # after each read attributes the gap to the first block that
            # contains post-gap data — the delivery following the gap
            # (TSDRPlugin_UHD.cpp:264-294), with no extra block of lag.
            while self._running:
                buf = bytearray(block_bytes)
                got = ring.read_into(memoryview(buf), blocking=True)
                if got < block_bytes:
                    break  # plugin returned / stop()
                dropped_bytes = ring.take_dropped()
                # each block's bytearray is fresh, so the array over it is
                # the consumer's alone: no copy of the block
                arr = np.frombuffer(buf, dtype=np.float32)
                yield SourceBlock(arr, int(dropped_bytes // _BYTES_PER_SAMPLE))
        finally:
            self.stop()

    def stop(self) -> None:
        self._running = False
        if self._dll is not None:
            try:
                self._dll.tsdrplugin_stop()
            except Exception:
                pass
        if self._ring is not None:
            self._ring.close()
        if self._reader is not None and self._reader.is_alive():
            self._reader.join(timeout=5)
        self._reader = None
        self._cb_keepalive = None

    def cleanup(self) -> None:
        self.stop()
        if self._dll is not None:
            try:
                self._dll.tsdrplugin_cleanup()
            except Exception:
                pass
