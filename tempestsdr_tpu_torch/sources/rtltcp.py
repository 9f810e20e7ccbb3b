"""rtl_tcp network source — a real live-hardware client over the de-facto
standard remote-SDR streaming protocol (rtl_tcp ships with librtlsdr; SDRplay,
Airspy and many others expose compatible servers).

This is the port's counterpart of the reference's live hardware plugins
(TSDRPlugin_UHD.cpp / TSDRPlugin_Mirics.c): it exercises the same plugin
contract — init from a param string, samplerate/freq/gain control
(tsdrplugin_setbasefreq/setgain, TSDRPlugin.h:53-57), an async receive path
that NEVER blocks on the consumer, and client-side overflow accounting
reported as `samples_dropped` for the pipeline's whole-frame compensation
(the UHD plugin's timestamp-gap estimation, TSDRPlugin_UHD.cpp:264-294, has
no protocol equivalent here: rtl_tcp carries no timestamps, so like the
ExtIO plugin the hardware-side drops are invisible — acs-dissertation.tex:702
— and only client-side FIFO overflow is observable).

Protocol (rtl_tcp.c, librtlsdr):
  server -> client: 12-byte header  "RTL0" | u32 tuner_type | u32 gain_count
                    then an endless stream of interleaved u8 I/Q
  client -> server: 5-byte commands  u8 cmd | u32 big-endian value
                    0x01 set_freq Hz, 0x02 set_sample_rate Hz,
                    0x03 set_gain_mode (1=manual), 0x04 set_gain (tenths dB)

Params string: "host port samplerate [freq=HZ] [gain=0..1] [ring=N]"
  gain maps the normalized 0..1 API gain onto 0..49.6 dB (the rtl-sdr
  R820T range) in tenths, like the UHD plugin's normalized-gain mapping
  (TSDRPlugin_UHD.cpp:53-62); ring is the receive ring size in chunks.
"""

from __future__ import annotations

import shlex
import socket
import struct
import threading
from typing import Iterator

import numpy as np

from ..errors import TSDRError, TSDRStatus
from .base import Source, SourceBlock, register_source

CMD_SET_FREQ = 0x01
CMD_SET_SAMPLE_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03
CMD_SET_GAIN = 0x04

MAX_GAIN_TENTHS_DB = 496  # R820T max 49.6 dB
CHUNK_BYTES = 1 << 16  # receive granularity (2 bytes/sample -> 32768 samples)


@register_source("rtltcp")
class RtlTcpSource(Source):
    def __init__(self):
        self._err = ""
        self._rate = 0.0
        self._host = ""
        self._port = 0
        self._freq: float | None = None
        self._gain: float | None = None
        self._ring_chunks = 64
        self._sock: socket.socket | None = None
        self._sock_lock = threading.Lock()
        self._running = False
        self._reader: threading.Thread | None = None
        self._ring = None
        self.tuner_type = None  # from the server header, for diagnostics
        self.tuner_gain_count = None

    # ---- plugin contract ----

    def init(self, params: str) -> None:
        try:
            toks = shlex.split(params)
            if len(toks) < 3:
                raise ValueError
            self._host = toks[0]
            self._port = int(toks[1])
            self._rate = float(toks[2])
            for tok in toks[3:]:
                if tok.startswith("freq="):
                    self._freq = float(tok.split("=", 1)[1])
                elif tok.startswith("gain="):
                    self._gain = float(tok.split("=", 1)[1])
                elif tok.startswith("ring="):
                    self._ring_chunks = int(tok.split("=", 1)[1])
                else:
                    raise ValueError
            if self._rate <= 0 or not 0 < self._port < 65536:
                raise ValueError
        except (ValueError, IndexError):
            self._err = ("params should be: host port samplerate "
                         "[freq=HZ] [gain=0..1] [ring=N]")
            raise TSDRError(TSDRStatus.PLUGIN_PARAMETERS_WRONG, self._err)

    def name(self) -> str:
        return f"rtl_tcp client ({self._host}:{self._port})"

    def samplerate(self) -> float:
        return self._rate

    def block_dtype(self):
        return np.uint8

    def set_basefreq(self, freq: float) -> None:
        self._freq = float(freq)
        self._send_cmd(CMD_SET_FREQ, int(round(freq)))

    def set_freq_offset(self, offset_hz: float) -> None:
        """Superband hop retune: tune the hardware to center+offset WITHOUT
        touching the stored center (the reference's shiftfreq semantics,
        TSDRLibrary.c:208-211) — offsets are absolute from one fixed center
        and must never compound."""
        if self._freq is None:
            return
        self._send_cmd(CMD_SET_FREQ, int(round(self._freq + offset_hz)))

    def set_gain(self, gain: float) -> None:
        self._gain = float(gain)
        self._send_cmd(CMD_SET_GAIN_MODE, 1)
        self._send_cmd(CMD_SET_GAIN,
                       int(round(max(0.0, min(1.0, gain)) * MAX_GAIN_TENTHS_DB)))

    def last_error(self) -> str:
        return self._err

    # ---- wire helpers ----

    def _send_cmd(self, cmd: int, value: int) -> None:
        with self._sock_lock:
            if self._sock is None:
                return  # not connected yet: applied at stream() start
            try:
                self._sock.sendall(struct.pack(">BI", cmd, value & 0xFFFFFFFF))
            except OSError as e:
                self._err = f"rtl_tcp command failed: {e}"
                raise TSDRError(TSDRStatus.ERR_PLUGIN, self._err)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            got = self._sock.recv(n - len(buf))
            if not got:
                raise TSDRError(TSDRStatus.ERR_PLUGIN,
                                "rtl_tcp server closed the connection")
            buf += got
        return buf

    def _read_loop(self, sock, ring) -> None:
        """Receive thread: socket -> non-blocking ring writes. A full ring
        drops the chunk whole and counts it (the hardware-FIFO-overflow
        semantics the pipeline's drop compensation consumes). Takes the
        socket as a local (stop() nulls self._sock concurrently)."""
        try:
            while self._running:
                data = sock.recv(CHUNK_BYTES)
                if not data:
                    break
                ring.write(data)
        except OSError:
            pass  # socket closed by stop()
        finally:
            ring.close()

    # ---- streaming ----

    def stream(self, block_samples: int) -> Iterator[SourceBlock]:
        from .. import native as native_io

        if self._rate <= 0:
            raise TSDRError(TSDRStatus.PLUGIN_PARAMETERS_WRONG, "not initialized")
        if not native_io.available():
            raise TSDRError(TSDRStatus.ERR_PLUGIN,
                            "native IO runtime required for rtltcp")
        try:
            sock = socket.create_connection((self._host, self._port), timeout=10)
        except OSError as e:
            self._err = f"cannot connect to rtl_tcp server: {e}"
            raise TSDRError(TSDRStatus.ERR_PLUGIN, self._err)
        sock.settimeout(10)
        with self._sock_lock:
            self._sock = sock
        try:
            hdr = self._recv_exact(12)
            if hdr[:4] != b"RTL0":
                raise TSDRError(TSDRStatus.ERR_PLUGIN,
                                f"not an rtl_tcp server (magic {hdr[:4]!r})")
            self.tuner_type, self.tuner_gain_count = struct.unpack(
                ">II", hdr[4:12])
            self._send_cmd(CMD_SET_SAMPLE_RATE, int(round(self._rate)))
            if self._freq is not None:
                self._send_cmd(CMD_SET_FREQ, int(round(self._freq)))
            if self._gain is not None:
                self.set_gain(self._gain)
        except Exception:
            self._close_sock()
            raise
        # the 10 s timeout guards connect/handshake only: a live stream may
        # legitimately stall longer (retune, network hiccup) — the reader
        # must block until data or close, never time out mid-stream
        sock.settimeout(None)

        block_bytes = 2 * block_samples  # u8 I/Q
        ring = native_io.Ring(max(self._ring_chunks * CHUNK_BYTES,
                                  4 * block_bytes))
        self._ring = ring
        self._running = True
        self._reader = threading.Thread(target=self._read_loop,
                                        args=(sock, ring), daemon=True)
        self._reader.start()
        try:
            # matured drops attach to the block AFTER the gap (the ring
            # positions each drop in the stream; see sources/live.py)
            # take right after each read: strict-< maturation attributes
            # the gap to the first block containing post-gap data
            while self._running:
                buf = bytearray(block_bytes)
                got = ring.read_into(memoryview(buf), blocking=True)
                if got < block_bytes:
                    break  # server closed / stop()
                dropped_bytes = ring.take_dropped()
                arr = np.frombuffer(bytes(buf), dtype=np.uint8)
                yield SourceBlock(arr, int(dropped_bytes // 2))
        finally:
            self.stop()

    def _close_sock(self) -> None:
        with self._sock_lock:
            if self._sock is not None:
                try:
                    self._sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def stop(self) -> None:
        self._running = False
        self._close_sock()
        if self._ring is not None:
            self._ring.close()
        if self._reader is not None and self._reader.is_alive():
            self._reader.join(timeout=5)
            self._reader = None
