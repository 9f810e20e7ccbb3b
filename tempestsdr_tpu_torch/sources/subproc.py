"""External-process meta-source — the port's equivalent of the
reference's ExtIO meta-plugin (P5, TSDRPlugin_ExtIO/src/TSDRPlugin_ExtIO.c).

ExtIO's capability is hosting THIRD-PARTY sources the framework has never
heard of: it loads ExtIO_*.dll files, resolves their ABI
(InitHW/OpenHW/StartHW/SetCallback/SetHWLO — ExtIOPluginLoader.c:40-56),
converts their 16/24/32-bit and float sample formats
(TSDRPlugin_ExtIO.c:125-155), applies freq/gain changes from a 50 ms
polling loop (:307-319), and survives buggy plugins with a
vectored-exception-handler + longjmp hack (:49-73).

The host-native re-design runs the third-party producer as a CHILD
PROCESS instead of an in-process dll:

  - any program that writes interleaved IQ to stdout is a source
    (rtl_sdr -, hackrf_transfer -r -, rx_sdr -, `cat recording.bin`, a
    Python wrapper around a vendor SDK, ...) — the de-facto UNIX SDR
    convention replaces the Windows ExtIO ABI;
  - sample-format conversion covers ExtIO's set: u8/i8/i16/u16/f32 pass
    through as the pipeline's native raw formats, and 24-bit little-endian
    signed PCM (exthwUSBdata24 / the :125-155 conversion) is widened to
    f32 in [-1, 1) host-side;
  - retune/gain control replaces the ExtIO polling loop with either a
    line protocol on the child's stdin (`FREQ <hz>` / `GAIN <0..1>`,
    control=stdin — the SetHWLO equivalent for cooperating wrappers) or a
    respawn with `{freq}`/`{gain}`/`{rate}` re-substituted into the argv
    template (control=restart — the Mirics plugin's device-reset retune
    fallback, TSDRPlugin_Mirics.c:132-155, for programs that only take
    tuning as flags);
  - crash isolation is BY CONSTRUCTION: a buggy producer can only kill its
    own process — the reader sees EOF, the stream ends cleanly and
    last_error() carries the exit status + a stderr tail. That retires the
    reference's VEH/longjmp hack (:49-73) rather than porting it.
  - like ExtIO, the protocol carries no hardware drop information
    (acs-dissertation.tex:702); only client-side ring overflow is
    observable and reported as `samples_dropped`.

Params string:
    "<samplerate> <format> [control=none|stdin|restart] [ring=N]
     [freq=HZ] [gain=0..1] -- command arg1 arg2 ..."

format: u8 | i8 | i16 | u16 | f32 | i24.  The command may contain
`{freq}` / `{gain}` / `{rate}` placeholders, substituted at every
(re)spawn; with control=restart a set_basefreq/set_gain respawns the
child, otherwise placeholders are one-shot start parameters.
"""

from __future__ import annotations

import shlex
import subprocess
import threading
from typing import Iterator, Optional

import numpy as np

from ..errors import TSDRError, TSDRStatus
from .base import Source, SourceBlock, register_source

CHUNK_BYTES = 1 << 16
STDERR_TAIL = 4096

_FORMATS = {
    "u8": (np.uint8, 1),
    "i8": (np.int8, 1),
    "i16": (np.int16, 2),
    "u16": (np.uint16, 2),
    "f32": (np.float32, 4),
    "i24": (None, 3),  # converted to f32 host-side
}


class _TailBuffer:
    """Thread-safe rolling byte tail (keeps only the most recent `limit`
    bytes) — the sink for the continuous stderr drain."""

    def __init__(self, limit: int):
        self._lock = threading.Lock()
        self._limit = limit
        self._buf = b""

    def feed(self, data: bytes) -> None:
        with self._lock:
            self._buf = (self._buf + data)[-self._limit:]

    def get(self) -> bytes:
        with self._lock:
            return self._buf


def _i24le_to_f32(raw: bytes) -> np.ndarray:
    """24-bit little-endian signed PCM -> f32 in [-1, 1) — the ExtIO
    24-bit conversion (TSDRPlugin_ExtIO.c:125-155 exthwUSBdata24 path)."""
    b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    v = (v << 8) >> 8  # sign-extend bit 23
    return (v.astype(np.float32) / np.float32(1 << 23)).astype(np.float32)


@register_source("exec")
class ExternalProcessSource(Source):
    """Host a third-party IQ producer as a child process (ExtIO equivalent)."""

    def __init__(self):
        self._err = ""
        self._rate = 0.0
        self._fmt = ""
        self._control = "none"
        self._ring_chunks = 64
        self._freq: Optional[float] = None
        self._gain: Optional[float] = None
        self._freq_offset = 0.0
        self._argv_template: list[str] = []
        self._proc: Optional[subprocess.Popen] = None
        self._proc_lock = threading.Lock()
        self._running = False
        self._ring = None
        self._reader: Optional[threading.Thread] = None
        self._generation = 0

    # ---- plugin contract ----

    def init(self, params: str) -> None:
        try:
            toks = shlex.split(params)
            sep = toks.index("--")
            head, self._argv_template = toks[:sep], toks[sep + 1:]
            if len(head) < 2 or not self._argv_template:
                raise ValueError
            self._rate = float(head[0])
            self._fmt = head[1]
            if self._fmt not in _FORMATS or self._rate <= 0:
                raise ValueError
            for tok in head[2:]:
                if tok.startswith("control="):
                    self._control = tok.split("=", 1)[1]
                    if self._control not in ("none", "stdin", "restart"):
                        raise ValueError
                elif tok.startswith("ring="):
                    self._ring_chunks = int(tok.split("=", 1)[1])
                elif tok.startswith("freq="):
                    self._freq = float(tok.split("=", 1)[1])
                elif tok.startswith("gain="):
                    self._gain = float(tok.split("=", 1)[1])
                else:
                    raise ValueError
        except (ValueError, IndexError):
            self._err = (
                "params should be: samplerate format(u8|i8|i16|u16|f32|i24) "
                "[control=none|stdin|restart] [ring=N] [freq=HZ] [gain=0..1] "
                "-- command args..."
            )
            raise TSDRError(TSDRStatus.PLUGIN_PARAMETERS_WRONG, self._err)

    def name(self) -> str:
        exe = self._argv_template[0] if self._argv_template else "?"
        return f"external process ({exe})"

    def samplerate(self) -> float:
        return self._rate

    def block_dtype(self):
        dtype, _ = _FORMATS[self._fmt]
        return np.float32 if dtype is None else dtype

    def last_error(self) -> str:
        return self._err

    # ---- control (the ExtIO polling-loop replacement) ----

    def set_basefreq(self, freq: float) -> None:
        self._freq = float(freq)
        self._freq_offset = 0.0  # absolute tune defines a new center
        self._apply_control(f"FREQ {int(round(self._tuned_freq()))}\n")

    def set_freq_offset(self, offset_hz: float) -> None:
        """Relative retune around the IMMUTABLE center — the reference's
        shiftfreq tunes to centfreq+diff without changing centfreq
        (TSDRLibrary.c:208-211), so superband hops 0..N are all absolute
        offsets from one fixed center and never compound."""
        if self._freq is None:
            return
        self._freq_offset = float(offset_hz)
        self._apply_control(f"FREQ {int(round(self._tuned_freq()))}\n")

    def _tuned_freq(self) -> float:
        return (self._freq or 0.0) + self._freq_offset

    def set_gain(self, gain: float) -> None:
        self._gain = max(0.0, min(1.0, float(gain)))
        self._apply_control(f"GAIN {self._gain}\n")

    def _apply_control(self, line: str) -> None:
        if self._control == "stdin":
            with self._proc_lock:
                p = self._proc
                if p is None or p.stdin is None:
                    return  # applied via {placeholders} at stream() start
                try:
                    p.stdin.write(line.encode())
                    p.stdin.flush()
                except (OSError, ValueError) as e:
                    self._err = f"control write failed: {e}"
                    raise TSDRError(TSDRStatus.ERR_PLUGIN, self._err)
        elif self._control == "restart":
            with self._proc_lock:
                if self._proc is not None and self._running:
                    self._respawn_locked()
        # control=none: tuning is fixed after start (like a file source)

    # ---- child management ----

    def _argv(self) -> list[str]:
        subst = {
            "freq": str(int(round(self._tuned_freq()))) if self._freq is not None
            else "0",
            "gain": str(self._gain if self._gain is not None else 0.0),
            "rate": str(int(round(self._rate))),
        }
        try:
            return [a.format(**subst) for a in self._argv_template]
        except (KeyError, IndexError) as e:
            raise TSDRError(
                TSDRStatus.PLUGIN_PARAMETERS_WRONG,
                f"bad placeholder in command template: {e}",
            )

    def _spawn_locked(self) -> subprocess.Popen:
        try:
            proc = subprocess.Popen(
                self._argv(),
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                stdin=subprocess.PIPE if self._control == "stdin" else
                subprocess.DEVNULL,
                bufsize=0,
            )
        except OSError as e:
            self._err = f"cannot spawn source process: {e}"
            raise TSDRError(TSDRStatus.ERR_PLUGIN, self._err)
        self._proc = proc
        self._generation += 1
        # Continuously drain stderr so a chatty producer (periodic stats on
        # stderr) can never fill the ~64 KiB pipe and deadlock its stdout
        # writes; only the last STDERR_TAIL bytes are kept for last_error.
        tail = _TailBuffer(STDERR_TAIL)
        drain = threading.Thread(
            target=self._drain_stderr, args=(proc, tail), daemon=True,
        )
        drain.start()
        t = threading.Thread(
            target=self._read_loop,
            args=(proc, self._ring, self._generation, tail, drain),
            daemon=True,
        )
        t.start()
        self._reader = t
        return proc

    @staticmethod
    def _drain_stderr(proc: subprocess.Popen, tail: "_TailBuffer") -> None:
        try:
            while True:
                data = proc.stderr.read(4096)
                if not data:
                    break
                tail.feed(data)
        except (OSError, ValueError):
            pass

    def _respawn_locked(self) -> None:
        """Retune-by-respawn (the Mirics device-reset fallback analog). The
        ring survives; the inter-process gap is invisible, like ExtIO's
        missing drop info."""
        old = self._proc
        self._proc = None
        if old is not None:
            self._terminate(old)
        self._spawn_locked()

    @staticmethod
    def _terminate(proc: subprocess.Popen) -> None:
        try:
            proc.terminate()
            try:
                proc.wait(timeout=3)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=3)
        except OSError:
            pass

    def _read_loop(self, proc: subprocess.Popen, ring, generation: int,
                   tail: "_TailBuffer", drain: threading.Thread) -> None:
        """stdout -> non-blocking ring writes; a full ring drops the chunk
        whole and counts it (same overflow semantics as sources/rtltcp.py).
        On child exit, capture the drained stderr tail for last_error — the
        crash-isolation replacement for ExtIO's VEH/longjmp."""
        try:
            while self._running:
                data = proc.stdout.read(CHUNK_BYTES)
                if not data:
                    break
                ring.write(data)
        except (OSError, ValueError):
            pass
        finally:
            # wait(timeout) instead of poll(): right after stdout EOF the
            # child may not be reaped yet and poll() returns None, losing
            # the rc; the bounded wait also covers a child that closed
            # stdout but lingers (never block ring.close on it).
            try:
                rc = proc.wait(timeout=3)
            except (subprocess.TimeoutExpired, OSError):
                rc = proc.poll()
            # only the CURRENT child reports errors and ends the stream — a
            # respawned-away child exits rc=-15 by design (control=restart
            # retune) and must neither poison last_error nor close the ring
            with self._proc_lock:
                current = self._generation == generation
            if rc not in (None, 0) and self._running and current:
                # let the drain thread flush the child's final stderr bytes
                # before snapshotting the tail (it ends at stderr EOF)
                drain.join(timeout=3)
                text = tail.get().decode("utf-8", "replace").strip()
                self._err = f"source process exited rc={rc}" + (
                    f": {text[-500:]}" if text else ""
                )
            if current:
                ring.close()

    # ---- streaming ----

    def stream(self, block_samples: int) -> Iterator[SourceBlock]:
        from .. import native as native_io

        if self._rate <= 0:
            raise TSDRError(TSDRStatus.PLUGIN_PARAMETERS_WRONG, "not initialized")
        if not native_io.available():
            raise TSDRError(TSDRStatus.ERR_PLUGIN,
                            "native IO runtime required for exec source")
        dtype, itemsize = _FORMATS[self._fmt]
        block_bytes = 2 * block_samples * itemsize
        ring = native_io.Ring(max(self._ring_chunks * CHUNK_BYTES,
                                  4 * block_bytes))
        self._ring = ring
        self._running = True
        try:
            with self._proc_lock:
                self._spawn_locked()
        except TSDRError:
            # failed spawn must not leak the native ring or leave the source
            # looking alive for a retry
            self._running = False
            self._ring = None
            ring.close()
            raise
        try:
            # take right after each read: strict-< maturation attributes
            # the gap to the first block containing post-gap data
            while self._running:
                buf = bytearray(block_bytes)
                got = ring.read_into(memoryview(buf), blocking=True)
                if got < block_bytes:
                    break  # child exited / stop()
                dropped_bytes = ring.take_dropped()
                raw = bytes(buf)
                if dtype is None:  # i24 -> f32 (ExtIO 24-bit conversion)
                    arr = _i24le_to_f32(raw)
                else:
                    arr = np.frombuffer(raw, dtype=dtype)
                yield SourceBlock(arr, int(dropped_bytes // (2 * itemsize)))
        finally:
            self.stop()

    def stop(self) -> None:
        self._running = False
        with self._proc_lock:
            proc, self._proc = self._proc, None
        if proc is not None:
            self._terminate(proc)
        if self._ring is not None:
            self._ring.close()
        if self._reader is not None and self._reader.is_alive():
            self._reader.join(timeout=5)
            self._reader = None
