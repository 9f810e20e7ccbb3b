"""Live terminal viewer — the interactive surface of the reference GUI,
re-homed to a terminal: the video canvas with FPS/OSD overlays
(ImageVisualizer.java:86-171), the hold-button control model with
accelerating repeats (HoldButton.java 50 ms timer + clickssofar;
Main.java:605-651 listeners), the keyboard map (Main.java:938-1010:
shift+arrows = manual sync move, plain left/right = framerate nudge with
quadratic acceleration capped at 0.05 — onFrameRateChanged :1012-1020 —
plain up/down = frequency step), and the toggle buttons (PLL "A",
autoshift "Auto", autocorr OFF/RST/DMP — Main.java:465-477,520-525,715-729).

Design: everything decision-shaped is a pure, curses-free core —
`decode_keys` (escape-sequence parser), `HoldCounter` (keyboard-autorepeat
emulation of HoldButton's clickssofar), `framerate_change_amount`,
`frame_to_cells`/`cells_to_ansi` (half-block truecolor renderer), and
`TuiController` (key -> TSDR calls state machine) — all unit-testable
against a fake TSDR. `run_tui` is the thin raw-terminal (termios) shell;
frames render as U+2580 half blocks, two pixels per character cell.

Terminals deliver no key-release events, so the hold model is emulated from
the autorepeat train: an unbroken run of identical keys (gap < HOLD_GAP_S)
increments clickssofar exactly like the 50 ms TimerTask; a gap releases.

The PyTorch port's copy of tempestsdr_tpu.tui (numpy only, over the port's
own config, params, snapshot, events and estimate.plotrender); it drives a
tempestsdr_tpu_torch TSDR, which runs on the device the TSDR was built for.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from .config import (
    PIXEL_SPECIAL_VALUE_B,
    PIXEL_SPECIAL_VALUE_G,
    PIXEL_SPECIAL_VALUE_R,
    PIXEL_SPECIAL_VALUE_TRANSPARENT,
)
from .params import DIRECTION, PARAM
from .snapshot import frame_to_rgb

# Main.java:79 OSD_TIME (ms) / :84-87 framerate nudge constants
OSD_TIME_S = 2.0
OSD_TIME_LONG_S = 5.0
FRAMERATE_SIGNIFICANT_FIGURES = 8
FRAMERATE_MIN_CHANGE = 10.0 ** (-FRAMERATE_SIGNIFICANT_FIGURES)
FRAMERATE_MAX_CHANGE = 0.05  # onFrameRateChanged cap, Main.java:1013-1014
FPS_COUNT_TO_AVG = 50  # ImageVisualizer.java:30
HOLD_GAP_S = 0.25  # autorepeat-train gap that counts as a key release


def framerate_change_amount(clickssofar: int) -> float:
    """Quadratic hold acceleration (Main.java:1012-1014): amount =
    clicks^2 * 10^-8, capped at 0.05 Hz per repeat."""
    amount = clickssofar * clickssofar * FRAMERATE_MIN_CHANGE
    return min(amount, FRAMERATE_MAX_CHANGE)


class HoldCounter:
    """HoldButton.clickssofar from keyboard autorepeat: consecutive
    occurrences of the same key within HOLD_GAP_S form one hold; each
    occurrence is one 50 ms TimerTask tick (HoldButton.java doHold)."""

    def __init__(self, gap_s: float = HOLD_GAP_S):
        self.gap_s = gap_s
        self._key: Optional[str] = None
        self._last = -1e18
        self._count = 0

    def click(self, key: str, now: float) -> int:
        if key == self._key and now - self._last < self.gap_s:
            self._count += 1
        else:
            self._key = key
            self._count = 1
        self._last = now
        return self._count


# ---- key decoding (raw-terminal byte stream -> key names) ------------------

_CSI_FINAL = {"A": "UP", "B": "DOWN", "C": "RIGHT", "D": "LEFT"}


def decode_keys(buf: bytes) -> tuple[list[str], bytes]:
    """Decode a raw byte stream into key names; returns (keys, remainder).

    Handles plain bytes, CSI arrows (ESC [ A..D) and modified CSI arrows
    (ESC [ 1 ; m A..D, xterm modifier m: 2=shift, 4=shift+alt, 6=shift+ctrl
    -> SHIFT_*). An incomplete trailing escape sequence stays in the
    remainder for the next read."""
    keys: list[str] = []
    i, n = 0, len(buf)
    while i < n:
        b = buf[i]
        if b != 0x1B:
            keys.append(chr(b))
            i += 1
            continue
        # escape sequence
        if i + 1 >= n:
            break  # incomplete: keep for next read
        if buf[i + 1] != ord("["):
            keys.append("ESC")
            i += 1
            continue
        j = i + 2
        params = bytearray()
        while j < n and (0x30 <= buf[j] <= 0x3B):  # digits + ';'
            params.append(buf[j])
            j += 1
        if j >= n:
            break  # incomplete CSI
        final = chr(buf[j])
        name = _CSI_FINAL.get(final)
        if name is not None:
            mod = 0
            parts = bytes(params).split(b";")
            if len(parts) == 2 and parts[1].isdigit():
                mod = int(parts[1])
            if mod in (2, 4, 6, 8):  # any shift-combination modifier
                name = "SHIFT_" + name
            keys.append(name)
        # unknown finals are swallowed (mouse reports etc.)
        i = j + 1
    return keys, buf[i:]


# ---- frame rendering (half-block truecolor) ---------------------------------


def _pool_axis_edges(n: int, m: int) -> np.ndarray:
    """m+1 bucket edges over [0, n] for area pooling (monotone, covers all)."""
    return (np.arange(m + 1, dtype=np.int64) * n) // m


def downsample_mean(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Area-mean pool an (H, W[, C]) image to (out_h, out_w[, C]) — the
    terminal-resolution analog of the canvas's scaled blit
    (ImageVisualizer.java:86-104). Pure numpy reduceat, no Python loops."""
    h, w = img.shape[:2]
    out_h, out_w = min(out_h, h), min(out_w, w)
    ye = _pool_axis_edges(h, out_h)
    xe = _pool_axis_edges(w, out_w)
    acc = np.add.reduceat(np.asarray(img, np.float64), ye[:-1], axis=0)
    acc = np.add.reduceat(acc, xe[:-1], axis=1)
    counts = np.outer(np.diff(ye), np.diff(xe)).astype(np.float64)
    if img.ndim == 3:
        counts = counts[..., None]
    return acc / counts


def frame_to_cells(frame: np.ndarray, cols: int, rows: int,
                   invert: bool = False) -> np.ndarray:
    """Float frame -> (2*rows, cols, 3) uint8 RGB pixel grid sized for
    half-block rendering (each character cell stacks two pixels). Special
    debug marker pixels get their pure colours before pooling, exactly as
    the JNI converter orders it (TSDRLibraryNDK.c:222-279)."""
    rgb = frame_to_rgb(frame, invert=invert).astype(np.float32)
    # transparent marker renders as mid-gray (no underlying image to show)
    t = np.asarray(frame, np.float32) == PIXEL_SPECIAL_VALUE_TRANSPARENT
    rgb[t] = 128.0
    cells = downsample_mean(rgb, 2 * rows, cols)
    return np.clip(cells + 0.5, 0, 255).astype(np.uint8)


def cells_to_ansi(cells: np.ndarray) -> list[str]:
    """(2R, C, 3) uint8 -> R lines of truecolor half blocks (fg = top pixel,
    bg = bottom pixel). Consecutive identical colour pairs reuse the active
    SGR state to keep lines short."""
    top = cells[0::2]
    bot = cells[1::2]
    lines = []
    for r in range(top.shape[0]):
        parts = []
        last = None
        for c in range(top.shape[1]):
            ft = tuple(int(x) for x in top[r, c])
            fb = tuple(int(x) for x in bot[r, c])
            if (ft, fb) != last:
                parts.append("\x1b[38;2;%d;%d;%dm\x1b[48;2;%d;%d;%dm" % (ft + fb))
                last = (ft, fb)
            parts.append("▀")
        parts.append("\x1b[0m")
        lines.append("".join(parts))
    return lines


# ---- controller -------------------------------------------------------------


@dataclass
class TuiStatus:
    """Live telemetry shown in the status bar (the GUI's side widgets)."""

    frames: int = 0
    render_fps: float = 0.0
    refreshrate: float = 0.0
    pll_framerate: Optional[float] = None
    autogain: Optional[tuple] = None
    snr_db: Optional[float] = None
    ac_rounds: int = 0
    freq: Optional[float] = None
    gain: Optional[float] = None
    osd: str = ""
    osd_until: float = 0.0


class TuiController:
    """Pure key -> action state machine over the TSDR API (Main.java's
    listener wiring, minus Swing). Inject a fake `rx` to unit-test.

    Key map (reference semantics where one exists):
      SHIFT+arrows / h j k l   manual sync move by clickssofar pixels
                               (onSync -> mSdrlib.sync(repeatssofar, dir),
                               Main.java:800-802,941-958)
      LEFT / RIGHT             framerate -/+ with quadratic hold
                               acceleration (Main.java:960-965,1012-1020)
      UP / DOWN                frequency +/- freq_step (Main.java:966-972)
      g / G                    gain -/+ 0.05 (slGain, Main.java:872-880)
      a                        frame-rate PLL toggle ("A")
      s                        autoshift toggle ("Auto")
      o                        autocorr plots on/off toggle ("OFF")
      r                        autocorr reset ("RST")
      d                        autocorr CSV dump ("DMP")
      n                        nearest-neighbour resampling toggle
      f                        fast-sync (f32 search) speed-mode toggle
      i                        invert video (JNI converter invert flag)
      p                        PNG/PGM snapshot (Main.java:1095-1116)
      v                        cycle view: video -> frame plot -> line plot
                               (the GUI's three visualizer panels)
      q                        stop and quit
    """

    def __init__(self, rx, *, freq_step: float = 50e3,
                 snapshot_dir: str = ".", snapshot_fmt: str = "pgm",
                 now: Callable[[], float] = time.monotonic):
        self.rx = rx
        self.freq_step = freq_step
        self.snapshot_dir = snapshot_dir
        self.snapshot_fmt = snapshot_fmt
        self.now = now
        self.hold = HoldCounter()
        self.status = TuiStatus()
        self.invert = False
        self.quit = False
        self._toggles = {}  # PARAM -> bool (mirrors Main.java's toggle state)
        self._freq = None
        self._gain = 0.5
        self._snap_n = 0
        self._last_frame: Optional[np.ndarray] = None
        self._plots: dict = {}  # PLOT_ID -> latest PlotEvent
        self.view = "video"  # video | frame | line (the GUI's 3 visualizers)
        self._plot_info: dict = {}

    # -- telemetry feeds (wired to TSDR callbacks by run_tui) --

    def on_frame(self, f: np.ndarray) -> None:
        self._last_frame = f
        self.status.frames += 1

    def on_plot(self, ev) -> None:
        self._plots[ev.plot_id] = ev

    def on_value(self, ev) -> None:
        from .events import VALUE_ID

        s = self.status
        if ev.value_id == VALUE_ID.PLL_FRAMERATE:
            s.pll_framerate = ev.arg0
        elif ev.value_id == VALUE_ID.AUTOGAIN_VALUES:
            s.autogain = (ev.arg0, ev.arg1)
        elif ev.value_id == VALUE_ID.SNR:
            s.snr_db = ev.arg0
        elif ev.value_id == VALUE_ID.AUTOCORRECT_FRAMES_COUNT:
            s.ac_rounds = int(ev.arg0)

    # -- helpers --

    def osd(self, text: str, secs: float = OSD_TIME_S) -> None:
        """ImageVisualizer.setOSD (:167-171)."""
        self.status.osd = text
        self.status.osd_until = self.now() + secs

    def _toggle(self, param, label: str) -> None:
        cur = not self._toggles.get(param, self._param_default(param))
        self._toggles[param] = cur
        self.rx.set_param(param, int(cur))
        self.osd(f"{label}: {'on' if cur else 'off'}")

    def _param_default(self, param) -> bool:
        p = getattr(self.rx, "_params", None)
        if p is None:
            return False
        return bool({
            PARAM.AUTOSHIFT: p.autoshift,
            PARAM.FRAMERATE_PLL: p.framerate_pll,
            PARAM.AUTOCORR_PLOTS_OFF: p.autocorr_plots_off,
            PARAM.NEAREST_NEIGHBOUR_RESAMPLING: p.nearest_neighbour,
        }.get(param, False))

    def seed(self, freq: Optional[float], gain: Optional[float]) -> None:
        self._freq = freq
        if gain is not None:
            self._gain = gain

    # -- the key handler --

    def handle_key(self, key: str) -> None:
        now = self.now()
        rx = self.rx
        sync_keys = {
            "SHIFT_LEFT": DIRECTION.LEFT, "h": DIRECTION.LEFT,
            "SHIFT_RIGHT": DIRECTION.RIGHT, "l": DIRECTION.RIGHT,
            "SHIFT_UP": DIRECTION.UP, "k": DIRECTION.UP,
            "SHIFT_DOWN": DIRECTION.DOWN, "j": DIRECTION.DOWN,
        }
        if key in sync_keys:
            clicks = self.hold.click(key, now)
            d = sync_keys[key]
            try:
                rx.sync(clicks, d)
            except Exception:
                return  # shift clamped at the frame edge, like the C checks
            self.osd(f"Move: {d.name.title()}")  # Main.java:944-957
            return
        if key in ("LEFT", "RIGHT"):
            clicks = self.hold.click(key, now)
            amount = framerate_change_amount(clicks)
            rate = rx.nudge_framerate(-amount if key == "LEFT" else amount)
            self.status.refreshrate = rate
            self.osd(f"Framerate: {rate:.8f} fps")  # FRAMERATE_FORMAT
            return
        if key in ("UP", "DOWN"):
            if self._freq is None:
                self.osd("Freq: source has no tuner")
                return
            self._freq += self.freq_step if key == "UP" else -self.freq_step
            rx.set_base_freq(self._freq)
            self.osd(f"Freq: {self._freq:.0f} Hz")  # Main.java:879
            return
        if key in ("g", "G"):
            self._gain = min(1.0, max(0.0, self._gain + (0.05 if key == "G" else -0.05)))
            rx.set_gain(self._gain)
            self.osd(f"Gain: {self._gain:.2f}")
            return
        if key == "a":
            self._toggle(PARAM.FRAMERATE_PLL, "PLL")
            return
        if key == "s":
            self._toggle(PARAM.AUTOSHIFT, "Autoshift")
            return
        if key == "o":
            self._toggle(PARAM.AUTOCORR_PLOTS_OFF, "Autocorr off")
            return
        if key == "n":
            self._toggle(PARAM.NEAREST_NEIGHBOUR_RESAMPLING, "Nearest-neighbour")
            return
        if key == "f":
            # an extra of this package: f32 sync-search speed mode (Params.fast_sync)
            cur = not bool(getattr(self.rx, "_params", None)
                           and self.rx._params.fast_sync)
            try:
                rx.set_extra_params(fast_sync=cur)
            except AttributeError:
                return
            self.osd(f"Fast sync (f32): {'on' if cur else 'off'}")
            return
        if key == "r":
            rx.set_param(PARAM.AUTOCORR_PLOTS_RESET, 1)
            self.osd("Autocorr: reset")
            return
        if key == "d":
            rx.set_param(PARAM.AUTOCORR_DUMP, 1)
            self.osd("Autocorr: dumped autocorr.csv")
            return
        if key == "i":
            self.invert = not self.invert
            self.osd(f"Invert: {'on' if self.invert else 'off'}")
            return
        if key == "p":
            if self._last_frame is None:
                self.osd("Snapshot: no frame yet")
                return
            from .snapshot import save_frame

            self._snap_n += 1
            path = os.path.join(
                self.snapshot_dir,
                f"snapshot_{self._snap_n:04d}.{self.snapshot_fmt}")
            save_frame(self._last_frame, path, invert=self.invert)
            self.osd(f"Snapshot: {path}", OSD_TIME_LONG_S)
            return
        if key == "v":
            order = ["video", "frame", "line"]
            self.view = order[(order.index(self.view) + 1) % len(order)]
            names = {"video": "Video", "frame": "Autocorr: frame plot",
                     "line": "Autocorr: line plot"}
            self.osd(f"View: {names[self.view]}")
            return
        if key == "q":
            self.quit = True

    # -- view rendering (the GUI's visualizer panel switch) --

    def render_cells(self, cols: int, rows: int) -> Optional[np.ndarray]:
        """Cells for the active view: the video canvas, or one of the two
        autocorrelation plot widgets rendered by the exact widget pipeline
        (estimate/plotrender ← PlotVisualizer.java:200-247)."""
        if self.view == "video":
            if self._last_frame is None:
                return None
            return frame_to_cells(self._last_frame, cols, rows,
                                  invert=self.invert)
        from .events import PLOT_ID
        from .estimate.plotrender import render_plot

        pid = PLOT_ID.FRAME if self.view == "frame" else PLOT_ID.LINE
        ev = self._plots.get(pid)
        if ev is None:
            return None  # no estimation round yet
        kw = {}
        if self.view == "line":
            fev = self._plots.get(PLOT_ID.FRAME)
            if fev is not None:  # widget transformer: height = frame/line lag
                kw["frame_lag"] = int(np.argmax(fev.values)) + fev.offset
        img, info = render_plot(np.asarray(ev.values), offset=ev.offset,
                                samplerate=ev.samplerate, nwidth=cols,
                                nheight=2 * rows, kind=self.view, **kw)
        self._plot_info[self.view] = info
        return np.repeat(img[..., None], 3, axis=-1)

    # -- status bar --

    def status_line(self, width: int) -> str:
        s = self.status
        if self.rx.session is not None:
            try:
                s.refreshrate = self.rx.session.current_refreshrate()
            except Exception:
                pass
        bits = [f"{s.render_fps:4.1f} fps", f"frames {s.frames}",
                f"rate {s.refreshrate:.4f} Hz"]
        if s.autogain is not None:
            bits.append(f"gain [{s.autogain[0]:.2f},{s.autogain[1]:.2f}]")
        if s.snr_db is not None:
            bits.append(f"snr {s.snr_db:.1f} dB")
        if s.ac_rounds:
            bits.append(f"ac {s.ac_rounds}")
        if self.view != "video":
            info = self._plot_info.get(self.view)
            bits.append(f"[{self.view} plot]"
                        + (f" peak {info['label']}" if info else ""))
        if self.now() < s.osd_until and s.osd:
            bits.append("| " + s.osd)
        line = "  ".join(bits)
        return line[:width].ljust(width)


# ---- the terminal shell ------------------------------------------------------


def run_tui(rx, *, max_frames=None, max_blocks=None, freq=None, gain=None,
            snapshot_dir: str = ".", snapshot_fmt: str = "pgm",
            redraw_hz: float = 20.0,
            stdin=None, stdout=None) -> int:
    """Drive `rx` (a configured TSDR with a source loaded) interactively.

    Raw-terminal loop: stream in the background, render the latest frame at
    redraw_hz as truecolor half blocks, poll the keyboard. Returns the frame
    count. Requires a tty unless both stdin/stdout are injected."""
    import select
    import termios
    import tty

    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout

    ctl = TuiController(rx, snapshot_dir=snapshot_dir,
                        snapshot_fmt=snapshot_fmt)
    ctl.seed(freq, gain)
    rx._callbacks.on_value = ctl.on_value  # chain telemetry into the bar
    rx._callbacks.on_plot = ctl.on_plot

    fd = stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    stdout.write("\x1b[?25l\x1b[2J")  # hide cursor, clear
    buf = b""
    fps_count, fps_prev = 0, time.monotonic()
    try:
        rx.start(on_frame=ctl.on_frame, max_frames=max_frames,
                 max_blocks=max_blocks, background=True)
        period = 1.0 / redraw_hz
        while not ctl.quit and rx.is_running:
            r, _, _ = select.select([fd], [], [], period)
            if r:
                data = os.read(fd, 1024)
                keys, buf = decode_keys(buf + data)
                for k in keys:
                    ctl.handle_key(k)
            cols, rows = os.get_terminal_size(stdout.fileno())
            cells = ctl.render_cells(cols, max(1, rows - 1))
            if cells is not None:
                lines = cells_to_ansi(cells)
                stdout.write("\x1b[H" + "\n".join(lines) + "\n")
                fps_count += 1
                if fps_count > FPS_COUNT_TO_AVG:  # drawFPS :141-154
                    now = time.monotonic()
                    ctl.status.render_fps = fps_count / (now - fps_prev)
                    fps_count, fps_prev = 0, now
            stdout.write("\x1b[7m" + ctl.status_line(cols) + "\x1b[0m\r")
            stdout.flush()
    finally:
        rx.stop()
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        stdout.write("\x1b[?25h\x1b[0m\n")
        stdout.flush()
    return ctl.status.frames
