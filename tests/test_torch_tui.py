"""The terminal viewer of the PyTorch port (tempestsdr_tpu_torch.tui) against
the JAX package's (tempestsdr_tpu.tui): every case of tests/test_tui.py
through both packages — the key decoder, the hold acceleration, the
half-block renderer, the controller against a fake TSDR, the live nudge
through a real session, and run_tui end to end over a pty (the port's TSDR
with device="cpu"). The two must give equal results."""

import contextlib
import os
import time

import numpy as np
import pytest

from tempestsdr_tpu import api as japi, config as jconfig, events as jevents, params as jparams
from tempestsdr_tpu import tui as jtui

from tempestsdr_tpu_torch import api as tapi, config as tconfig, events as tevents
from tempestsdr_tpu_torch import params as tparams, tui as ttui

PKGS = {
    "jax": dict(tui=jtui, config=jconfig, events=jevents, params=jparams,
                tsdr=lambda **kw: japi.TSDR(**kw)),
    "torch": dict(tui=ttui, config=tconfig, events=tevents, params=tparams,
                  tsdr=lambda **kw: tapi.TSDR(device="cpu", **kw)),
}
both = pytest.mark.parametrize("pkg", list(PKGS))


# ---- decode_keys ----


@both
def test_decode_keys(pkg):
    tui = PKGS[pkg]["tui"]
    assert tui.decode_keys(b"q\x1b[A\x1b[D") == (["q", "UP", "LEFT"], b"")
    assert tui.decode_keys(b"\x1b[1;2C\x1b[1;2B")[0] == ["SHIFT_RIGHT", "SHIFT_DOWN"]
    keys, rest = tui.decode_keys(b"a\x1b[1;")
    assert keys == ["a"] and rest == b"\x1b[1;"
    assert tui.decode_keys(rest + b"2A") == (["SHIFT_UP"], b"")
    assert tui.decode_keys(b"\x1bq") == (["ESC", "q"], b"")


# ---- hold acceleration ----


@both
def test_hold_counter_and_framerate_change(pkg):
    tui = PKGS[pkg]["tui"]
    h = tui.HoldCounter(gap_s=0.25)
    assert [h.click("LEFT", t) for t in (0.0, 0.05, 0.10, 0.40)] == [1, 2, 3, 1]
    assert h.click("RIGHT", 0.41) == 1
    assert tui.framerate_change_amount(1) == pytest.approx(1e-8)
    assert tui.framerate_change_amount(100) == pytest.approx(1e-4)
    assert tui.framerate_change_amount(3000) == 0.05


# ---- renderer: both packages give the same cells and lines ----


def test_renderer_equal_in_both_packages():
    rng = np.random.default_rng(4)
    img = np.kron(np.array([[10.0, 20.0], [30.0, 40.0]]), np.ones((8, 8)))
    f = np.zeros((64, 64), np.float32)
    f[:32] = 1.0
    fm = np.full((64, 64), tconfig.PIXEL_SPECIAL_VALUE_G, np.float32)
    noisy = rng.random((50, 70)).astype(np.float32)
    for pkg in PKGS.values():
        tui = pkg["tui"]
        np.testing.assert_allclose(tui.downsample_mean(img, 2, 2), [[10, 20], [30, 40]])
        cells = tui.frame_to_cells(f, cols=8, rows=4)
        assert cells.shape == (8, 8, 3) and cells.dtype == np.uint8
        assert np.all(cells[0] == 255) and np.all(cells[-1] == 0)
        inv = tui.frame_to_cells(f, cols=8, rows=4, invert=True)
        assert np.all(inv[0] == 0) and np.all(inv[-1] == 255)
        g = tui.frame_to_cells(fm, cols=4, rows=2)
        assert np.all(g[..., 1] == 255) and np.all(g[..., 0] == 0)
        two = np.zeros((2, 3, 3), np.uint8)
        two[0] = 255
        (line,) = tui.cells_to_ansi(two)
        assert line.count("▀") == 3 and line.count("38;2;255;255;255") == 1
        assert "48;2;0;0;0" in line and line.endswith("\x1b[0m")
    for args in ((noisy, 17, 9), (noisy, 17, 9, True), (fm, 4, 2)):
        a, b = (pkg["tui"].frame_to_cells(*args[:3], invert=len(args) > 3) for pkg in
                PKGS.values())
        np.testing.assert_array_equal(a, b)
        assert jtui.cells_to_ansi(a) == ttui.cells_to_ansi(b)


# ---- controller against a fake TSDR ----


class FakeTSDR:
    def __init__(self, params_mod):
        self.calls = []
        self.session = None
        self._params = params_mod.Params()
        self._dir = params_mod.DIRECTION
        self._param = params_mod.PARAM

    def sync(self, pixels, direction):
        self.calls.append(("sync", pixels, self._dir(direction).name))

    def nudge_framerate(self, d):
        self.calls.append(("nudge", d))
        return 60.0 + d

    def set_base_freq(self, f):
        self.calls.append(("freq", f))

    def set_gain(self, g):
        self.calls.append(("gain", g))

    def set_param(self, p, v):
        self.calls.append(("param", self._param(p).name, v))


def make_ctl(pkg):
    rx = FakeTSDR(PKGS[pkg]["params"])
    t = {"now": 100.0}
    return rx, PKGS[pkg]["tui"].TuiController(rx, now=lambda: t["now"]), t


def drive_keys(pkg, tmp_path):
    """tests/test_tui.py's controller cases, as one script; returns what
    the fake saw and the controller's state after each step."""
    rx, ctl, t = make_ctl(pkg)
    seen = []
    for key in ("SHIFT_LEFT", "SHIFT_LEFT", "h", "LEFT", "LEFT", "RIGHT"):
        ctl.handle_key(key)
        t["now"] += 0.05
        seen.append(ctl.status.osd)
    ctl.seed(400e6, 0.5)
    for key in ("UP", "DOWN", "G", "a", "s", "r", "d", "o", "n"):
        ctl.handle_key(key)
        seen.append(ctl.status.osd)
    ctl.snapshot_dir = str(tmp_path)
    ctl.handle_key("p")
    seen.append(ctl.status.osd)
    ctl.on_frame(np.zeros((8, 8), np.float32))
    ctl.handle_key("p")
    ctl.handle_key("i")
    ctl.handle_key("q")
    return rx.calls, seen, ctl.invert, ctl.quit, sorted(os.listdir(tmp_path))


def test_controller_equal_in_both_packages(tmp_path):
    got = {pkg: drive_keys(pkg, tmp_path / pkg) for pkg in PKGS if not (tmp_path / pkg).mkdir()}
    calls, seen, invert, quit_, snaps = got["torch"]
    assert got["torch"] == got["jax"]
    assert calls[:6] == [("sync", 1, "LEFT"), ("sync", 2, "LEFT"), ("sync", 1, "LEFT"),
                         ("nudge", -1e-8), ("nudge", -4e-8), ("nudge", 1e-8)]
    for want in (("freq", 400e6 + 50e3), ("freq", 400e6), ("gain", 0.55),
                 ("param", "FRAMERATE_PLL", 0), ("param", "AUTOSHIFT", 1),
                 ("param", "AUTOCORR_PLOTS_RESET", 1), ("param", "AUTOCORR_DUMP", 1)):
        assert want in calls
    assert "Move: Left" in seen[0] and "Framerate:" in seen[5] and "no frame yet" in seen[-1]
    assert invert and quit_ and snaps == ["snapshot_0001.pgm"]


@both
def test_status_line_width_and_fields(pkg):
    _, ctl, _ = make_ctl(pkg)
    ev = PKGS[pkg]["events"]
    ctl.on_value(ev.ValueEvent(ev.VALUE_ID.AUTOGAIN_VALUES, 0.1, 0.9))
    ctl.on_value(ev.ValueEvent(ev.VALUE_ID.SNR, 12.5, 0))
    ctl.on_value(ev.ValueEvent(ev.VALUE_ID.AUTOCORRECT_FRAMES_COUNT, 7, 0))
    line = ctl.status_line(200)
    assert len(line) == 200 and "snr 12.5 dB" in line and "ac 7" in line
    assert len(ctl.status_line(20)) == 20


def test_view_cycle_and_plot_render_equal_in_both_packages():
    fvals = np.ones(500)
    fvals[120] = 100.0
    lvals = np.ones(300)
    lvals[40] = 50.0
    out = {}
    for pkg in PKGS:
        _, ctl, _ = make_ctl(pkg)
        ev = PKGS[pkg]["events"]
        assert ctl.render_cells(10, 5) is None
        ctl.handle_key("v")
        assert ctl.view == "frame" and ctl.render_cells(10, 5) is None
        ctl.on_plot(ev.PlotEvent(ev.PLOT_ID.FRAME, 1000, fvals, 8e6))
        ctl.on_plot(ev.PlotEvent(ev.PLOT_ID.LINE, 50, lvals, 8e6))
        frame_cells = ctl.render_cells(64, 20)
        assert frame_cells.shape == (40, 64, 3) and frame_cells.max() == 255
        frame_line = ctl.status_line(120)
        assert "[frame plot]" in frame_line and "fps" in frame_line
        ctl.handle_key("v")
        line_cells = ctl.render_cells(64, 20)
        assert ctl.view == "line" and "px" in ctl.status_line(120)
        ctl.handle_key("v")
        assert ctl.view == "video"
        out[pkg] = (frame_cells, line_cells, frame_line)
    for a, b in zip(out["jax"], out["torch"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---- the live nudge through a real session ----


@both
def test_session_nudge_refreshrate_live_and_clamped(pkg):
    """tests/test_tui.py:217-248 through each package's TSDR."""
    p = PKGS[pkg]
    rx = p["tsdr"](block_samples=4096)
    rx.load_source("synthetic", "64 40 60 1000000 0.05")
    rx.set_resolution(64, 60.0)
    rx.set_param(p["params"].PARAM.FRAMERATE_PLL, 0)
    rx.set_param(p["params"].PARAM.AUTOCORR_PLOTS_OFF, 1)
    seen = []
    lim = 60.0 * p["config"].PLL_HEADROOM_FRAC

    def on_frame(f):
        seen.append(rx.session.current_refreshrate())
        if len(seen) == 1:
            assert rx.nudge_framerate(0.5 * lim) == pytest.approx(60.0 + 0.5 * lim)
        elif len(seen) == 2:
            assert rx.nudge_framerate(10 * lim) == pytest.approx(60.0 + lim)

    rx.start(on_frame=on_frame, max_frames=4)
    assert seen[0] == pytest.approx(60.0)
    assert any(v == pytest.approx(60.0 + 0.5 * lim) for v in seen[1:])
    assert seen[-1] == pytest.approx(60.0 + lim)
    rx.stop()
    assert rx.nudge_framerate(1.0) == pytest.approx(61.0)
    rx.close()


@both
def test_nudge_framerate_idle_adjusts_nominal(pkg):
    rx = PKGS[pkg]["tsdr"]()
    rx.set_resolution(600, 60.0)
    assert rx.nudge_framerate(0.05) == pytest.approx(60.05)
    assert rx.nudge_framerate(-0.1) == pytest.approx(59.95)


@both
def test_run_tui_end_to_end_over_pty(pkg):
    """tests/test_tui.py:251-306: stream a synthetic source through run_tui
    on a real pty, inject RIGHT and q, and read half-block video and the
    status bar off the terminal."""
    import fcntl
    import pty
    import struct
    import termios as tm
    import threading

    p = PKGS[pkg]
    master, slave = pty.openpty()
    fcntl.ioctl(slave, tm.TIOCSWINSZ, struct.pack("HHHH", 24, 80, 0, 0))
    sin = os.fdopen(slave, "rb", buffering=0, closefd=False)
    sout = os.fdopen(slave, "w", buffering=1, closefd=False)
    rx = p["tsdr"](block_samples=4096)
    rx.load_source("synthetic", "64 40 60 1000000 0.05")
    rx.set_resolution(64, 60.0)
    rx.set_param(p["params"].PARAM.AUTOCORR_PLOTS_OFF, 1)
    result = {}

    def go():
        result["frames"] = p["tui"].run_tui(rx, max_frames=200, redraw_hz=60.0, stdin=sin,
                                            stdout=sout)

    t = threading.Thread(target=go, daemon=True)
    t.start()
    chunks, stop_drain = [], threading.Event()

    def drain():  # keep the pty buffer empty or run_tui's writes block
        while not stop_drain.is_set():
            try:
                chunks.append(os.read(master, 65536))
            except OSError:
                return

    threading.Thread(target=drain, daemon=True).start()
    deadline = time.time() + 60
    while time.time() < deadline and b"\xe2\x96\x80" not in b"".join(chunks):
        time.sleep(0.02)
    os.write(master, b"\x1b[C")
    os.write(master, b"q")
    t.join(timeout=60)
    alive = t.is_alive()
    stop_drain.set()
    out = b"".join(chunks)
    assert not alive
    assert b"\xe2\x96\x80" in out and b"fps" in out
    assert result["frames"] >= 1
    for fd in (master, slave):
        with contextlib.suppress(OSError):
            os.close(fd)


def test_cli_tui_over_pty_runs_the_port(tmp_path):
    """`cli.main([... "--tui", "--device", "cpu"])` with the pty as the
    process's terminal: the viewer streams, q quits, the CLI returns 0 and
    logs its frame count (the JAX CLI's --tui path, cli.py:316-325)."""
    import fcntl
    import pty
    import struct
    import subprocess
    import sys
    import termios as tm

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; from tempestsdr_tpu_torch import cli; sys.exit(cli.main(["
            "'--source', 'synthetic', '--source-params', '64 40 60 1000000 0.05', "
            "'--height', '64', '--rate', '60', '--block-samples', '4096', '--no-autocorr', "
            "'--tui', '--frames', '100000', '--device', 'cpu', '--out', sys.argv[1]]))")
    master, slave = pty.openpty()
    fcntl.ioctl(slave, tm.TIOCSWINSZ, struct.pack("HHHH", 24, 80, 0, 0))
    env = {**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "2"}  # a share of the cores
    proc = subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], stdin=slave,
                            stdout=slave, stderr=subprocess.PIPE, env=env, cwd=str(tmp_path))
    os.close(slave)
    out, deadline, sent = b"", time.time() + 120, False
    while proc.poll() is None and time.time() < deadline:
        try:
            out += os.read(master, 65536)
        except OSError:
            break
        if not sent and b"\xe2\x96\x80" in out:
            os.write(master, b"q")
            sent = True
    rc = proc.wait(timeout=30)
    os.close(master)
    assert rc == 0, proc.stderr.read().decode()[-2000:]
    assert sent and b"tui done:" in out and b"fps" in out
