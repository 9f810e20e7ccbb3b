"""The port's front door — tempestsdr_tpu_torch.api.TSDR and
`python -m tempestsdr_tpu_torch.cli` — against the JAX package's on the CPU:
the cases of tests/test_api.py and tests/test_cli.py run through both, the
port with device="cpu" / --device cpu. Frame counts, detected (height,
rate), the restart under --auto-apply, the saved file names and the prefs
file are equal; frames within FRAME_RTOL/FRAME_ATOL (the step's parity
tolerance), so .npy snapshots within that and 8-bit .pgm snapshots within
one grey level."""

import json
import os
import re
import time

import numpy as np
import pytest

import tempestsdr_tpu as jpkg
from tempestsdr_tpu import cli as jcli
from tempestsdr_tpu.stream import session as jsession

import tempestsdr_tpu_torch as tpkg
from tempestsdr_tpu_torch import cli as tcli
from tempestsdr_tpu_torch.stream import session as tsession

from test_torch_device_step import one_torch_thread  # noqa: F401 (autouse)

LINES, TWIDTH, REFRESH, SR = 100, 200, 50.0, 1e6
SPEC = f"{LINES} {TWIDTH} {REFRESH} {SR} 0.01"
FRAME_ATOL, FRAME_RTOL = 1e-5, 1e-6  # tests/test_torch_stream.py
PACKAGES = {"jax": (jpkg, {}), "torch": (tpkg, dict(device="cpu"))}


def make_api(which, **kw):
    pkg, dev = PACKAGES[which]
    api = pkg.TSDR(block_samples=8192, **kw, **dev)
    api.load_source("synthetic", SPEC)
    api.set_resolution(LINES, REFRESH)
    return api


# ---- TSDR ----


def test_api_streams_the_same_frames():
    frames = {}
    for which in PACKAGES:
        api = make_api(which)
        frames[which] = []
        n = api.start(on_frame=frames[which].append, max_frames=3)
        assert n == 3 and len(frames[which]) == 3
        assert frames[which][0].shape == (LINES, api.session.config.width)
        assert not api.is_running
        api.close()
    for a, b in zip(frames["torch"], frames["jax"]):
        np.testing.assert_allclose(a, b, rtol=FRAME_RTOL, atol=FRAME_ATOL)


def test_tsdr_has_every_method_of_the_reference():
    public = lambda cls: {n for n in dir(cls) if not n.startswith("_")}  # noqa: E731
    assert public(jpkg.TSDR) <= public(tpkg.TSDR)
    assert public(jsession.Session) <= public(tsession.Session)
    import inspect

    jargs = set(inspect.signature(jsession.Session.__init__).parameters)
    targs = set(inspect.signature(tsession.Session.__init__).parameters)
    assert jargs <= targs and targs - jargs == {"device"}
    assert set(inspect.signature(tpkg.TSDR.__init__).parameters) - set(
        inspect.signature(jpkg.TSDR.__init__).parameters) == {"device"}


@pytest.mark.parametrize("which", PACKAGES)
def test_set_parameter_double_and_set_param(which):
    pkg, dev = PACKAGES[which]
    api = pkg.TSDR(**dev)
    api.set_parameter_double(0, 1.5)
    api.set_parameter_double(1, -2.5)
    assert api._params_double == [1.5, -2.5]
    for bad in (-1, 2, 99):
        with pytest.raises(pkg.TSDRError) as ei:
            api.set_parameter_double(bad, 0.0)
        assert ei.value.status == pkg.TSDRStatus.INVALID_PARAMETER
    api.set_param(pkg.PARAM.AUTOSHIFT, 1)
    assert api._params.autoshift
    api.set_param(pkg.PARAM.AUTOSHIFT, 0)
    assert not api._params.autoshift
    with pytest.raises(ValueError):
        api.set_param(99, 1)
    # one-shot params with no session are accepted and do nothing
    api.set_param(pkg.PARAM.AUTOCORR_PLOTS_RESET, 1)
    api.set_param(pkg.PARAM.AUTOCORR_DUMP, 1)
    assert api.nudge_framerate(0.05) == pytest.approx(60.05)
    assert api.nudge_framerate(-0.1) == pytest.approx(59.95)
    assert api.last_error == "" and api.session is None


@pytest.mark.parametrize("which", PACKAGES)
def test_error_probes_raise_the_same_status(which):
    """Bad source name, bad params string, bad resolution, sync with no
    session, and — while a background session streams — a resolution
    change, a source load, a second start and a superresolution toggle."""
    pkg, dev = PACKAGES[which]
    st = pkg.TSDRStatus
    api = pkg.TSDR(block_samples=8192, **dev)

    def status(fn, *a, **k):
        with pytest.raises(pkg.TSDRError) as ei:
            fn(*a, **k)
        return ei.value.status.name

    assert status(api.load_source, "no_such_source") == st.INCOMPATIBLE_PLUGIN.name
    assert "no_such_source" in api.last_error
    assert status(api.load_source, "synthetic", "100 nonsense") == st.PLUGIN_PARAMETERS_WRONG.name
    assert status(api.set_resolution, 0, 60.0) == st.WRONG_VIDEOPARAMS.name
    assert status(api.set_resolution, 100, -1.0) == st.WRONG_VIDEOPARAMS.name
    assert status(api.set_motionblur, 1.5) == st.WRONG_VIDEOPARAMS.name
    assert status(api.sync, 3) == st.NOT_RUNNING.name
    assert status(api.start, lambda f: None, max_frames=1) == st.ERR_PLUGIN.name  # no source
    api.load_source("synthetic", SPEC)
    api.set_resolution(LINES, REFRESH)
    api.set_param(pkg.PARAM.AUTOCORR_PLOTS_OFF, 1)
    frames = []
    assert api.start(on_frame=frames.append, background=True) is None
    try:
        assert api.is_running
        assert status(api.set_resolution, 120, 60.0) == st.ALREADY_RUNNING.name
        assert status(api.load_source, "synthetic", SPEC) == st.ALREADY_RUNNING.name
        assert status(api.unload_source) == st.ALREADY_RUNNING.name
        assert status(api.start, frames.append) == st.ALREADY_RUNNING.name
        assert status(api.set_param, pkg.PARAM.AUTOCORR_SUPERRESOLUTION, 1) == \
            st.ALREADY_RUNNING.name
        assert status(api.sync, LINES + 1, 1) == st.WRONG_VIDEOPARAMS.name  # UP past height
        api.sync(3)
        api.set_motionblur(0.5)
        api.set_base_freq(100e6)
        api.set_gain(0.5)
        deadline = time.time() + 60
        while len(frames) < 2 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        api.stop()
    assert not api.is_running and len(frames) >= 2
    api.set_resolution(120, 60.0)  # stopped -> allowed
    assert api._height == 120
    api.close()


def test_set_extra_params_live_flip_matches():
    """Extras (fast_sync, resampler, ...) flip live through
    TSDR.set_extra_params with the carried state surviving: the same frames
    from both packages, before and after the flip."""
    frames = {}
    for which in PACKAGES:
        rx = make_api(which)
        rx.set_param(PACKAGES[which][0].PARAM.AUTOCORR_PLOTS_OFF, 1)
        got = frames[which] = []

        def on_frame(f, rx=rx, got=got):
            got.append(f)
            if len(got) == 4:
                rx.set_extra_params(fast_sync=True)

        rx.start(on_frame=on_frame, max_frames=10)
        assert len(got) == 10 and rx._params.fast_sync and rx.session.params.fast_sync
        assert int(np.asarray(rx.session.state.frame_count)) == 10
        rx.close()
    for a, b in zip(frames["torch"], frames["jax"]):
        np.testing.assert_allclose(a, b, rtol=FRAME_RTOL, atol=FRAME_ATOL)


def test_warm_resolution_background_is_reused():
    """warm_resolution(background=True) returns its thread; the restarted
    session reuses the warmed step, on the TSDR's device."""
    import torch

    rx = make_api("torch")
    rx.set_param(tpkg.PARAM.FRAMERATE_PLL, 0)
    t = rx.warm_resolution(LINES + 14, REFRESH, background=True)
    t.join(timeout=120)
    assert not t.is_alive()
    assert rx.warm_resolution(LINES + 16, REFRESH) is None
    frames = []
    rx.set_resolution(LINES + 14, REFRESH)
    rx.start(on_frame=frames.append, max_frames=2)
    key = (rx.session.config, rx.session.params, 1, torch.device("cpu"))
    assert rx.session._runner is tsession._WARM_STEPS[key]
    assert len(frames) == 2 and frames[0].shape[0] == LINES + 14
    rx.close()


def test_background_start_beside_a_background_warm(tmp_path):
    """start(background=True), and while it streams warm_resolution(...,
    background=True), joined; then stop, set_resolution to the warmed
    geometry and start again. A rawfile source restarts at the file's
    start, so the streamed frames are a foreground run's first frames bit
    for bit; the restarted session takes the warmed runner and its frames
    are a foreground run's at that geometry."""
    import torch
    from tempestsdr_tpu_torch.sources.synthetic import render_test_pattern, synth_iq

    path = tmp_path / "capture.u8"
    synth_iq(render_test_pattern(LINES, TWIDTH), samplerate=SR, pixelclock=LINES * TWIDTH * REFRESH,
             n_samples=16 * 8192, noise=0.01, dtype=np.uint8).tofile(path)

    def api(height):
        rx = tpkg.TSDR(block_samples=8192, device="cpu")
        rx.load_source("rawfile", f"{path} {SR} uint8")
        rx.set_resolution(height, REFRESH)
        return rx

    def foreground(height, n):
        rx = api(height)
        got = []
        rx.start(on_frame=got.append, max_frames=n)
        rx.close()
        return got

    rx = api(LINES)
    streamed = []
    assert rx.start(on_frame=streamed.append, background=True) is None
    deadline = time.time() + 60
    while len(streamed) < 2 and time.time() < deadline:
        time.sleep(0.005)
    assert rx.is_running
    t = rx.warm_resolution(LINES + 14, REFRESH, background=True)
    t.join(timeout=120)
    assert not t.is_alive()
    rx.stop()
    assert not rx.is_running and len(streamed) >= 2
    want = foreground(LINES, len(streamed))
    assert len(want) == len(streamed)
    assert all(np.array_equal(a, b) for a, b in zip(streamed, want))

    rx.set_resolution(LINES + 14, REFRESH)
    key = (rx._make_config(), rx._params, 1, torch.device("cpu"))
    warmed = tsession._WARM_STEPS[key]
    restarted = []
    assert rx.start(on_frame=restarted.append, max_frames=3) == 3
    assert rx.session._runner is warmed
    rx.close()
    want = foreground(LINES + 14, 3)
    assert len(restarted) == len(want) == 3
    assert restarted[0].shape == (LINES + 14, rx.session.config.width)
    assert all(np.array_equal(a, b) for a, b in zip(restarted, want))


@pytest.mark.parametrize("which", PACKAGES)
def test_make_config_multiplies_the_rate_under_superresolution(which):
    pkg, _ = PACKAGES[which]
    rx = make_api(which)
    assert rx._make_config().samplerate == SR
    rx.set_param(pkg.PARAM.AUTOCORR_SUPERRESOLUTION, 1)
    cfg = rx._make_config(height=120)
    assert cfg.samplerate == 4 * SR and cfg.height == 120 and cfg.block_samples == 8192
    rx.close()


def test_api_superresolution_streams_like_jax():
    """TSDR with PARAM.AUTOCORR_SUPERRESOLUTION builds the 4x-rate pipeline
    itself; frames within rtol/atol 1e-4 of the JAX package's (the stitched
    stream's tolerance, tests/test_torch_superband.py)."""
    frames = {}
    for which, (pkg, dev) in PACKAGES.items():
        rx = pkg.TSDR(block_samples=4096, **dev)
        rx.load_source("synthetic", "60 40 50 250000 0.01")
        rx.set_resolution(60, 50.0)
        for param, value in ((pkg.PARAM.AUTOCORR_SUPERRESOLUTION, 1),
                             (pkg.PARAM.FRAMERATE_PLL, 0), (pkg.PARAM.AUTOCORR_PLOTS_OFF, 1)):
            rx.set_param(param, value)
        frames[which] = []
        assert rx.start(on_frame=frames[which].append, max_frames=2) >= 2
        rx.close()
    assert len(frames["torch"]) == len(frames["jax"])
    for a, b in zip(frames["torch"], frames["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


# ---- the command line ----

CLIS = {"jax": (jcli, []), "torch": (tcli, ["--device", "cpu"])}
SMALL = ["--source", "synthetic", "--source-params", "100 200 50 1000000 0.01",
         "--height", "100", "--rate", "50", "--block-samples", "8192"]
WRONG_MODE = ["--source", "synthetic", "--source-params", "600 111 60 2000000 0.01",
              "--height", "400", "--rate", "55", "--block-samples", "16384",
              "--blocks", "60", "--no-pll"]


def run_cli(which, argv, capsys):
    mod, extra = CLIS[which]
    assert mod.main(list(argv) + extra) == 0
    # drop the "[   1.23s] " stamp of every log line
    return [re.sub(r"^\[[ 0-9.]+s\] ", "", line)
            for line in capsys.readouterr().out.splitlines()]


def test_cli_parser_has_every_option_of_the_reference():
    opts = lambda p: {s: (a.default, a.type, a.choices) for a in p._actions  # noqa: E731
                      for s in a.option_strings}
    jopts, topts = opts(jcli.build_parser()), opts(tcli.build_parser())
    assert set(topts) - set(jopts) == {"--device"} and topts["--device"][0] == "cuda"
    assert {k: topts[k] for k in jopts} == jopts


def _read_pgm(path):
    with open(path, "rb") as f:
        magic, dims, maxval = f.readline(), f.readline(), f.readline()
        assert magic.strip() == b"P5" and maxval.strip() == b"255"
        w, h = (int(x) for x in dims.split())
        return np.frombuffer(f.read(), np.uint8).reshape(h, w)


@pytest.mark.parametrize("fmt", ["pgm", "npy"])
def test_cli_end_to_end_snapshots(tmp_path, capsys, fmt):
    """The same run through both CLIs: the same log (frame count, saved
    names), and the snapshots equal up to the frames' tolerance."""
    logs = {}
    for which in CLIS:
        out = tmp_path / which
        logs[which] = run_cli(which, SMALL + [
            "--frames", "8", "--out", str(out), "--save-every", "4", "--format", fmt,
            "--no-pll", "--no-autocorr", "--invert"], capsys)
        assert any(line.startswith("done: 8 frames") for line in logs[which])
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        f"frame_{i:06d}.{fmt}" for i in (1, 4, 8)]
    saved = lambda log, d: [line.replace(str(d), "") for line in log if "saved" in line]  # noqa: E731
    assert saved(logs["torch"], tmp_path / "torch") == saved(logs["jax"], tmp_path / "jax")
    for name in names:
        t, j = tmp_path / "torch" / name, tmp_path / "jax" / name
        if fmt == "npy":
            np.testing.assert_allclose(np.load(t), np.load(j), rtol=FRAME_RTOL, atol=FRAME_ATOL)
        else:
            diff = np.abs(_read_pgm(t).astype(int) - _read_pgm(j).astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_cli_auto_apply_restarts_at_the_same_detected_mode(capsys):
    """--auto-resolution --auto-apply from a wrong height and rate: both
    CLIs detect the same mode, warm it while the first session streams,
    and only then restart at it."""
    lines = {w: run_cli(w, WRONG_MODE + ["--auto-resolution", "--auto-apply"], capsys)
             for w in CLIS}
    pick = lambda log, word: [line for line in log if line.startswith(word)]  # noqa: E731
    detected = pick(lines["torch"], "AUTO-RESOLUTION")
    assert detected == pick(lines["jax"], "AUTO-RESOLUTION") and len(detected) == 1
    assert detected[0].startswith("AUTO-RESOLUTION: 60.00 Hz, ")
    applied = pick(lines["torch"], "applying detected mode")
    assert applied == pick(lines["jax"], "applying detected mode") and len(applied) == 1
    log = lines["torch"]
    assert log.index(pick(log, "warm start ready")[0]) < log.index(applied[0])


def test_cli_manual_lag_selection_applies_the_same_mode(capsys):
    """--select-lag/--select-line-lag with --auto-apply: the same
    MANUAL-SELECT line and the same applied mode from both CLIs."""
    frame_lag = 2_000_000 // 60
    argv = WRONG_MODE + ["--select-lag", f"{frame_lag - 40},100", "--select-line-lag", "56,8",
                         "--auto-apply"]
    lines = {w: run_cli(w, argv, capsys) for w in CLIS}
    for word in ("MANUAL-SELECT", "applying detected mode"):
        got = {w: [line for line in lines[w] if line.startswith(word)] for w in CLIS}
        assert got["torch"] == got["jax"] and len(got["torch"]) == 1, word
    assert any(line.startswith("MANUAL-SELECT: 60.00 Hz") for line in lines["torch"])


def test_cli_bad_selection_spec_exits():
    for which, (mod, extra) in CLIS.items():
        with pytest.raises(SystemExit, match="bad selection spec"):
            mod.main(SMALL + ["--select-lag", "12"] + extra)


def test_cli_plot_out_renders_the_same_plots(tmp_path, capsys):
    """--plot-out: the same files and the same peak labels; the rendered
    images equal but for the few pixels where a plotted value sits on a
    rounding edge (under 0.1 % of the pixels)."""
    logs = {}
    for which in CLIS:
        logs[which] = run_cli(which, SMALL + [
            "--frames", "6", "--plot-out", str(tmp_path / which), "--no-pll", "--format", "npy"],
            capsys)
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert any("autocorr_frame" in n for n in names) and any("autocorr_line" in n for n in names)
    peaks = {w: [line.split(" -> ")[0] for line in logs[w] if line.startswith("plot ")]
             for w in CLIS}
    assert peaks["torch"] == peaks["jax"] and peaks["torch"]
    for name in names:
        t, j = np.load(tmp_path / "torch" / name), np.load(tmp_path / "jax" / name)
        assert t.shape == j.shape and (t != j).mean() < 1e-3


def test_cli_save_and_use_prefs_write_the_same_file(tmp_path, capsys):
    """--save-prefs writes the JAX package's file, byte for byte; --use-prefs
    reads it back (also the one the other package wrote); no source
    anywhere is an argparse error."""
    paths = {w: str(tmp_path / f"{w}.json") for w in CLIS}
    for which in CLIS:
        run_cli(which, SMALL + ["--frames", "2", "--no-pll", "--no-autocorr", "--quiet",
                                "--save-prefs", "--prefs-path", paths[which]], capsys)
    assert open(paths["torch"], "rb").read() == open(paths["jax"], "rb").read()
    saved = json.load(open(paths["torch"]))
    assert saved["source"] == "synthetic" and saved["height"] == 100
    assert saved["no_autocorr"] is True
    log = run_cli("torch", ["--use-prefs", "--prefs-path", paths["jax"],
                            "--block-samples", "8192", "--frames", "2", "--no-pll"], capsys)
    assert any(line.startswith("done: 2 frames") for line in log)
    with pytest.raises(SystemExit) as e:
        tcli.main(["--frames", "1", "--device", "cpu"])
    assert e.value.code == 2


def test_cli_tui_is_refused_and_trace_is_written(tmp_path, capsys):
    """--tui needs a terminal on stdin (tests/test_torch_tui.py drives it
    over a pty); without one both command lines refuse it alike."""
    refused = {}
    for which, (mod, extra) in CLIS.items():
        with pytest.raises(Exception) as e:
            mod.main(SMALL + ["--tui"] + extra)
        refused[which] = type(e.value)
    assert refused["torch"] is refused["jax"] is not NotImplementedError
    trace = tmp_path / "trace"
    run_cli("torch", SMALL + ["--blocks", "3", "--no-autocorr", "--trace", str(trace)], capsys)
    assert [p.suffix for p in trace.iterdir()] == [".json"]
