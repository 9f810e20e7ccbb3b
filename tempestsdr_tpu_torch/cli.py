"""Command-line interface — headless counterpart of the reference's GUI
controls (start/stop, resolution/rate, gain, motion blur, param toggles,
snapshots — Main.java), driving the TSDR API over any registered source.

Examples:
  python -m tempestsdr_tpu_torch.cli --source rawfile \\
      --source-params "capture.bin 8000000 uint8" \\
      --height 628 --rate 60 --frames 120 --out /tmp/frames --save-every 30
  python -m tempestsdr_tpu_torch.cli --source synthetic \\
      --source-params "628 424 60 8000000 0.02" --height 628 --rate 60 \\
      --frames 60 --auto-resolution

Runs on the CUDA device unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .api import TSDR
from .estimate import AutoResolution
from .events import PLOT_ID
from .params import PARAM
from .snapshot import save_frame


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tempestsdr-tpu-torch", description=__doc__)
    p.add_argument("--source", default=None, help="source name (rawfile, synthetic, simlive, rtltcp, "
                   "exec, cplugin); "
                   "required unless --use-prefs supplies a saved one")
    p.add_argument("--source-params", default="", help="opaque source parameter string")
    p.add_argument("--height", type=int, default=628, help="total lines incl. blanking")
    p.add_argument("--rate", type=float, default=60.0, help="refresh rate Hz")
    p.add_argument("--freq", type=float, default=None, help="center frequency Hz")
    p.add_argument("--gain", type=float, default=None, help="normalized gain 0..1")
    p.add_argument("--motionblur", type=float, default=0.0)
    p.add_argument("--frames", type=int, default=None, help="stop after N frames")
    p.add_argument("--blocks", type=int, default=None, help="stop after N blocks")
    p.add_argument("--block-samples", type=int, default=1 << 16)
    p.add_argument("--batch-blocks", default=None,
                   help="blocks per device dispatch (amortizes dispatch "
                        "latency; adds control latency). An integer, or "
                        "'auto' to size from the measured dispatch floor "
                        "under a 250 ms control-latency cap. Default: 1 "
                        "(lowest latency); --tui defaults to auto")
    p.add_argument("--out", default=None, help="directory for frame snapshots")
    p.add_argument("--plot-out", default=None,
                   help="directory for rendered autocorr plot images "
                        "(PlotVisualizer equivalent, one per estimation round)")
    p.add_argument("--save-every", type=int, default=30, help="snapshot cadence (frames)")
    p.add_argument("--format", default="pgm", choices=["pgm", "npy", "png"])
    p.add_argument("--invert", action="store_true",
                   help="invert snapshot grayscale (JNI converter's invert flag)")
    p.add_argument("--autoshift", action="store_true", help="auto-center via sync detection")
    p.add_argument("--no-pll", action="store_true", help="disable the frame-rate PLL")
    p.add_argument("--nearest", action="store_true", help="nearest-neighbour resampling")
    p.add_argument("--fast-sync", action="store_true",
                   help="f32 sync search (speed mode; exact near-tie "
                        "parity with the reference's double math needs the "
                        "default f64)")
    p.add_argument("--no-autocorr", action="store_true", help="disable the estimator")
    p.add_argument("--auto-resolution", action="store_true",
                   help="detect (rate, height) from autocorrelation, then report")
    p.add_argument("--auto-apply", action="store_true",
                   help="with --auto-resolution or --select-lag/"
                        "--select-line-lag: apply the detected/selected mode "
                        "and restart streaming at it (GUI AUT behaviour, "
                        "Main.java:1259-1262)")
    p.add_argument("--select-lag", default=None, metavar="AROUND,AREA",
                   help="manual frame-plot selection: snap to the best peak "
                        "within AREA lags around lag AROUND (samples) on the "
                        "first estimation round and derive the refresh rate "
                        "(the plot click + area spinner, "
                        "PlotVisualizer.getBestIdAround :144-163, "
                        "Main.java:563-572,1315-1321)")
    p.add_argument("--select-line-lag", default=None, metavar="AROUND,AREA",
                   help="manual line-plot selection: derive the height as "
                        "frame_lag/line_lag (Main.java:1357-1361; frame_lag "
                        "from --select-lag if given, else samplerate/rate)")
    p.add_argument("--tui", action="store_true",
                   help="interactive terminal viewer: live half-block video "
                        "+ keyboard control (the GUI's canvas/hold-button "
                        "surface — see tempestsdr_tpu_torch/tui.py for the key map)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the run into DIR "
                        "(a Chrome trace, Perfetto-readable; SURVEY §5.1)")
    p.add_argument("--use-prefs", action="store_true",
                   help="apply saved preferences as defaults for any option "
                        "not given on the command line (the GUI loads its "
                        "java.util.prefs store at start, Main.java:90-104)")
    p.add_argument("--save-prefs", action="store_true",
                   help="persist this run's settings on exit")
    p.add_argument("--prefs-path", default=None,
                   help="preferences file (default ~/.config/tempestsdr_tpu/"
                        "prefs.json or $TSDR_PREFS_PATH)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device the pipeline runs on (default: cuda; "
                        "without a CUDA device the run fails unless this is cpu)")
    return p


# pref key -> (cli flag, attr); mirrors the PREF_* set the GUI persists
# (Main.java:90-104) + the PARAM toggle states (ParametersToggleButton.java)
_PREF_MAP = [
    ("source", "--source", "source"),
    ("source_params", "--source-params", "source_params"),
    ("height", "--height", "height"),
    ("rate", "--rate", "rate"),
    ("freq", "--freq", "freq"),
    ("gain", "--gain", "gain"),
    ("motionblur", "--motionblur", "motionblur"),
    ("autoshift", "--autoshift", "autoshift"),
    ("nearest", "--nearest", "nearest"),
    ("no_pll", "--no-pll", "no_pll"),
    ("fast_sync", "--fast-sync", "fast_sync"),
    ("no_autocorr", "--no-autocorr", "no_autocorr"),
    ("invert", "--invert", "invert"),
]


def _flag_given(flag: str, argv) -> bool:
    return any(a == flag or a.startswith(flag + "=") for a in argv)


def _apply_prefs(args, prefs, argv) -> None:
    for key, flag, attr in _PREF_MAP:
        if not _flag_given(flag, argv) and key in prefs.keys():
            setattr(args, attr, prefs.get(key))


def _store_prefs(args, prefs) -> None:
    prefs.update({key: getattr(args, attr) for key, flag, attr in _PREF_MAP})
    prefs.save()


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    prefs = None
    if args.use_prefs or args.save_prefs:
        from .prefs import Preferences

        prefs = Preferences(args.prefs_path)
    if args.use_prefs:
        _apply_prefs(args, prefs, argv)
    if not args.source:
        parser.error("--source is required (no saved source in preferences)")

    t0 = time.time()
    n_frames = 0
    tracker = None

    def log(msg):
        if not args.quiet:
            print(f"[{time.time()-t0:7.2f}s] {msg}", flush=True)

    def on_value(ev):
        log(f"value {ev.value_id.name}: {ev.arg0:.6g} {ev.arg1:.6g}")

    detected = {"est": None, "manual": None, "warm_threads": {}}

    def parse_sel(spec):
        try:
            around, area = (int(x) for x in spec.split(","))
            if around <= 0 or area < 0:
                raise ValueError
            return around, area
        except ValueError:
            raise SystemExit(f"bad selection spec {spec!r}: want AROUND,AREA "
                             "(positive lag, non-negative area)")

    sel_frame = parse_sel(args.select_lag) if args.select_lag else None
    sel_line = parse_sel(args.select_line_lag) if args.select_line_lag else None
    plots = {}

    def manual_select():
        """Mirror the GUI click sequence on the first estimation round:
        frame-plot selection -> fps (Main.java:1315-1321), line-plot
        selection -> height with frame_lag = the frame selection when
        present, else samplerate/rate (:1352-1361)."""
        from .estimate.peaks import select_fps, select_height

        sr = rx._source.samplerate()
        rate, height = args.rate, args.height
        frame_lag = sr / rate
        if sel_frame:
            fev = plots[PLOT_ID.FRAME]
            got = select_fps(np.asarray(fev.values), fev.offset, sr,
                             sel_frame[0], sel_frame[1])
            if got is None:
                log(f"MANUAL-SELECT: frame lag {sel_frame[0]} outside the "
                    "plotted window; keeping current rate")
            else:
                frame_lag, rate = got[0], got[1]
        if sel_line:
            lev = plots[PLOT_ID.LINE]
            got = select_height(np.asarray(lev.values), lev.offset, frame_lag,
                                sel_line[0], sel_line[1])
            if got is None:
                log(f"MANUAL-SELECT: line lag {sel_line[0]} outside the "
                    "plotted window; keeping current height")
            else:
                height = got[1]
        detected["manual"] = (height, rate)
        log(f"MANUAL-SELECT: {rate:.2f} Hz, {height} lines")
        if args.auto_apply:
            stop_after_warm(height, rate)

    def stop_after_warm(height, rate):
        """Warm the next geometry's step while the current session still
        streams, THEN stop — the mode switch costs only the stream gap
        instead of a cold first block (live tsdr_setresolution semantics,
        TSDRLibrary.c:552-566). Stops only the session that was streaming at
        detection time (the first session may also end on its own limits
        while the warm start runs — never kill the restarted one)."""
        import threading

        key = (int(height), float(rate))
        if key in detected["warm_threads"]:
            return  # already warming this mode (e.g. manual + AUT agree)
        sess = rx.session

        def _go():
            try:
                rx.warm_resolution(height, rate)
                log(f"warm start ready: {height} lines @ {rate:g} Hz")
            except Exception as e:  # noqa: BLE001 — apply anyway, start cold
                log(f"warm start failed ({e}); applying cold")
            finally:
                if sess is not None:
                    sess.stop()

        t = threading.Thread(target=_go, daemon=True)
        detected["warm_threads"][key] = t
        t.start()

    plot_rounds = {"n": 0}

    def on_plot(ev):
        nonlocal tracker
        if (sel_frame or sel_line) and detected["manual"] is None:
            plots[ev.plot_id] = ev
            if PLOT_ID.FRAME in plots and PLOT_ID.LINE in plots:
                manual_select()
        if args.plot_out:
            from .estimate.plotrender import render_plot, save_plot

            kind = "frame" if ev.plot_id.name == "FRAME" else "line"
            if kind == "frame":
                plot_rounds["n"] += 1
            img, info = render_plot(
                np.asarray(ev.values), offset=ev.offset,
                samplerate=ev.samplerate, kind=kind)
            path = os.path.join(
                args.plot_out,
                f"autocorr_{kind}_{plot_rounds['n']:04d}.{args.format}")
            save_plot(img, path)
            log(f"plot {kind}: peak {info['label']} -> {path}")
        if tracker is None:
            return
        est = tracker.feed(ev)
        if est is not None and detected["est"] is None:
            detected["est"] = est
            mode = f" -> {est.mode.name}" if est.mode else ""
            log(f"AUTO-RESOLUTION: {est.refreshrate:.2f} Hz, {est.height} lines{mode}")
            if args.auto_apply:
                height, rate = est.height, est.refreshrate
                if est.mode is not None:
                    height, rate = est.mode.height, est.mode.refreshrate
                stop_after_warm(height, rate)

    # --tui is the live-interactive mode: default to floor-aware auto
    # batching (250 ms control-latency cap); headless replay keeps batch=1
    # unless the caller sizes it
    batch = args.batch_blocks
    if batch is None:
        batch = "auto" if args.tui else 1
    elif batch != "auto":
        batch = int(batch)
    rx = TSDR(on_value=on_value, on_plot=on_plot, block_samples=args.block_samples,
              batch_blocks=batch, device=args.device)
    rx.load_source(args.source, args.source_params)
    rx.set_resolution(args.height, args.rate)
    if args.freq is not None:
        rx.set_base_freq(args.freq)
    if args.gain is not None:
        rx.set_gain(args.gain)
    rx.set_param(PARAM.AUTOSHIFT, int(args.autoshift))
    rx.set_param(PARAM.FRAMERATE_PLL, int(not args.no_pll))
    rx.set_param(PARAM.NEAREST_NEIGHBOUR_RESAMPLING, int(args.nearest))
    rx.set_param(PARAM.AUTOCORR_PLOTS_OFF, int(args.no_autocorr))
    if args.fast_sync:
        rx.set_extra_params(fast_sync=True)
    rx.set_motionblur(args.motionblur)
    if args.auto_resolution:
        tracker = AutoResolution(rx._source.samplerate())

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.plot_out:
        os.makedirs(args.plot_out, exist_ok=True)

    def on_frame(f: np.ndarray):
        nonlocal n_frames
        n_frames += 1
        if args.out and (n_frames % args.save_every == 0 or n_frames == 1):
            path = os.path.join(args.out, f"frame_{n_frames:06d}.{args.format}")
            save_frame(f, path, invert=args.invert)
            log(f"frame {n_frames}: saved {path}")
        elif n_frames % 30 == 0:
            log(f"frame {n_frames}: range [{f.min():.3f}, {f.max():.3f}]")

    if args.tui:
        from .tui import run_tui

        n = run_tui(rx, max_frames=args.frames, max_blocks=args.blocks,
                    freq=args.freq, gain=args.gain,
                    snapshot_dir=args.out or ".", snapshot_fmt=args.format)
        log(f"tui done: {n} frames")
        if args.save_prefs:
            _store_prefs(args, prefs)
        rx.close()
        return 0

    import contextlib

    trace_ctx = contextlib.nullcontext()
    if args.trace:
        from .utils.profiling import profile_trace

        trace_ctx = profile_trace(args.trace)

    try:
        with trace_ctx:
            rx.start(on_frame=on_frame, max_frames=args.frames,
                     max_blocks=args.blocks)
        apply_mode = None
        if detected["manual"] is not None:
            apply_mode = detected["manual"]  # manual click wins over AUT
        elif detected["est"] is not None:
            est = detected["est"]
            apply_mode = (est.height, est.refreshrate)
            if est.mode is not None:
                apply_mode = (est.mode.height, est.mode.refreshrate)
        if args.auto_apply and apply_mode is not None:
            height, rate = apply_mode
            # join the warm thread for the mode actually being applied
            # (manual and AUT may have warmed different geometries)
            t = detected["warm_threads"].get((int(height), float(rate)))
            if t is not None:
                t.join(timeout=600)  # the restart below reuses its step
            log(f"applying detected mode: {height} lines @ {rate:g} Hz")
            rx.set_resolution(height, rate)
            rx.start(on_frame=on_frame, max_frames=args.frames, max_blocks=args.blocks)
    except KeyboardInterrupt:
        rx.stop()
    dt = time.time() - t0
    log(f"done: {n_frames} frames in {dt:.1f}s ({n_frames/dt:.1f} fps)")
    if args.save_prefs:
        _store_prefs(args, prefs)
    rx.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
