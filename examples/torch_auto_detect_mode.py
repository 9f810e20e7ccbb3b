"""Unknown display mode, with the PyTorch port: estimate (refresh, lines)
from the autocorrelation plots, snap to the nearest VESA mode, then stream
at it.

usage: python examples/torch_auto_detect_mode.py capture.bin 8000000 uint8 [--device cpu]

Runs on the CUDA card by default (and raises without one); --device cpu
runs the kernels' plain PyTorch versions.
"""

import argparse

import tempestsdr_tpu_torch as tsdr
from tempestsdr_tpu_torch.estimate import AutoResolution

ap = argparse.ArgumentParser()
ap.add_argument("source_params", nargs="+")
ap.add_argument("--device", default="cuda")
opts = ap.parse_args()
params = " ".join(opts.source_params[:3])

rx = tsdr.TSDR(device=opts.device)
rx.load_source("rawfile", params)
rx.set_resolution(600, 55.0)  # deliberately wrong initial guess

tracker = AutoResolution(rx._source.samplerate())
found = []


def on_plot(ev):
    est = tracker.feed(ev)
    if est and not found:
        found.append(est)
        mode = est.mode.name if est.mode else "(no VESA match)"
        print(f"detected: {est.refreshrate:.2f} Hz, {est.height} lines -> {mode}")
        # render the winning autocorrelation window as the GUI plot widget
        # would (max-decimation + log-dB + peak label)
        from tempestsdr_tpu_torch.estimate import render_plot, save_plot

        img, info = render_plot(ev.values, offset=ev.offset,
                                samplerate=ev.samplerate, kind="line",
                                frame_lag=est.frame_lag)
        save_plot(img, "autocorr_line.pgm")
        print(f"plot peak: {info['label']} -> autocorr_line.pgm")
        rx.stop()


rx._callbacks.on_plot = on_plot
rx.start(on_frame=lambda f: None, max_blocks=600)

if found:
    est = found[0]
    height, rate = (est.mode.height, est.mode.refreshrate) if est.mode else (
        est.height, est.refreshrate)
    rx.set_resolution(height, rate)
    frames = []
    rx.start(on_frame=frames.append, max_frames=30)
    print(f"streamed {len(frames)} frames at {height} lines @ {rate:g} Hz; "
          f"last frame range [{frames[-1].min():.3f}, {frames[-1].max():.3f}]")
else:
    print("no convergence — capture too short or too noisy")
