"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions;
2. builds every CUDA kernel of the port from tempestsdr_tpu_torch/csrc
   (one nvcc per source, started together) and holds each against its
   plain PyTorch version on the card, at the shapes the streaming step
   gives it at the 64 MS/s and 8 MS/s geometries;
3. times each kernel (CUDA events, L2 flushed before each launch) beside
   its plain version and its memory/compute bound;
4. runs Session.run end to end on a synthetic uint8 source at 64 MS/s
   (K == 1) and 8 MS/s (K == 4) and checks frames, autocorrelation plots
   and that every block launched the kernels;
5. prints a JSON line of per-kernel numbers, then, as the last line,
   {"ok": true, "device": {...}}.

Any failure raises and exits nonzero. Without a CUDA device it exits 2
before printing any result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(2)

from tempestsdr_tpu_torch import kernels  # noqa: E402
from tempestsdr_tpu_torch.config import PipelineConfig  # noqa: E402
from tempestsdr_tpu_torch.kernels import build  # noqa: E402
from tempestsdr_tpu_torch.kernels.strided_resample import (  # noqa: E402
    box_resample_strided_cuda,
    k1_margin,
)
from tempestsdr_tpu_torch.ops.resample import box_resample_strided  # noqa: E402
from tempestsdr_tpu_torch.params import Params  # noqa: E402
from tempestsdr_tpu_torch.sources.base import Source, SourceBlock  # noqa: E402
from tempestsdr_tpu_torch.sources.synthetic import render_test_pattern, synth_iq  # noqa: E402
from tempestsdr_tpu_torch.stream.pipeline import StepControls, make_step  # noqa: E402
from tempestsdr_tpu_torch.stream.session import Session, SessionCallbacks  # noqa: E402
from tempestsdr_tpu_torch.stream.state import init_state  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores, published
K1_TOL = 2e-5  # K1's rel ramp is the TPU kernel's (margin+frac)+s*(2inv-1),
# the plain form's the XLA form's chunk ramp: f32 rounding of the window
# edges differs by ~1e-6 of a sample (4.7e-6 max seen on [0, 1) inputs)
CORR_MIN = 0.9  # first frame vs the box-resampled raster (noise 0.02, u8):
# the first frame is folded before the PLL first moves the rate, so it must
# reproduce the raster (0.94 seen); later frames follow the PLL's walk

GEOMETRIES = {
    # README flagship (bench.py:847) and demo (bench.py:629) geometries
    "64MS/s": PipelineConfig(samplerate=64e6, height=628, refreshrate=60.0,
                             block_samples=786432),
    "8MS/s": PipelineConfig(samplerate=8e6, height=628, refreshrate=60.0,
                            block_samples=450560),
}


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(out)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return out


def k1_inputs(cfg, rng, scale):
    """Three streamed blocks of envelope-like data at one rate scale."""
    n, taps = cfg.block_samples, cfg.resample_taps
    inv = torch.tensor(round(cfg.samples_per_pixel * scale * (1 << 40)), device=DEV)
    blocks = [torch.from_numpy(rng.random(n, dtype=np.float32) * 1.5).to(DEV)
              for _ in range(3)]
    return inv, blocks


def k1_call(fn, cfg, x, phase, inv):
    return fn(x, phase, inv, n_samples=cfg.block_samples, max_pix=cfg.max_block_pixels,
              taps=cfg.resample_taps, inv_nominal=cfg.samples_per_pixel)


def check_k1(cfg):
    """K1 against the plain strided form: n_out and phase exact, pixels
    within K1_TOL, over 3 blocks at rate scales 1, 1.001, 1/1.001."""
    rng = np.random.default_rng(7)
    taps = cfg.resample_taps
    worst = 0.0
    for scale in (1.0, 1.001, 1 / 1.001):
        inv, blocks = k1_inputs(cfg, rng, scale)
        phase = torch.zeros((), dtype=torch.int64, device=DEV)
        tail = torch.zeros(taps, device=DEV)
        for env in blocks:
            x = torch.cat([tail, env])
            a, na, pa = k1_call(box_resample_strided, cfg, x, phase, inv)
            b, nb, pb = k1_call(box_resample_strided_cuda, cfg, x, phase, inv)
            torch.cuda.synchronize()
            assert int(na) == int(nb) and int(pa) == int(pb), (scale, int(na), int(nb))
            err = (a - b).abs().max().item()
            assert err <= K1_TOL, f"K1 differs from its plain version by {err}"
            worst = max(worst, err)
            phase, tail = pa, x[-taps:]
    return worst


def time_launches(fn, reps=30):
    """Median device ms of fn(), L2 flushed (a 256 MB write) before each
    call so inputs come from device memory as in the step. A spin kernel
    ahead of the start event keeps the card busy while the host enqueues
    fn's launches, so host overhead stays out of the time."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device=DEV)
    times = []
    for _ in range(reps + 3):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times[3:]))


def measure_k1(cfg):
    n, mp = cfg.block_samples, cfg.max_block_pixels
    rng = np.random.default_rng(8)
    inv, blocks = k1_inputs(cfg, rng, 1.0)
    x = torch.cat([torch.zeros(cfg.resample_taps, device=DEV), blocks[0]])
    phase = torch.zeros((), dtype=torch.int64, device=DEV)
    ms = time_launches(lambda: k1_call(box_resample_strided_cuda, cfg, x, phase, inv))
    plain_ms = time_launches(lambda: k1_call(box_resample_strided, cfg, x, phase, inv))
    # each input read once, each output written once
    nbytes = (n + cfg.resample_taps) * 4 + mp * 4 + 2 * 8 + 8 + 4
    # the box filter's own work: per pixel, overlap weights (min, max,
    # sub, max) and a multiply-add over the resample_taps samples it spans
    flops = mp * cfg.resample_taps * 6 + mp
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, margin_taps=k1_margin(cfg.samples_per_pixel))


class ReplayU8(Source):
    """Pre-made uint8 IQ blocks of a synthetic emanation (the data is made
    before the timed run; loading it is set-up)."""

    def __init__(self, cfg, raster, n_blocks, noise=0.02, gain=80.0):
        pixclock = raster.shape[0] * raster.shape[1] * cfg.refreshrate
        self.blocks = []
        for b in range(n_blocks):
            f = synth_iq(raster, samplerate=cfg.samplerate, pixelclock=pixclock,
                         n_samples=cfg.block_samples, start_sample=b * cfg.block_samples,
                         noise=noise, seed=b)
            self.blocks.append(np.clip(f * gain + 128.0, 0, 255).astype(np.uint8))
        self.rate = cfg.samplerate

    def init(self, params):
        pass

    def name(self):
        return "replay u8"

    def samplerate(self):
        return self.rate

    def stream(self, block_samples):
        for blk in self.blocks:
            yield SourceBlock(blk, 0)

    def stop(self):
        pass


def expected_frame(cfg, raster):
    """The raster box-sampled onto the pipeline's pixel grid."""
    pixclock = raster.shape[0] * raster.shape[1] * cfg.refreshrate
    p = np.arange(cfg.frame_pixels)
    t = (p + 0.5) / cfg.pixelrate
    disp = np.floor(t * pixclock).astype(np.int64) % raster.size
    return raster.reshape(-1)[disp].reshape(cfg.height, cfg.width)


def warm_up(cfg, raster):
    """A short session that reaches a frame emit and an autocorrelation
    round, so cuFFT plans and the allocator's pools exist before timing."""
    n = -(-cfg.ac_round_samples // cfg.block_samples) + 1
    Session(cfg, Params(), ReplayU8(cfg, raster, n), device=DEV).run(max_blocks=n)


def run_session(name, cfg, n_blocks):
    """One Session.run over n_blocks after a warm-up session. Launch counts
    are zeroed just before the timed run and read just after."""
    raster = render_test_pattern(cfg.height, cfg.width // 2)
    warm_up(cfg, raster)
    src = ReplayU8(cfg, raster, n_blocks)
    frames, plots = [], []
    sess = Session(cfg, Params(), src,
                   SessionCallbacks(on_frame=frames.append, on_plot=plots.append), device=DEV)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sess.run(max_blocks=n_blocks)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels.WRAPPERS}
    assert frames, f"{name}: no frames"
    assert all(np.isfinite(f).all() and f.shape == (cfg.height, cfg.width) for f in frames)
    cc = float(np.corrcoef(frames[0].ravel(), expected_frame(cfg, raster).ravel())[0, 1])
    assert cc > CORR_MIN, f"{name}: frame correlation {cc}"
    assert plots, f"{name}: no autocorrelation plots"
    assert launches["box_resample_strided_cuda"] == n_blocks, launches
    per_block_ms = dt / n_blocks * 1e3
    row = dict(geometry=name, blocks=n_blocks, frames=len(frames), plots=len(plots),
               corr=cc, per_block_ms=per_block_ms,
               msps=cfg.block_samples * n_blocks / dt / 1e6, launches=launches)
    print("e2e " + json.dumps(row))
    return row


def check_against_cpu(cfg, n_blocks=4):
    """The step on the card (K1) against the same step on the CPU (plain
    versions) over the same u8 blocks: pixel counts, emit and round flags,
    the phase and the sync positions exact; frames within 1e-4 (K1 and the
    plain form differ by ~1e-6 in pixels)."""
    raster = render_test_pattern(cfg.height, cfg.width // 2)
    src = ReplayU8(cfg, raster, n_blocks)
    steps = {d: make_step(cfg, Params(), device=d) for d in ("cuda", "cpu")}
    states = {d: init_state(cfg, device=d) for d in steps}
    worst = 0.0
    for b, raw in enumerate(src.blocks):
        outs = {}
        for d, step in steps.items():
            states[d], outs[d] = step(states[d], torch.from_numpy(raw), StepControls())
        g, c = outs["cuda"], outs["cpu"]
        for f in ("n_pixels", "frame_valid", "ac_plot_valid", "sync_dx", "sync_dy", "ac_calls"):
            assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), (b, f)
        assert int(states["cuda"].phase_fix) == int(states["cpu"].phase_fix), b
        worst = max(worst, (g.frame.cpu() - c.frame).abs().max().item())
    assert worst < 1e-4, worst
    return worst


def profile_steady(cfg, n_blocks=6):
    """torch.profiler over steady 64 MS/s blocks: device busy share (sum of
    kernel and copy time over wall time) and the top device consumers."""
    from torch.profiler import ProfilerActivity, profile

    raster = render_test_pattern(cfg.height, cfg.width // 2)
    warm_up(cfg, raster)
    sess = Session(cfg, Params(), ReplayU8(cfg, raster, n_blocks), device=DEV)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.run(max_blocks=n_blocks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    row = dict(blocks=n_blocks, wall_ms_per_block=wall_ms / n_blocks,
               device_ms_per_block=dev_ms / n_blocks, device_busy_share=dev_ms / wall_ms,
               top=[(e.key[:60], e.self_device_time_total / 1e3 / n_blocks, e.count)
                    for e in top])
    print("profile(64MS/s, under the profiler) " + json.dumps(row))


def fetch_cost_us(reps=200):
    """Round trip of the step's one per-block host fetch (5 int64 packed
    and read with .tolist()) on an idle card."""
    vals = [torch.zeros((), dtype=torch.int32, device=DEV) for _ in range(5)]
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.stack([v.to(torch.int64) for v in vals]).tolist()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6


def main():
    smi = card()
    t0 = time.time()
    build.build(["strided_resample"])
    print(f"built kernels in {time.time() - t0:.1f} s")
    print(build.BUILD_LOG.get("strided_resample", "").strip())

    errs = {name: check_k1(cfg) for name, cfg in GEOMETRIES.items()}
    torch.cuda.synchronize()
    print("K1 max_abs_err " + json.dumps(errs))
    perf = {name: measure_k1(cfg) for name, cfg in GEOMETRIES.items()}
    print("K1 timing " + json.dumps(perf))

    main_row = run_session("64MS/s", GEOMETRIES["64MS/s"], 12)
    assert main_row["plots"] >= 2 and main_row["frames"] >= 6, main_row
    k4_row = run_session("8MS/s", GEOMETRIES["8MS/s"], 4)
    assert k4_row["frames"] > k4_row["blocks"], k4_row  # several frames per block
    print(f"step on the card vs on the CPU (8MS/s, 4 blocks): frames max abs diff "
          f"{check_against_cpu(GEOMETRIES['8MS/s']):.3g}")
    profile_steady(GEOMETRIES["64MS/s"])
    print(f"per-block host fetch round trip: {fetch_cost_us():.1f} us")

    p = perf["64MS/s"]
    kern = [dict(
        name="K1 box_resample_strided_cuda", route="cuda",
        source="tempestsdr_tpu_torch/csrc/strided_resample.cu",
        replaces="tempestsdr_tpu/pallas/strided_kernel.py:65",
        launches=main_row["launches"]["box_resample_strided_cuda"],
        max_abs_err=errs["64MS/s"], ms=p["ms"], plain_ms=p["plain_ms"],
        bound_ms=p["bound_ms"], bound_by=p["bound_by"], library_ms=None,
    )]
    print(f"card: {smi}")
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
