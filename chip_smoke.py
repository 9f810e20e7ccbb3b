"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions;
2. builds every CUDA kernel of the port from tempestsdr_tpu_torch/csrc
   (one nvcc per source, started together) and holds each against its
   plain PyTorch version on the card, at the shapes the streaming step
   gives it at the 64 MS/s and 8 MS/s geometries, over three streamed
   blocks at three rates: K1 (strided), K2 and K2' (fused decode + demod +
   resample, uint8 and int8), K3 and K4 (chunked), and K4's window gather
   (exactly);
   every kernel also on an input that starts 4 bytes past a 16-byte
   boundary, on a phase past the block (n_out == 0) and on a phase in the
   tail, where the window staging takes its other branches;
3. times each kernel (CUDA events, L2 flushed before each launch) beside
   its plain version and its memory/compute bound, K2 and K2' in turns;
   also warm (the input just written, as in the step) and as one of eight
   launches in a row; K4 alone, its gather kernel, the gather's plain
   version and the two launches together; and the floors those times are
   read against: an empty launch, and a float4 copy of each kernel's own
   bytes;
4. runs Session.run end to end on a synthetic uint8 source: the default
   path at 64 MS/s (K == 1) and 8 MS/s (K == 4), and resampler="fused",
   "pallas" and "pallas_windows" at 64 MS/s, checking frames,
   autocorrelation plots and one launch of each of the path's kernels per
   block (the gather and K4 for "pallas_windows"); K2'
   streams the same blocks through its function entry. A Session runs its
   blocks as CUDA-graph replays (stream/graph.py), so its launches on the
   card are counted by kernel name under torch.profiler (card_counts):
   a wrapper's own count sees its eager launches and the captures only;
5. cross-checks the card's step against the CPU step at 8 MS/s for six
   configurations, and profiles steady default blocks; then the graph
   step: the eager device step under set_sync_debug_mode("error") (no
   host read), the block runner at batch 1, 4 and 8 against the eager
   device step (every output bit for bit) and the device step on the CPU
   (integers exact, frames within GRAPH_TOL), Session(batch_blocks=1, 4,
   8) at 64 MS/s (frames equal to the eager step's, one packed fetch a
   batch, K1 once a block), timed in turns, its busy share at batch 8, the
   one-block replay floor, the fused, pallas and pallas_windows resamplers
   at batch 4 and 8 MS/s (K == 4) at batch 4 with a drop and a sync shift;
   then the branch nodes (phase 5b): every runner captures each branch of
   the step (the FFT round, each emit slot, the sync-skip shift; per
   channel, or gated on any() over the channels) as CUDA-graph IF nodes,
   so a replay runs only the taken bodies; the block runner at 64 MS/s
   (K = 1, 4, 8, 24 blocks) and 8 MS/s (K = 4, a drop in slot 2, a sync
   shift in slot 0), the channel runner at config 5 (unrolled), batched at
   64 MS/s (C = 4) and make_multi_step's gated form at 8 MS/s (C = 3,
   K == 4), each against the eager select-form step bit for bit in every
   output and state leaf, the FFT kernels once per completed round and the
   post-process once per emitted frame by kernel name against the packed
   flags, with each graph's parent, IF and body nodes, its capture's
   memory, and device ms a block and busy share under the profiler. Every
   run under the profiler in this script (card_counts, profile_trace) is
   held to the eager step: its outputs, or its frames, bit for bit; then
   the post-process kernels (phase 5c, post_process_phase, its "post-process
   kernels" line): csrc/post_process.cu against the plain chain at 628 x
   849 and 628 x 3397, one frame and C = 8, under every flag set (frames
   and carries bit for bit, the SNR within PP_SNR_TOL), a captured call
   against eager calls, ms a post-process in a graph beside the bytes bound
   and the chain, and both benchmark runners' census and untraced replay
   ms with the chain and with the kernels;
6. drives the front door: a uint8 capture written to a temporary file goes
   through tempestsdr_tpu_torch.cli.main (rawfile source, 64 MS/s, frames
   and plots saved, K1 once per block) and through TSDR with
   resampler="fused" (K2 once per block); --auto-resolution --auto-apply
   at 8 MS/s from a wrong height must detect 628 lines at 60 Hz, warm the
   new geometry while streaming, restart and emit frames at the new shape;
7. runs a batch_blocks=4 session against batch_blocks=1 (frames equal),
   live controls from a second thread on a start_async session (set_params,
   nudge_refreshrate, sync_shift, dump_autocorr, stop), and a
   superresolution session (a 16 MS/s native source stitched to the 64 MS/s
   geometry, through K1), with stitch_hops on the card held against the CPU
   and the alignment lags equal;
7d. the intake paths (intake_phase), each held against a run already
   trusted: rawfile captures in int8, int16, uint16 and float32 (and int8
   under resampler="fused") through Session at 64 MS/s against the CPU
   step over the same blocks (integers exact, frames within GRAPH_TOL) and
   the uint8 capture of the same emanation, one graph captured per dtype,
   K1 (K2) once a block by the profiler; the exec source (`cat` of an int8
   capture at 16 MS/s, of a 24-bit one widened to float32 at 8 MS/s) and
   rtltcp at 2.4 MS/s from a paced loopback server, each bit for bit
   rawfile's over the same samples, no drop, the rtl_tcp commands those of
   a CPU run; MultiSession.start_async at config 5 bit for bit the
   foreground run, in turns; TSDR.start(background=True) beside
   warm_resolution(background=True), the restart at the warmed geometry
   capturing no graph (first block beside a cold geometry's), every
   session's frames a foreground run's; examples/torch_*.py with their
   default device against --device cpu. An exception on any worker thread
   fails the run (worker_faults);
8. prints the dispatch floor, what batch_blocks="auto" resolves to, and a
   first block in a fresh process cold and after warm_compile_step
   (`chip_smoke.py --first-block cold|warm`, which it starts itself);
9. runs multi-target on the card at config 5's geometry (8 channels at
   16 MS/s, block 786432, K == 4), every channel step through a
   ChannelRunner graph (one replay a block) unless said: the eager channel
   step for one block under set_sync_debug_mode("error"); the graph (its
   branch nodes' line: census, memory, bodies counted, device operations a
   replay) against the eager step over 6 blocks (a drop on channel 1;
   every output bit for bit); stacked demod against per-channel demod
   (eager, bit for bit); the fused graph (K2 8 times a block) against the
   K1 graph, and each against its eager step; the K1 graph against each
   channel's single-channel step with the plain strided resampler, and at
   8 MS/s with 3 channels against the channel step on the CPU;
   cond_mode="batched" against "unrolled" at the 64 MS/s geometry with 4
   channels (and their censuses); MultiSession over 8 uint8 sources of
   their own line widths for 12 blocks (frames and plots on every channel,
   no two channels alike, first frames against their rasters; ms a block
   and the aggregate MS/s against the 128 MS/s of real time beside the
   select form's), then 4 blocks under the profiler (K1 8 times a block,
   every frame the eager step's, the branch bodies by kernel name); its
   per-block host split of upload and replay, the packed fetch and the
   downloads; its busy share under profile_trace; and a simlive source
   (native ring) through Session; then the sharded receiver on 4 gloo
   ranks sharing the card: K1's range entry against its plain version,
   and the time-sharded step at 64 MS/s (T = 4; default, FIR 31 and
   nearest-neighbour), the 2 x 2 grid and the channel mesh 4 x 2 at config
   5, each rank holding its frames against the single-card reference and
   reporting its eager select-form step and its captured step (stages
   replayed as CUDA graphs between the collectives, the back half's
   branches IF nodes; the channel mesh one ChannelRunner replay a block)
   in turns, every replay bit for bit the eager step, the bodies by
   device counters against the rounds and frames, K1's entries by the
   profiler, each graph's nodes and the capture's memory; the time-sharded
   step also under the post-process orders with autoshift;
9b. what users toggle (phase 11): every post-process order and sync flag
   of the reference's PARAM registry, fast_sync and the plain resampler
   forms (FLAG_SETS, F1-F9) through Session and the block runner at
   64 MS/s, each against the CPU step (integers exact, frames within the
   path's tolerance), its IF-node replays bit for bit the eager step under
   set_sync_debug_mode("error") with the bodies counted, its kernel once a
   block by the profiler and ms a block in turns with Params(); config 5's
   ChannelRunner and MultiSession under three flag sets, and the gated
   channel form at 8 MS/s against the CPU; TSDR.set_param through every
   toggle and back, twice, on the card and on the CPU (frames held, each
   flip's first block and memory, no capture and no growth in the second
   cycle); cli.main under --autoshift --fast-sync --no-pll --motionblur
   0.5 against a hand-built Session; the viewer's s, a, f and o keys
   typed over a pty mid-run;
9c. the live path (phase 12): sources that push on the radio's own clock
   into the native ring, which drops whole pushes when the receiver falls
   behind. The repo's replay plugin (native/replay_plugin.c, a fixture to
   the reference's binary plugin ABI, built with gcc) through cplugin and
   Session at 64 MS/s: drop-free (block=1) in uint8, int16 and float32
   against rawfile over the same capture (frames within 2e-5, carries
   equal); at the radio's rate (pace=1) with the host split; with gaps the
   plugin reports at slots 1, 2 and 3 of a batch of 4; overloaded (pace=0,
   a 20 ms frame handler) at batch 1 and 4, where drops must show; a pace
   sweep (each producer's own rate; the highest pace up to which every
   pace ran with no drop and its producer at its pace, beside pre-made
   float32 blocks); config 5 over 8 plugins through MultiSession at pace 1
   (the first float32 ChannelRunner: its nodes and memory) and a sweep of
   paces, then overloaded (pace 0, drops must show) under the profiler in
   a process of its own (`chip_smoke.py --live-channels-overload`: K1
   once per channel a block); simlive's producer rate and 8 simlive
   channels; TSDR over cplugin with its controls while it streams, and
   cli.main --source cplugin against --source rawfile. Every live run but
   the sweeps' is recorded by a TeeSource and held against the CPU step
   over the recording (integers exact, frames within 1e-4), every gap of a
   replay plugin's recording found in its capture (gaps_in), and every
   live run has a wall-clock limit of its own. `chip_smoke.py
   --profiled-fault` is the test of the open fault of ROADMAP Queue 3:
   this run, then config 5's float32 graph replayed under the profiler;
9d. the downloads into pinned memory (phase 13), at 64 MS/s (Session,
   one 8.5 MB frame) and config 5 (MultiSession, about 49 MB of frames a
   block): every row a session downloads bit for bit the stack's .cpu();
   the frames kept from 4 blocks unchanged after 8 more; the pinned hit
   share over two steady stretches and the pinned host memory held; ms a
   block of the session and of its downloads; one block's download alone,
   consecutive and gathered rows, bit for bit the stack's .cpu();
9e. the uploads through the runners' pinned staging buffers (phase 14,
   pinned_upload_phase, its "pinned uploads" lines): the host copy into a
   pinned buffer by np.copyto against torch's copy_ (and the np.stack it
   replaced), the BlockRunner at K = 1 and 4 at 64 MS/s and config 5's
   ChannelRunner at C = 8 with uint8, int16 and float32 raws against the
   CPU step (integers exact, frames within GRAPH_TOL), none waiting and
   every call staged but K = 1's (a lone row is copied in directly); two
   calls back to back without a fetch, the caller overwriting its blocks
   between them, behind a device sleep so the second waits on the first's
   copies, still the CPU step's; a Session at 64 MS/s at batch 1 and 4
   and a MultiSession at config 5 over steady blocks: no wait, no pinned
   block made by the uploads, staged share 1.0 (0 at batch 1);
10. prints a JSON line of the floors, a JSON line of per-kernel numbers,
   then, as the last line, {"ok": true, "device": {...}}.

Any failure raises and exits nonzero. Without a CUDA device it exits 2
before printing any result.
"""

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(2)

from tempestsdr_tpu_torch import TSDR, cli, kernels, native, superband  # noqa: E402
from tempestsdr_tpu_torch import tui as tui_mod  # noqa: E402
from tempestsdr_tpu_torch.config import PIXEL_SPECIAL_VALUE_G, PipelineConfig  # noqa: E402
from tempestsdr_tpu_torch.kernels import build, graph_cond  # noqa: E402
from tempestsdr_tpu_torch.kernels import post_process as post_process_mod  # noqa: E402
from tempestsdr_tpu_torch.kernels.chunked_resample import (  # noqa: E402
    box_resample_pallas_cuda,
    box_resample_pallas_windows_cuda,
    gather_windows,
    gather_windows_plain,
    k4_window_len,
    windows_resample_launch,
)
from tempestsdr_tpu_torch.kernels.fused_demod_resample import (  # noqa: E402
    fused_demod_resample,
    fused_demod_resample_cuda,
    fused_demod_resample_u16_cuda,
)
from tempestsdr_tpu_torch.kernels.strided_resample import (  # noqa: E402
    box_resample_range_strided_cuda,
    box_resample_strided_cuda,
    k1_margin,
    launch_copy_floor,
    launch_noop,
    range_launch,
)
from tempestsdr_tpu_torch.ops.demod import normalize_iq  # noqa: E402
from tempestsdr_tpu_torch.ops.sync import PLLState, SweetspotState  # noqa: E402
from tempestsdr_tpu_torch.ops.resample import (  # noqa: E402
    box_resample_block_chunked,
    box_resample_range_strided,
    box_resample_strided,
    resample_counts,
)
from tempestsdr_tpu_torch.params import PARAM, Params  # noqa: E402
from tempestsdr_tpu_torch.parallel import (  # noqa: E402
    make_channel_step,
    make_grid_step,
    make_mesh,
    make_time_sharded_step,
    stack_states,
)
from tempestsdr_tpu_torch.parallel.channels import ChannelMeshStep  # noqa: E402
from tempestsdr_tpu_torch.parallel.launch import RankPool  # noqa: E402
from tempestsdr_tpu_torch.sources.base import Source, SourceBlock, load_source  # noqa: E402
from tempestsdr_tpu_torch.sources.synthetic import render_test_pattern, synth_iq  # noqa: E402
from tempestsdr_tpu_torch.sources.tee import RecordedSource, TeeSource, gaps_in  # noqa: E402
from tempestsdr_tpu_torch.stream import MultiSession  # noqa: E402
from tempestsdr_tpu_torch.stream.pipeline import (  # noqa: E402
    ChannelsStep,
    StepControls,
    channel_controls_on,
    make_channels_step_hybrid,
    make_step,
)
from tempestsdr_tpu_torch.stream import pipeline as pipeline_mod  # noqa: E402
from tempestsdr_tpu_torch.stream import session as session_mod  # noqa: E402
from tempestsdr_tpu_torch.stream.session import (  # noqa: E402
    Session,
    SessionCallbacks,
    resolve_batch_blocks,
    warm_compile_step,
)
from tempestsdr_tpu_torch.stream.graph import (  # noqa: E402
    BlockRunner,
    ChannelRunner,
    Stage,
    sync_debug,
)
from tempestsdr_tpu_torch.events import VALUE_ID  # noqa: E402
from tempestsdr_tpu_torch.stream.state import (  # noqa: E402
    StepOutputs,
    StreamState,
    init_state,
    reset_autocorr,
    state_leaves,
)
from tempestsdr_tpu_torch.utils.profiling import (  # noqa: E402
    measure_dispatch_floor,
    measure_replay_floor,
    profile_trace,
)

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores, published
K1_TOL = 2e-5  # K1's rel ramp is the TPU kernel's (margin+frac)+s*(2inv-1),
# the plain form's the XLA form's chunk ramp: f32 rounding of the window
# edges differs by ~1e-6 of a sample (4.7e-6 max seen on [0, 1) inputs).
# K2's pixels are K1's, so the same; its envelope is held exact.
K3_TOL = 3e-4  # K3/K4 against the chunked form (tests/test_pallas.py:99):
# their f32 ramps start at each 256-pixel tile, the chunked form's at each
# 128-pixel chunk's aligned window
STEP_TOL = {  # the card's step against the CPU step, frames max abs diff
    "default": 1e-4, "fused": 1e-4, "nearest_neighbour": 1e-4,  # K1-class pixels
    "pallas": 2e-3, "pallas_windows": 2e-3, "fir31+pallas": 2e-3,  # K3-class pixels;
    # 2e-3 is the JAX package's kernel-vs-XLA step tolerance (tests/test_stream.py:91)
}
STITCH_TOL = 1e-4  # stitch_hops on the card against the CPU, of the peak magnitude:
# complex64 FFTs of 2^21 and 2^23 points, cuFFT against pocketfft
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
# config 5 of the reference bench (bench.py:860-957): 8 independent emitters
# at 16 MS/s, block 786432 (width 849, K == 4 frames a block)
CH5 = PipelineConfig(samplerate=16e6, height=628, refreshrate=60.0, block_samples=786432)
N_CH = 8
CHANNEL_TOL = 1e-4  # hybrid (K1) against the plain per-channel steps, K2's against K1's, and the card's
# hybrid step against the CPU's: frames max abs diff, the K1-class
# card-vs-CPU tolerance (STEP_TOL["default"]): autogain scales K1's 2e-5
# pixel differences by ~1/span


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(out)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return out


def rate_inv(cfg, scale):
    return torch.tensor(round(cfg.samples_per_pixel * scale * (1 << 40)), device=DEV)


def call(fn, cfg, *args):
    return fn(*args, n_samples=cfg.block_samples, max_pix=cfg.max_block_pixels,
              taps=cfg.resample_taps, inv_nominal=cfg.samples_per_pixel)


def raw_block(cfg, rng, dtype=torch.uint8):
    raw = torch.from_numpy(rng.integers(0, 256, size=2 * cfg.block_samples, dtype=np.uint8))
    return raw.view(dtype).to(DEV)


def check_kernels(cfg):
    """Every kernel against its plain version over three streamed blocks at
    rate scales 1, 1.001 and 1/1.001: carries exact; K1 and K2/K2' pixels
    within K1_TOL and K2's envelope exact; K3 and K4 within K3_TOL of the
    chunked form; the gather kernel's windows and fracs exactly its plain
    version's. Each plain version's carries feed the next block.
    Returns the max abs pixel error per kernel."""
    rng = np.random.default_rng(7)
    taps = cfg.resample_taps
    errs = dict.fromkeys(("K1", "K2", "K2'", "K3", "K4", "gather"), 0.0)

    def held(name, got, want, tol):
        (a, na, pa), (b, nb, pb) = got, want
        torch.cuda.synchronize()
        assert int(na) == int(nb) and int(pa) == int(pb), (name, int(na), int(nb))
        err = (a - b).abs().max().item()
        assert err <= tol, f"{name} differs from its plain version by {err}"
        errs[name] = max(errs[name], err)

    for scale in (1.0, 1.001, 1 / 1.001):
        inv = rate_inv(cfg, scale)
        phase = torch.zeros((), dtype=torch.int64, device=DEV)
        tail = torch.zeros(taps, device=DEV)
        for _ in range(3):
            x = torch.cat([tail, torch.from_numpy(rng.random(cfg.block_samples, dtype=np.float32)
                                                  * 1.5).to(DEV)])
            strided = call(box_resample_strided, cfg, x, phase, inv)
            held("K1", call(box_resample_strided_cuda, cfg, x, phase, inv), strided, K1_TOL)
            chunked = call(box_resample_block_chunked, cfg, x, phase, inv)
            held("K3", call(box_resample_pallas_cuda, cfg, x, phase, inv), chunked, K3_TOL)
            held("K4", call(box_resample_pallas_windows_cuda, cfg, x, phase, inv), chunked,
                 K3_TOL)
            del chunked
            held_gather(cfg, x, phase, inv)
            phase, tail = strided[2], x[-taps:]
        for dtype in (torch.uint8, torch.int8):
            phase = torch.zeros((), dtype=torch.int64, device=DEV)
            tail = torch.zeros(taps, device=DEV)
            for _ in range(3):
                raw = raw_block(cfg, rng, dtype)
                env, *plain = call(fused_demod_resample, cfg, raw, tail, phase, inv)
                for name, fn in (("K2", fused_demod_resample_cuda),
                                 ("K2'", fused_demod_resample_u16_cuda)):
                    got_env, *got = call(fn, cfg, raw, tail, phase, inv)
                    held(name, got, plain, K1_TOL)
                    assert torch.equal(got_env, env), f"{name}: envelope not bit-exact"
                phase, tail = plain[2], env[-taps:]
    return errs


def held_gather(cfg, x, phase, inv):
    """The gather kernel's windows and fracs against its plain version's:
    equal, rows of k4_window_len samples."""
    kw = dict(max_pix=cfg.max_block_pixels, taps=cfg.resample_taps,
              inv_nominal=cfg.samples_per_pixel)
    got, want = gather_windows(x, phase, inv, **kw), gather_windows_plain(x, phase, inv, **kw)
    torch.cuda.synchronize()
    assert got[0].shape == (-(-cfg.max_block_pixels // 256),
                            k4_window_len(cfg.samples_per_pixel, cfg.resample_taps))
    assert torch.equal(got[0], want[0]), "gather: windows differ from the plain version's"
    assert torch.equal(got[1], want[1]), "gather: fracs differ from the plain version's"


def check_edges(cfg):
    """Every kernel against its plain version where the window staging
    takes its other branches: an input that starts 4 bytes past a 16-byte
    boundary (a view), a phase past the block (negative numerator:
    n_out == 0 and every pixel 0) and a phase in the tail (the first window
    starts before the input). Carries exact, pixels within K1_TOL and
    K3_TOL, K2's envelope and the gather exact. Returns the max abs pixel
    error per kernel."""
    rng = np.random.default_rng(9)
    n, taps = cfg.block_samples, cfg.resample_taps
    x_pad = torch.cat([torch.zeros(1, device=DEV),
                       torch.from_numpy(rng.random(n + taps, dtype=np.float32) * 1.5).to(DEV)])
    x = x_pad[1:].clone()
    assert x.data_ptr() % 16 == 0 and x_pad[1:].data_ptr() % 16 == 4
    inv = rate_inv(cfg, 1.0)
    raw_pad = torch.from_numpy(rng.integers(0, 256, size=2 * n + 4, dtype=np.uint8)).to(DEV)
    raw = raw_pad[4:].clone()
    assert raw.data_ptr() % 16 == 0 and raw_pad[4:].data_ptr() % 16 == 4
    tail = torch.from_numpy(rng.random(taps, dtype=np.float32) * 1.5).to(DEV)
    errs = dict.fromkeys(("K1", "K2", "K2'", "K3", "K4"), 0.0)

    def held(kid, name, got, want, tol):
        (a, na, pa), (b, nb, pb) = got, want
        torch.cuda.synchronize()
        assert int(na) == int(nb) and int(pa) == int(pb), (kid, name, int(na), int(nb))
        err = (a - b).abs().max().item()
        assert err <= tol, f"{kid} ({name}) differs from its plain version by {err}"
        if name == "negative num":
            assert int(na) == 0 and not a.any(), (kid, name)
        else:
            assert int(na) > 0 and a[:int(na)].any(), (kid, name)
        errs[kid] = max(errs[kid], err)

    for name, (off, ph) in {"unaligned": (True, 0), "negative num": (False, (n + 5) << 40),
                            "phase in the tail": (False, -(1 << 40) - 12345)}.items():
        phase = torch.tensor(ph, dtype=torch.int64, device=DEV)
        xe = x_pad[1:] if off else x
        for kid, fn, plain, tol in (
                ("K1", box_resample_strided_cuda, box_resample_strided, K1_TOL),
                ("K3", box_resample_pallas_cuda, box_resample_block_chunked, K3_TOL),
                ("K4", box_resample_pallas_windows_cuda, box_resample_block_chunked, K3_TOL)):
            held(kid, name, call(fn, cfg, xe, phase, inv), call(plain, cfg, xe, phase, inv), tol)
        held_gather(cfg, xe, phase, inv)
        for dtype in (torch.uint8, torch.int8):
            re = (raw_pad[4:] if off else raw).view(dtype)
            env, *plain = call(fused_demod_resample, cfg, re, tail, phase, inv)
            for kid, fn in (("K2", fused_demod_resample_cuda),
                            ("K2'", fused_demod_resample_u16_cuda)):
                got_env, *got = call(fn, cfg, re, tail, phase, inv)
                held(kid, name, got, plain, K1_TOL)
                assert torch.equal(got_env, env), f"{kid} ({name}): envelope not bit-exact"
    return errs


def time_launches(fn, reps=30, warm_input=None, flush=True):
    """Median device ms of fn(). By default L2 is flushed (a 256 MB write)
    before each call, so inputs come from device memory. With warm_input,
    fn(warm_input()) is timed instead with no flush: its input was written
    just before (by a torch.cat, as the step writes the envelope) and is
    still in L2, which is what the step's launch finds. A spin kernel ahead
    of the start event keeps the card busy while the host enqueues fn's
    launches, so host overhead stays out of the time."""
    flush_buf = (torch.empty(64 << 20, dtype=torch.float32, device=DEV)
                 if flush and warm_input is None else None)
    times = []
    for _ in range(reps + 3):
        args = (warm_input(),) if warm_input else ()
        if flush_buf is not None:
            flush_buf.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn(*args)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times[3:]))


def each_of(fn, k=8, reps=30):
    """Device ms per launch when k launches follow each other between one
    pair of events (inputs warm): the time a launch adds to a stream of
    launches, without the event pair's and the first launch's overhead."""
    def many():
        for _ in range(k):
            fn()

    one = time_launches(fn, reps, flush=False)
    return (time_launches(many, reps, flush=False) - one) / (k - 1)


def copy_floor(n_in, n_out):
    """The float4 copy kernel reading n_in floats and writing n_out floats:
    device ms flushed, warm (the input just written) and as one of eight in
    a row, and the bytes it moves (whole 16-byte pieces)."""
    src, dst = torch.rand(n_in, device=DEV), torch.empty(n_out, device=DEV)
    copy = lambda: launch_copy_floor(src, dst)  # noqa: E731
    return dict(ms=time_launches(copy),
                warm_ms=time_launches(lambda s: launch_copy_floor(s, dst), warm_input=src.clone),
                each_of_8_ms=each_of(copy), bytes=4 * n_in // 16 * 16 + 4 * n_out // 16 * 16)


def measure_floors(cfg):
    """What the kernels' times at this geometry are read against: an empty
    kernel through the same ctypes route (the event pair and a launch), and
    a grid-stride float4 copy kernel that reads and writes each kernel's own
    bytes, flushed, warm and one of eight as the kernels are timed: K1's and
    K3's (4*(n + taps) in, 4*max_pix out), K2's (2n in, 4n + 4*max_pix out),
    K4's (the windows and fracs in, 4*max_pix out) and the gather's
    (4*(n + taps) in, the windows out). The copy computes nothing of any
    kernel's function; it is no library call."""
    n, mp, taps = cfg.block_samples, cfg.max_block_pixels, cfg.resample_taps
    n_tiles, w_in = -(-mp // 256), k4_window_len(cfg.samples_per_pixel, taps)
    noop = lambda: launch_noop(DEV)  # noqa: E731
    k1 = copy_floor(n + taps, mp)
    return dict(
        noop_ms=time_launches(noop), noop_each_of_8_ms=each_of(noop),
        copy_ms=k1["ms"], copy_warm_ms=k1["warm_ms"], copy_each_of_8_ms=k1["each_of_8_ms"],
        copy_bytes=k1["bytes"],
        K2=copy_floor(n // 2, n + mp), K4=copy_floor(n_tiles * w_in + n_tiles, mp),
        gather=copy_floor(n + taps, n_tiles * w_in))


def bound(nbytes, flops):
    """The least time for the work: bytes at the memory rate or f32
    operations at the f32 rate, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bytes=nbytes, flops=flops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def measure_kernels(cfg):
    """Each kernel's device time beside its plain version's and its bound,
    at the step's shapes on one block of this geometry. K2 and K2' are
    timed in turns (K2, K2', K2', K2) for their A/B. Every kernel is also
    timed warm (its input just written: the envelope by a torch.cat, the raw
    block by a copy, K4's windows by the gather kernel) and as one of eight
    launches in a row. Counts per block: each
    input read once, each output written once (carries: 2 int64 in, int32 +
    int64 out); operations: the box filter's per-pixel overlap weights
    (min, max, sub, max) and multiply-add over the resample_taps samples a
    pixel spans, plus a multiply by the rate; the demod's 2 subtractions,
    2 squares, add, sqrt and scale per sample."""
    n, mp, taps = cfg.block_samples, cfg.max_block_pixels, cfg.resample_taps
    rng = np.random.default_rng(8)
    inv = rate_inv(cfg, 1.0)
    phase = torch.zeros((), dtype=torch.int64, device=DEV)
    x = torch.cat([torch.zeros(taps, device=DEV),
                   torch.from_numpy(rng.random(n, dtype=np.float32) * 1.5).to(DEV)])
    raw = raw_block(cfg, rng)
    tail = torch.zeros(taps, device=DEV)
    windows, fracs = gather_windows(x, phase, inv, max_pix=mp, taps=taps,
                                    inv_nominal=cfg.samples_per_pixel)
    carries = 2 * 8 + 4 + 8
    resample_flops = mp * taps * 6 + mp
    out = {}

    k2 = lambda: call(fused_demod_resample_cuda, cfg, raw, tail, phase, inv)  # noqa: E731
    k2p = lambda: call(fused_demod_resample_u16_cuda, cfg, raw, tail, phase, inv)  # noqa: E731
    ab = [time_launches(f) for f in (k2, k2p, k2p, k2)]
    fused_bound = bound(2 * n + 4 * taps + 4 * n + 4 * mp + carries, 7 * n + resample_flops)
    fused_plain = time_launches(lambda: call(fused_demod_resample, cfg, raw, tail, phase, inv))
    for kid, fn, turns in (("K2", fused_demod_resample_cuda, [ab[0], ab[3]]),
                           ("K2'", fused_demod_resample_u16_cuda, [ab[1], ab[2]])):
        out[kid] = dict(
            ms=min(turns), ms_turns=turns,
            ms_warm=time_launches(lambda r, fn=fn: call(fn, cfg, r, tail, phase, inv),
                                  warm_input=raw.clone),
            ms_each_of_8=each_of(lambda fn=fn: call(fn, cfg, raw, tail, phase, inv)),
            plain_ms=fused_plain, **fused_bound)

    resample_bound = bound(4 * (n + taps) + 4 * mp + carries, resample_flops)
    body = x[taps:].clone()
    fresh = lambda: torch.cat([tail, body])  # noqa: E731

    def in_step(fn):  # what a launch in the step pays
        return dict(
            ms_warm=time_launches(lambda xw: call(fn, cfg, xw, phase, inv), warm_input=fresh),
            ms_each_of_8=each_of(lambda: call(fn, cfg, x, phase, inv)))

    out["K1"] = dict(
        ms=time_launches(lambda: call(box_resample_strided_cuda, cfg, x, phase, inv)),
        **in_step(box_resample_strided_cuda),
        plain_ms=time_launches(lambda: call(box_resample_strided, cfg, x, phase, inv)),
        margin_taps=k1_margin(cfg.samples_per_pixel), **resample_bound)
    chunked_plain = time_launches(lambda: call(box_resample_block_chunked, cfg, x, phase, inv),
                                  reps=10)
    out["K3"] = dict(
        ms=time_launches(lambda: call(box_resample_pallas_cuda, cfg, x, phase, inv)),
        **in_step(box_resample_pallas_cuda),
        plain_ms=chunked_plain, **resample_bound)
    gather_kw = dict(max_pix=mp, taps=taps, inv_nominal=cfg.samples_per_pixel)
    k4 = lambda w, f: windows_resample_launch(w, f, phase, inv, n_samples=n,  # noqa: E731
                                              max_pix=mp)
    out["K4"] = dict(
        ms=time_launches(lambda: k4(windows, fracs)),
        ms_warm=time_launches(lambda wf: k4(*wf),
                              warm_input=lambda: gather_windows(x, phase, inv, **gather_kw)),
        ms_each_of_8=each_of(lambda: k4(windows, fracs)),
        wrapper_ms=time_launches(
            lambda: call(box_resample_pallas_windows_cuda, cfg, x, phase, inv)),
        wrapper_plain_gather_ms=time_launches(
            lambda: k4(*gather_windows_plain(x, phase, inv, **gather_kw))),
        plain_ms=chunked_plain, windows_shape=list(windows.shape),
        **bound(4 * windows.numel() + 4 * fracs.numel() + 4 * mp + carries, resample_flops))
    gather = lambda xe: gather_windows(xe, phase, inv, **gather_kw)  # noqa: E731
    out["gather"] = dict(
        ms=time_launches(lambda: gather(x)), ms_warm=time_launches(gather, warm_input=fresh),
        ms_each_of_8=each_of(lambda: gather(x)),
        plain_ms=time_launches(lambda: gather_windows_plain(x, phase, inv, **gather_kw)),
        # per row: an int64 multiply-add, shift, clip and the frac's two f32 operations
        **bound(4 * (n + taps) + 2 * 8 + 4 * windows.numel() + 4 * fracs.numel(),
                6 * fracs.numel()))
    return out


class ReplayU8(Source):
    """Pre-made uint8 IQ blocks of a synthetic emanation (the data is made
    before the timed run; loading it is set-up)."""

    def __init__(self, cfg, raster, n_blocks, noise=0.02, gain=80.0, loop=False):
        self.loop, self.working = loop, True
        pixclock = raster.shape[0] * raster.shape[1] * cfg.refreshrate
        self.blocks = []
        for b in range(n_blocks):
            f = synth_iq(raster, samplerate=cfg.samplerate, pixelclock=pixclock,
                         n_samples=cfg.block_samples, start_sample=b * cfg.block_samples,
                         noise=noise, seed=b)
            self.blocks.append(np.clip(f * gain + 128.0, 0, 255).astype(np.uint8))
        self.rate, self.raster = cfg.samplerate, raster

    def init(self, params):
        pass

    def name(self):
        return "replay u8"

    def samplerate(self):
        return self.rate

    def stream(self, block_samples):
        self.working = True
        while self.working:
            for blk in self.blocks:
                if not self.working:
                    return
                yield SourceBlock(blk, 0)
            if not self.loop:
                return

    def stop(self):
        self.working = False


def expected_frame(cfg, raster):
    """The raster box-sampled onto the pipeline's pixel grid."""
    pixclock = raster.shape[0] * raster.shape[1] * cfg.refreshrate
    p = np.arange(cfg.frame_pixels)
    t = (p + 0.5) / cfg.pixelrate
    disp = np.floor(t * pixclock).astype(np.int64) % raster.size
    return raster.reshape(-1)[disp].reshape(cfg.height, cfg.width)


def warm_up(cfg, raster, params):
    """A short session that reaches a frame emit and an autocorrelation
    round, so cuFFT plans and the allocator's pools exist before timing."""
    n = -(-cfg.ac_round_samples // cfg.block_samples) + 1
    Session(cfg, params, ReplayU8(cfg, raster, n), device=DEV).run(max_blocks=n)


def run_session(name, cfg, n_blocks, params=Params(), kernels_run=("box_resample_strided_cuda",)):
    """Session.run over n_blocks after a warm-up session (which captured the
    session's graph): once timed, then once with its launches on the card
    counted (card_counts; the profiler's own cost makes that run slower):
    each of `kernels_run` must have launched once per block and no other
    kernel at all, and its frames are the eager step's."""
    raster = render_test_pattern(cfg.height, cfg.width // 2)
    warm_up(cfg, raster, params)
    src = ReplayU8(cfg, raster, n_blocks)
    frames, plots = [], []
    sess = Session(cfg, params, src,
                   SessionCallbacks(on_frame=frames.append, on_plot=plots.append), device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.run(max_blocks=n_blocks)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert frames, f"{name}: no frames"
    assert all(np.isfinite(f).all() and f.shape == (cfg.height, cfg.width) for f in frames)
    cc = float(np.corrcoef(frames[0].ravel(), expected_frame(cfg, raster).ravel())[0, 1])
    assert cc > CORR_MIN, f"{name}: frame correlation {cc}"
    assert plots, f"{name}: no autocorrelation plots"
    counted_frames = []
    counted = Session(cfg, params, src, SessionCallbacks(on_frame=counted_frames.append),
                      device=DEV)
    with card_counts() as launches:
        t1 = time.perf_counter()
        counted.run(max_blocks=n_blocks)
        torch.cuda.synchronize()
        dt_counted = time.perf_counter() - t1
    assert launches == {k: n_blocks if k in kernels_run else 0 for k in launches}, (name, launches)
    held_frames(counted_frames, eager_frames(cfg, params, src.blocks), f"{name} under the profiler")
    # the branch nodes' set kernel, in the parent graph: one a branch a block
    # (the sync-skip shift, the round, each emit slot)
    set_launches = launches.named(SET_KERNEL)
    assert set_launches == n_blocks * (2 + cfg.frames_per_block), (name, set_launches)
    row = dict(path=name, resampler=params.resampler, blocks=n_blocks, frames=len(frames),
               plots=len(plots), corr=cc, per_block_ms=dt / n_blocks * 1e3,
               msps=cfg.block_samples * n_blocks / dt / 1e6,
               per_block_ms_under_profiler=dt_counted / n_blocks * 1e3, launches=launches,
               set_kernel=dict(launches=set_launches, ms=launches.ms_each(SET_KERNEL)))
    print("e2e " + json.dumps(row))
    return row


def stream_k2_u16(cfg, n_blocks):
    """K2' through its function entry, the way the TPU package's probe is
    used: n_blocks of the session's uint8 stream, tail and phase carried.
    Counts are zeroed just before and read just after; the envelope and
    pixels are held against K2's on the same blocks."""
    raster = render_test_pattern(cfg.height, cfg.width // 2)
    blocks = [torch.from_numpy(b).to(DEV) for b in ReplayU8(cfg, raster, n_blocks).blocks]
    inv = rate_inv(cfg, 1.0)
    phase = torch.zeros((), dtype=torch.int64, device=DEV)
    tail = torch.zeros(cfg.resample_taps, device=DEV)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs = []
    for raw in blocks:
        env, px, n_out, phase = call(fused_demod_resample_u16_cuda, cfg, raw, tail, phase, inv)
        tail = env[-cfg.resample_taps:]
        outs.append((env, px))
    torch.cuda.synchronize()
    launches = fused_demod_resample_u16_cuda.launches
    assert launches == n_blocks and all(
        fn.launches == 0 for fn in kernels.WRAPPERS if fn is not fused_demod_resample_u16_cuda)
    phase = torch.zeros((), dtype=torch.int64, device=DEV)
    tail = torch.zeros(cfg.resample_taps, device=DEV)
    for raw, (env_u16, px_u16) in zip(blocks, outs):
        env, px, _, phase = call(fused_demod_resample_cuda, cfg, raw, tail, phase, inv)
        assert torch.equal(env, env_u16) and torch.equal(px, px_u16)
        tail = env[-cfg.resample_taps:]
    print(f"K2' streamed {n_blocks} blocks through its function entry: {launches} launches, "
          "envelope and pixels equal to K2's")
    return launches


CPU_CHECKS = {
    "default": Params(),
    "fused": Params(resampler="fused"),
    "pallas": Params(resampler="pallas"),
    "pallas_windows": Params(resampler="pallas_windows"),
    "fir31+pallas": Params(resampler="pallas", fir_lowpass_taps=31),
    "nearest_neighbour": Params(nearest_neighbour=True),
}


def check_against_cpu(cfg, n_blocks=3):
    """The step on the card (kernels) against the same step on the CPU
    (plain versions) over the same u8 blocks, for each CPU_CHECKS
    configuration: pixel counts, emit and round flags, the phase and the
    sync positions exact; frames within STEP_TOL. Returns the worst frame
    difference of each."""
    raster = render_test_pattern(cfg.height, cfg.width // 2)
    src = ReplayU8(cfg, raster, n_blocks)
    worst = {}
    for name, params in CPU_CHECKS.items():
        steps = {d: make_step(cfg, params, device=d) for d in ("cuda", "cpu")}
        states = {d: init_state(cfg, params.fir_lowpass_taps, device=d) for d in steps}
        worst[name] = 0.0
        for b, raw in enumerate(src.blocks):
            outs = {}
            for d, step in steps.items():
                states[d], outs[d] = step(states[d], torch.from_numpy(raw), StepControls())
            g, c = outs["cuda"], outs["cpu"]
            for f in ("n_pixels", "frame_valid", "ac_plot_valid", "sync_dx", "sync_dy",
                      "ac_calls", "pll_locked"):
                assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), (name, b, f)
            assert int(states["cuda"].phase_fix) == int(states["cpu"].phase_fix), (name, b)
            assert int(states["cuda"].fill) == int(states["cpu"].fill), (name, b)
            worst[name] = max(worst[name], (g.frame.cpu() - c.frame).abs().max().item())
        assert worst[name] <= STEP_TOL[name], (name, worst[name])
    return worst


def profile_steady(cfg, n_blocks=6):
    """The port's profile_trace (torch.profiler) over steady 64 MS/s blocks:
    device busy share (sum of kernel and copy time over wall time), the top
    device consumers, and the Chrome trace it writes; the frames the eager
    step's."""
    raster = render_test_pattern(cfg.height, cfg.width // 2)
    warm_up(cfg, raster, Params())
    src, frames = ReplayU8(cfg, raster, n_blocks), []
    sess = Session(cfg, Params(), src, SessionCallbacks(on_frame=frames.append), device=DEV)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        with profile_trace(logdir) as prof:
            t0 = time.perf_counter()
            sess.run(max_blocks=n_blocks)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        (trace,) = os.listdir(logdir)
        trace_bytes = os.path.getsize(os.path.join(logdir, trace))
    held_frames(frames, eager_frames(cfg, Params(), src.blocks), "profiled steady blocks")
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    assert events and trace_bytes > 0, "profile_trace recorded no device activity"
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    row = dict(blocks=n_blocks, trace_bytes=trace_bytes, wall_ms_per_block=wall_ms / n_blocks,
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


def counts():
    return {fn.__name__: fn.launches for fn in kernels.WRAPPERS}


def only(launches, **want):
    """The launch counts are exactly `want` (wrapper name -> count), every
    other kernel 0."""
    assert launches == {k: want.get(k, 0) for k in launches}, (want, launches)


def write_capture(cfg, path, n_blocks):
    """A uint8 capture of the synthetic emanation at cfg's rate: the blocks
    a ReplayU8 would stream, as a raw file for the rawfile source; returns
    the raster and the blocks."""
    raster = render_test_pattern(cfg.height, cfg.width // 2)
    blocks = ReplayU8(cfg, raster, n_blocks).blocks
    np.concatenate(blocks).tofile(path)
    return raster, blocks


def run_cli(argv):
    """cli.main with its log captured; returns (lines without their time
    stamps, wall seconds). The log is printed after the run."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert rc == 0, rc
    lines = buf.getvalue().splitlines()
    for line in lines[:6] + (["  ..."] if len(lines) > 12 else []) + lines[6:][-6:]:
        print("  cli| " + line)
    return [line.split("] ", 1)[-1] for line in lines], dt


def front_door(cfg, tmp, hand_built_ms):
    """Phase 6a: the 64 MS/s capture through the command line (default
    Params: K1) and through TSDR with resampler="fused" (K2), each run's
    frames the eager step's."""
    path = os.path.join(tmp, "capture64.u8")
    raster, capture = write_capture(cfg, path, 12)
    n_frames = 6
    # frame k completes in the block that brings the fold to k frames
    blocks = -(-n_frames * cfg.frame_pixels * cfg.samples_per_pixel // cfg.block_samples)
    out, plots = os.path.join(tmp, "frames"), os.path.join(tmp, "plots")
    with card_counts() as launches:
        log, dt = run_cli([
            "--source", "rawfile", "--source-params", f"{path} {cfg.samplerate} uint8",
            "--block-samples", str(cfg.block_samples), "--height", str(cfg.height),
            "--rate", str(cfg.refreshrate), "--out", out, "--plot-out", plots,
            "--frames", str(n_frames), "--save-every", "2", "--format", "npy"])
    only(launches, box_resample_strided_cuda=int(blocks))
    assert any(line.startswith(f"done: {n_frames} frames") for line in log), log[-3:]
    saved = sorted(os.listdir(out))
    assert saved == [f"frame_{i:06d}.npy" for i in (1, 2, 4, 6)], saved
    want = eager_frames(cfg, Params(), capture)
    for i in (1, 2, 4, 6):  # frame_<i> is the i-th frame
        held_frames([np.load(os.path.join(out, f"frame_{i:06d}.npy"))], want[i - 1:],
                    f"cli frame {i}")
    first = np.load(os.path.join(out, saved[0]))
    assert first.shape == (cfg.height, cfg.width) and np.isfinite(first).all()
    cc = float(np.corrcoef(first.ravel(), expected_frame(cfg, raster).ravel())[0, 1])
    assert cc > CORR_MIN, f"cli: frame correlation {cc}"
    rendered = sorted(os.listdir(plots))
    assert any("autocorr_frame" in f for f in rendered) and any(
        "autocorr_line" in f for f in rendered), rendered
    img = np.load(os.path.join(plots, rendered[0]))
    assert img.shape == (240, 640) and img.max() == 1.0  # the curve, as floats in [0, 1]
    row = dict(path="cli 64MS/s", blocks=int(blocks), frames=n_frames, corr=cc, plots=len(rendered),
               per_block_ms_under_profiler=dt / blocks * 1e3,
               msps_under_profiler=cfg.block_samples * blocks / dt / 1e6,
               hand_built_session_per_block_ms_under_profiler=hand_built_ms)
    print("e2e " + json.dumps(row))

    frames = []
    rx = TSDR(block_samples=cfg.block_samples, device=DEV)
    rx.load_source("rawfile", f"{path} {cfg.samplerate} uint8")
    rx.set_resolution(cfg.height, cfg.refreshrate)
    rx.set_extra_params(resampler="fused")
    with card_counts() as launches:
        t0 = time.perf_counter()
        got = rx.start(on_frame=frames.append, max_blocks=8)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    only(launches, fused_demod_resample_cuda=8)
    rx.close()
    held_frames(frames, eager_frames(cfg, Params(resampler="fused"), capture[:8]), "TSDR fused")
    whole = int(8 * cfg.block_samples // (cfg.frame_pixels * cfg.samples_per_pixel))
    assert got == len(frames) >= whole and all(
        f.shape == (cfg.height, cfg.width) and np.isfinite(f).all() for f in frames)
    cc = float(np.corrcoef(frames[0].ravel(), expected_frame(cfg, raster).ravel())[0, 1])
    assert cc > CORR_MIN, f"TSDR fused: frame correlation {cc}"
    print("e2e " + json.dumps(dict(path="TSDR fused 64MS/s", blocks=8, frames=got, corr=cc,
                                   per_block_ms_under_profiler=dt / 8 * 1e3)))
    return row


def auto_resolution_round_trip(cfg, tmp, wrong_height=525):
    """Phase 6b: --auto-resolution --auto-apply at 8 MS/s from a wrong
    height: the mode detected, the new geometry warmed on its thread while
    the first session streams, the restart, frames at the new shape."""
    path = os.path.join(tmp, "capture8.u8")
    _, capture = write_capture(cfg, path, 24)
    out = os.path.join(tmp, "frames8")
    with card_counts() as launches:
        log, dt = run_cli([
            "--source", "rawfile", "--source-params", f"{path} {cfg.samplerate} uint8",
            "--block-samples", str(cfg.block_samples), "--height", str(wrong_height),
            "--rate", str(cfg.refreshrate), "--blocks", "40", "--out", out, "--save-every",
            "20", "--format", "npy", "--auto-resolution", "--auto-apply"])
    pick = lambda word: [i for i, line in enumerate(log) if line.startswith(word)]  # noqa: E731
    detected, ready, applied = (pick(w) for w in (
        "AUTO-RESOLUTION", "warm start ready", "applying detected mode"))
    assert len(detected) == 1 and len(ready) == 1 and len(applied) == 1, log
    assert detected[0] < ready[0] < applied[0], (detected, ready, applied)
    assert log[applied[0]] == f"applying detected mode: {cfg.height} lines @ {cfg.refreshrate:g} Hz", \
        log[applied[0]]
    assert "60.00 Hz" in log[detected[0]], log[detected[0]]
    key = (cfg, Params(), 1, DEV)
    assert key in session_mod._WARM_STEPS, "the detected geometry was not warmed"
    shapes = [np.load(os.path.join(out, f)).shape for f in sorted(os.listdir(out))]
    old = PipelineConfig(samplerate=cfg.samplerate, height=wrong_height,
                         refreshrate=cfg.refreshrate, block_samples=cfg.block_samples)
    assert shapes[0] == (wrong_height, old.width) and shapes[-1] == (cfg.height, cfg.width), shapes
    # the first session's saved frames (the old geometry, from the capture's
    # first block) are the eager step's; where in the capture the restarted
    # session began is not known here, so its frames are held by shape only
    want = eager_frames(old, Params(), capture)
    for name in sorted(os.listdir(out)):
        got = np.load(os.path.join(out, name))
        if got.shape == (wrong_height, old.width):
            i = int(name[len("frame_"):-len(".npy")])
            held_frames([got], want[i - 1:], f"auto-resolution first session frame {i}")
    # the first session's blocks (until the warm thread stopped it), each
    # runner's warm-up block before its capture (the first session's, the
    # warm start's) and replayed block (the warm start's one), the restarted
    # session's 40
    assert 43 <= launches["box_resample_strided_cuda"] <= 82, launches
    only(launches, box_resample_strided_cuda=launches["box_resample_strided_cuda"])
    print("auto-resolution round trip (8MS/s): " + json.dumps(dict(
        detected=log[detected[0]], applied=log[applied[0]], shapes=shapes,
        k1_launches=launches["box_resample_strided_cuda"], wall_s=dt)))


def batched_session(cfg, n_blocks=12):
    """Phase 7a: batch_blocks=4 against 1 on the same blocks: the same
    kernels in the same order (one graph replay a batch), so the frames are
    equal bit for bit, and the eager step's; K1 once a block on the card
    (profiler count)."""
    raster = render_test_pattern(cfg.height, cfg.width // 2)
    src_blocks = ReplayU8(cfg, raster, n_blocks).blocks
    runs = {}
    for batch in (1, 4, 4, 1):
        src = ReplayU8(cfg, raster, 0)
        src.blocks = src_blocks
        frames = []
        sess = Session(cfg, Params(), src, SessionCallbacks(on_frame=frames.append),
                       batch_blocks=batch, device=DEV)
        warm_compile_step(cfg, Params(), batch_blocks=batch, raw_dtype=np.uint8, device=DEV)
        with card_counts() as launches:
            t0 = time.perf_counter()
            sess.run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / n_blocks * 1e3
        only(launches, box_resample_strided_cuda=n_blocks)
        runs.setdefault(batch, dict(frames=frames, ms=[]))["ms"].append(ms)
    f1, f4 = runs[1]["frames"], runs[4]["frames"]
    assert len(f1) == len(f4) >= n_blocks * cfg.block_samples // (
        cfg.frame_pixels * cfg.samples_per_pixel) - 1
    assert all(np.array_equal(a, b) for a, b in zip(f1, f4)), "batch 4 frames differ from batch 1"
    held_frames(f1, eager_frames(cfg, Params(), src_blocks), "batched session")
    print("batched session (64MS/s, in turns 1, 4, 4, 1, under the profiler): " + json.dumps(
        dict(blocks=n_blocks, frames=len(f1), per_block_ms_batch1=runs[1]["ms"],
             per_block_ms_batch4=runs[4]["ms"], frames_equal=True)))


def live_controls(cfg, tmp):
    """Phase 7b: a start_async session steered from this (a second) thread:
    set_params flip, nudge_refreshrate, sync_shift, dump_autocorr, stop."""
    raster = render_test_pattern(cfg.height, cfg.width // 2)
    frames, plots = [], []
    params = Params(framerate_pll=False)
    sess = Session(cfg, params, ReplayU8(cfg, raster, 12, loop=True),
                   SessionCallbacks(on_frame=frames.append, on_plot=plots.append), device=DEV)

    def wait_for(cond, what):
        deadline = time.time() + 60
        while not cond():
            assert time.time() < deadline and sess.is_running, f"live controls: no {what}"
            time.sleep(0.002)

    sess.start_async()
    assert sess.is_running
    wait_for(lambda: len(frames) >= 2, "frames")
    sess.set_params(params.replace(debug_markers=True))
    rate = sess.nudge_refreshrate(0.01)
    assert abs(rate - (cfg.refreshrate + 0.01)) < 1e-6, rate
    sess.sync_shift(100)
    n_at_flip = len(frames)
    wait_for(lambda: len(frames) >= n_at_flip + 3 and plots, "frames after the flip, or no plots")
    dump = os.path.join(tmp, "autocorr.csv")
    assert sess.dump_autocorr(dump), "dump_autocorr: no round yet"
    off_thread_rate = sess.current_refreshrate()
    sess.stop()
    assert not sess.is_running
    n = len(frames)
    with open(dump) as f:
        rows = f.read().splitlines()
    assert rows[0] == "ms, dB" and len(rows) == cfg.ac_fft_size // 2 + 1, len(rows)
    assert int(sess.state.frame_count) == n, (int(sess.state.frame_count), n)
    assert not (frames[0] == PIXEL_SPECIAL_VALUE_G).any()
    assert (frames[-1] == PIXEL_SPECIAL_VALUE_G).any(), "the marker flip never applied"
    assert abs(sess.current_refreshrate() - (cfg.refreshrate + 0.01)) < 1e-4
    assert abs(off_thread_rate - (cfg.refreshrate + 0.01)) < 1e-4, off_thread_rate
    assert sess.params.debug_markers and sess.meter.total_frames == n
    print("live controls (64MS/s, start_async): " + json.dumps(dict(
        frames=n, plots=len(plots), dump_rows=len(rows) - 1, refreshrate=off_thread_rate,
        meter_msps=sess.meter.samples_per_sec / 1e6)))


def superresolution(cfg, native_rate=16e6):
    """Phase 7c: a native-rate source, Params(superresolution=True), the
    pipeline at cfg (4x the native rate): one stitched cycle through K1,
    its frames the eager step's over the same stitched stream.
    Then stitch_hops on the card against the CPU on shifted, noisy copies of
    a recorded hop: the alignment lags equal, the stitched stream within
    STITCH_TOL of its peak."""
    native = PipelineConfig(samplerate=native_rate, height=cfg.height,
                            refreshrate=cfg.refreshrate, block_samples=cfg.block_samples)
    sb = superband.SuperBandwidth(native_rate, cfg.refreshrate, device=DEV)
    assert sb.output_samplerate == cfg.samplerate
    # one cycle: four gathers and three retune pauses, in native blocks
    need = 4 * sb.samples_to_gather + 3 * (sb.samples_to_pause + cfg.block_samples)
    n_native = -(-need // cfg.block_samples) + 4
    raster = render_test_pattern(cfg.height, cfg.width // 2)
    src = ReplayU8(native, raster, n_native)
    frames = []
    sess = Session(cfg, Params(superresolution=True), src,
                   SessionCallbacks(on_frame=frames.append), device=DEV)
    warm_compile_step(cfg, Params(superresolution=True), raw_dtype=np.float32, device=DEV)
    with card_counts() as launches:
        t0 = time.perf_counter()
        got = sess.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    blocks = sess.meter.total_samples // cfg.block_samples
    # one stitched cycle of 4 * 2^21 samples, in whole blocks
    assert blocks == 4 * sb.n // cfg.block_samples, blocks
    only(launches, box_resample_strided_cuda=blocks)
    assert got == len(frames) >= 6 and all(
        f.shape == (cfg.height, cfg.width) and np.isfinite(f).all() for f in frames)
    assert frames[-1].std() > 0
    held_frames(frames, superres_eager_frames(cfg, native_rate, src.blocks), "superresolution")

    rng = np.random.default_rng(12)
    f = np.concatenate(src.blocks[:-(-sb.n // cfg.block_samples)]).astype(np.float32)[:2 * sb.n]
    hop0 = ((f[0::2] - 128.0) / 128.0 + 1j * (f[1::2] - 128.0) / 128.0).astype(np.complex64)
    shifts = [int(v) for v in rng.integers(1, sb.n, size=3)]
    hops = np.stack([hop0] + [
        (np.roll(hop0, sh) * 0.9 + (rng.standard_normal(sb.n) + 1j * rng.standard_normal(sb.n))
         * 0.005).astype(np.complex64) for sh in shifts])
    lags, lags_cpu = (superband.best_alignment(hops[0], hops[1:], device=d).tolist()
                      for d in (DEV, "cpu"))
    assert lags == lags_cpu == shifts, (lags, lags_cpu, shifts)
    xc = superband._xcorr(*(torch.from_numpy(h).to(DEV) for h in (hops[0], hops[1:])))
    top2 = torch.topk(xc, 2, dim=-1).values
    margin = ((top2[:, 0] - top2[:, 1]) / top2[:, 0]).tolist()
    card_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = superband.stitch_hops(hops, DEV)
        card_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    on_cpu = superband.stitch_hops(hops, "cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    peak = float(np.abs(on_cpu).max())
    err = float(np.abs(on_card - on_cpu).max()) / peak
    assert on_card.shape == (4 * sb.n,) and err <= STITCH_TOL, err
    print("superresolution (16MS/s native -> 64MS/s): " + json.dumps(dict(
        hop_samples=sb.n, native_blocks=n_native, stitched_blocks=int(blocks), frames=got,
        stitch_ms_card=card_ms, stitch_ms_cpu=cpu_ms,
        stitch_rel_err_vs_cpu=err, lags=lags, peak_margin=margin,
        per_stitched_block_ms=dt / blocks * 1e3)))
    return sb.n


def superres_eager_frames(cfg, native_rate, native_blocks):
    """The frames of the eager device step over the stream a
    superresolution Session stitches from the native blocks (its host loop:
    hops gathered by SuperBandwidth, the stitched stream a block at a
    time)."""
    sb = superband.SuperBandwidth(native_rate, cfg.refreshrate, device=DEV)
    step = make_step(cfg, Params(superresolution=True), device=DEV)
    state, n = init_state(cfg, device=DEV), cfg.block_samples
    carry, frames = np.empty(0, np.complex64), []
    for blk in native_blocks:
        f = session_mod._normalize_host(np.asarray(blk))
        out = sb.feed((f[0::2] + 1j * f[1::2]).astype(np.complex64), 0)
        if out is None:
            continue
        carry = np.concatenate([carry, out]) if carry.size else out
        while carry.size >= n:
            one, carry = carry[:n], carry[n:]
            inter = np.empty(2 * n, np.float32)
            inter[0::2], inter[1::2] = one.real, one.imag
            state, o = step(state, torch.from_numpy(inter).to(DEV), StepControls())
            frames += [fr for _, fr in _valid_frames(o)]
    return frames


def first_block(mode):
    """`chip_smoke.py --first-block cold|warm`, in a process of its own:
    the ms from building a default 64 MS/s Session to the end of its first
    block, in a process that has touched the card for nothing else (cold)
    or has run warm_compile_step for that geometry (warm). The kernels'
    library is already built on disk; its build time is printed by the
    parent."""
    cfg = GEOMETRIES["64MS/s"]
    src = ReplayU8(cfg, render_test_pattern(cfg.height, cfg.width // 2), 2)
    warm_ms = None
    if mode == "warm":
        t0 = time.perf_counter()
        warm_compile_step(cfg, Params(), raw_dtype=np.uint8, device=DEV)
        warm_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    sess = Session(cfg, Params(), src, device=DEV)
    sess.run(max_blocks=1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    # the wrapper's count: one eager block before the capture, one captured
    # (which warm_compile_step makes in the warm mode, the session in the cold)
    assert box_resample_strided_cuda.launches == 2
    print(json.dumps(dict(mode=mode, first_block_ms=ms, warm_compile_step_ms=warm_ms)))


def numbers_worth_a_line(build_s):
    """Phase 8: the dispatch floor, what "auto" resolves to, and the first
    block of a fresh process cold and warmed."""
    floor = measure_dispatch_floor(device=DEV)
    auto = {name: resolve_batch_blocks(cfg, "auto", device=DEV) for name, cfg in GEOMETRIES.items()}
    assert all(v >= 1 for v in auto.values())
    first = {}
    for mode in ("cold", "warm", "warm", "cold"):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--first-block", mode],
                             capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, f"--first-block {mode} failed:\n{run.stderr[-2000:]}"
        first.setdefault(mode, []).append(json.loads(run.stdout.strip().splitlines()[-1]))
    print("numbers " + json.dumps(dict(
        dispatch_floor_us=floor * 1e6, auto_batch_blocks=auto, nvcc_build_s=build_s,
        first_block_ms_cold=[r["first_block_ms"] for r in first["cold"]],
        first_block_ms_warm=[r["first_block_ms"] for r in first["warm"]],
        warm_compile_step_ms=[r["warm_compile_step_ms"] for r in first["warm"]])))


def channel_sources(cfg, n_ch, n_blocks):
    """One pre-made uint8 source per channel, each with a raster of its own
    line width (cfg.width // 2 + 8 c, as tests/test_stream.py:435-440 sets
    them), so every channel carries a picture of its own."""
    return [ReplayU8(cfg, render_test_pattern(cfg.height, cfg.width // 2 + 8 * c), n_blocks)
            for c in range(n_ch)]


def channel_blocks(srcs):
    """The sources' blocks stacked per block: [C, 2n] uint8 arrays."""
    return [np.stack(blks) for blks in zip(*(s.blocks for s in srcs))]


CHANNEL_INTS = ("n_pixels", "frame_valid", "ac_plot_valid", "sync_dx", "sync_dy", "ac_calls",
                "pll_locked")
CHANNEL_CARRIES = ("phase_fix", "fill", "skip_pixels", "ac_fill", "frame_count")


class PlainPerChannel:
    """A comparator for the channel steps that shares none of their code:
    the single-channel step with the plain strided resampler, on each
    channel's own state. Called as a channel step is; returns the carries
    and outputs that hold_channels reads, stacked over the channels."""

    def __init__(self, cfg, n_ch, device):
        self.step = make_step(cfg, Params(resampler="strided"), device=device)
        self.states = [init_state(cfg, device=device) for _ in range(n_ch)]

    def __call__(self, _stacked, raws, controls):
        outs = []
        for c, dropped in enumerate(controls.samples_dropped):
            self.states[c], out = self.step(self.states[c], raws[c], StepControls(dropped, 0, 0.0))
            outs.append(out)
        stack = lambda objs, f: torch.stack([getattr(o, f) for o in objs])  # noqa: E731
        return (types.SimpleNamespace(**{f: stack(self.states, f) for f in CHANNEL_CARRIES}),
                types.SimpleNamespace(**{f: stack(outs, f) for f in CHANNEL_INTS + ("frame",)}))


def hold_channels(name, steps, cfg, n_ch, blocks, tol, drop_channel=1, drop=37777,
                  motionblur=0.0):
    """Two channel steps ((step, device) each) over the same blocks, channel
    drop_channel losing `drop` samples before block 1, every channel at
    `motionblur`: every integer output and carry equal, frames finite and
    within tol. Returns the worst frame difference."""
    states = [stack_states(cfg, n_ch, device=d) for _, d in steps]
    worst, emitted = 0.0, 0
    for b, raws in enumerate(blocks):
        dropped = [drop if (c == drop_channel and b == 1) else 0 for c in range(n_ch)]
        outs = []
        for i, (step, d) in enumerate(steps):
            states[i], out = step(states[i], torch.from_numpy(raws).to(d),
                                  StepControls(dropped, 0, motionblur))
            outs.append(out)
        a, c = outs
        assert torch.isfinite(a.frame).all() and torch.isfinite(c.frame).all(), (name, b)
        for f in CHANNEL_INTS:
            assert torch.equal(getattr(a, f).cpu(), getattr(c, f).cpu()), (name, b, f)
        for f in CHANNEL_CARRIES:
            assert torch.equal(getattr(states[0], f).cpu(), getattr(states[1], f).cpu()), \
                (name, b, f)
        emitted += int(a.frame_valid.sum())
        worst = max(worst, (a.frame.cpu() - c.frame.cpu()).abs().max().item())
    assert emitted >= n_ch and worst <= tol, (name, emitted, worst)
    return worst


class RunnerStep:
    """A ChannelRunner called as a channel step is (state, raws, controls)
    -> (state, outputs), for hold_channels: the controls as its [C, 3]
    buffer, the outputs cloned out of the graph's and kept (`calls`, with
    the raws and controls) for replays_held."""

    def __init__(self, runner):
        self.runner = runner
        self.calls = []

    def __call__(self, state, raws, controls):
        n = self.runner.n_blocks
        ctl = np.stack([np.broadcast_to(np.asarray(v, np.float64), (n,)) for v in controls], 1)
        state, out, _ = self.runner.run(state, raws, ctl)
        out = StepOutputs(*(x.clone() for x in out))
        self.calls.append((raws, ctl, out))
        return state, out


def replays_held(rstep, what):
    """Every replay a RunnerStep made, from a fresh state, bit for bit the
    eager step's on the same raws and controls."""
    state = stack_states(rstep.runner.config, rstep.runner.n_blocks, device=DEV)
    for b, (raws, ctl, out) in enumerate(rstep.calls):
        state, want = rstep.runner.step(state, raws, StepControls(*ctl.T))
        same_outputs(out, want, f"{what} block {b}")


def captured(runner, raws):
    """The runner after its first call (the capture, and the eager warm-up
    step before it, whose launches must not count) on a scratch state."""
    runner.run(stack_states(runner.config, runner.n_blocks, device=DEV), raws,
               np.zeros((runner.n_blocks, 3)))
    torch.cuda.synchronize()
    return runner


def device_ops_per_replay(runner, raws, n=2):
    """Device operations (kernels, copies, fills) a replay runs, counted in
    a profiler trace over n replays of one block from a fresh state; each
    replay's outputs held bit for bit to the eager channel step's."""
    state = stack_states(runner.config, runner.n_blocks, device=DEV)
    got = []
    with card_counts() as trace:
        for _ in range(n):
            state, out, _ = runner.run(state, raws, np.zeros((runner.n_blocks, 3)))
            got.append(StepOutputs(*(x.clone() for x in out)))
    state_e = stack_states(runner.config, runner.n_blocks, device=DEV)
    for i, out in enumerate(got):
        state_e, want = runner.step(state_e, raws, StepControls())
        same_outputs(out, want, f"profiled replay {i}")
    return sum(trace.kernels.values()) / n


SELECT_FORM_CONFIG5 = dict(per_block_ms=[65.2, 66.1], aggregate_msps=[96.5, 95.2])  # PERF.md:
# MultiSession through the channel graph's select form (both sides of every branch run) on an
# NVIDIA H100 80GB HBM3 at 700 W


def multisession_run(cfg, srcs, n_blocks, smi):
    """MultiSession.run over n_blocks on the card after a warm-up run (the
    channel graph's capture; a frame and a round on every channel): once
    timed, then over 4 blocks under the profiler (multisession_held)."""
    MultiSession(cfg, Params(), srcs, device=DEV).run(max_blocks=2)
    n_ch = len(srcs)
    first, last, plots = {}, {c: [] for c in range(n_ch)}, [0] * n_ch

    def on_frame(c, f):
        first.setdefault(c, f.copy())
        last[c] = (last[c] + [f])[-1:]

    def on_plot(c, ev):
        plots[c] += 1
        assert ev.values.shape[0] > 0 and np.isfinite(ev.values).all()

    ms = MultiSession(cfg, Params(), srcs, on_frame=on_frame, on_plot=on_plot, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total = ms.run(max_blocks=n_blocks)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    whole = int(n_blocks * cfg.block_samples // (cfg.frame_pixels * cfg.samples_per_pixel))
    assert total == sum(ms.frames_total) and min(ms.frames_total) >= whole, ms.frames_total
    assert min(plots) >= 1, plots
    corr = []
    for c in range(n_ch):
        f = last[c][0]
        assert f.shape == (cfg.height, cfg.width) and np.isfinite(f).all()
        raster = srcs[c].raster
        corr.append(float(np.corrcoef(first[c].ravel(),
                                      expected_frame(cfg, raster).ravel())[0, 1]))
        for c2 in range(c):
            assert np.abs(f - last[c2][0]).max() > 0.05, f"channels {c2} and {c} alike"
    assert min(corr) > CORR_MIN, corr
    held = multisession_held(cfg, srcs)
    return dict(card=smi, blocks=n_blocks, frames=ms.frames_total, plots=plots,
                first_frame_corr=corr, per_block_ms=dt / n_blocks * 1e3,
                aggregate_msps=n_ch * cfg.block_samples * n_blocks / dt / 1e6,
                realtime_msps=n_ch * cfg.samplerate / 1e6, select_form=SELECT_FORM_CONFIG5,
                k1_launches_in_4_blocks=held["k1_launches"], branch_nodes_4_blocks=held)


def multisession_held(cfg, srcs, n_blocks=4, params=Params(), per_body=None):
    """MultiSession over n_blocks under the profiler: K1 once per channel a
    block from inside the graph and no other kernel of the port, every
    channel's frames the eager channel step's bit for bit, and the round and
    emit bodies launched by kernel name beside the eager step's flags on the
    same blocks (reported; phase 5b counts the bodies of this graph's twin
    exactly)."""
    n_ch = len(srcs)
    blocks = channel_blocks(srcs)[:n_blocks]
    eager = make_channels_step_hybrid(cfg, params, n_ch, device=DEV)
    if per_body is None:  # a body's kernels, unless the caller counted them
        per_body = body_kernels(eager, stack_states(cfg, n_ch, device=DEV),
                                torch.from_numpy(blocks[0]).to(DEV))
    want, flags, _ = eager_channel_frames(eager, blocks)
    got = [[] for _ in range(n_ch)]
    counted = MultiSession(cfg, params, srcs, on_frame=lambda c, f: got[c].append(np.array(f)),
                           device=DEV)
    with card_counts() as launches:
        counted.run(max_blocks=n_blocks)
    only(launches, box_resample_strided_cuda=n_ch * n_blocks)
    frames = [held_frames(got[c], want[c], f"MultiSession channel {c}") for c in range(n_ch)]
    return dict(k1_launches=launches["box_resample_strided_cuda"], frames=frames,
                rounds=int(flags.ac_plot_valid.sum()), frames_flagged=int(flags.frame_valid.sum()),
                bodies_by_profiler=profiler_bodies(launches, per_body, flags, False),
                device_ms_per_block_under_profiler=launches.device_ms / n_blocks,
                transfer_ms_per_block_under_profiler=launches.transfer_ms / n_blocks)


def _timed(owner, name, spent):
    """Wrap owner.name so the host seconds spent in it add up in spent[name];
    returns a function that puts the original back."""
    orig = getattr(owner, name)

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return orig(*a, **k)
        finally:
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0

    setattr(owner, name, wrapper)
    return lambda: setattr(owner, name, orig)


def channels_split(cfg, srcs, n_blocks=8):
    """MultiSession.run with the host clock read around the runner's run
    (the staged upload and the replay), the packed fetch (.tolist(), which
    waits for the replay) and the frame and plot downloads, per block; then
    one block's worth of valid frames downloaded alone, on an idle card,
    into pageable memory."""
    got = []
    ms = MultiSession(cfg, Params(), srcs, on_frame=lambda c, f: got.append(1),
                      on_plot=lambda c, ev: None, device=DEV)
    spent = {}
    undo = [_timed(ChannelRunner, "run", spent), _timed(torch.Tensor, "tolist", spent),
            _timed(session_mod, "_download", spent)]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms.run(max_blocks=n_blocks)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        for u in undo[::-1]:
            u()
    names = {"run": "upload + replay", "tolist": "packed fetch (waits for the replay)",
             "_download": "frame and plot downloads"}
    split = {names[k]: v * 1e3 / n_blocks for k, v in spent.items()}
    split["the rest (sources, stacking, callbacks)"] = dt * 1e3 / n_blocks - sum(split.values())
    per_block = round(len(got) / n_blocks)
    stack = torch.zeros((per_block, cfg.height, cfg.width), device=DEV)
    alone = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stack.cpu().numpy()
        alone.append((time.perf_counter() - t0) * 1e3)
    return dict(blocks=n_blocks, ms_per_block=dt * 1e3 / n_blocks, split_ms_per_block=split,
                frames_per_block=len(got) / n_blocks, frames_bytes_per_block=stack.numel() * 4,
                download_alone_ms=alone, download_alone_ms_median=float(np.median(alone)),
                download_share=float(np.median(alone)) / (dt * 1e3 / n_blocks))


def profile_channels(cfg, srcs, n_blocks=4):
    """profile_trace over a MultiSession run: device busy share, device ms
    and device operations per block, the top device consumers; every
    channel's frames the eager channel step's."""
    MultiSession(cfg, Params(), srcs, device=DEV).run(max_blocks=2)
    got = [[] for _ in srcs]
    ms = MultiSession(cfg, Params(), srcs, on_frame=lambda c, f: got[c].append(np.array(f)),
                      device=DEV)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        with profile_trace(logdir) as prof:
            t0 = time.perf_counter()
            ms.run(max_blocks=n_blocks)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    want, *_ = eager_channel_frames(make_channels_step_hybrid(cfg, Params(), len(srcs), device=DEV),
                                   channel_blocks(srcs)[:n_blocks])
    for c in range(len(srcs)):
        held_frames(got[c], want[c], f"MultiSession under profile_trace, channel {c}")
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    assert events, "profile_trace recorded no device activity"
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    return dict(blocks=n_blocks, wall_ms_per_block=wall_ms / n_blocks,
                device_ms_per_block=dev_ms / n_blocks, device_busy_share=dev_ms / wall_ms,
                device_ops_per_block=sum(e.count for e in events) / n_blocks,
                top=[(e.key[:60], e.self_device_time_total / 1e3 / n_blocks, e.count / n_blocks)
                     for e in top])


def simlive_session(cfg, n_blocks=8):
    """A simlive source (a producer thread at real time into the native
    ring) through Session on the card, recorded by a TeeSource: frames, its
    drops counted, and the frames and carries held against the CPU step
    over the recording (held_live)."""
    src = load_source("simlive", f"{cfg.height} {cfg.width // 2} {cfg.refreshrate} "
                                 f"{cfg.samplerate} 0.02 pace=1 ring=8")
    tee = TeeSource(src)
    frames = []
    sess = Session(cfg, Params(), tee, SessionCallbacks(on_frame=frames.append), device=DEV)
    warm_compile_step(cfg, Params(), raw_dtype=src.block_dtype(), device=DEV)
    with live_limit("simlive Session", sess.stop), card_counts() as launches:
        t0 = time.perf_counter()
        sess.run(max_blocks=n_blocks)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    only(launches, box_resample_strided_cuda=n_blocks)
    assert frames and all(f.shape == (cfg.height, cfg.width) and np.isfinite(f).all()
                          for f in frames)
    chunk = max(int(0.06 * cfg.samplerate), 1024)
    assert sess.samples_dropped_total % chunk == 0, sess.samples_dropped_total
    err = held_live(cfg, dict(frames=frames, sess=sess, tee=tee), "simlive Session")
    return dict(blocks=n_blocks, frames=len(frames), samples_dropped=sess.samples_dropped_total,
                per_block_ms=dt / n_blocks * 1e3, max_abs_err_vs_cpu_replay=err,
                k1_launches=launches["box_resample_strided_cuda"])


def channels_phase(smi, cfg=CH5, n_ch=N_CH, n_blocks=12):
    """Phase 9: multi-target on the card at config 5's geometry, every
    channel step through a ChannelRunner graph (one replay a block) unless
    said. Returns K1's and K2's launches on the card (profiler count) on
    its two channel paths."""
    srcs = channel_sources(cfg, n_ch, n_blocks)
    blocks = channel_blocks(srcs)
    raws = [torch.from_numpy(b).to(DEV) for b in blocks]

    def ctl_of(b, drop=37777):  # channel 1 drops before block 1
        ctl = np.zeros((n_ch, 3))
        ctl[1, 0] = drop if b == 1 else 0
        return ctl

    # the eager channel step reads nothing to the host: one block (a drop
    # on channel 1) under set_sync_debug_mode("error"), after a warm-up
    eager = make_channels_step_hybrid(cfg, Params(), n_ch, device=DEV)
    state = stack_states(cfg, n_ch, device=DEV)
    state, _ = eager(state, raws[0], StepControls())  # cuFFT plans, library load
    ctl = channel_controls_on(StepControls(*ctl_of(1).T), n_ch, DEV)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = eager(state, raws[1], ctl)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("channels: the eager channel step ran a block (a drop on channel 1) under "
          "set_sync_debug_mode('error') with no synchronizing call")

    # the graph: its capture's memory and nodes, then 6 blocks counted on
    # the card and held bit for bit against the eager step's
    runner = ChannelRunner(cfg, Params(), n_ch, DEV)
    graph = hold_replays("ChannelRunner config 5 (8x16MS/s, unrolled, one replay a block; a drop "
                         "on channel 1), 6 blocks", runner, raws[:6], [ctl_of(b) for b in range(6)])
    assert graph["bodies"]["frames"] >= 6 * n_ch
    graph["device_ops_per_replay"] = device_ops_per_replay(runner, raws[0])
    print("branch nodes " + json.dumps(dict(card=smi, **graph)))
    del eager

    # stacked demod against per-channel demod, bit for bit
    steps = {m: make_channels_step_hybrid(cfg, Params(), n_ch, demod_mode=m, device=DEV)
             for m in ("per-channel", "stacked")}
    states = {m: stack_states(cfg, n_ch, device=DEV) for m in steps}
    for raw in raws[:4]:
        outs = {}
        for m, step in steps.items():
            states[m], outs[m] = step(states[m], raw, StepControls())
        assert all(torch.equal(a, b) for a, b in zip(outs["per-channel"], outs["stacked"])), \
            "stacked demod differs from per-channel demod"
    assert all(torch.equal(a, b) for a, b in zip(*(state_leaves(s) for s in states.values())))
    del steps, states, outs

    # resampler="fused": K2 once per channel a block from inside its graph,
    # held against the K1 graph (once per channel a block) on the same blocks
    fused = captured(ChannelRunner(cfg, Params(resampler="fused"), n_ch, DEV), raws[0])
    profiled = [RunnerStep(fused), RunnerStep(runner)]
    with card_counts() as k2:
        worst_fused = hold_channels("fused graph (K2) vs K1 graph",
                                    [(rs, DEV) for rs in profiled], cfg, n_ch, blocks[:4],
                                    CHANNEL_TOL)
    only(k2, fused_demod_resample_cuda=n_ch * 4, box_resample_strided_cuda=n_ch * 4)
    for name, rs in zip(("fused graph", "K1 graph"), profiled):
        replays_held(rs, f"profiled {name}")
    del fused, profiled

    worst = hold_channels(
        "K1 graph vs per-channel steps (plain strided)",
        [(RunnerStep(runner), DEV), (PlainPerChannel(cfg, n_ch, DEV), DEV)], cfg, n_ch,
        blocks[:3], CHANNEL_TOL)
    g8 = GEOMETRIES["8MS/s"]
    worst_cpu = hold_channels(
        "channel graph on the card vs the channel step on the CPU (8MS/s, C=3)",
        [(RunnerStep(ChannelRunner(g8, Params(), 3, DEV)), DEV),
         (make_channels_step_hybrid(g8, Params(), 3, device="cpu"), "cpu")],
        g8, 3, channel_blocks(channel_sources(g8, 3, 3)), CHANNEL_TOL)

    # cond_mode="batched" (the bodies once over the channels) against
    # "unrolled" at the 64 MS/s geometry (one frame a block), C = 4
    g64 = GEOMETRIES["64MS/s"]
    b64 = channel_blocks(channel_sources(g64, 4, 6))
    modes = {m: ChannelRunner(g64, Params(), 4, DEV, cond_mode=m) for m in ("batched", "unrolled")}
    worst_modes = hold_channels("batched vs unrolled (64MS/s, C=4)",
                                [(RunnerStep(r), DEV) for r in modes.values()], g64, 4, b64,
                                CHANNEL_TOL)
    b64_0 = torch.from_numpy(b64[0]).to(DEV)
    mode_ops = {m: dict(nodes=r.census(), device_ops_per_replay=device_ops_per_replay(r, b64_0))
                for m, r in modes.items()}
    assert mode_ops["batched"]["nodes"]["all_nodes"] < mode_ops["unrolled"]["nodes"]["all_nodes"], \
        mode_ops
    del modes
    print("channels held: " + json.dumps(dict(
        stacked_demod_bit_identical=True, fused_k2_launches_in_4_blocks=k2[
            "fused_demod_resample_cuda"], fused_vs_k1_max_abs=worst_fused,
        graph_vs_plain_max_abs=worst, card_vs_cpu_max_abs=worst_cpu,
        batched_vs_unrolled_64MS_C4_max_abs=worst_modes, batched_vs_unrolled_ops=mode_ops)))
    del runner

    row = multisession_run(cfg, srcs, n_blocks, smi)
    print("channels MultiSession " + json.dumps(row))
    print("channels split " + json.dumps(channels_split(cfg, srcs)))
    print("profile(8x16MS/s MultiSession, under the profiler) "
          + json.dumps(profile_channels(cfg, srcs)))
    simlive = simlive_session(GEOMETRIES["8MS/s"])
    print("simlive Session (8MS/s, native ring) " + json.dumps(simlive))
    return {"K1": row["k1_launches_in_4_blocks"], "K2": k2["fused_demod_resample_cuda"],
            "simlive": simlive["k1_launches"]}


# ---- phase 10: the sharded receiver over torch.distributed ----------------
# One group of T_RANKS gloo ranks on this one card (RankPool, "spawn"),
# started once for every sharded check. The parent runs each reference (the
# single-card step, the single-process hybrid channels step) on the same
# blocks first and writes its frames to files; each rank holds its replicated
# or local outputs against them and reports integers, errors, a digest of
# everything it returned, its launch counts and its per-block host ms.

T_RANKS = 4
SHARD_TOL = 2e-3  # the sharded step's frames against the single-card step's
# (tests/test_parallel.py:64-66): K1's range entry against its block entry
# differs like K1 against its plain version, scaled by autogain
REF_FIELDS = ("n_pixels", "frame_valid", "ac_calls")
REF_CARRIES = ("phase_fix", "fill", "frame_count")


def _ints(state, out):
    """The integers a sharded run must reproduce exactly, one block."""
    return ([getattr(out, f).tolist() for f in REF_FIELDS]
            + [getattr(state, f).tolist() for f in REF_CARRIES])


def run_reference(step, state, blocks, ref_dir, tag):
    """The reference step over the blocks: its integers per block, and its
    frames (the whole stacked frame output when any slot emits) as
    ref_dir/tag-b.npy."""
    ints = []
    for b, raw in enumerate(blocks):
        state, out = step(state, torch.from_numpy(raw).to(step.device), StepControls())
        ints.append(_ints(state, out))
        if out.frame_valid.any():
            np.save(os.path.join(ref_dir, f"{tag}-{b}.npy"), out.frame.cpu().numpy())
    return ints


def _hold(outs, ref_dir, tag, ref_ints, pick=lambda a: a):
    """A rank's (state ints, outputs) per block against the reference's:
    integers equal (pick selects this rank's part of a stacked reference),
    frames within their tolerance. Returns (integers equal, max abs frame
    difference, frames compared)."""
    worst, frames, same = 0.0, 0, True
    for b, (ints, frame, valid) in enumerate(outs):
        want = [pick(np.asarray(v)).tolist() for v in ref_ints[b]]
        same &= ints == want
        path = os.path.join(ref_dir, f"{tag}-{b}.npy")
        if np.asarray(valid).any():
            ref = pick(np.load(path, mmap_mode="r"))
            mask = np.asarray(valid)
            worst = max(worst, float(np.abs(frame[mask] - ref[mask]).max()))
            frames += int(mask.sum())
    return same, worst, frames


def _digest(arrays):
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _pass(step, state, raws):
    """One pass of a rank's step over its pre-uploaded blocks from `state`:
    per block its integers, read right after the call (a captured step's
    state is the runner's, rewritten by the next call), and its outputs
    (each call's own), host ms per block ending in a synchronize, and the
    final state's leaves (copied)."""
    outs, ints, ms = [], [], []
    torch.cuda.synchronize()
    for raw in raws:
        t0 = time.perf_counter()
        state, out = step(state, raw, StepControls())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        ints.append(_ints(state, out))
        outs.append(out)
    return dict(outs=outs, ints=ints, ms=ms, state=[x.clone() for x in state_leaves(state)])


def _split_pass(step, state, raws):
    """A pass with its host ms a block split (host clock): waiting for the
    card before each exchange (a synchronize: the stage's device work and
    the launches queued ahead of it), the exchanges themselves (gloo's
    copies through host memory and the collective), and the rest (the
    launches or replays, the copies in and out)."""
    spent = dict(wait=0.0, exchange=0.0)
    real = Stage.exchange

    def exchange(self, ctxs, into=False):
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        real(self, ctxs, into)
        spent["wait"] += t1 - t0
        spent["exchange"] += time.perf_counter() - t1

    Stage.exchange = exchange
    try:
        ms = _pass(step, state, raws)["ms"]
    finally:
        Stage.exchange = real
    n = len(raws)
    wait, xch = spent["wait"] * 1e3 / n, spent["exchange"] * 1e3 / n
    return dict(wall=sum(ms) / n, wait_for_card=wait, exchanges=xch,
                rest=sum(ms) / n - wait - xch)


def _equal_passes(a, b):
    """Every output of every block and every final state leaf bit for bit."""
    return (all(torch.equal(x, y) for o, w in zip(a["outs"], b["outs"]) for x, y in zip(o, w))
            and all(torch.equal(x, y) for x, y in zip(a["state"], b["state"])))


def _rank_case(eager, captured, new_state, raws, evaluations, ref_dir, tag, ref_ints, pick):
    """One sharded case on this rank: the captured step's first call (its
    capture, with a device counter in every branch body, counted_bodies)
    and the memory it took; then from fresh states, in turns, the eager
    select-form step, the captured step, the eager step and the captured
    step again (host ms a block each), the later captured pass bit for bit
    the later eager one; then the captured step under the profiler (K1's
    entries by kernel name), bit for bit the eager pass too, with the
    bodies its counters saw held to its completed rounds and emitted
    frames (`evaluations`: each branch's evaluations in the pass). Frames
    held to the reference (integers exact), and a digest of the captured
    pass's outputs and final state."""
    raws = [torch.from_numpy(np.ascontiguousarray(r)).to(DEV) for r in raws]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    with counted_bodies() as counters:
        captured(new_state(), raws[0], StepControls())
    torch.cuda.synchronize()
    memory = dict(after_capture_bytes=torch.cuda.memory_allocated(DEV) - mem0,
                  capture_peak_bytes=torch.cuda.max_memory_allocated(DEV) - mem0)
    passes = {}
    for turn in ("eager 1", "captured 1", "eager 2", "captured 2"):
        step = eager if turn.startswith("eager") else captured
        passes[turn] = _pass(step, new_state(), raws)
    want = passes["eager 2"]
    split = {form: _split_pass(step, new_state(), raws)
             for form, step in (("eager", eager), ("captured", captured))}
    counters.cnt.zero_()
    with card_counts() as trace:
        profiled = _pass(captured, new_state(), raws)
    got = StepOutputs(*(torch.stack(list(v)) for v in zip(*profiled["outs"])))
    gated = isinstance(captured, ChannelMeshStep) and captured.cond_mode == "batched"
    bodies = held_counts(counters, got, gated, evaluations, 0, tag)
    mine = passes["captured 2"]
    outs = [(ints, out.frame.cpu().numpy(), out.frame_valid.cpu().numpy())
            for ints, out in zip(mine["ints"], mine["outs"])]
    same, worst, frames = _hold(outs, ref_dir, tag, ref_ints, pick)
    every = [x.cpu().numpy() for out in mine["outs"] for x in out]
    every += [x.cpu().numpy() for x in mine["state"]]
    n = len(raws)
    return dict(
        ints_equal=same, max_abs=worst, frames=frames,
        replays_equal_eager=_equal_passes(mine, want) and _equal_passes(profiled, want),
        launches={w: trace[w] for w in KERNEL_NAMES}, blocks=n,
        eager_ms=passes["eager 1"]["ms"] + want["ms"],
        captured_ms=passes["captured 1"]["ms"] + mine["ms"],
        split_ms_per_block=split,
        under_profiler=dict(device_ms_per_block=trace.device_ms / n,
                            transfer_ms_per_block=trace.transfer_ms / n,
                            wall_ms_per_block=trace.wall_ms / n,
                            top_kernels_ms_per_block={
                                k[:60]: v / n for k, v in sorted(trace.device_ms_by.items(),
                                                                 key=lambda kv: -kv[1])[:4]}),
        census=_census(captured), memory=memory,
        bodies=dict(rounds=int(got.ac_plot_valid.sum()), frames=int(got.frame_valid.sum()),
                    counted=bodies),
        digest=_digest(every))


def _census(step):
    """The node counts of a captured sharded step (less the body counters'
    nodes, one a body): per stage for a StagedRunner, the one graph of a
    channel step's runner."""
    if isinstance(step, ChannelMeshStep):
        graphs = [step.runner._graphs[torch.uint8]]
        counts = [step.runner.census()]
    else:
        graphs = next(iter(step._staged.values())).graphs
        counts = step.census()
    for g, c in zip(graphs, counts):
        bodies = len(g.branches.bodies) if g.branches is not None else 0
        c.update(body_nodes=c["body_nodes"] - bodies, all_nodes=c["all_nodes"] - bodies)
    return counts


def rank_time_sharded(cfg, params, blocks, ref_dir, tag, ref_ints):
    """One rank of the time-sharded step at T = T_RANKS on this card: its
    eager step (TimeShardedStep) against its captured stages
    (make_time_sharded_step)."""
    mesh = make_mesh(1, T_RANKS, device=DEV)
    step = make_time_sharded_step(cfg, params, mesh)
    S, t = cfg.block_samples // T_RANKS, mesh.time_index
    res = _rank_case(step.program, step,
                     lambda: init_state(cfg, params.fir_lowpass_taps, device=mesh.device),
                     [b[2 * S * t:2 * S * (t + 1)] for b in blocks], (len(blocks), len(blocks)),
                     ref_dir, tag, ref_ints, lambda a: a)
    return dict(device=str(mesh.device), **res)


def rank_grid(cfg, params, per_ch_blocks, ref_dir, ref_ints):
    """One rank of the 2 x 2 grid: its row's channel, time-sharded over the
    row, eager (GridStep) and captured (make_grid_step)."""
    mesh = make_mesh(2, T_RANKS // 2, device=DEV)
    step = make_grid_step(cfg, params, mesh)
    (r, t), S = mesh.coords, cfg.block_samples // (T_RANKS // 2)
    nb = len(per_ch_blocks[r])
    res = _rank_case(step.program, step, lambda: stack_states(cfg, 1, device=mesh.device),
                     [b[None, 2 * S * t:2 * S * (t + 1)] for b in per_ch_blocks[r]], (nb, nb),
                     ref_dir, f"grid{r}", ref_ints[r],
                     lambda a: a[None] if a.ndim in (0, 2) else a)
    return dict(channel=r, **res)


def rank_channels(cfg, params, n_ch, blocks, ref_dir, ref_ints):
    """One rank of the channel mesh (T_RANKS 'ch' rows): its n_ch // T_RANKS
    channels through make_channel_step (one ChannelRunner replay a block),
    against its eager channel step and the single-process hybrid step over
    all n_ch channels."""
    mesh = make_mesh(T_RANKS, 1, device=DEV)
    step = make_channel_step(cfg, params, mesh, n_ch)
    per = n_ch // T_RANKS
    mine = slice(mesh.ch_index * per, (mesh.ch_index + 1) * per)
    nb = len(blocks)
    res = _rank_case(step.step, step, lambda: stack_states(cfg, per, device=mesh.device),
                     [b[mine] for b in blocks], (nb * per, nb * per * cfg.frames_per_block),
                     ref_dir, "channels", ref_ints, lambda a: a[mine])
    return dict(channels=[mine.start, mine.stop], **res)


def check_range_entry(cfg, T=T_RANKS):
    """K1's range entry against box_resample_range_strided on the card, over
    the T shards of one block (x_local and the pixel ranges as
    tests/test_parallel.py:177-191 builds them, the first shard owning a
    pixel that starts in the tail), an empty range and a range past its
    segment, at three phases and rate scales 1 and 1.001^+-1: within K1_TOL,
    exactly 0 past n_valid, one launch per call. Then the time of its launch
    flushed for shard 1 at scale 1 (ms; wrapper_ms adds the wrapper's four
    small torch operations that make the shard's phase and count), beside
    its plain version, its bound and the copy floor of its bytes. Returns
    the row of numbers."""
    n, taps = cfg.block_samples, cfg.resample_taps
    S = n // T
    mpl = int(S * cfg.pixelrate / cfg.samplerate * 1.02) + 2
    rng = np.random.default_rng(31)
    x_full = torch.from_numpy(np.concatenate([
        rng.random(taps + n, dtype=np.float32) * 1.5, np.zeros(taps, np.float32)])).to(DEV)
    kw = dict(max_pix=mpl, taps=taps, inv_nominal=cfg.samples_per_pixel)
    i64 = lambda v: torch.tensor(v, dtype=torch.int64, device=DEV)  # noqa: E731
    worst, calls = 0.0, 0
    kernels.reset_launch_counts()
    for scale in (1.0, 1.001, 1 / 1.001):
        inv = rate_inv(cfg, scale)
        for ph in (0, -(1 << 38), -(1 << 40) - 12345):
            phase = i64(ph)
            n_out = int(resample_counts(phase, inv, n)[0])
            inv_h = int(inv)
            first = lambda s: min(max(-((ph - (s << 40)) // inv_h), 0), n_out)  # noqa: E731
            cases = [(t * S, 0 if t == 0 else first(t * S), first((t + 1) * S)) for t in range(T)]
            cases += [(S, 7, 7), (S, 4 * S + 50, 4 * S + 150)]
            for seg, p0, p1 in cases:
                x_local = x_full[seg:seg + S + 2 * taps].contiguous()
                args = (x_local, phase, inv, i64(p0), i64(p1), seg)
                got = box_resample_range_strided_cuda(*args, **kw)
                want = box_resample_range_strided(*args, **kw)
                calls += 1
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                assert err <= K1_TOL, f"K1 range entry differs from its plain version by {err}"
                assert not got[max(p1 - p0, 0):].any(), "K1 range entry: pixels past n_valid"
                worst = max(worst, err)
    assert box_resample_range_strided_cuda.launches == calls, "K1 range entry launch count"
    only(counts(), box_resample_range_strided_cuda=calls)
    inv = rate_inv(cfg, 1.0)
    phase = i64(-(1 << 38))
    p0 = -((-(1 << 38) - (S << 40)) // int(inv))
    p1 = -((-(1 << 38) - ((2 * S) << 40)) // int(inv))
    args = (x_full[S:2 * S + 2 * taps].contiguous(), phase, inv, i64(p0), i64(p1), S)
    eff, n_valid = phase + i64(p0) * inv - (S << 40), i64(p1 - p0)
    floor = copy_floor(S + 2 * taps, mpl)
    return dict(
        ms=time_launches(lambda: range_launch(args[0], eff, inv, n_valid, **kw)),
        wrapper_ms=time_launches(lambda: box_resample_range_strided_cuda(*args, **kw)),
        plain_ms=time_launches(lambda: box_resample_range_strided(*args, **kw), reps=10),
        copy_floor_ms=floor["ms"], max_abs_err=worst, checked_calls=calls, shard_samples=S,
        max_pix_local=mpl,
        # x_local and the shard's pixels, plus 4 int64 scalars in
        **bound(4 * (S + 2 * taps) + 4 * mpl + 4 * 8, mpl * taps * 6 + mpl))


@contextlib.contextmanager
def pty_terminal(rows=40, cols=120):
    """This process's stdin and stdout on a pty for the enclosed code (the
    viewer's terminal); yields the pty's master (to type keys into) and the
    list of what the viewer has written, drained on a thread."""
    import fcntl
    import pty
    import termios

    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH", rows, cols, 0, 0))
    out, stop = [], threading.Event()

    def drain():  # keep the pty's buffer empty, or the viewer's writes block
        while not stop.is_set():
            try:
                out.append(os.read(master, 1 << 16))
            except OSError:
                return

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    saved = sys.stdin, sys.stdout
    sys.stdin = os.fdopen(slave, "rb", buffering=0, closefd=False)
    sys.stdout = os.fdopen(slave, "w", buffering=1, closefd=False)
    try:
        yield master, out
    finally:
        sys.stdin, sys.stdout = saved
        time.sleep(0.5)
        stop.set()
        os.close(slave)
        reader.join(timeout=10)
        os.close(master)


def tui_over_pty(cfg, n_blocks=3):
    """cli.main([... "--tui" ...]) in this process with a pty as its
    terminal, 8 MS/s on the card: the viewer streams n_blocks (K1 once per
    block on the card, no other kernel; the frames the eager step's over the
    synthetic source's blocks) and writes half-block video and its status
    bar."""
    with pty_terminal() as (_, out):
        t0 = time.perf_counter()
        with card_counts() as launches, session_frames((cfg.height, cfg.width)) as frames:
            rc = cli.main(["--source", "synthetic", "--source-params",
                           f"{cfg.height} {cfg.width // 2} {cfg.refreshrate} {cfg.samplerate} 0.02",
                           "--block-samples", str(cfg.block_samples), "--height", str(cfg.height),
                           "--rate", str(cfg.refreshrate), "--tui", "--blocks", str(n_blocks),
                           "--batch-blocks", "1"])  # "auto" (--tui's default) may round
        # the blocks up to a whole batch; the CPU tests drive the default
        dt = time.perf_counter() - t0
    text = b"".join(out)
    assert rc == 0, rc
    # one more where the session captured its graph in the run (its eager
    # block before the capture)
    k1 = launches["box_resample_strided_cuda"]
    assert n_blocks <= k1 <= n_blocks + 1, launches
    only(launches, box_resample_strided_cuda=k1)
    pixclock = cfg.height * (cfg.width // 2) * cfg.refreshrate
    raster = render_test_pattern(cfg.height, cfg.width // 2)
    synthetic = [synth_iq(raster, samplerate=cfg.samplerate, pixelclock=pixclock,
                          n_samples=cfg.block_samples, start_sample=b * cfg.block_samples,
                          noise=0.02) for b in range(n_blocks)]
    held_frames(frames, eager_frames(cfg, Params(), synthetic), "tui")
    done = [ln for ln in text.decode(errors="replace").splitlines() if "tui done:" in ln]
    assert done and b"\xe2\x96\x80" in text and b"fps" in text, text[-500:]
    return dict(blocks=n_blocks, k1_launches=k1, log=done[-1].split("] ", 1)[-1],
                terminal_bytes=len(text), wall_s=dt)


def sharded_phase(smi):
    """Phase 10; returns K1's launches per rank on each sharded path (the
    captured steps', by kernel name under the profiler) and the range
    entry's row."""
    g64 = GEOMETRIES["64MS/s"]
    rng_row = check_range_entry(g64)
    print("K1 range entry (64MS/s, T=4 shards) " + json.dumps(rng_row))
    rows, by_path = {}, {}
    raster = render_test_pattern(g64.height, g64.width // 2)
    blocks = ReplayU8(g64, raster, 12).blocks
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with RankPool(T_RANKS, init_method=f"file://{os.path.join(tmp, 'rdv')}") as pool:
            pids = pool.run(os.getpid)  # every rank up and in the process group
            print(f"started {T_RANKS} gloo ranks (pids {pids}) in "
                  f"{time.perf_counter() - t0:.1f} s")
            runs = (("time-sharded", Params(framerate_pll=False), 12, 1),
                    ("time-sharded fir31", Params(framerate_pll=False, fir_lowpass_taps=31), 4, 1),
                    ("time-sharded nearest", Params(framerate_pll=False, nearest_neighbour=True),
                     4, 0),
                    # the post-process orders with autoshift: the full _post_process in
                    # each rank's back half
                    ("time-sharded orders", Params(framerate_pll=False, lowpass_before_sync=True,
                                                   autogain_after_proc=True, autoshift=True),
                     4, 1))
            for name, params, nb, per_block in runs:
                ref = run_reference(make_step(g64, params, device=DEV),
                                    init_state(g64, params.fir_lowpass_taps, device=DEV),
                                    blocks[:nb], tmp, name)
                res = pool.run(rank_time_sharded, g64, params, blocks[:nb], tmp, name, ref)
                rows[name] = hold_ranks(name, res, {"box_resample_range_strided_cuda":
                                                    per_block * nb})
            by_path["time-sharded T=4 64MS/s, 12 blocks (range entry, each rank)"] = \
                rows["time-sharded"]["launches"]["box_resample_range_strided_cuda"]
            assert by_path["time-sharded T=4 64MS/s, 12 blocks (range entry, each rank)"] == 12
            by_path["time-sharded orders T=4 64MS/s, 4 blocks (range entry, each rank)"] = \
                rows["time-sharded orders"]["launches"]["box_resample_range_strided_cuda"]

            # the grid: 2 channels of their own raster widths, each over 2 ranks
            srcs = channel_sources(g64, 2, 4)
            per_ch = [s.blocks for s in srcs]
            ref = [run_reference(make_step(g64, Params(framerate_pll=False), device=DEV),
                                 init_state(g64, device=DEV), per_ch[c], tmp, f"grid{c}")
                   for c in range(2)]
            res = pool.run(rank_grid, g64, Params(framerate_pll=False), per_ch, tmp, ref)
            rows["grid"] = hold_ranks("grid", res, {"box_resample_range_strided_cuda": 4},
                                      groups=lambda r: r["channel"])
            by_path["grid 2x2 64MS/s, 4 blocks (range entry, each rank)"] = 4

            # the channel mesh at config 5's geometry: 4 ranks x 2 channels
            srcs = channel_sources(CH5, N_CH, 4)
            cblocks = channel_blocks(srcs)
            ref = run_reference(make_channels_step_hybrid(CH5, Params(), N_CH, device=DEV),
                                stack_states(CH5, N_CH, device=DEV), cblocks, tmp, "channels")
            res = pool.run(rank_channels, CH5, Params(), N_CH, cblocks, tmp, ref)
            rows["channel mesh"] = hold_ranks(
                "channel mesh", res, {"box_resample_strided_cuda": 4 * N_CH // T_RANKS},
                groups=lambda r: tuple(r["channels"]), tol=CHANNEL_TOL)
            by_path["channel mesh 4x2 16MS/s, 4 blocks (block entry, each rank)"] = \
                4 * N_CH // T_RANKS
    for name, row in rows.items():
        print(f"sharded {name} " + json.dumps(dict(card=smi, **row)))
    print(f"sharded, ms a block per rank, eager select form / captured stages in turns "
          f"(parity only: one card shows no speed-up from sharding; host clock; card {smi}): "
          + json.dumps({name: [row["eager_ms_per_block_median"],
                               row["captured_ms_per_block_median"]]
                        for name, row in rows.items()}))
    print("tui over a pty (8MS/s) " + json.dumps(tui_over_pty(GEOMETRIES["8MS/s"])))
    return by_path, rng_row


def hold_ranks(name, res, launches, groups=lambda r: 0, tol=SHARD_TOL):
    """Every rank held: integers equal to the reference's, frames within
    tol, every replay equal to the rank's eager step bit for bit, the
    path's kernel launched exactly `launches` times in each rank's profiled
    captured pass and no other kernel, and ranks that hold the same replica
    (same groups(r)) equal bit for bit. Returns the case's row: per rank
    the eager and captured ms a block (medians of two passes each, in
    turns), launches a block, the census, memory and bodies."""
    for rank, r in enumerate(res):
        assert r["ints_equal"], (name, rank, "integers differ from the reference")
        assert r["frames"] > 0 and r["max_abs"] <= tol, (name, rank, r["frames"], r["max_abs"])
        assert r["replays_equal_eager"], (name, rank, "a replay differs from the eager step")
        assert r["launches"] == {k: launches.get(k, 0) for k in r["launches"]}, \
            (name, rank, r["launches"])
    replicas = {}
    for r in res:
        replicas.setdefault(groups(r), set()).add(r["digest"])
    assert all(len(d) == 1 for d in replicas.values()), (name, "ranks of one replica differ")
    return dict(
        ranks=len(res), frames_each=[r["frames"] for r in res],
        max_abs=max(r["max_abs"] for r in res), replays_equal_eager=True, replicas_equal=True,
        launches={k: v for k, v in res[0]["launches"].items() if v},
        launches_per_block={k: v / res[0]["blocks"] for k, v in res[0]["launches"].items() if v},
        eager_ms_per_block=[float(np.median(r["eager_ms"])) for r in res],
        captured_ms_per_block=[float(np.median(r["captured_ms"])) for r in res],
        eager_ms_per_block_median=float(np.median([m for r in res for m in r["eager_ms"]])),
        captured_ms_per_block_median=float(np.median([m for r in res for m in r["captured_ms"]])),
        split_ms_per_block=[r["split_ms_per_block"] for r in res],
        under_profiler=[r["under_profiler"] for r in res],
        census=[r["census"] for r in res], memory=[r["memory"] for r in res],
        bodies=[r["bodies"] for r in res])


# ---- the graph step --------------------------------------------------------

KERNEL_NAMES = {  # wrapper -> its CUDA kernel's name in a profiler trace
    "box_resample_strided_cuda": "strided_resample_kernel<false>",
    "box_resample_range_strided_cuda": "strided_resample_kernel<true>",
    "fused_demod_resample_cuda": "fused_kernel<2>",
    "fused_demod_resample_u16_cuda": "fused_kernel<1>",
    "box_resample_pallas_cuda": "chunked_resample_kernel",
    "box_resample_pallas_windows_cuda": "windows_resample_kernel",
    "gather_windows": "gather_windows_kernel",
}
GRAPH_TOL = 1e-4  # the card's device step and graphs against the CPU's device step,
# frames max abs diff: STEP_TOL["default"] (K1 against its plain version,
# scaled by autogain)


def is_transfer(name: str) -> bool:
    """A profiler event that copies between the host and the card."""
    return name.startswith(("Memcpy HtoD", "Memcpy DtoH"))


class Trace(dict):
    """card_counts' result: {wrapper name: launches of its kernel on the
    card}, and every device event's count by name (`kernels`), the device
    ms of the traced code (the sum of its events' device time), the part of
    it that copies between the host and the card (transfer_ms) and its wall
    ms (host clock, ending in a synchronize), all under the profiler."""

    def named(self, *words: str) -> int:
        """Launches of the kernels whose name holds one of `words` (any case)."""
        return sum(c for k, c in self.kernels.items() if any(w in k.lower() for w in words))

    def ms_each(self, word: str) -> float:
        """Device ms a launch of the kernels whose name holds `word`."""
        total = sum(v for k, v in self.device_ms_by.items() if word in k.lower())
        return total / self.named(word)


@contextlib.contextmanager
def card_counts():
    """A Trace of the enclosed code, counted by kernel name in a
    torch.profiler trace, so a CUDA-graph replay's launches count (a
    wrapper's own count sees its eager launches and the captures, not the
    replays), the launches inside a replay's IF-node bodies too. Filled in
    on exit."""
    from torch.profiler import ProfilerActivity, profile

    got = Trace()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the trace keeps only device events it times inside its window, so
        # the counted work starts and ends well inside it
        time.sleep(0.05)
        t0 = time.perf_counter()
        yield got
        torch.cuda.synchronize()
        got.wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(0.05)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    got.kernels = {e.key: e.count for e in events}
    got.device_ms_by = {e.key: e.self_device_time_total / 1e3 for e in events}
    got.device_ms = sum(e.self_device_time_total for e in events) / 1e3
    got.transfer_ms = sum(e.self_device_time_total for e in events if is_transfer(e.key)) / 1e3
    for wrapper, name in KERNEL_NAMES.items():
        got[wrapper] = sum(c for k, c in got.kernels.items() if name in k)


def stepped(step, state, raws, controls):
    """The step block by block: its final state and, per field, its outputs
    stacked over the blocks (as a runner stacks them)."""
    outs = []
    for raw, ctl in zip(raws, controls):
        state, out = step(state, raw, StepControls(*ctl))
        outs.append(out)
    return state, StepOutputs(*(torch.stack(list(v)) for v in zip(*outs)))


def eager_outputs(step, state, raws, controls):
    """stepped's outputs."""
    return stepped(step, state, raws, controls)[1]


def batches_of(runner, raws, controls, k):
    """The runner over the blocks in batches of k from a fresh state (after
    one batch on a scratch state, which captures): outputs stacked over
    every block, and the launches on the card of the counted batches."""
    cfg = runner.config
    runner.run(init_state(cfg, runner.params.fir_lowpass_taps, device=DEV),
               torch.stack(raws[:k]), np.zeros((k, 3)))
    state = init_state(cfg, runner.params.fir_lowpass_taps, device=DEV)
    outs = []
    with card_counts() as launches:
        for b in range(0, len(raws), k):
            state, out, _ = runner.run(state, torch.stack(raws[b:b + k]), controls[b:b + k])
            outs.append(StepOutputs(*(x.clone() for x in out)))
    return StepOutputs(*(torch.cat(list(v)) for v in zip(*outs))), launches


def same_outputs(got, want, what):
    for name, a, b in zip(StepOutputs._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (what, name)


def _valid_frames(out, lead=()):
    """The valid frames of one block's outputs, as numpy arrays in slot
    order (per leading index, e.g. per channel, when lead is given)."""
    valid = out.frame_valid.reshape(*lead, -1)
    stack = out.frame.reshape(*valid.shape, *out.frame.shape[-2:])
    return [(tuple(ix[:-1]), stack[tuple(ix)].cpu().numpy()) for ix in valid.nonzero().tolist()]


def eager_frames(cfg, params, blocks):
    """The frames the eager device step (the select form: both sides of
    every branch) emits over the blocks with no control, as numpy arrays in
    stream order: what a profiled run's frames are held to, bit for bit."""
    step = make_step(cfg, params, device=DEV)
    state = init_state(cfg, params.fir_lowpass_taps, device=DEV)
    frames = []
    for raw in blocks:
        state, out = step(state, torch.as_tensor(np.asarray(raw)).to(DEV), StepControls())
        frames += [f for _, f in _valid_frames(out)]
    return frames


def eager_channel_frames(step, blocks, drops=None):
    """Per channel, the frames the eager channel step emits over the blocks
    ([C, 2n] each) on its device, each block with its channels' drops
    (drops[b], C counts; none without), its outputs stacked over the blocks,
    and its final state."""
    n_ch = step.n_channels
    state = stack_states(step.config, n_ch, step.params.fir_lowpass_taps, device=step.device)
    per, outs = [[] for _ in range(n_ch)], []
    for b, raws in enumerate(blocks):
        controls = StepControls() if drops is None else StepControls(list(drops[b]), 0, 0.0)
        state, out = step(state, torch.as_tensor(np.asarray(raws)).to(step.device), controls)
        for (c,), f in _valid_frames(out, (n_ch,)):
            per[c].append(f)
        outs.append(out)
    return per, StepOutputs(*(torch.stack(list(v)) for v in zip(*outs))), state


def held_frames(got, want, what):
    """A profiled run's frames against the eager step's: as many as the run
    emitted (it may stop first), each equal bit for bit, so a launch missing
    from a replay shows as a wrong frame. Returns the count."""
    assert 0 < len(got) <= len(want), (what, len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and np.array_equal(a, b), (what, i)
    return len(got)


@contextlib.contextmanager
def session_frames(shape):
    """The frames of `shape` every Session downloads in the enclosed code
    (wrapping its one download of a batch's valid frames), in order."""
    got, real = [], session_mod._download

    def download(stack, rows):
        arrays = real(stack, rows)
        got.extend(a.copy() for a in arrays if a.shape == shape)
        return arrays

    session_mod._download = download
    try:
        yield got
    finally:
        session_mod._download = real


def cpu_outputs(cfg, raws, controls):
    """The device step on the CPU over the same blocks (the plain versions
    of the kernels), stacked as eager_outputs stacks them."""
    return eager_outputs(make_step(cfg, Params(), device="cpu"), init_state(cfg, device="cpu"),
                         [r.cpu() for r in raws], controls)


def held_to_cpu(got, want, what, tol=GRAPH_TOL):
    """Integer outputs equal, frames within tol; returns the worst frame
    difference."""
    for f in CHANNEL_INTS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), (what, f)
    err = (got.frame.cpu() - want.frame).abs().max().item()
    assert err <= tol, (what, err)
    return err


def graph_session(cfg, params, blocks, batch, count=False, spent=None):
    """Session.run(batch_blocks=batch) over the blocks, the runner warmed
    first (warm_compile_step): (frames, seconds, packed fetches, launches
    on the card or None). With a dict `spent`, the host seconds of the run
    in the runner's run, the fetch and the downloads add up in it."""
    warm_compile_step(cfg, params, batch_blocks=batch, raw_dtype=np.uint8, device=DEV)
    src = ReplayU8(cfg, render_test_pattern(cfg.height, cfg.width // 2), 0)
    src.blocks = blocks
    frames = []
    sess = Session(cfg, params, src, SessionCallbacks(on_frame=frames.append),
                   batch_blocks=batch, device=DEV)
    fetches = []
    undo = [] if spent is None else [
        _timed(BlockRunner, "run", spent), _timed(torch.Tensor, "tolist", spent),
        _timed(session_mod, "_download", spent)]
    real = torch.Tensor.tolist
    torch.Tensor.tolist = lambda self: (fetches.append(1), real(self))[1]
    try:
        torch.cuda.synchronize()
        with (card_counts() if count else contextlib.nullcontext({})) as launches:
            t0 = time.perf_counter()
            sess.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    finally:
        torch.Tensor.tolist = real
        for u in undo[::-1]:
            u()
    return frames, dt, len(fetches), (launches if count else None)


def graph_step_phase(cfg, smi, n_blocks=24):
    """The device step and its graph runner on the card, at 64 MS/s with
    default Params unless said: the eager device step under
    set_sync_debug_mode("error"); the runner at batch 1, 4 and 8 against
    the eager device step (every output bit for bit) and the device step on
    the CPU (integers exact, frames within GRAPH_TOL); Session(batch_blocks=K)
    for K in 1, 4, 8 (frames equal to the eager step's, one packed fetch a
    batch, K1 once a block by profiler count), timed in turns; the busy
    share at batch 8 under profile_trace; the one-block replay floor; the
    fused, pallas and pallas_windows resamplers at batch 4 (bit for bit,
    each kernel once a block); and 8 MS/s (K == 4) at batch 4 with a drop in
    slot 2 and a sync shift in slot 0. Returns K1's and K2's launches per
    graph path."""
    raster = render_test_pattern(cfg.height, cfg.width // 2)
    blocks = ReplayU8(cfg, raster, n_blocks).blocks
    raws = [torch.from_numpy(b).to(DEV) for b in blocks]
    zero = [(0, 0, 0.0)] * n_blocks
    step = make_step(cfg, Params(), device=DEV)
    state = init_state(cfg, device=DEV)
    state, _ = step(state, raws[0], StepControls())  # cuFFT plan, library load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b, ctl in enumerate([(0, 0, 0.2), (0, 321, 0.2), (4000, 0, 0.2), (0, 0, 0.2)]):
            state, _ = step(state, raws[b], StepControls(*ctl))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("graph step: the eager device step ran 4 blocks under set_sync_debug_mode('error') "
          "with no synchronizing call")

    eager = eager_outputs(step, init_state(cfg, device=DEV), raws, zero)
    cpu = cpu_outputs(cfg, raws, zero)
    worst = held_to_cpu(eager, cpu, "eager device step")
    frames_eager = [eager.frame[b].cpu().numpy() for b in range(n_blocks) if eager.frame_valid[b]]
    by_path = {}
    rows = {}
    for k in (1, 4, 8):
        got, launches = batches_of(BlockRunner(cfg, Params(), k, DEV), raws, zero, k)
        same_outputs(got, eager, f"runner batch {k}")
        worst = max(worst, held_to_cpu(got, cpu, f"runner batch {k}"))
        only(launches, box_resample_strided_cuda=n_blocks)
        frames, _, fetches, launches = graph_session(cfg, Params(), blocks, k, count=True)
        only(launches, box_resample_strided_cuda=n_blocks)
        assert fetches == n_blocks // k, (k, fetches)
        assert len(frames) == len(frames_eager) and all(
            np.array_equal(a, b) for a, b in zip(frames, frames_eager)), f"Session batch {k}"
        by_path[f"graph Session batch {k} 64MS/s, {n_blocks} blocks"] = launches[
            "box_resample_strided_cuda"]
        rows[k] = []
    block_s = cfg.block_samples / cfg.samplerate
    for k in (1, 4, 8, 8, 4, 1):
        _, dt, _, _ = graph_session(cfg, Params(), blocks, k)
        rows[k].append(dt / n_blocks * 1e3)
    timing = {f"batch {k}": dict(per_block_ms=ms, msps=[cfg.block_samples / m / 1e3 for m in ms],
                                 x_realtime=[block_s * 1e3 / m for m in ms])
              for k, ms in rows.items()}
    for k in (1, 8):  # where a block's host time goes, by batch size
        spent = {}
        _, dt, _, _ = graph_session(cfg, Params(), blocks, k, spent=spent)
        split = {("upload + replay" if name == "run" else "fetch (waits for the replay)"
                  if name == "tolist" else "frame and plot downloads"): v * 1e3 / n_blocks
                 for name, v in spent.items()}
        split["the rest (source, stacking, callbacks)"] = dt * 1e3 / n_blocks - sum(split.values())
        timing[f"batch {k}"]["split_ms_per_block"] = split
    warm_compile_step(cfg, Params(), batch_blocks=8, raw_dtype=np.uint8, device=DEV)
    src = ReplayU8(cfg, raster, 0)
    src.blocks = blocks
    busy_frames = []
    sess = Session(cfg, Params(), src, SessionCallbacks(on_frame=busy_frames.append),
                   batch_blocks=8, device=DEV)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as logdir:
        with profile_trace(logdir) as prof:
            t0 = time.perf_counter()
            sess.run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    held_frames(busy_frames, frames_eager, "Session batch 8 under profile_trace")
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    busy = dict(wall_ms_per_block=wall_ms / n_blocks, device_ms_per_block=dev_ms / n_blocks,
                device_busy_share=dev_ms / wall_ms,
                device_ops_per_block=sum(e.count for e in events) / n_blocks)
    floors = dict(dispatch_floor_us=measure_dispatch_floor(device=DEV) * 1e6,
                  one_block_replay_and_fetch_us=[
                      measure_replay_floor(cfg, device=DEV) * 1e6 for _ in range(2)])
    print("graph step (64MS/s, default Params, Session timed in turns 1, 4, 8, 8, 4, 1, then "
          "split at 1 and 8) "
          + json.dumps(dict(card=smi, blocks=n_blocks, timing=timing,
                            busy_under_profile_trace_batch8=busy, floors=floors,
                            worst_frame_diff_vs_cpu=worst)))

    k2 = {}
    for resampler, names in (("fused", ("fused_demod_resample_cuda",)),
                             ("pallas", ("box_resample_pallas_cuda",)),
                             ("pallas_windows", ("box_resample_pallas_windows_cuda",
                                                 "gather_windows"))):
        params = Params(resampler=resampler)
        want = eager_outputs(make_step(cfg, params, device=DEV), init_state(cfg, device=DEV),
                             raws[:8], zero[:8])
        got, launches = batches_of(BlockRunner(cfg, params, 4, DEV), raws[:8], zero[:8], 4)
        same_outputs(got, want, f"runner batch 4 {resampler}")
        only(launches, **{name: 8 for name in names})
        k2[resampler] = launches[names[0]]

    g8 = GEOMETRIES["8MS/s"]
    assert g8.frames_per_block == 4
    blocks8 = [torch.from_numpy(b).to(DEV)
               for b in ReplayU8(g8, render_test_pattern(g8.height, g8.width // 2), 8).blocks]
    # the session's contract: the drop in its own slot, the sync shift in slot 0
    ctl8 = [(0, 1234, 0.3), (0, 0, 0.3), (37777, 0, 0.3)] + [(0, 0, 0.3)] * 5
    want = eager_outputs(make_step(g8, Params(), device=DEV), init_state(g8, device=DEV),
                         blocks8, ctl8)
    cpu8 = cpu_outputs(g8, blocks8, ctl8)
    got, launches = batches_of(BlockRunner(g8, Params(), 4, DEV), blocks8,
                               np.array(ctl8, np.float64), 4)
    same_outputs(got, want, "runner batch 4 8MS/s")
    err8 = held_to_cpu(got, cpu8, "runner batch 4 8MS/s")
    only(launches, box_resample_strided_cuda=8)
    assert int(got.frame_valid.sum()) > 8 and int(got.n_pixels[2]) < int(got.n_pixels[1])
    print("graph step (fused/pallas/pallas_windows at batch 4, 8 blocks; 8MS/s K == 4 at "
          "batch 4 with a drop in slot 2 and a sync shift in slot 0) " + json.dumps(dict(
              card=smi, launches=k2, frames_8MS=int(got.frame_valid.sum()),
              worst_frame_diff_vs_cpu_8MS=err8)))
    return by_path, {"graph runner batch 4 fused 64MS/s, 8 blocks": k2["fused"]}


# ---- phase 5b: the branches as CUDA-graph IF nodes ---------------------------
# Every runner captures each branch of the step (pipeline._cond: the FFT
# round, each emit slot, the sync-skip shift; per channel, or gated on any()
# over the channels) as IF nodes, so a replay runs only the taken bodies.
# Each runner is held bit for bit to the eager step, which runs the select
# form (every body every block). The bodies a replay ran are counted two
# ways against the rounds and frames its packed flags report: by device
# counters captured into each body (exact; the checked count), and by
# kernel name under the profiler (reported: in a graph of many IF nodes the
# profiler has named some body kernels wrongly, e.g. 36 or 14 cuFFT kernels
# where 20 ran, with the outputs bit for bit the eager step's).

SET_KERNEL = "set_conditional_kernel"  # csrc/graph_cond.cu: sets a branch's IF-node conditions
ROUND_KERNEL = "fft"  # names (any case) of cuFFT's kernels, which only the FFT round runs
POST_KERNELS = ("scan", "post_process_search")  # of the kernels only the post-process
# runs: the plain chain's sweet-spot cumulative sums (the orders and fast_sync),
# or csrc/post_process.cu's search kernel (the default order, once a post-process)


class MultiStepRunner(ChannelRunner):
    """The channel runner over make_multi_step's form: the bodies once over
    the channels behind a gate on any(), at any frames a block."""

    def __init__(self, config, params, n_channels, device):
        super().__init__(config, params, n_channels, device, cond_mode="batched")

    def _make_step(self, device):
        return ChannelsStep(self.config, self.params, self.n_blocks, device, cond_mode="batched")


def body_kernels(step, state, raw):
    """ROUND_KERNEL launches per round body and POST_KERNELS launches per
    emit body: one eager block of the step (the select form, which runs
    every body once a block: per channel in the unrolled channel step, once
    over the channels in the batched one) under the profiler."""
    k = step.config.frames_per_block
    per_channel = isinstance(step, ChannelsStep) and step.cond_mode == "unrolled"
    c = raw.shape[0] if per_channel else 1
    with card_counts() as trace:
        step(state, raw, StepControls())
    per = (trace.named(ROUND_KERNEL) / c, trace.named(*POST_KERNELS) / (c * k))
    assert all(float(v).is_integer() for v in per) and per[1] > 0, per
    assert (per[0] > 0) == step.run_autocorr, per  # no round with the plots off
    return int(per[0]), int(per[1])


def taken_bodies(out, gated):
    """(round bodies, emit bodies) a run of the node form takes, from its
    packed flags (out stacked over the blocks): one round body per
    completed round and one emit body per emitted frame, or, gated (the
    batched channel forms), one a block in which any channel completed a
    round and one per emit slot that any channel filled."""
    rv, fv = out.ac_plot_valid, out.frame_valid
    if gated:
        return int(rv.any(dim=1).sum()), int(fv.any(dim=1).sum())
    return int(rv.sum()), int(fv.sum())


def profiler_bodies(trace, per_body, out, gated):
    """The round and emit bodies a run launched by kernel name under the
    profiler (ROUND_KERNEL and POST_KERNELS launches over the launches of one
    body), beside what its packed flags say it took; reported, not held
    (see the section's comment)."""
    rounds, emits = taken_bodies(out, gated)
    got = (trace.named(ROUND_KERNEL), trace.named(*POST_KERNELS))
    return dict(fft_kernels=got[0], post_process_kernels=got[1],
                per_round_body=per_body[0], per_emit_body=per_body[1],
                agree=got == (per_body[0] * rounds, per_body[1] * emits))


def _site(fn) -> str:
    """A branch's name: its taken body's (any:<name> for a gated one)."""
    if isinstance(fn, functools.partial):
        if fn.func is pipeline_mod._both:
            return "any:" + _site(fn.args[1])
        return _site(fn.func)
    return fn.__name__


@contextlib.contextmanager
def counted_bodies(slots=16):
    """While a runner captures in the enclosed code, each of its IF-node
    bodies first adds one to a device counter of its own branch and side
    (one small kernel more in the body; the counters live outside the
    graph, and every replay writes them, so the caller keeps them as long
    as the graph), so what a replay ran is read from the counters after it.
    Yields the counters (`cnt`) and their slots by name (`index`: a
    branch's name for its taken side, <name>:else for the other)."""
    got = types.SimpleNamespace(cnt=torch.zeros(slots, dtype=torch.int64, device=DEV), index={})
    real = graph_cond.Branches.if_else

    def counted(fn, name):
        i = got.index.setdefault(name, len(got.index))

        def body(*ops):
            got.cnt[i].add_(1)
            return fn(*ops)

        return body

    def if_else(self, pred, true_fn, false_fn, operands):
        site = _site(true_fn)
        return real(self, pred, counted(true_fn, site),
                    None if false_fn is None else counted(false_fn, site + ":else"), operands)

    graph_cond.Branches.if_else = if_else
    try:
        yield got
    finally:
        graph_cond.Branches.if_else = real


def held_counts(got, out, gated, evaluations, shifts, what, rounds_run=True):
    """The bodies the counters saw, against the packed flags: every round
    and emit branch evaluated (`evaluations`: (round, emit) evaluations in
    the run) took its taken side as often as the flags say and its other
    side every other time; the sync-skip shift ran `shifts` times. Without
    rounds_run (the plots off) the step has no round branch at all."""
    seen = {name: int(got.cnt[i]) for name, i in got.index.items()}
    rounds, emits = taken_bodies(out, gated)
    pre = "any:" if gated else ""
    want = {pre + "round_body": rounds, pre + "round_body:else": evaluations[0] - rounds,
            pre + "emit_fn": emits, pre + "emit_fn:else": evaluations[1] - emits,
            "shift": shifts}
    if not rounds_run:
        assert rounds == 0, (what, rounds)
        want = {k: v for k, v in want.items() if "round_body" not in k}
    assert seen == want, (what, seen, want)
    return seen


def hold_replays(name, runner, blocks, ctls):
    """One node-form runner over the blocks (single channel: raws [2n] and
    controls (dropped, sync, motionblur) per block, K to a replay; channels:
    raws [C, 2n] and controls [C, 3] per block, one to a replay), captured
    with body counters (counted_bodies): its capture's memory, then the
    replays from a fresh state under the profiler, every output and the
    final state bit for bit the eager step's, the bodies run (counters,
    held) and launched by kernel name (profiler, reported) against the
    packed flags, the graph's parent, IF and body nodes (less the counters'
    nodes, one a body), device ms a block and the busy share. Each replay
    runs under set_sync_debug_mode("error"), its raws and controls already
    on the card: a host read inside it raises."""
    cfg, k, fir = runner.config, runner.n_blocks, runner.params.fir_lowpass_taps
    channels = isinstance(runner, ChannelRunner)
    if channels:
        new_state = lambda: stack_states(cfg, k, fir, device=DEV)  # noqa: E731
        batch, stack = 1, (lambda i: blocks[i])
        ctl_of, eager_ctl = (lambda i: np.asarray(ctls[i], np.float64)), (
            lambda i: StepControls(*np.asarray(ctls[i]).T))
    else:
        new_state = lambda: init_state(cfg, fir, device=DEV)  # noqa: E731
        batch, stack = k, (lambda i: torch.stack(blocks[i:i + k]))
        ctl_of, eager_ctl = (lambda i: np.asarray(ctls[i:i + k], np.float64)), (
            lambda i: StepControls(*ctls[i]))
    per_body = body_kernels(runner.step, new_state(), blocks[0])
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    with counted_bodies() as counters:  # the eager warm-up block and the capture
        runner.run(new_state(), stack(0), ctl_of(0))
    # every replay of the graph adds to the counters: they live as long as it
    runner.body_counters = counters
    torch.cuda.synchronize()
    memory = dict(after_capture_bytes=torch.cuda.memory_allocated(DEV) - mem0,
                  capture_peak_bytes=torch.cuda.max_memory_allocated(DEV) - mem0)
    counters.cnt.zero_()
    state, outs = new_state(), []
    inputs = [(stack(i), torch.from_numpy(ctl_of(i)).to(DEV)) for i in range(0, len(blocks), batch)]
    torch.cuda.synchronize()
    with card_counts() as trace:
        for raws, ctl in inputs:
            with sync_debug("error"):
                state, out, _ = runner.run(state, raws, ctl)
            outs.append(StepOutputs(*(x.clone() for x in out)))
    join = torch.stack if channels else torch.cat
    got = StepOutputs(*(join(list(v)) for v in zip(*outs)))
    state_e, wants = new_state(), []
    for i, raw in enumerate(blocks):
        state_e, want = runner.step(state_e, raw, eager_ctl(i))
        wants.append(want)
    same_outputs(got, StepOutputs(*(torch.stack(list(v)) for v in zip(*wants))), name)
    assert all(torch.equal(a, b) for a, b in zip(state_leaves(state), state_leaves(state_e))), name
    gated = channels and runner.cond_mode == "batched"
    n, kf = len(blocks), cfg.frames_per_block
    per_block = 1 if (gated or not channels) else k  # each branch's evaluations a block
    sync = [np.asarray(c, np.float64).reshape(-1, 3)[:, 1] for c in ctls]
    shifts = int(sum(((s != 0) & (got.n_pixels[b].reshape(-1).cpu().numpy() > 0)).sum()
                     for b, s in enumerate(sync)))
    census = runner.census()
    bodies = len(runner._graphs[torch.uint8].branches.bodies)
    census.update(body_nodes=census["body_nodes"] - bodies, all_nodes=census["all_nodes"] - bodies)
    return dict(graph=name, census=census, memory=memory,
                bodies=dict(rounds=int(got.ac_plot_valid.sum()), frames=int(got.frame_valid.sum()),
                            counted=held_counts(counters, got, gated,
                                                (n * per_block, n * per_block * kf), shifts, name,
                                                runner.step.run_autocorr),
                            profiler=profiler_bodies(trace, per_body, got, gated)),
                under_profiler_with_body_counters=dict(device_ms_per_block=trace.device_ms / n,
                                    transfer_ms_per_block=trace.transfer_ms / n,
                                    wall_ms_per_block=trace.wall_ms / n,
                                    busy_share=trace.device_ms / trace.wall_ms,
                                    device_ops_per_block=sum(trace.kernels.values()) / n))


def branch_nodes_phase(smi):
    """Phase 5b: every node-form runner against the eager (select-form)
    step, block by block and bit for bit (hold_replays): the block runner at
    64 MS/s, default Params, K = 1, 4 and 8 over 24 blocks (blocks with and
    without a round and a frame); at 8 MS/s (K == 4) at K = 4 with a drop
    of 37,777 samples in slot 2 and a sync shift in slot 0 (the shift's
    node taken); the channel runner with cond_mode="batched" at 64 MS/s
    with C = 4 and make_multi_step's gated form at 8 MS/s with C = 3 (K ==
    4), a drop on channel 1 each. The channel runner at config 5 (unrolled)
    and MultiSession are held in phase 9 (its "branch nodes" line and
    multisession_held)."""
    g64, g8 = GEOMETRIES["64MS/s"], GEOMETRIES["8MS/s"]
    raws64 = [torch.from_numpy(b).to(DEV)
              for b in ReplayU8(g64, render_test_pattern(g64.height, g64.width // 2), 24).blocks]
    rows = []

    def report(row):
        print("branch nodes " + json.dumps(dict(card=smi, **row)), flush=True)
        rows.append(row)

    for k in (1, 4, 8):
        report(hold_replays(f"BlockRunner 64MS/s K={k}, 24 blocks",
                            BlockRunner(g64, Params(), k, DEV), raws64, [(0, 0, 0.0)] * 24))
    blocks8 = [torch.from_numpy(b).to(DEV)
               for b in ReplayU8(g8, render_test_pattern(g8.height, g8.width // 2), 8).blocks]
    ctl8 = [(0, 1234, 0.3), (0, 0, 0.3), (37777, 0, 0.3)] + [(0, 0, 0.3)] * 5
    report(hold_replays("BlockRunner 8MS/s K=4 (a drop in slot 2, a sync shift in slot 0), "
                        "8 blocks", BlockRunner(g8, Params(), 4, DEV), blocks8, ctl8))

    def channel_case(name, runner, cfg, n_ch, n_blocks):
        blocks = [torch.from_numpy(b).to(DEV)
                  for b in channel_blocks(channel_sources(cfg, n_ch, n_blocks))]
        ctls = [np.zeros((n_ch, 3)) for _ in blocks]
        ctls[1][1, 0] = 37777  # channel 1 drops before block 1
        report(hold_replays(name, runner, blocks, ctls))

    channel_case("ChannelRunner batched 64MS/s C=4 (a drop on channel 1), 6 blocks",
                 ChannelRunner(g64, Params(), 4, DEV, cond_mode="batched"), g64, 4, 6)
    channel_case("make_multi_step runner 8MS/s C=3 K=4 (gated; a drop on channel 1), 4 blocks",
                 MultiStepRunner(g8, Params(), 3, DEV), g8, 3, 4)
    return rows


# ---- the post-process kernels (csrc/post_process.cu) -----------------------

PP_SNR_TOL = 1e-4  # the SNR's relative gap, kernels against the plain version: the
# kernels sum (f - mean)^2 and the mean's pixels in f64 partials, the plain
# version in torch's f32 reductions (mn, mx, the frames and every integer exact)
PP_FLAGS = {"default": Params(), "autoshift": Params(autoshift=True),
            "markers": Params(debug_markers=True), "pll_off": Params(framerate_pll=False)}
PP_FRAMES = 16  # emanation frames, and as many random ones with planted specials


def pp_frames(h, w, lead, seed):
    """PP_FRAMES emanation frames (a raster drifting a few pixels a frame,
    each stacked frame at an offset of its own, noise 0.02) then PP_FRAMES
    uniform random frames with 64 special pixels planted in each (and in
    pixel 0 of every third), [*lead, H, W] on the card."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    base = torch.from_numpy(render_test_pattern(h, w, seed=seed)).to(DEV)
    n = math.prod(lead)
    out = []
    for k in range(PP_FRAMES):
        f = torch.stack([torch.roll(base, (3 * k + 5 * i, 7 * k + 11 * i), dims=(0, 1))
                         for i in range(n)])
        f = f + 0.02 * torch.randn(f.shape, generator=gen, device=DEV)
        out.append(f.reshape(lead + (h, w)))
    specials = torch.tensor([300.0, -300.0, 1000.0, -251.0], device=DEV)
    for k in range(PP_FRAMES):
        f = torch.rand((n, h * w), generator=gen, device=DEV)
        at = torch.randint(0, h * w, (n, 64), generator=gen, device=DEV)
        f.scatter_(1, at, specials[torch.randint(0, 4, (n, 64), generator=gen, device=DEV)])
        if k % 3 == 0:
            f[:, 0] = 500.0
        out.append(f.reshape(lead + (h, w)))
    return out


def pp_carries(lead):
    """A post-process's carries at the state's start, [*lead] leaves."""
    def z(dtype):
        return torch.zeros(lead, dtype=dtype, device=DEV)

    ag = (z(torch.float32), z(torch.float32), torch.ones(lead, device=DEV))
    return (ag, SweetspotState(*(z(torch.int32) for _ in range(3))),
            SweetspotState(*(z(torch.int32) for _ in range(3))),
            PLLState(z(torch.float64), z(torch.bool), z(torch.float32)))


def pp_leaves(out):
    """(frames [result, screen], exact leaves, snr) of a post-process's outputs."""
    result, screen, (mn, mx, snr), sx, sy, pll = out
    return [result, screen], [mn, mx, *sx, *sy, *pll], snr


def pp_hold(cfg, params, lead, frames):
    """The kernels against the plain version on the card over the frames,
    each frame from the plain version's carries: frames, min, max, the sync
    and PLL carries exact, the SNR within PP_SNR_TOL; every kernel call
    under set_sync_debug_mode("error"). Then each chained on its own carries
    over all the frames, the carries at the end equal."""
    spec = pipeline_mod._post_spec(cfg, params)
    shape = tuple(lead) + (cfg.height, cfg.width)
    mb = torch.full(tuple(lead), 0.25, device=DEV)
    worst_snr = 0.0
    mine = plain = (torch.zeros(shape, device=DEV), *pp_carries(tuple(lead)))
    for k, f in enumerate(frames):
        with sync_debug("error"):
            got = post_process_mod.post_process_cuda(f, *plain, mb, spec)
        want = pipeline_mod._post_process_default_order(f, *plain, mb, spec)
        (gf, gx, gs), (wf, wx, ws) = pp_leaves(got), pp_leaves(want)
        for i, (a, b) in enumerate(zip(gf + gx, wf + wx)):
            assert a.dtype == b.dtype and torch.equal(a, b), (
                "post-process kernels", shape, params, k, i, (a != b).sum().item())
        worst_snr = max(worst_snr, ((gs - ws).abs() / ws.abs()).max().item())
        plain = want[1:]
        mine = post_process_mod.post_process_cuda(f, *mine, mb, spec)[1:]
    assert worst_snr <= PP_SNR_TOL, (shape, params, worst_snr)
    ends = [pp_leaves((m[0],) + tuple(m)) for m in (mine, plain)]
    assert all(torch.equal(a, b) for a, b in zip(ends[0][1], ends[1][1])), (shape, params)
    return worst_snr


def pp_replayed(cfg, lead, frames):
    """One post-process of the stack captured in a CUDA graph and replayed
    three times, then with the next frame copied in: every output bit for
    bit the eager call's."""
    spec = pipeline_mod._post_spec(cfg, Params())
    shape = tuple(lead) + (cfg.height, cfg.width)
    static = frames[0].clone()
    ins = (torch.zeros(shape, device=DEV), *pp_carries(tuple(lead)))
    mb = torch.full(tuple(lead), 0.25, device=DEV)
    eager = [post_process_mod.post_process_cuda(f, *ins, mb, spec) for f in frames[:2]]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = post_process_mod.post_process_cuda(static, *ins, mb, spec)
    for k, want in ((0, eager[0]), (0, eager[0]), (0, eager[0]), (1, eager[1])):
        static.copy_(frames[k])
        graph.replay()
        for a, b in zip(graph_cond._leaves(out), graph_cond._leaves(want)):
            assert torch.equal(a, b), ("post-process replay", shape, k)
    return True


def pp_graph_ms(cfg, lead, frames, fn, reps=16):
    """Device ms a post-process of fn: `reps` of them chained over the frames
    in one CUDA graph, its replays timed with CUDA events (median of 10),
    over reps; and the kernels' device ms each a post-process by the
    profiler (none for the plain chain)."""
    spec = pipeline_mod._post_spec(cfg, Params())
    shape = tuple(lead) + (cfg.height, cfg.width)
    mb = torch.full(tuple(lead), 0.25, device=DEV)
    carry = (torch.zeros(shape, device=DEV), *pp_carries(tuple(lead)))
    fn(frames[0], *carry, mb, spec)  # loads and warms outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = carry
        for k in range(reps):
            c = fn(frames[k % len(frames)], *c, mb, spec)[1:]
    times = []
    for _ in range(13):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    with card_counts() as trace:
        graph.replay()
    by_kernel = {re.search(r"post_process_\w+", k).group(0): v / reps
                 for k, v in trace.device_ms_by.items() if "post_process_" in k}
    return dict(ms=float(np.median(times[3:])), device_ms_by_kernel=by_kernel)


@contextlib.contextmanager
def plain_post_process():
    """Within: the step's default order runs the plain chain on the card too,
    as it did before the kernels (the 'before' of the census)."""
    real = pipeline_mod.post_process_cuda
    pipeline_mod.post_process_cuda = pipeline_mod._post_process_default_order
    try:
        yield
    finally:
        pipeline_mod.post_process_cuda = real


def pp_runner(name, runner, state, raws, ctl, n=12):
    """A runner captured (its warm-up block and capture counted by the
    wrapper), its census, its untraced replays timed (ms a block, CUDA
    events around copy-in and replay, median over n blocks) and the
    post-process kernels and emitted frames of the replays of raws[1:]
    under the profiler."""
    n0 = post_process_mod.post_process_cuda.launches
    state, out, _ = runner.run(state, raws[0], ctl)
    torch.cuda.synchronize()
    captured = post_process_mod.post_process_cuda.launches - n0
    times = []
    for i in range(n):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        state, out, _ = runner.run(state, raws[i % len(raws)], ctl)
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    frames = 0
    with card_counts() as trace:
        for raw in raws[1:]:
            state, out, _ = runner.run(state, raw, ctl)
            frames += int(out.frame_valid.sum())
    return dict(runner=name, census=runner.census(),
                wrapper_launches_in_warm_up_and_capture=captured,
                replay_ms_per_block_untraced=float(np.median(times)),
                replays=dict(blocks=len(raws) - 1, frames=frames,
                             post_process_kernels=trace.named("post_process_"),
                             device_ms=trace.device_ms))


def pp_runners_agree(name, make, new_state, raws, ctl):
    """The main path's runner with the plain chain (as before the kernels)
    and with the kernels, the kernels' one captured with a device counter
    in each IF-node body (counted_bodies); then both from fresh states over
    the same raws (distinct blocks, each of its own noise) in turns, the
    counters zeroed just before: every replay's emitted frames, validity,
    sync, PLL, autogain min and max and the rest of its outputs bit for bit,
    the SNR within PP_SNR_TOL, and the carries at the end equal likewise.
    The bodies the counters saw are the emitted frames, so the post-process
    kernels launched 3 an emitted frame on this path, inside the replays."""
    with plain_post_process():
        plain = make()
        plain.run(new_state(), raws[0], ctl)
    post_process_mod.post_process_cuda.launches = 0
    with counted_bodies() as counters:
        mine = make()
        mine.run(new_state(), raws[0], ctl)
    torch.cuda.synchronize()
    captured = post_process_mod.post_process_cuda.launches
    sp, sm = new_state(), new_state()
    counters.cnt.zero_()
    frames, worst_snr = 0, 0.0

    def snr_gap(a, b):
        return ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()

    for k, raw in enumerate(raws):
        sp, op, _ = plain.run(sp, raw, ctl)
        sm, om, _ = mine.run(sm, raw, ctl)
        valid = op.frame_valid
        assert torch.equal(valid, om.frame_valid), (name, k)
        assert torch.equal(op.frame[valid], om.frame[valid]), (
            name, k, (op.frame[valid] != om.frame[valid]).sum().item())
        for field, a, b in zip(StepOutputs._fields, op, om):
            if field not in ("frame", "ag_snr"):
                assert torch.equal(a, b), (name, k, field)
        worst_snr = max(worst_snr, snr_gap(om.ag_snr, op.ag_snr))
        frames += int(valid.sum())
    for field, a, b in zip(StreamState._fields, sp, sm):
        for x, y in zip(a, b) if isinstance(a, tuple) else ((a, b),):
            if field == "ag_snr":
                worst_snr = max(worst_snr, snr_gap(y, x))
            else:
                assert torch.equal(x, y), (name, "final state", field)
    assert worst_snr <= PP_SNR_TOL, (name, worst_snr)
    seen = {site: int(counters.cnt[i]) for site, i in counters.index.items()}
    bodies = sum(v for site, v in seen.items() if site.endswith("emit_fn"))
    assert frames > 0 and bodies == frames, (name, seen, frames)
    return dict(blocks=len(raws), frames=frames, emit_bodies_counted=bodies,
                launches=3 * bodies, wrapper_launches_at_capture=captured,
                worst_snr_gap=worst_snr)


def post_process_phase(smi):
    """The post-process kernels (csrc/post_process.cu) against their plain
    version on the card, at the 64 MS/s (628 x 3397) and config 5 (628 x
    849) geometries, one frame and C = 8 (pp_hold, every flag set of
    PP_FLAGS), a capture replayed against eager calls (pp_replayed); ms a
    post-process in a graph of 16, kernels and plain chain, beside the
    bytes bound; the same at one frame of a superresolution pipeline of a
    64 MS/s source (256 MS/s, 628 x 13588: the search's profiles do not fit
    in shared memory); then the 64 MS/s BlockRunner (K = 1) and config 5's
    unrolled ChannelRunner with the plain chain (as before the kernels) and
    with the kernels: census, untraced replay ms a block, the kernels in a
    replay by the profiler; and each held replay by replay against the
    plain chain's on the same raws, the kernels' launches on the path
    counted by body counters (pp_runners_agree). Returns the row."""
    t0 = time.time()
    geoms = {"628x3397": GEOMETRIES["64MS/s"], "628x849": CH5,
             "628x13588": PipelineConfig(samplerate=256e6, height=628, refreshrate=60.0,
                                         block_samples=4 * 786432)}
    assert geoms["628x13588"].width == 13588
    row = dict(card=smi, snr_tol=PP_SNR_TOL, worst_snr_gap={}, replayed={}, ms_per_post_process={})
    for gname, cfg in geoms.items():
        for lead in ((), (N_CH,)) if cfg.width < 13588 else ((),):
            key = f"{gname} C={math.prod(lead)}"
            frames = pp_frames(cfg.height, cfg.width, lead, seed=len(row["worst_snr_gap"]))
            row["worst_snr_gap"][key] = {flag: pp_hold(cfg, params, lead, frames)
                                         for flag, params in PP_FLAGS.items()}
            row["replayed"][key] = pp_replayed(cfg, lead, frames)
            # the frame and the screen read, the new screen and the emitted frame written
            nbytes = 4 * 4 * cfg.height * cfg.width * math.prod(lead)
            row["ms_per_post_process"][key] = dict(
                kernels=pp_graph_ms(cfg, lead, frames, post_process_mod.post_process_cuda),
                plain=pp_graph_ms(cfg, lead, frames, pipeline_mod._post_process_default_order),
                bytes_bound=nbytes / 3.35e12 * 1e3)
    g64 = GEOMETRIES["64MS/s"]
    raws64 = [torch.from_numpy(b).to(DEV)[None] for b in
              ReplayU8(g64, render_test_pattern(g64.height, g64.width // 2), 4).blocks]
    raws5 = [torch.from_numpy(b).to(DEV) for b in channel_blocks(channel_sources(CH5, N_CH, 4))]
    runners = []
    for label, ctx in (("plain chain", plain_post_process), ("kernels", contextlib.nullcontext)):
        with ctx():
            runners.append(pp_runner(f"BlockRunner 64MS/s K=1, {label}",
                                     BlockRunner(g64, Params(), 1, DEV),
                                     init_state(g64, device=DEV),
                                     raws64, np.zeros((1, 3))))
            runners.append(pp_runner(f"ChannelRunner config 5 unrolled, {label}",
                                     ChannelRunner(CH5, Params(), N_CH, DEV),
                                     stack_states(CH5, N_CH, device=DEV), raws5,
                                     np.zeros((N_CH, 3))))
    for r in runners[2:]:  # by name in IF-node bodies: reported, the body counters hold
        r["replays"]["agree"] = r["replays"]["post_process_kernels"] == 3 * r["replays"]["frames"]
        assert r["replays"]["post_process_kernels"] > 0 and r["replays"]["frames"] > 0, r
        assert r["wrapper_launches_in_warm_up_and_capture"] > 0, r
    for r in runners[:2]:  # none captured (the profiler's names are reported only)
        assert r["wrapper_launches_in_warm_up_and_capture"] == 0, r
    row["runners"] = runners
    row["body_nodes_cut"] = {
        r["runner"].split(",")[0]: 1 - r["census"]["body_nodes"] / p["census"]["body_nodes"]
        for p, r in zip(runners[:2], runners[2:])}
    row["launches"] = post_process_mod.post_process_cuda.launches
    # the main paths against the plain chain, replay by replay, on blocks
    # of their own (8 at 64 MS/s, 6 of 8 channels at config 5)
    raws64 = [torch.from_numpy(b).to(DEV)[None] for b in
              ReplayU8(g64, render_test_pattern(g64.height, g64.width // 2), 8).blocks]
    raws5 = [torch.from_numpy(b).to(DEV) for b in channel_blocks(channel_sources(CH5, N_CH, 6))]
    row["main_paths"] = {
        "BlockRunner 64MS/s K=1, 8 blocks": pp_runners_agree(
            "BlockRunner 64MS/s", lambda: BlockRunner(g64, Params(), 1, DEV),
            lambda: init_state(g64, device=DEV), raws64, np.zeros((1, 3))),
        "ChannelRunner config 5 unrolled, 6 blocks": pp_runners_agree(
            "ChannelRunner config 5", lambda: ChannelRunner(CH5, Params(), N_CH, DEV),
            lambda: stack_states(CH5, N_CH, device=DEV), raws5, np.zeros((N_CH, 3)))}
    row["seconds"] = time.time() - t0
    print("post-process kernels " + json.dumps(row), flush=True)
    return row


# ---- intake paths: what users feed the receiver ---------------------------

INTAKE_FORMATS = (  # label, the rawfile format, its dtype, Params
    ("int8", "int8", np.int8, Params()),
    ("int16", "int16", np.int16, Params()),
    ("uint16", "uint16", np.uint16, Params()),
    ("float32", "float", np.float32, Params()),
    ("int8 fused", "int8", np.int8, Params(resampler="fused")),
)
INTAKE_BLOCKS = 12
# an RTL-SDR's rate, at the block size TSDR and the command line default to
RTL_CFG = PipelineConfig(samplerate=2.4e6, height=628, refreshrate=60.0, block_samples=1 << 16)
EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")


@contextlib.contextmanager
def worker_faults():
    """Every exception raised on a worker thread inside the block, caught by
    threading.excepthook and raised at its end. The port, like the JAX
    package, lets a worker thread's exception be printed and dropped; the
    smoke run refuses to pass over one."""
    seen, prev = [], threading.excepthook

    def hook(args):
        seen.append(f"{args.thread.name if args.thread else '?'}: "
                    f"{args.exc_type.__name__}: {args.exc_value}")
        prev(args)

    threading.excepthook = hook
    try:
        yield seen
    finally:
        threading.excepthook = prev
    assert not seen, f"exceptions on worker threads: {seen}"


def emanation(cfg, dtype, n_blocks):
    """A capture of the synthetic emanation in `dtype`, quantized by
    synth_iq like a recorder: the raster at 0.3-0.9 of full scale plus
    noise, inside every format's range. Returns (raster, samples)."""
    raster = render_test_pattern(cfg.height, cfg.width // 2)
    iq = synth_iq(raster * 0.6, samplerate=cfg.samplerate,
                  pixelclock=raster.size * cfg.refreshrate,
                  n_samples=n_blocks * cfg.block_samples, dc=0.3, noise=0.02, dtype=dtype)
    return raster, iq


def i24_le(f32):
    """float32 in [-1, 1) as the ExtIO 24-bit little-endian signed PCM, and
    the float32 values those bytes stand for (v / 2^23), made with numpy
    apart from the exec source's own widening."""
    v = np.clip(np.round(f32.astype(np.float64) * (1 << 23)), -(1 << 23), (1 << 23) - 1)
    v = v.astype("<i4")
    return v.view(np.uint8).reshape(-1, 4)[:, :3].tobytes(), (v / (1 << 23)).astype(np.float32)


def source_session(cfg, params, source, count=False, motionblur=0.0, batch=1, **run):
    """Session(batch_blocks=batch).run over `source` on the card at
    `motionblur`: (frames, session, seconds, launches under the profiler or
    None). A fault on the session's own thread, or on a worker thread
    (worker_faults), fails the run."""
    frames, errors = [], []
    sess = Session(cfg, params, source, SessionCallbacks(on_frame=frames.append,
                                                         on_exception=errors.append),
                   batch_blocks=batch, device=DEV)
    sess.set_motionblur(motionblur)
    torch.cuda.synchronize()
    with (card_counts() if count else contextlib.nullcontext(None)) as launches:
        t0 = time.perf_counter()
        sess.run(**run)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    assert not errors, errors
    assert sess.samples_dropped_total == 0, sess.samples_dropped_total
    return frames, sess, dt, launches


def cpu_step(cfg, params, blocks, drops=None):
    """The device step on the CPU (the kernels' plain versions) over the
    blocks, each with its drop (drops[b]; none without): its frames and its
    final state."""
    step = make_step(cfg, params, device="cpu")
    state = init_state(cfg, params.fir_lowpass_taps, device="cpu")
    frames = []
    for b, raw in enumerate(blocks):
        controls = StepControls() if drops is None else StepControls(int(drops[b]), 0, 0.0)
        state, out = step(state, torch.from_numpy(raw), controls)
        frames += [f for _, f in _valid_frames(out)]
    return frames, state


def same_ints(state, want_state, what):
    """Every integer leaf of two states (the carries) equal."""
    for i, (a, b) in enumerate(zip(state_leaves(state), state_leaves(want_state))):
        if not (a.is_floating_point() or a.is_complex()):
            assert torch.equal(a.cpu(), b.cpu()), (what, "state leaf", i)


def held_to_cpu_step(frames, state, want, want_state, what, tol=GRAPH_TOL):
    """The card's frames and final state against the CPU step's: as many
    frames, each within tol, every integer leaf of the state (the carries)
    equal. Returns the worst frame difference."""
    assert len(frames) == len(want) > 0, (what, len(frames), len(want))
    err = max(float(np.abs(a - b).max()) for a, b in zip(frames, want))
    assert err <= tol, (what, err)
    same_ints(state, want_state, what)
    return err


def same_frames(got, want, what):
    """held_frames, and as many frames as `want`."""
    assert held_frames(got, want, what) == len(want), (what, len(got), len(want))


def graphs_of(cfg, params):
    """The raw dtypes the cached runner of (cfg, params, batch 1) holds a
    graph for."""
    runner = session_mod._WARM_STEPS.get((cfg, params, 1, DEV))
    return set() if runner is None else set(runner._graphs)


def intake_formats(cfg, tmp, smi):
    """Every raw format through rawfile -> Session at 64 MS/s: against the
    CPU step over the same blocks, against the uint8 capture of the same
    emanation, and its graph captured once."""
    blocks_of = {}

    def through(label, fmt, dtype, params):
        path = os.path.join(tmp, f"intake.{fmt}")
        if dtype not in blocks_of:
            blocks_of[dtype] = emanation(cfg, dtype, INTAKE_BLOCKS)[1]
            blocks_of[dtype].tofile(path)
        spec = f"{path} {cfg.samplerate} {fmt} noloop"
        before = graphs_of(cfg, params)
        runs = []
        for count in (False, False, False, False, True):  # the capture, 3 timed, counted
            runs.append(source_session(cfg, params, load_source("rawfile", spec), count=count))
        captured = graphs_of(cfg, params) - before
        assert captured == ({torch.from_numpy(np.zeros(0, dtype)).dtype} - before), captured
        for frames, *_ in runs[1:]:
            same_frames(frames, runs[0][0], f"rawfile {label}, replays")
        frames, sess, _, launches = runs[-1]
        blocks = sess.meter.total_samples // cfg.block_samples
        assert blocks == INTAKE_BLOCKS, blocks
        kernel = "fused_demod_resample_cuda" if params.resampler == "fused" else \
            "box_resample_strided_cuda"
        only(launches, **{kernel: blocks})
        return dict(frames=frames, sess=sess, blocks=blocks, captured=sorted(map(str, captured)),
                    first_run_ms=runs[0][2] / blocks * 1e3,
                    ms=[run[2] / blocks * 1e3 for run in runs[1:4]],
                    kernel=kernel, launches=launches[kernel],
                    under_profiler={k: getattr(launches, k) / blocks
                                    for k in ("wall_ms", "device_ms", "transfer_ms")})

    u8 = through("uint8", "uint8", np.uint8, Params())
    rows, launches = {}, {}
    for label, fmt, dtype, params in INTAKE_FORMATS:
        got = through(label, fmt, dtype, params)
        blocks = np.split(blocks_of[dtype], INTAKE_BLOCKS)
        t_cpu = time.perf_counter()
        want, want_state = cpu_step(cfg, params, blocks)
        t_cpu = time.perf_counter() - t_cpu
        err = held_to_cpu_step(got["frames"], got["sess"].state, want, want_state,
                               f"rawfile {label}")
        # the same emanation in uint8: as many frames, the first alike (later
        # frames follow each run's PLL walk, which quantization steers)
        assert len(got["frames"]) == len(u8["frames"]), (label, len(got["frames"]))
        corr = [float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
                for a, b in zip(got["frames"], u8["frames"])]
        assert corr[0] > CORR_MIN, (label, corr)
        rows[label] = dict(blocks=got["blocks"], frames=len(got["frames"]),
                           graphs_captured=got["captured"], first_run_ms_a_block=got["first_run_ms"],
                           ms_a_block_median=float(np.median(got["ms"])), ms_a_block=got["ms"],
                           launches={got["kernel"]: got["launches"]},
                           ms_a_block_under_profiler=got["under_profiler"],
                           max_abs_err_vs_cpu_step=err, cpu_step_s=t_cpu,
                           corr_vs_uint8_by_frame=corr)
        print(f"intake rawfile {label} (64MS/s, {smi}): " + json.dumps(rows[label]))
        launches[f"rawfile {label} Session 64MS/s, {INTAKE_BLOCKS} blocks"] = got["launches"]
    return rows, launches


def exec_case(cfg, fmt, tmp, n_blocks=6):
    """The exec source: `cat` of a capture in `fmt` (i8, or i24 widened to
    float32 on the host) through Session, against rawfile over the same
    samples (int8, or the float32 those 24-bit samples stand for): the same
    graph and the same input, so the frames are equal bit for bit. The
    child exits 0 with nothing reported."""
    if fmt == "i8":
        samples = emanation(cfg, np.int8, n_blocks)[1]
        data, ref_fmt, ref = samples.tobytes(), "int8", samples
    else:
        data, ref = i24_le(emanation(cfg, np.float32, n_blocks)[1])
        ref_fmt = "float"
    path, ref_path = os.path.join(tmp, f"exec.{fmt}"), os.path.join(tmp, f"exec_ref.{ref_fmt}")
    with open(path, "wb") as f:
        f.write(data)
    ref.tofile(ref_path)
    want, *_ = source_session(cfg, Params(), load_source(
        "rawfile", f"{ref_path} {cfg.samplerate} {ref_fmt} noloop"))
    ring = -(-len(data) // (1 << 16)) + 1  # the whole capture: cat outruns the session
    src = load_source("exec", f"{cfg.samplerate} {fmt} ring={ring} -- cat {path}")
    frames, sess, dt, launches = source_session(cfg, Params(), src, count=True)
    same_frames(frames, want, f"exec {fmt} against rawfile {ref_fmt}")
    blocks = sess.meter.total_samples // cfg.block_samples
    assert blocks == n_blocks, blocks
    assert src.last_error() == "", src.last_error()
    only(launches, box_resample_strided_cuda=blocks)
    return dict(rate_msps=cfg.samplerate / 1e6, blocks=blocks, frames=len(frames),
                frames_equal_rawfile=ref_fmt, per_block_ms_under_profiler=dt / blocks * 1e3,
                k1_launches=launches["box_resample_strided_cuda"], child_error=src.last_error())


class RtlTcpServer:
    """A loopback server speaking rtl_tcp.c's wire format: the 12-byte
    header ("RTL0", tuner type, gain count), then the capture's uint8 IQ at
    `rate` samples a second, recording every 5-byte command (u8 command, u32
    big-endian value) the client sends. It closes once the client has."""

    def __init__(self, data: bytes, rate: float, chunk: int = 1 << 14):
        self.data, self.rate, self.chunk = data, rate, chunk
        self.commands = []
        self.srv = socket.create_server(("127.0.0.1", 0))
        self.port = self.srv.getsockname()[1]
        self.thread = threading.Thread(target=self._serve, name="rtl_tcp server", daemon=True)
        self.thread.start()

    def _serve(self):
        conn, _ = self.srv.accept()
        with conn, self.srv:
            conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))  # R820T, 29 gains
            reader = threading.Thread(target=self._commands, args=(conn,),
                                      name="rtl_tcp commands", daemon=True)
            reader.start()
            t0 = time.monotonic()
            try:
                for pos in range(0, len(self.data), self.chunk):
                    wait = t0 + pos / (2 * self.rate) - time.monotonic()
                    if wait > 0:
                        time.sleep(wait)
                    conn.sendall(self.data[pos:pos + self.chunk])
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client stopped first
            reader.join(timeout=60)

    def _commands(self, conn):
        buf = b""
        while True:
            try:
                got = conn.recv(64)
            except OSError:
                return
            if not got:
                return
            buf += got
            while len(buf) >= 5:
                self.commands.append(struct.unpack(">BI", buf[:5]))
                buf = buf[5:]

    def join(self):
        self.thread.join(timeout=60)
        assert not self.thread.is_alive(), "the rtl_tcp server did not finish"


def rtltcp_case(tmp, n_blocks=24):
    """rtltcp through TSDR at an RTL-SDR's 2.4 MS/s, from a loopback server
    that paces the capture at that rate: frames equal to rawfile's over the
    same bytes (the same graph, the same input), no drop, and the commands
    on the wire those the same source sends from a CPU run."""
    cfg = RTL_CFG
    data = emanation(cfg, np.uint8, n_blocks)[1]
    path = os.path.join(tmp, "rtl.u8")
    data.tofile(path)
    ring = -(-data.nbytes // (1 << 16)) + 1

    def through(name, params, device, count=False):
        frames = []
        rx = TSDR(block_samples=cfg.block_samples, device=device)
        rx.load_source(name, params)
        rx.set_resolution(cfg.height, cfg.refreshrate)
        with (card_counts() if count else contextlib.nullcontext(None)) as launches:
            t0 = time.perf_counter()
            rx.start(on_frame=frames.append, max_blocks=n_blocks)
            dt = time.perf_counter() - t0
        dropped = rx.session.samples_dropped_total
        rx.close()
        assert dropped == 0, (name, device, dropped)
        return frames, dt, launches

    want, *_ = through("rawfile", f"{path} {cfg.samplerate} uint8 noloop", DEV)
    runs = {}
    for where, device in (("card", DEV), ("cpu", "cpu")):
        server = RtlTcpServer(data.tobytes(), cfg.samplerate)
        spec = f"127.0.0.1 {server.port} {cfg.samplerate:.0f} freq=433920000 gain=0.5 ring={ring}"
        frames, dt, launches = through("rtltcp", spec, device, count=where == "card")
        server.join()
        runs[where] = dict(frames=frames, s=dt, commands=server.commands, launches=launches)
    card, cpu = runs["card"], runs["cpu"]
    same_frames(card["frames"], want, "rtltcp against rawfile uint8")
    assert card["commands"] == cpu["commands"] and card["commands"], (card["commands"],
                                                                      cpu["commands"])
    err = max(float(np.abs(a - b).max()) for a, b in zip(card["frames"], cpu["frames"]))
    assert len(card["frames"]) == len(cpu["frames"]) and err <= GRAPH_TOL, err
    only(card["launches"], box_resample_strided_cuda=n_blocks)
    return dict(rate_msps=cfg.samplerate / 1e6, width=cfg.width, blocks=n_blocks,
                frames=len(card["frames"]), dropped=0, commands=card["commands"],
                paced_wall_s=card["s"], signal_s=n_blocks * cfg.block_samples / cfg.samplerate,
                max_abs_err_vs_cpu=err,
                k1_launches_under_profiler=card["launches"]["box_resample_strided_cuda"])


def multisession_async(n_blocks=8):
    """MultiSession.start_async at config 5 (Params(framerate_pll=False), as
    examples/torch_multi_target.py sets it): this thread polls is_running
    until the worker's run ends, then stop(); frames per channel equal a
    foreground run's over the same sources bit for bit; ms a block of each,
    in turns; K1 once per channel a block from the worker, by the profiler."""
    params = Params(framerate_pll=False)
    srcs = channel_sources(CH5, N_CH, n_blocks)
    MultiSession(CH5, params, srcs, device=DEV).run(max_blocks=1)  # the graph's capture

    def one(mode, count=False):
        got = {c: [] for c in range(N_CH)}
        ms = MultiSession(CH5, params, srcs, on_frame=lambda c, f: got[c].append(f), device=DEV)
        torch.cuda.synchronize()
        with (card_counts() if count else contextlib.nullcontext(None)) as launches:
            t0 = time.perf_counter()
            if mode == "foreground":
                ms.run(max_blocks=n_blocks)
            else:
                ms.start_async(max_blocks=n_blocks)
                assert ms.is_running
                deadline = time.time() + 120
                while ms.is_running:
                    assert time.time() < deadline, "MultiSession.start_async: no end"
                    time.sleep(0.001)
                thread = ms._thread
                ms.stop()
                assert ms._thread is None and not thread.is_alive()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        return got, dt / n_blocks * 1e3, launches

    ms_by = {"foreground": [], "background": []}
    frames = {}
    for mode in ("foreground", "background", "background", "foreground"):
        got, ms, _ = one(mode)
        ms_by[mode].append(ms)
        if mode in frames:
            for c in range(N_CH):
                same_frames(got[c], frames[mode][c], f"MultiSession {mode} channel {c}")
        frames[mode] = got
    for c in range(N_CH):
        same_frames(frames["background"][c], frames["foreground"][c],
                    f"MultiSession.start_async channel {c}")
    got, _, launches = one("background", count=True)
    only(launches, box_resample_strided_cuda=N_CH * n_blocks)
    return dict(channels=N_CH, blocks=n_blocks,
                frames=[len(frames["background"][c]) for c in range(N_CH)],
                per_block_ms_foreground=ms_by["foreground"],
                per_block_ms_start_async=ms_by["background"],
                k1_launches_under_profiler=launches["box_resample_strided_cuda"])


def tsdr_background(tmp, n_blocks=6):
    """TSDR.start(background=True) at 8 MS/s and, while it streams,
    warm_resolution(height + 14, background=True), joined; then stop(),
    set_resolution to the warmed geometry and start again. The restarted
    session's first block captures no graph (its runner is the warmed one);
    its time to the first frame beside a cold geometry's (kernels loaded,
    its graph not captured). Every session's frames equal a foreground run's
    of the same geometry from the capture's start bit for bit."""
    cfg = GEOMETRIES["8MS/s"]
    path = os.path.join(tmp, "tsdr8.u8")
    emanation(cfg, np.uint8, 2 * n_blocks)[1].tofile(path)
    warm_h, cold_h = cfg.height + 14, cfg.height + 28
    captures = []
    real_capture = BlockRunner._capture

    def capture(self, dtype):
        captures.append((self.config.height, threading.current_thread().name))
        return real_capture(self, dtype)

    def api(height, pace=""):
        rx = TSDR(block_samples=cfg.block_samples, device=DEV)
        rx.load_source("rawfile", f"{path} {cfg.samplerate} uint8{pace}")
        rx.set_resolution(height, cfg.refreshrate)
        return rx

    def timed_start(rx, count=False):
        """start(max_blocks=n_blocks): its frames, the ms of its first
        block's dispatch (upload, replay or capture, fetch, downloads) and
        the ms from start() to its first frame, and its launches."""
        frames, first, dispatch = [], [], []
        real = Session._dispatch_blocks
        t0 = time.perf_counter()

        def timed(self, *a):
            t = time.perf_counter()
            got = real(self, *a)
            dispatch.append((time.perf_counter() - t) * 1e3)
            return got

        def on_frame(f):
            if not first:
                first.append((time.perf_counter() - t0) * 1e3)
            frames.append(f)

        Session._dispatch_blocks = timed
        try:
            with (card_counts() if count else contextlib.nullcontext(None)) as launches:
                rx.start(on_frame=on_frame, max_blocks=n_blocks)
        finally:
            Session._dispatch_blocks = real
        return frames, dict(first_block_ms=dispatch[0], first_frame_ms=first[0]), launches

    def foreground(height, **limit):
        rx = api(height)
        frames = []
        rx.start(on_frame=frames.append, **limit)
        rx.close()
        return frames

    BlockRunner._capture = capture
    try:
        rx = api(cfg.height, " throttle")  # at the radio's rate, as a live source
        streamed = []
        rx.start(on_frame=streamed.append, background=True)
        deadline = time.time() + 60
        while len(streamed) < 2:
            assert time.time() < deadline and rx.is_running, "TSDR background: no frames"
            time.sleep(0.001)
        at_warm = len(streamed)
        t0 = time.perf_counter()
        warm = rx.warm_resolution(warm_h, cfg.refreshrate, background=True)
        warm.join(timeout=120)
        warm_s = time.perf_counter() - t0
        assert not warm.is_alive() and rx.is_running
        during_warm = len(streamed) - at_warm
        rx.stop()
        assert not rx.is_running
        warmed_key = (rx._make_config(height=warm_h), rx._params, 1, DEV)
        assert session_mod._WARM_STEPS[warmed_key]._graphs.keys() == {torch.uint8}
        n_captures = len(captures)
        rx.set_resolution(warm_h, cfg.refreshrate)
        restarted, warm_first, _ = timed_start(rx)
        assert rx.session._runner is session_mod._WARM_STEPS[warmed_key]
        assert len(captures) == n_captures, captures[n_captures:]  # none: the warmed graph
        rx.set_resolution(cold_h, cfg.refreshrate)
        cold, cold_first, _ = timed_start(rx)
        assert [h for h, _ in captures[n_captures:]] == [cold_h], captures
        rx.set_resolution(warm_h, cfg.refreshrate)
        counted, _, launches = timed_start(rx, count=True)
        same_frames(counted, restarted, "TSDR restarted, under the profiler")
        rx.close()
    finally:
        BlockRunner._capture = real_capture
    same_frames(streamed, foreground(cfg.height, max_frames=len(streamed))[:len(streamed)],
                "TSDR background session")
    same_frames(restarted, foreground(warm_h, max_blocks=n_blocks), "TSDR restarted (warmed)")
    same_frames(cold, foreground(cold_h, max_blocks=n_blocks), "TSDR restarted (cold)")
    only(launches, box_resample_strided_cuda=n_blocks)
    return dict(frames_background=len(streamed), frames_during_the_warm=during_warm,
                warm_thread_s=warm_s, graphs_captured_by=sorted(set(captures)),
                warmed=warm_first, cold_geometry=cold_first,
                source_block_ms=cfg.block_samples / cfg.samplerate * 1e3,
                restarted_frames=len(restarted),
                k1_launches_restarted=launches["box_resample_strided_cuda"])


def run_example(args, cwd, device):
    """examples/<args[0]> with the rest of args and, for "cpu", --device
    cpu (the card is each example's default), started in `cwd`."""
    argv = [sys.executable, os.path.join(EXAMPLES, args[0]), *args[1:]]
    if device == "cpu":
        argv += ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(EXAMPLES), OMP_NUM_THREADS="2")
    return subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finished(proc, what, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, (what, proc.returncode, err[-2000:])
    return out.splitlines()


def numbers_in(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+", line)]


def ranges_agree(card, cpu, what):
    """Frame ranges the examples print, card against CPU: within 1e-4, plus
    one unit of the last printed digit (each side rounds to it)."""
    for a, b in zip(card, cpu):
        na, nb = numbers_in(a), numbers_in(b)
        assert len(na) == len(nb) and a.split("[")[0] == b.split("[")[0], (what, a, b)
        for x, y, s in zip(na, nb, a.split("[")[-1].split(",")):
            digits = len(s.strip(" ]").split(".")[-1]) if "." in s else 0
            assert abs(x - y) <= 1e-4 + 10.0 ** -digits, (what, a, b)


def examples_case(tmp):
    """The card examples with their default device and with --device cpu,
    the eight processes at once (their times are not compared): the same frame
    counts and detected mode, frame ranges within 1e-4, the multi-channel
    ranks on cuda: devices. torch_reference_plugin.py needs the reference's
    plugin sources, which are not in the repository: not run."""
    cap = os.path.join(tmp, "example_capture.bin")
    made = finished(run_example(["torch_make_test_capture.py", cap, "1.0"], tmp, None),
                    "torch_make_test_capture.py")
    assert os.path.getsize(cap) == int(8e6) * 2, made
    cases = {
        "torch_replay_capture.py": [cap, "8000000", "uint8", "30"],
        "torch_auto_detect_mode.py": [cap, "8000000", "uint8"],
        "torch_multi_target.py": ["3"],
        "torch_multi_channel.py": ["4"],
    }
    dirs, procs, out = {}, {}, {}
    t0 = time.perf_counter()
    for name, args in cases.items():  # all together, each in a directory of its own
        for device in ("cuda", "cpu"):
            dirs[name, device] = d = os.path.join(tmp, f"{name}.{device}")
            os.makedirs(d)
            procs[name, device] = run_example([name, *args], d, device)
    for (name, device), proc in procs.items():
        out[name, device] = finished(proc, f"{name} on {device}")
    wall_s = time.perf_counter() - t0

    rows = {}
    card, cpu = out["torch_replay_capture.py", "cuda"], out["torch_replay_capture.py", "cpu"]
    saved = {d: sorted(os.listdir(os.path.join(dirs["torch_replay_capture.py", d], "frames")))
             for d in ("cuda", "cpu")}
    assert saved["cuda"] == saved["cpu"] and saved["cuda"], saved
    for name in saved["cuda"]:  # 8-bit snapshots: within one grey level
        a, b = (np.frombuffer(open(os.path.join(dirs["torch_replay_capture.py", d], "frames",
                                                name), "rb").read(), np.uint8)
                for d in ("cuda", "cpu"))
        assert a.shape == b.shape and np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
    frames_of = lambda lines: [l for l in lines if l.startswith("done:")][0].split("/ ")[-1]  # noqa
    assert frames_of(card) == frames_of(cpu) == "30 frames)", (card[-1], cpu[-1])
    rows["torch_replay_capture.py"] = dict(frames=30, snapshots=saved["cuda"])

    card, cpu = out["torch_auto_detect_mode.py", "cuda"], out["torch_auto_detect_mode.py", "cpu"]
    detected = [l for l in card if l.startswith("detected:")]
    assert detected and detected == [l for l in cpu if l.startswith("detected:")], (card, cpu)
    assert "60.00 Hz" in detected[0], detected
    streamed = [l for l in card if l.startswith("streamed")]
    assert streamed and "at 628 lines @ 60 Hz" in streamed[0], streamed
    assert streamed[0].split(";")[0] == [
        l for l in cpu if l.startswith("streamed")][0].split(";")[0], (card, cpu)
    ranges_agree(streamed, [l for l in cpu if l.startswith("streamed")], "auto_detect")
    rows["torch_auto_detect_mode.py"] = dict(detected=detected[0], streamed=streamed[0])

    card, cpu = out["torch_multi_target.py", "cuda"], out["torch_multi_target.py", "cpu"]
    assert card[0].replace("on cuda:0", "on cpu").replace("on cuda", "on cpu") == cpu[0], (card, cpu)
    ranges_agree(card[1:], cpu[1:], "multi_target")
    rows["torch_multi_target.py"] = dict(line=card[0])

    card, cpu = out["torch_multi_channel.py", "cuda"], out["torch_multi_channel.py", "cpu"]
    assert "['cuda:0']" in card[0] and "['cpu']" in cpu[0], (card[0], cpu[0])
    assert card[0].split(" on ")[0] == cpu[0].split(" on ")[0], (card[0], cpu[0])
    assert card[0].split(": ")[-1] == cpu[0].split(": ")[-1] == "4 channels produced frames"
    ranges_agree(card[1:], cpu[1:], "multi_channel")
    rows["torch_multi_channel.py"] = dict(line=card[0])
    rows["all eight runs"] = dict(wall_s=wall_s)
    rows["torch_reference_plugin.py"] = ("not run: it loads a plugin built from the "
                                         "reference's sources (TSDRPlugin_RawFile), which "
                                         "are not in the repository")
    return rows


def intake_phase(smi):
    """The paths by which users feed the receiver, on the card, each held
    against a run already trusted (the CPU step, or rawfile over the same
    samples, or the foreground run): every raw format, exec, rtltcp,
    MultiSession.start_async, TSDR's background start beside a background
    warm, and the examples. A worker thread's exception fails the run.
    Returns K1's and K2's launches by path."""
    t0 = time.time()
    with worker_faults(), tempfile.TemporaryDirectory() as tmp:
        g64 = GEOMETRIES["64MS/s"]
        formats, launches = intake_formats(g64, tmp, smi)
        print(f"intake formats took {time.time() - t0:.1f} s")
        for name, cfg, fmt in (("i8", CH5, "i8"), ("i24", GEOMETRIES["8MS/s"], "i24")):
            row = exec_case(cfg, fmt, tmp)
            print(f"intake exec {name} ({smi}): " + json.dumps(row))
            launches[f"exec {name} Session {row['rate_msps']:g}MS/s, {row['blocks']} blocks"] = \
                row["k1_launches"]
        row = rtltcp_case(tmp)
        print(f"intake rtltcp ({smi}): " + json.dumps(row))
        launches[f"rtltcp TSDR 2.4MS/s, {row['blocks']} blocks"] = \
            row["k1_launches_under_profiler"]
        row = multisession_async()
        print(f"intake MultiSession.start_async (8x16MS/s, {smi}): " + json.dumps(row))
        launches[f"MultiSession.start_async 8x16MS/s, {row['blocks']} blocks"] = \
            row["k1_launches_under_profiler"]
        row = tsdr_background(tmp)
        print(f"intake TSDR background start + background warm (8MS/s, {smi}): " + json.dumps(row))
        launches["TSDR restarted at the warmed geometry 8MS/s, 6 blocks"] = \
            row["k1_launches_restarted"]
        for name, row in examples_case(tmp).items():
            print(f"intake example {name}: " + json.dumps(row))
    k2 = {k: v for k, v in launches.items() if "fused" in k}
    k1 = {k: v for k, v in launches.items() if "fused" not in k}
    print(f"intake paths took {time.time() - t0:.1f} s")
    return k1, k2


# ---- phase 11: what users toggle ------------------------------------------
# Every post-process order and sync flag of the reference's PARAM registry
# (AUTOSHIFT, LOW_PASS_BEFORE_SYNC, AUTOGAIN_AFTER_PROCESSING, FRAMERATE_PLL,
# AUTOCORR_PLOTS_OFF), fast_sync and the explicit resampler choices, through
# the captured graphs at 64 MS/s (flags_phase), the channel steps
# (channel_flags_phase) and the sharded steps (sharded_phase's "time-sharded
# orders"); live flips through TSDR.set_param, with the gap and the memory of
# each (flips_phase); the command line's flag options and the terminal
# viewer's toggle keys (flags_front_doors).

FLAG_SETS = (  # name, Params, motion blur, the kernel of the table it runs (None: a plain form)
    ("F1 autogain after", Params(autogain_after_proc=True), 0.0, "K1"),
    ("F2 lowpass first", Params(lowpass_before_sync=True), 0.5, "K1"),
    ("F3 both orders", Params(autogain_after_proc=True, lowpass_before_sync=True), 0.5, "K1"),
    ("F4 autoshift", Params(autoshift=True), 0.0, "K1"),
    ("F5 fast_sync", Params(fast_sync=True), 0.0, "K1"),
    ("F6 PLL off, plots off", Params(framerate_pll=False, autocorr_plots_off=True), 0.0, "K1"),
    ("F7 fused with toggles",
     Params(resampler="fused", autogain_after_proc=True, autoshift=True), 0.0, "K2"),
    ("F8 every toggle", Params(resampler="pallas", fir_lowpass_taps=31, lowpass_before_sync=True,
                               autogain_after_proc=True, autoshift=True, fast_sync=True), 0.5, "K3"),
    ("F9 strided", Params(resampler="strided"), 0.0, None),
    ("F9 chunked", Params(resampler="chunked"), 0.0, None),
)
FLAG_BLOCKS = 12  # 4 for F9's plain forms


def changed(params):
    """The fields of params that differ from Params()'s."""
    return {k: v for k, v in vars(params).items() if v != getattr(Params(), k)}


def flag_session(cfg, params, blocks, motionblur, batch=1, count=False):
    """source_session over the pre-made uint8 blocks: (frames, ms a block
    by host clock, the session, launches on the card under the profiler or
    None)."""
    src = ReplayU8(cfg, render_test_pattern(cfg.height, cfg.width // 2), 0)
    src.blocks = blocks
    frames, sess, dt, launches = source_session(cfg, params, src, count, motionblur, batch)
    return frames, dt / len(blocks) * 1e3, sess, launches


def valid_frames(outs):
    """The valid frames of outputs stacked over the blocks, in stream order."""
    return [f for b in range(outs.frame_valid.shape[0])
            for _, f in _valid_frames(StepOutputs(*(x[b] for x in outs)))]


def flag_set(cfg, name, params, motionblur, kid, blocks, batches=(1,)):
    """One set of FLAG_SETS over the blocks, every block at `motionblur`:
    (a) the card's eager step against the CPU step block by block (every
    integer output and carry exact, frames within the path's tolerance),
    then Session at each batch size: its frames the eager step's bit for
    bit, and within the tolerance of the CPU step's with the carries
    exact; (b) the block runner at each batch size, its IF-node replays bit
    for bit the eager step and its bodies counted against the rounds and
    frames (hold_replays), (d) each replay under set_sync_debug_mode("error");
    (c) the set's kernel once a block by the profiler and no other kernel
    of the table. Also ms a block by host clock in turns with Params() (the
    same blocks and blur), device ms a block under the profiler, and under
    autoshift the two gathers' device ms on a frame."""
    n, fir = len(blocks), params.fir_lowpass_taps
    tol = STEP_TOL["pallas"] if kid == "K3" else GRAPH_TOL
    want = {KERNELS[kid][0].__name__: n} if kid else {}
    ctls = [(0, 0, motionblur)] * n
    raws = [torch.from_numpy(b).to(DEV) for b in blocks]
    cpu_state, cpu = stepped(make_step(cfg, params, device="cpu"),
                             init_state(cfg, fir, device="cpu"),
                             [torch.from_numpy(b) for b in blocks], ctls)
    state, eager = stepped(make_step(cfg, params, device=DEV), init_state(cfg, fir, device=DEV),
                           raws, ctls)
    worst = held_to_cpu(eager, cpu, f"{name}: the eager step", tol)
    same_ints(state, cpu_state, f"{name}: the eager step's carries")
    frames_eager, frames_cpu = valid_frames(eager), valid_frames(cpu)

    ms, held, device_ms = {"Params()": [], name: []}, {}, {}
    for batch in batches:
        for p in (Params(), params):
            warm_compile_step(cfg, p, batch_blocks=batch, raw_dtype=np.uint8, device=DEV)
        if batch == 1:
            for label, p in (("Params()", Params()), (name, params), (name, params),
                             ("Params()", Params())) * 2:
                ms[label].append(flag_session(cfg, p, blocks, motionblur)[1])
        got, _, sess, launches = flag_session(cfg, params, blocks, motionblur, batch, count=True)
        only(launches, **want)
        same_frames(got, frames_eager, f"{name}: Session batch {batch} under the profiler")
        held[batch] = held_to_cpu_step(got, sess.state, frames_cpu, cpu_state,
                                       f"{name}: Session batch {batch}", tol)
        device_ms[batch] = dict(device_ms=launches.device_ms / n,
                                transfer_ms=launches.transfer_ms / n,
                                wall_ms=launches.wall_ms / n)
    graphs = [hold_replays(f"{name}: BlockRunner K={k}, {n} blocks",
                           BlockRunner(cfg, params, k, DEV), raws, ctls) for k in batches]
    row = dict(set=name, params=changed(params), motionblur=motionblur, kernel=kid, blocks=n,
               frames=len(frames_eager), rounds=int(eager.ac_plot_valid.sum()),
               launches={k: v for k, v in launches.items() if v} if kid else {
                   "table kernels": sum(launches.values())},
               worst_frame_diff_vs_cpu=max(worst, *held.values()), tol=tol,
               graphs=[dict(graph=g["graph"], census=g["census"],
                            after_capture_mb=g["memory"]["after_capture_bytes"] / 2**20,
                            capture_peak_mb=g["memory"]["capture_peak_bytes"] / 2**20,
                            bodies=g["bodies"]["counted"]) for g in graphs],
               ms_a_block_host_clock_in_turns=ms,
               ms_a_block_median={k: float(np.median(v)) for k, v in ms.items()},
               under_profiler_a_block=device_ms)
    if params.autoshift:
        b = int(eager.frame_valid.nonzero()[0, 0])
        frame, sx, sy = eager.frame[b], state.sync_x, state.sync_y
        row["autoshift_gathers_ms_flushed"] = time_launches(
            lambda: pipeline_mod._sync_apply(pipeline_mod._post_spec(cfg, params), frame, sx, sy))
    return row


def flags_phase(smi):
    """Phase 11a: FLAG_SETS at 64 MS/s (flag_set; F3 at batch 1 and 4).
    Returns the launches of K1, K2 and K3 by path."""
    t0 = time.time()
    cfg = GEOMETRIES["64MS/s"]
    blocks = ReplayU8(cfg, render_test_pattern(cfg.height, cfg.width // 2), FLAG_BLOCKS).blocks
    by_path = {"K1": {}, "K2": {}, "K3": {}}
    # what the sets' device ms a block under the profiler are read against
    warm_compile_step(cfg, Params(), batch_blocks=1, raw_dtype=np.uint8, device=DEV)
    default_ms = flag_session(cfg, Params(), blocks, 0.0, count=True)[3].device_ms / FLAG_BLOCKS
    print(f"flags Params() (64MS/s, {smi}): device ms a block under the profiler "
          f"{default_ms}", flush=True)
    for name, params, motionblur, kid in FLAG_SETS:
        nb = FLAG_BLOCKS if kid else 4
        row = flag_set(cfg, name, params, motionblur, kid, blocks[:nb],
                       (1, 4) if name.startswith("F3") else (1,))
        print(f"flags {name} (64MS/s, {smi}): " + json.dumps(row), flush=True)
        if kid:
            by_path[kid][f"flags {name} Session 64MS/s, {nb} blocks"] = \
                row["launches"][KERNELS[kid][0].__name__]
    print(f"flags phase took {time.time() - t0:.1f} s")
    return by_path


CHANNEL_FLAG_SETS = (  # tests/test_torch_channels.py's non-default sets; motion blur
    ("autoshift", Params(autoshift=True), 0.0),
    ("markers + autogain after", Params(debug_markers=True, autogain_after_proc=True), 0.0),
    ("lowpass first + fast_sync", Params(lowpass_before_sync=True, fast_sync=True), 0.5),
)


def channel_flags_phase(smi, n_blocks=4):
    """Phase 11b: the channel steps under the flags. Config 5 (8 channels at
    16 MS/s): per set of CHANNEL_FLAG_SETS the ChannelRunner's replays bit
    for bit its eager channel step with the bodies counted (hold_replays: a
    drop on channel 1, the set's blur on every channel), and MultiSession
    over one replay a block (K1 once per channel a block by the profiler,
    every channel's frames the eager step's); then the gated form (C = 3 at
    8 MS/s, K = 4) under lowpass first + fast_sync against the CPU's channel
    step (integers exact, frames within CHANNEL_TOL), its replays bit for
    bit its eager step. Returns K1's launches by path."""
    t0 = time.time()
    srcs = channel_sources(CH5, N_CH, n_blocks)
    blocks = channel_blocks(srcs)
    raws = [torch.from_numpy(b).to(DEV) for b in blocks]
    by_path = {}
    for name, params, motionblur in CHANNEL_FLAG_SETS:
        ctls = [np.tile([0.0, 0.0, motionblur], (N_CH, 1)) for _ in blocks]
        ctls[1][1, 0] = 37777  # channel 1 drops before block 1
        # the runner MultiSession takes from the cache: captured (and held) here
        runner = MultiSession(CH5, params, srcs, device=DEV)._runner
        graph = hold_replays(f"ChannelRunner config 5 {name}, {n_blocks} blocks", runner, raws,
                             ctls)
        profiled = graph["bodies"]["profiler"]
        held = multisession_held(CH5, srcs, n_blocks, params,
                                 (profiled["per_round_body"], profiled["per_emit_body"]))
        print(f"channel flags {name} (8x16MS/s, {smi}): " + json.dumps(dict(
            params=changed(params), motionblur=motionblur, census=graph["census"],
            after_capture_mb=graph["memory"]["after_capture_bytes"] / 2**20,
            capture_peak_mb=graph["memory"]["capture_peak_bytes"] / 2**20,
            bodies=graph["bodies"], multisession=held)), flush=True)
        by_path[f"MultiSession 8x16MS/s {name}, {n_blocks} blocks"] = held["k1_launches"]
    g8 = GEOMETRIES["8MS/s"]
    params = Params(lowpass_before_sync=True, fast_sync=True)
    gated = RunnerStep(MultiStepRunner(g8, params, 3, DEV))
    worst = hold_channels(
        "gated graph (make_multi_step, 8MS/s, C=3) vs the CPU's channel step, lowpass first "
        "+ fast_sync", [(gated, DEV), (ChannelsStep(g8, params, 3, "cpu", cond_mode="batched"),
                                       "cpu")],
        g8, 3, channel_blocks(channel_sources(g8, 3, n_blocks)), CHANNEL_TOL, motionblur=0.5)
    replays_held(gated, "gated graph under lowpass first + fast_sync")
    print("channel flags gated (8MS/s, C=3, K=4, lowpass first + fast_sync, blur 0.5) "
          + json.dumps(dict(card=smi, blocks=n_blocks, card_vs_cpu_max_abs=worst,
                            tol=CHANNEL_TOL, census=gated.runner.census())))
    print(f"channel flags took {time.time() - t0:.1f} s")
    return by_path


# what a user toggles, in order, through the API (the GUI's buttons, the
# TUI's keys, the command line's options); then each back, in reverse
FLIP_CYCLE = ((PARAM.AUTOSHIFT, 1), (PARAM.LOW_PASS_BEFORE_SYNC, 1),
              (PARAM.AUTOGAIN_AFTER_PROCESSING, 1), (PARAM.FRAMERATE_PLL, 0),
              (PARAM.AUTOCORR_PLOTS_OFF, 1), ("fast_sync", True),
              (PARAM.NEAREST_NEIGHBOUR_RESAMPLING, 1))
FLIP_EVERY = 2  # frames between two flips


def flip_run(cfg, device, had):
    """TSDR in the foreground on the looping synthetic source (batch 1,
    motion blur 0.5): FLIP_CYCLE and back, twice, through set_param and
    set_extra_params from on_frame every FLIP_EVERY frames, so each flip
    lands on a known block. Returns the frames, the TSDR, the wall seconds
    and per flip: the toggle, its cycle, the graphs the block after it
    captured, that block's ms (from the flip's apply at the block's arrival
    to the end of its dispatch, fetch and downloads) and, on the card, the
    memory allocated before and after it and reserved after it. `had`
    gains, for each Params the run visits, the raw dtypes its cached runner
    held a graph for before the run."""
    back = [(k, (not v) if isinstance(k, str) else 1 - v) for k, v in reversed(FLIP_CYCLE)]
    cycle = list(FLIP_CYCLE) + back
    schedule = cycle * 2
    n_frames = FLIP_EVERY * (len(schedule) + 1)
    card = torch.device(device).type == "cuda"
    frames, flips, captures, pending = [], [], [], {}
    rx = TSDR(block_samples=cfg.block_samples, device=device)
    rx.load_source("synthetic", f"{cfg.height} {cfg.width // 2} {cfg.refreshrate} "
                                f"{cfg.samplerate} 0.02")
    rx.set_resolution(cfg.height, cfg.refreshrate)
    rx.set_motionblur(0.5)

    def on_frame(f):
        frames.append(f)
        i, due = divmod(len(frames), FLIP_EVERY)
        if due == 0 and 1 <= i <= len(schedule):
            key, value = schedule[i - 1]
            flips.append(dict(flip=f"{getattr(key, 'name', key)} {int(value)}",
                              cycle=1 + (i - 1) // len(cycle)))
            if isinstance(key, str):
                rx.set_extra_params(**{key: value})
            else:
                rx.set_param(int(key), value)
            flips[-1]["params"] = rx._params

    real_apply, real_dispatch = Session._apply_pending_params, Session._dispatch_blocks
    real_capture = BlockRunner._capture

    def apply(self):
        pending.update(t0=time.perf_counter(), flip=flips[-1], captures=len(captures))
        if card:
            flips[-1]["allocated_before_mb"] = torch.cuda.memory_allocated(DEV) / 2**20
        real_apply(self)

    def dispatch(self, raws, dropped):
        got = real_dispatch(self, raws, dropped)
        if "t0" in pending:
            flip = pending.pop("flip")
            flip.update(first_block_ms=(time.perf_counter() - pending.pop("t0")) * 1e3,
                        captured=len(captures) - pending.pop("captures"))
            if card:
                flip.update(allocated_after_mb=torch.cuda.memory_allocated(DEV) / 2**20,
                            reserved_after_mb=torch.cuda.memory_reserved(DEV) / 2**20)
        return got

    def capture(self, dtype):
        captures.append((self.params, dtype))
        return real_capture(self, dtype)

    p = Params()
    for key, value in [(None, 0)] + schedule:
        if key is not None:
            p = p.replace(**{key: value}) if isinstance(key, str) else p.with_int_param(key, value)
        had[p] = graphs_of(cfg, p) if card else set()
    Session._apply_pending_params, Session._dispatch_blocks = apply, dispatch
    BlockRunner._capture = capture
    try:
        t0 = time.perf_counter()
        got = rx.start(on_frame=on_frame, max_frames=n_frames)
        if card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Session._apply_pending_params, Session._dispatch_blocks = real_apply, real_dispatch
        BlockRunner._capture = real_capture
    assert got == len(frames) == n_frames, (got, len(frames), n_frames)
    assert len(flips) == len(schedule) and all("first_block_ms" in f for f in flips), flips
    assert int(rx.session.state.frame_count) == n_frames, int(rx.session.state.frame_count)
    assert rx.session.params == Params(), rx.session.params
    return frames, rx, wall, flips


def flips_phase(smi):
    """Phase 11c: flip_run at 64 MS/s on the card and on the CPU. Held: as
    many frames, each within GRAPH_TOL of the CPU's (the first after each
    lowpass_before_sync flip shows the zeroed screen buffer in both), the
    carries exact, the frame counter counting on across every flip; the
    first cycle captures one graph for each Params it has not run before and
    the second none; the memory allocated and reserved after the second
    cycle no more than after the first. Reports each flip's first block (a
    capture in the first cycle where the Params is new: cold; warm
    otherwise) and its memory, and the MB a new cached runner adds."""
    cfg = GEOMETRIES["64MS/s"]
    # the raw dtypes each Params' cached runner holds a graph for before the run
    had = {}
    frames, rx, wall, flips = flip_run(cfg, DEV, had)
    frames_cpu, rx_cpu, wall_cpu, _ = flip_run(cfg, "cpu", {})
    worst = held_to_cpu_step(frames, rx.session.state, frames_cpu, rx_cpu.session.state,
                             "flips card vs CPU")
    # the first cycle captures, at the block after a flip, the float32 graph
    # of each Params that had none; the second captures nothing
    visited = {Params()}
    for f in flips:
        new = f["params"] not in visited and torch.float32 not in had[f["params"]]
        assert f["captured"] == int(new), f
        visited.add(f["params"])
    half = len(flips) // 2
    first, second = flips[:half], flips[half:]
    assert sum(f["captured"] for f in second) == 0, second
    cold = [f for f in first if f["captured"]]
    new_mb = [f["allocated_after_mb"] - f["allocated_before_mb"] for f in cold]
    end1, end2 = first[-1], second[-1]
    assert end2["allocated_after_mb"] <= end1["allocated_after_mb"], (end1, end2)
    assert end2["reserved_after_mb"] <= end1["reserved_after_mb"], (end1, end2)
    for f in flips:
        f["params"] = changed(f["params"])
    row = dict(card=smi, blocks=rx.session.meter.total_samples // cfg.block_samples,
               frames=len(frames), flips=len(flips), card_wall_s=wall, cpu_wall_s=wall_cpu,
               max_abs_vs_cpu=worst, captures_cycle_1=len(cold), captures_cycle_2=0,
               cold_first_block_ms=[f["first_block_ms"] for f in cold],
               warm_first_block_ms_cycle_2=[f["first_block_ms"] for f in second],
               new_runner_allocated_mb=new_mb,
               reserved_mb_after_cycle=[end1["reserved_after_mb"], end2["reserved_after_mb"]],
               allocated_mb_after_cycle=[end1["allocated_after_mb"], end2["allocated_after_mb"]],
               per_flip=flips)
    print("flips (TSDR.set_param at 64MS/s, card against CPU) " + json.dumps(row), flush=True)
    return row


def cli_under_flags(cfg, tmp, n_blocks=8):
    """cli.main with --autoshift --fast-sync --no-pll --motionblur 0.5 over
    a 64 MS/s uint8 capture: K1 once a block (and once more for the eager
    block ahead of the new Params' capture), every frame saved and equal bit
    for bit to a hand-built Session's with the same Params and blur."""
    path = os.path.join(tmp, "flags64.u8")
    _, capture = write_capture(cfg, path, n_blocks)
    out = os.path.join(tmp, "flag_frames")
    with card_counts() as launches:
        log, dt = run_cli([
            "--source", "rawfile", "--source-params", f"{path} {cfg.samplerate} uint8",
            "--block-samples", str(cfg.block_samples), "--height", str(cfg.height),
            "--rate", str(cfg.refreshrate), "--out", out, "--save-every", "1", "--format", "npy",
            "--blocks", str(n_blocks), "--autoshift", "--fast-sync", "--no-pll",
            "--motionblur", "0.5", "--device", str(DEV)])
    k1 = launches["box_resample_strided_cuda"]
    assert n_blocks <= k1 <= n_blocks + 1, launches
    only(launches, box_resample_strided_cuda=k1)
    params = Params(autoshift=True, fast_sync=True, framerate_pll=False)
    want = flag_session(cfg, params, capture, 0.5)[0]
    saved = sorted(os.listdir(out))
    assert saved == [f"frame_{i:06d}.npy" for i in range(1, len(want) + 1)], saved
    same_frames([np.load(os.path.join(out, f)) for f in saved], want, "cli under the flags")
    return dict(blocks=n_blocks, frames=len(saved), k1_launches=k1,
                per_block_ms_under_profiler=dt / n_blocks * 1e3, log=log[-1])


TUI_KEYS = (("s", "Autoshift: on"), ("a", "PLL: off"), ("f", "Fast sync (f32): on"),
            ("o", "Autocorr off: on"))


def tui_toggles_over_pty(cfg, max_blocks=4000):
    """cli.main([... "--tui" ...]) at 8 MS/s on the card over a pty, the
    keys of TUI_KEYS typed one by one mid-run, 0.3 s apart once frames
    stream, then q once three more frames came: every toggle on the status
    bar and in the TSDR's Params, the loop streaming past the last, K1
    once a block (and once for each capture's eager block), no worker
    thread raising."""
    rxs, real_run_tui = [], tui_mod.run_tui

    def run_tui(rx, **kw):
        rxs.append(rx)
        return real_run_tui(rx, **kw)

    sent = []
    tui_mod.run_tui = run_tui
    try:
        with worker_faults(), pty_terminal() as (master, out), \
                session_frames((cfg.height, cfg.width)) as frames, card_counts() as launches:
            def press():
                def wait_for(n, limit=60.0):
                    t_end = time.time() + limit
                    while len(frames) < n and time.time() < t_end:
                        time.sleep(0.01)
                    return len(frames) >= n

                wait_for(1)
                for key, _ in TUI_KEYS:
                    time.sleep(0.3)
                    sent.append((key, len(frames)))
                    os.write(master, key.encode())
                wait_for(sent[-1][1] + 3)
                os.write(master, b"q")

            presser = threading.Thread(target=press, daemon=True)
            presser.start()
            rc = cli.main([
                "--source", "synthetic", "--source-params",
                f"{cfg.height} {cfg.width // 2} {cfg.refreshrate} {cfg.samplerate} 0.02",
                "--block-samples", str(cfg.block_samples), "--height", str(cfg.height),
                "--rate", str(cfg.refreshrate), "--tui", "--blocks", str(max_blocks),
                "--batch-blocks", "1", "--device", str(DEV)])
            presser.join(timeout=30)
    finally:
        tui_mod.run_tui = real_run_tui
    text = b"".join(out).decode(errors="replace")
    assert rc == 0, rc
    assert len(sent) == len(TUI_KEYS), sent
    for key, osd in TUI_KEYS:
        assert osd in text, (key, osd, text[-500:])
    rx = rxs[0]
    assert rx._params == Params(autoshift=True, framerate_pll=False, fast_sync=True,
                                autocorr_plots_off=True), rx._params
    assert len(frames) >= sent[-1][1] + 3, (len(frames), sent)
    blocks = rx.session.meter.total_samples // cfg.block_samples
    assert blocks < max_blocks, blocks  # q, not the block limit, ended the run
    k1 = launches["box_resample_strided_cuda"]
    assert blocks <= k1 <= blocks + 1 + len(TUI_KEYS), (blocks, launches)
    only(launches, box_resample_strided_cuda=k1)
    return dict(blocks=int(blocks), frames=len(frames), keys_at_frame=sent, k1_launches=k1,
                params=changed(rx._params))


def flags_front_doors(smi):
    """Phase 11d: the command line under flag options at 64 MS/s and the
    terminal viewer's toggle keys at 8 MS/s. Returns K1's launches by path."""
    with tempfile.TemporaryDirectory() as tmp:
        row = cli_under_flags(GEOMETRIES["64MS/s"], tmp)
    print("cli under the flags (64MS/s, --autoshift --fast-sync --no-pll --motionblur 0.5) "
          + json.dumps(dict(card=smi, **row)))
    tui = tui_toggles_over_pty(GEOMETRIES["8MS/s"])
    print("tui toggle keys over a pty (8MS/s) " + json.dumps(dict(card=smi, **tui)))
    return {f"cli --autoshift --fast-sync --no-pll 64MS/s, {row['blocks']} blocks": row[
        "k1_launches"], f"tui toggles 8MS/s, {tui['blocks']} blocks": tui["k1_launches"]}


# ---- phase 12: the live path ----------------------------------------------
# Sources that push on the radio's own clock into the native ring, which
# drops whole pushes when the receiver falls behind: the reference's binary
# plugin ABI through the repo's replay plugin (native/replay_plugin.c, built
# with gcc; a fixture that stands in for a user's compiled plugin) and
# simlive, through Session, MultiSession, TSDR and cli.main. Every live run
# but the pace sweeps' is recorded by a TeeSource and held against the CPU
# step over that recording (held_live: integers and carries exact, frames
# within GRAPH_TOL), never against a second live run; the gaps of a replay
# plugin's recording are found in its capture (gaps_in: each drop whole
# pushes, reported once, on the first block of data after it). The sweeps
# are not recorded: they give each pace's drop share and ms a block, and
# the rate each producer reached (producer_rate), so that a pace its
# producer fell short of counts as the producer's, never the receiver's.

LIVE_BLOCKS = 24
LIVE_PUSH = 512 * 1024 // 2  # IQ samples a push: the plugin's default, the reference's 512 x 1024 floats
LIVE_TAIL = 1000  # samples past the last whole block: no gap is a whole loop of the capture
LIVE_LIMIT_S = 120  # each live run's own wall-clock limit
LIVE_PACES = (0.5, 0.8, 1.0, 1.25, 1.5, 2.0)
SWEEP_SIGNAL_S = 2.0  # of signal a run of the pace sweep (cut from 3 s for the script's time)
CH5_PACES = (0.5, 0.8, 1.25)  # config 5's sweep, beside its held run at pace 1
CH5_SWEEP_BLOCKS = 12
OVERLOAD_FRAME_S = 0.02  # the overload runs' frame handler (a display or writer slower than
# the radio): an unthrottled plugin's GIL-bound callbacks alone need not outrun the receiver
PLUGIN_TOL = 2e-5  # cplugin against rawfile over one capture (tests/test_cplugin.py:192-193)
LIVE_FORMATS = (("uint8", np.uint8, "uint8"), ("int16", np.int16, "int16"),
                ("float32", np.float32, "float"))  # the plugin's name, dtype, rawfile's name
INJECTED = ((5, 1, 123457), (10, 2, 1000000), (15, 0, 77777))  # block, its push after the
# gap, samples skipped: slots 1, 2 and 3 of a batch of 4
PRODUCER_REACHED = 0.95  # a producer reached its pace when it pushed at least this share of
# pace x rate between its own first and last push (a paced plugin's pushes keep a deadline each)


def plugin_stats(src):
    """The replay plugin's own counters (native.replay_plugin_stats)."""
    return native.replay_plugin_stats(src._dll)


def producer_rate(srcs, cfg, pace):
    """The rate each replay plugin of `srcs` pushed at, in MS/s, between
    its own first and last push (a plugin starts when its stream is first
    read, so a run's wall time is no measure of it), and whether every one
    reached PRODUCER_REACHED of pace x the config's rate (pace 0,
    unthrottled, has no rate to reach)."""
    msps = []
    for s in srcs:
        st = plugin_stats(s)
        span = st["last_push_s"] - st["first_push_s"]
        assert st["pushes"] >= 2 and span > 0, st
        msps.append(st["samples_pushed"] * (st["pushes"] - 1) / st["pushes"] / span / 1e6)
    want = pace * cfg.samplerate / 1e6
    return dict(producer_msps=msps if len(msps) > 1 else msps[0],
                producer_reached_pace=bool(pace) and min(msps) >= PRODUCER_REACHED * want)


def highest_clean_pace(runs):
    """The live path's real-time factor: the highest pace of a sweep (rows
    with pace, drop_share and producer_reached_pace) up to which every pace
    ran with no drop and with its producer at its pace; None when the
    lowest did not."""
    best = None
    for r in sorted(runs, key=lambda r: r["pace"]):
        if r["drop_share"] or not r["producer_reached_pace"]:
            break
        best = r["pace"]
    return best


@contextlib.contextmanager
def live_limit(what, *stop, limit=LIVE_LIMIT_S):
    """The enclosed live run's own wall-clock limit: when it is reached,
    every `stop` is called (a session's or a source's; a readasync that
    ignored stop would hang the script) and the run fails."""
    hit = []

    def fire():
        hit.append(limit)
        for s in stop:
            s()

    timer = threading.Timer(limit, fire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()
    assert not hit, f"{what}: the live run reached its limit of {limit} s"


def live_capture(cfg, dtype, n_samples, path, twidth=None):
    """A capture of the synthetic emanation (as emanation makes it) of
    n_samples at cfg's rate, written to path; returns the float32 values
    the replay plugin delivers for it (normalize_iq's)."""
    raster = render_test_pattern(cfg.height, twidth or cfg.width // 2)
    iq = synth_iq(raster * 0.6, samplerate=cfg.samplerate, pixelclock=raster.size * cfg.refreshrate,
                  n_samples=n_samples, dc=0.3, noise=0.02, dtype=dtype)
    iq.tofile(path)
    return normalize_iq(torch.from_numpy(iq)).numpy()


def plugin_source(so, path, cfg, fmt="uint8", loader="", **opts):
    """load_source("cplugin") over the replay plugin `so` replaying path."""
    extra = "".join(f" {k}={v}" for k, v in opts.items())
    return load_source("cplugin", f"{so} {loader} -- {path} {int(cfg.samplerate)} {fmt}{extra}")


def cpu_channel_replay(cfg, recordings):
    """The channel step on the CPU over one recording per channel, each
    block with its channel's drop: per channel its frames, and the final
    stacked state."""
    step = make_channels_step_hybrid(cfg, Params(), len(recordings), device="cpu")
    blocks = [np.stack([np.asarray(b.samples) for b in blks]) for blks in zip(*recordings)]
    drops = [[b.dropped for b in blks] for blks in zip(*recordings)]
    per, _, state = eager_channel_frames(step, blocks, drops)
    return per, state


def held_live(cfg, run, what, capture=None):
    """A live run ({frames, sess, tee}) against the CPU step over its
    recording: the drops the session counted those recorded, integers and
    carries exact, frames within GRAPH_TOL; with `capture` (the values a
    replay plugin delivers), every gap where gaps_in finds it. Returns the
    worst frame difference."""
    rec = run["tee"].blocks
    assert run["sess"].samples_dropped_total == run["tee"].samples_dropped, what
    if capture is not None:
        gaps_in(rec, capture, LIVE_PUSH)
    want, want_state = cpu_step(cfg, Params(), [np.asarray(b.samples) for b in rec],
                                [b.dropped for b in rec])
    return held_to_cpu_step(run["frames"], run["sess"].state, want, want_state, what)


def live_session(cfg, source, batch=1, n_blocks=LIVE_BLOCKS, count=False, split=False,
                 record=True, frame_s=0.0, what="live Session"):
    """Session(batch_blocks=batch).run over a live source on the card (its
    float32 graph warmed first), recorded by a TeeSource unless `record` is
    False, bounded by live_limit, under the profiler with `count`, with the
    host clock read around the runner's run (upload + replay), the packed
    fetch and the downloads with `split`, a frame handler that takes
    frame_s seconds. Returns a dict of the run."""
    warm_compile_step(cfg, Params(), batch_blocks=batch, raw_dtype=np.float32, device=DEV)
    tee = TeeSource(source) if record else None
    frames, errors = [], []

    def on_frame(frame):
        frames.append(frame)
        time.sleep(frame_s)

    sess = Session(cfg, Params(), tee or source,
                   SessionCallbacks(on_frame=on_frame, on_exception=errors.append),
                   batch_blocks=batch, device=DEV)
    spent = {}
    undo = [_timed(BlockRunner, "run", spent), _timed(torch.Tensor, "tolist", spent),
            _timed(session_mod, "_download", spent)] if split else []
    try:
        torch.cuda.synchronize()
        with live_limit(what, sess.stop), \
                (card_counts() if count else contextlib.nullcontext(None)) as launches:
            t0 = time.perf_counter()
            sess.run(max_blocks=n_blocks)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for u in undo[::-1]:
            u()
    assert not errors, (what, errors)
    drops = [b.dropped for b in tee.blocks] if tee else None
    assert tee is None or len(drops) == n_blocks, (what, len(drops))
    signal = n_blocks * cfg.block_samples / cfg.samplerate
    row = dict(batch=batch, blocks=n_blocks, frames=len(frames), wall_s=wall, signal_s=signal,
               ms_a_block=wall / n_blocks * 1e3, samples_dropped=sess.samples_dropped_total,
               drop_share=sess.samples_dropped_total / (
                   n_blocks * cfg.block_samples + sess.samples_dropped_total))
    if tee:
        row.update(blocks_with_a_drop=[b for b, d in enumerate(drops) if d],
                   slots_with_a_drop=sorted({b % batch for b, d in enumerate(drops) if d}),
                   pushes_dropped=[d / LIVE_PUSH for d in drops if d],
                   source_ms_a_block=sum(tee.wait_s) / n_blocks * 1e3)
    if split:
        names = {"run": "upload + replay", "tolist": "packed fetch (waits for the replay)",
                 "_download": "frame downloads"}
        row["split_ms_a_block"] = {names[k]: v * 1e3 / n_blocks for k, v in spent.items()}
        row["split_ms_a_block"]["source (its copies, and waiting for the ring)"] = \
            row["source_ms_a_block"]
        row["split_ms_a_block"]["the rest"] = row["ms_a_block"] - sum(
            row["split_ms_a_block"].values())
    if count:
        only(launches, box_resample_strided_cuda=n_blocks)
        row["k1_launches"] = launches["box_resample_strided_cuda"]
    return dict(row=row, frames=frames, sess=sess, tee=tee)


def plugin_formats(cfg, so, tmp, smi):
    """cplugin drop-free (block=1) at 64 MS/s in uint8, int16 and float32,
    at batch 1 and 4: every block the capture's (gaps_in: none), frames
    within PLUGIN_TOL of rawfile's over the same capture, integers and
    carries equal. Returns the uint8 capture (path, values) and the uint8
    batch-1 run's recording and K1 launches."""
    keep = {}
    for fmt, dtype, raw_fmt in LIVE_FORMATS:
        path = os.path.join(tmp, f"live.{fmt}")
        n = LIVE_BLOCKS * cfg.block_samples + (LIVE_TAIL if fmt == "uint8" else 0)
        values = live_capture(cfg, dtype, n, path)
        ref, ref_sess, _, _ = source_session(
            cfg, Params(), load_source("rawfile", f"{path} {cfg.samplerate} {raw_fmt} noloop"),
            max_blocks=LIVE_BLOCKS)
        rows = {}
        for batch in (1, 4):
            src = plugin_source(so, path, cfg, fmt, "block=1")
            count = fmt == "uint8" and batch == 1
            run = live_session(cfg, src, batch, count=count, what=f"cplugin {fmt} block=1")
            assert plugin_stats(src)["active"] == 0, "readasync did not return"
            assert run["row"]["samples_dropped"] == 0 and gaps_in(
                run["tee"].blocks, values, LIVE_PUSH) == [], fmt
            assert len(run["frames"]) == len(ref) > 0, (fmt, len(run["frames"]), len(ref))
            err = max(float(np.abs(a - b).max()) for a, b in zip(run["frames"], ref))
            assert err <= PLUGIN_TOL, (fmt, batch, err)
            same_ints(run["sess"].state, ref_sess.state, f"cplugin {fmt} batch {batch}")
            rows[f"batch {batch}"] = dict(run["row"], max_abs_err_vs_rawfile=err)
            if count:
                keep.update(recording=run["tee"].blocks, k1=run["row"]["k1_launches"])
        print(f"live cplugin {fmt} block=1 against rawfile (64MS/s, {smi}): " + json.dumps(rows))
        if fmt == "uint8":
            keep.update(path=path, values=values)
    return keep


def premade_rate(cfg, recording, batch, reps=3):
    """Session over pre-made float32 blocks (a drop-free recording): ms a
    block, the median of reps runs."""
    ms = []
    for _ in range(reps):
        _, _, dt, _ = source_session(cfg, Params(), RecordedSource(recording, cfg.samplerate),
                                     batch=batch)
        ms.append(dt / len(recording) * 1e3)
    return float(np.median(ms))


def plugin_paced(cfg, so, cap, smi):
    """cplugin at the radio's rate (pace=1, block=0), with gaps the plugin
    reports at slots 1, 2 and 3 of a batch of 4 (INJECTED), and overloaded
    (pace=0 and a frame handler of OVERLOAD_FRAME_S, at batch 1 and 4),
    each held against the CPU step over its recording; the overload runs
    must drop. Returns K1's launches by path."""
    path, values = cap["path"], cap["values"]
    src = plugin_source(so, path, cfg, pace=1)
    run = live_session(cfg, src, 1, split=True, what="cplugin pace=1")
    st = plugin_stats(src)
    assert st["active"] == 0, "readasync did not return"
    row = dict(run["row"], callbacks_a_second=st["pushes"] / run["row"]["wall_s"],
               **producer_rate([src], cfg, 1),
               max_abs_err_vs_cpu_replay=held_live(cfg, run, "cplugin pace=1", values))
    print(f"live cplugin pace=1 block=0 (64MS/s, {smi}): " + json.dumps(row))
    # gaps the plugin reports itself (a radio's lost samples): at slots 1,
    # 2 and 3 of a batch of 4, one inside a block, through block=1
    ppb = cfg.block_samples // LIVE_PUSH
    inject = ",".join(f"{b * ppb + k}:{n}" for b, k, n in INJECTED)
    src = plugin_source(so, path, cfg, loader="block=1", inject=inject)
    run = live_session(cfg, src, 4, what="cplugin injected gaps batch 4")
    assert gaps_in(run["tee"].blocks, values, LIVE_PUSH) == [
        (b, k * LIVE_PUSH, n) for b, k, n in INJECTED], "injected gaps misplaced"
    row = dict(run["row"], max_abs_err_vs_cpu_replay=held_live(
        cfg, run, "cplugin injected gaps batch 4"))
    assert row["slots_with_a_drop"] == [1, 2, 3], row
    print(f"live cplugin injected gaps, block=1 batch 4 (64MS/s, {smi}): " + json.dumps(row))
    launches = {}
    for batch in (1, 4):
        src = plugin_source(so, path, cfg)
        run = live_session(cfg, src, batch, count=True, frame_s=OVERLOAD_FRAME_S,
                           what=f"cplugin overload batch {batch}")
        assert plugin_stats(src)["active"] == 0, "readasync did not return"
        row = run["row"]
        assert row["samples_dropped"] > 0 and all(p == int(p) for p in row["pushes_dropped"]), row
        row["max_abs_err_vs_cpu_replay"] = held_live(cfg, run, f"cplugin overload batch {batch}",
                                                     values)
        print(f"live cplugin overload, pace=0 block=0 batch {batch}, {OVERLOAD_FRAME_S * 1e3:g} ms "
              f"a frame handled (64MS/s, under the profiler, {smi}): " + json.dumps(row))
        launches[f"cplugin overload Session 64MS/s batch {batch}, {LIVE_BLOCKS} blocks"] = \
            row["k1_launches"]
    return launches


def pace_sweep(cfg, so, cap, smi):
    """cplugin at paces LIVE_PACES, SWEEP_SIGNAL_S of signal each, at batch
    1 and 4, not recorded: the drop share, ms a block and the producer's
    rate of each; the highest pace with no drop and the producer at its
    pace (highest_clean_pace) beside the rate of pre-made blocks."""
    n = int(round(SWEEP_SIGNAL_S * cfg.samplerate / cfg.block_samples / 4)) * 4
    runs, best = [], {}
    for batch in (1, 4):
        for pace in LIVE_PACES:
            src = plugin_source(so, cap["path"], cfg, pace=pace)
            row = live_session(cfg, src, batch, n_blocks=n, record=False,
                               what=f"pace {pace} batch {batch}")["row"]
            assert plugin_stats(src)["active"] == 0, "readasync did not return"
            assert row["samples_dropped"] % LIVE_PUSH == 0, row
            runs.append(dict(pace=pace, **row, **producer_rate([src], cfg, pace)))
        best[f"batch {batch}"] = highest_clean_pace([r for r in runs if r["batch"] == batch])
    block_ms = cfg.block_samples / cfg.samplerate * 1e3
    premade = {f"batch {b}": premade_rate(cfg, cap["recording"], b) for b in (1, 4)}
    print(f"live pace sweep (64MS/s, {smi}): " + json.dumps(dict(
        runs=[{k: r[k] for k in ("pace", "batch", "blocks", "wall_s", "ms_a_block",
                                  "samples_dropped", "drop_share", "producer_msps",
                                  "producer_reached_pace")} for r in runs],
        producer_bound=[(r["pace"], r["batch"]) for r in runs if not r["producer_reached_pace"]],
        highest_pace_with_no_drop=best, premade_float32_ms_a_block=premade,
        premade_realtime_factor={k: block_ms / v for k, v in premade.items()},
        block_ms_of_signal=block_ms)))


def channel_captures(cfg, so, tmp, n_blocks):
    """One replay plugin (a copy of the .so: a plugin's state lives in its
    library) and one uint8 capture per channel, each of its own raster
    width: (plugin, capture path, the values it delivers) per channel."""
    caps = []
    for c in range(N_CH):
        so_c = os.path.join(tmp, f"replay{c}.so")
        shutil.copy(so, so_c)
        path = os.path.join(tmp, f"ch{c}.u8")
        caps.append((so_c, path, live_capture(cfg, np.uint8, n_blocks * cfg.block_samples
                                              + LIVE_TAIL, path, twidth=cfg.width // 2 + 8 * c)))
    return caps


def channels_live_run(cfg, caps, pace, n_blocks, count=False, graph=False):
    """MultiSession over the plugins of `caps` at `pace`, block=0, recorded
    by TeeSources, bounded by live_limit, under the profiler with `count`
    (K1 once per channel a block, no other kernel of the table): held
    against the CPU channel step over the recordings (every gap where
    gaps_in finds it, integers exact, frames within CHANNEL_TOL). With
    `graph`, the float32 graph's census and memory, captured first. Returns
    the run's row."""
    srcs = [plugin_source(so_c, path, cfg, pace=pace) for so_c, path, _ in caps]
    tees = [TeeSource(s) for s in srcs]
    got = [[] for _ in range(N_CH)]
    ms = MultiSession(cfg, Params(), tees, on_frame=lambda c, f: got[c].append(f), device=DEV)
    torch.cuda.synchronize()
    if graph:
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        captured = torch.float32 not in ms._runner._graphs
        ms._runner.prepare(torch.float32)
        torch.cuda.synchronize()
        graph = dict(census=ms._runner.census(torch.float32),
                     graphs=sorted(map(str, ms._runner._graphs)), captured_here=captured,
                     capture_mb=(torch.cuda.memory_allocated() - before) / 2**20,
                     capture_peak_mb=(torch.cuda.max_memory_allocated() - before) / 2**20,
                     allocated_mb=torch.cuda.memory_allocated() / 2**20)
    with live_limit(f"config 5 live pace={pace}", ms.stop), \
            (card_counts() if count else contextlib.nullcontext(None)) as launches:
        t0 = time.perf_counter()
        ms.run(max_blocks=n_blocks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for s in srcs:
        assert plugin_stats(s)["active"] == 0, "readasync did not return"
    recs = [t.blocks for t in tees]
    assert all(len(r) == n_blocks for r in recs), [len(r) for r in recs]
    for c, (rec, (_, _, values)) in enumerate(zip(recs, caps)):
        assert ms.samples_dropped_total[c] == tees[c].samples_dropped, c
        gaps_in(rec, values, LIVE_PUSH)
    want, want_state = cpu_channel_replay(cfg, recs)
    worst = 0.0
    for c in range(N_CH):
        assert len(got[c]) == len(want[c]) > 0, (c, len(got[c]), len(want[c]))
        worst = max([worst] + [float(np.abs(a - b).max()) for a, b in zip(got[c], want[c])])
    assert worst <= CHANNEL_TOL, worst
    same_ints(ms.state, want_state, f"config 5 live pace={pace}")
    waits = [sum(t.wait_s) * 1e3 / n_blocks for t in tees]
    dropped = sum(ms.samples_dropped_total)
    row = dict(pace=pace, blocks=n_blocks, frames=[len(g) for g in got], wall_s=wall,
               signal_s=n_blocks * cfg.block_samples / cfg.samplerate,
               ms_a_block=wall / n_blocks * 1e3,
               aggregate_msps=N_CH * n_blocks * cfg.block_samples / wall / 1e6,
               realtime_msps=N_CH * cfg.samplerate / 1e6,
               samples_dropped=ms.samples_dropped_total,
               drop_share=dropped / (N_CH * n_blocks * cfg.block_samples + dropped),
               **producer_rate(srcs, cfg, pace),
               source_wait_ms_a_block=waits, waited_longest=int(np.argmax(waits)),
               max_abs_err_vs_cpu_channel_step=worst)
    if graph:
        row["float32_channel_graph"] = graph
    if count:
        only(launches, box_resample_strided_cuda=N_CH * n_blocks)
        row["k1_launches"] = launches["box_resample_strided_cuda"]
    return row


def live_channels(cfg, so, tmp, smi, n_blocks=8):
    """Config 5 live: MultiSession over 8 replay plugins, one capture per
    raster width, block=0: at pace=1 (the first float32 ChannelRunner: its
    census and memory), held against the CPU channel step over its
    recordings; then at CH5_PACES, not recorded (the drop share, ms a block
    and the producers' rate of each); then overloaded (pace=0), held and
    under the profiler, in a process of its own (live_channels_overload).
    Returns K1's launches in the overloaded run."""
    caps = channel_captures(cfg, so, tmp, n_blocks)
    row = channels_live_run(cfg, caps, 1, n_blocks, graph=True)
    print(f"live config 5 MultiSession over 8 cplugin, pace=1 block=0 (8x16MS/s, {smi}): "
          + json.dumps(row))
    sweep = [{k: row[k] for k in ("pace", "blocks", "wall_s", "ms_a_block", "drop_share",
                                  "producer_msps", "producer_reached_pace")}]
    for pace in CH5_PACES:
        srcs = [plugin_source(so_c, path, cfg, pace=pace) for so_c, path, _ in caps]
        ms = MultiSession(cfg, Params(), srcs, device=DEV)
        torch.cuda.synchronize()
        with live_limit(f"config 5 pace {pace}", ms.stop):
            t0 = time.perf_counter()
            ms.run(max_blocks=CH5_SWEEP_BLOCKS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        assert all(plugin_stats(s)["active"] == 0 for s in srcs), "readasync did not return"
        dropped = sum(ms.samples_dropped_total)
        sweep.append(dict(pace=pace, blocks=CH5_SWEEP_BLOCKS, wall_s=wall,
                          ms_a_block=wall / CH5_SWEEP_BLOCKS * 1e3,
                          drop_share=dropped / (N_CH * CH5_SWEEP_BLOCKS * cfg.block_samples
                                                + dropped),
                          **producer_rate(srcs, cfg, pace)))
    print(f"live config 5 pace sweep ({smi}): " + json.dumps(dict(
        runs=sorted(sweep, key=lambda r: r["pace"]),
        producer_bound=[r["pace"] for r in sweep if not r["producer_reached_pace"]],
        highest_pace_with_no_drop=highest_clean_pace(sweep))))
    run = subprocess.run([sys.executable, os.path.abspath(__file__), "--live-channels-overload"],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, f"--live-channels-overload failed:\n{run.stderr[-3000:]}"
    row = json.loads(run.stdout.strip().splitlines()[-1])
    print(f"live config 5 MultiSession over 8 cplugin, pace=0 block=0 (8x16MS/s, under the "
          f"profiler, in a process of its own, {smi}): " + json.dumps(row))
    return row["k1_launches"]


def live_channels_overload(n_blocks=8):
    """`chip_smoke.py --live-channels-overload`, in a process of its own:
    config 5's overloaded live run (pace=0, block=0; channels_live_run),
    its float32 ChannelRunner captured here and replayed under the
    profiler: drops on at least one channel, held against the CPU channel
    step over its recordings, K1 once per channel a block. A process of its
    own, because late in the smoke run's process a profiled replay of this
    graph faults (an illegal address; PERF.md section 7, ROADMAP Queue 3)."""
    so = native.build_replay_plugin()
    with tempfile.TemporaryDirectory() as tmp:
        caps = channel_captures(CH5, so, tmp, n_blocks)
        row = channels_live_run(CH5, caps, 0, n_blocks, count=True, graph=True)
    assert sum(row["samples_dropped"]) > 0, row["samples_dropped"]
    print(json.dumps(row))


def profiled_fault():
    """`chip_smoke.py --profiled-fault`: the test of the open fault of
    ROADMAP Queue 3. The whole smoke run (smoke) in this process, then config
    5's float32 ChannelRunner, which its live phase captured, replayed over
    recorded float32 blocks under the profiler: with CPU activity only, then
    with CUDA activity (CUPTI). While the fault stands, the second replay
    ends the process with CUDA's illegal address; exits 0 when both pass."""
    from torch.profiler import ProfilerActivity, profile

    smoke()
    so = native.build_replay_plugin()
    with tempfile.TemporaryDirectory() as tmp:
        n = 2 * CH5.block_samples
        srcs = [RecordedSource([SourceBlock(v[b * n:(b + 1) * n], 0) for b in range(4)],
                               CH5.samplerate) for _, _, v in channel_captures(CH5, so, tmp, 4)]
        for acts in ([ProfilerActivity.CPU], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            ms = MultiSession(CH5, Params(), srcs, device=DEV)
            assert torch.float32 in ms._runner._graphs, "the live phase captured no float32 graph"
            with profile(activities=acts):
                ms.run(max_blocks=4)
                torch.cuda.synchronize()
            print(f"profiled ({', '.join(a.name for a in acts)}) replays of config 5's float32 "
                  "ChannelRunner passed", flush=True)


def simlive_producer_rate(cfg, seconds=1.0):
    """simlive's producer unthrottled (pace=0), the consumer discarding:
    samples produced (delivered and dropped) a second, in MS/s."""
    src = load_source("simlive", f"{cfg.height} {cfg.width // 2} {cfg.refreshrate} "
                                 f"{cfg.samplerate} 0.02")
    delivered = dropped = 0
    t0 = time.perf_counter()
    with live_limit("simlive producer", src.stop):
        for blk in src.stream(cfg.block_samples):
            delivered += blk.samples.size // 2
            dropped += blk.dropped
            if time.perf_counter() - t0 >= seconds:
                break
        src.stop()
    wall = time.perf_counter() - t0
    return dict(msps=(delivered + dropped) / wall / 1e6, dropped=dropped, wall_s=wall)


def simlive_channels(cfg, smi, n_blocks=4):
    """MultiSession over 8 simlive channels (their own line widths) at
    pace=1, held against the CPU channel step over the recordings: whether
    the producers or the receiver set the rate."""
    tees = [TeeSource(load_source("simlive", f"{cfg.height} {cfg.width // 2 + 8 * c} "
                                             f"{cfg.refreshrate} {cfg.samplerate} 0.02 pace=1"))
            for c in range(N_CH)]
    got = [[] for _ in range(N_CH)]
    ms = MultiSession(cfg, Params(), tees, on_frame=lambda c, f: got[c].append(f), device=DEV)
    torch.cuda.synchronize()
    with live_limit("simlive MultiSession", ms.stop):
        t0 = time.perf_counter()
        ms.run(max_blocks=n_blocks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    want, want_state = cpu_channel_replay(cfg, [t.blocks for t in tees])
    worst = 0.0
    for c in range(N_CH):
        assert len(got[c]) == len(want[c]), (c, len(got[c]), len(want[c]))
        worst = max([worst] + [float(np.abs(a - b).max()) for a, b in zip(got[c], want[c])])
    assert worst <= CHANNEL_TOL, worst
    same_ints(ms.state, want_state, "simlive MultiSession")
    signal = n_blocks * cfg.block_samples / cfg.samplerate
    dropped = sum(ms.samples_dropped_total)
    who = ("the receiver: it fell behind the producers (drops)" if dropped else
           "the producers: no drop, slower than real time" if wall > 1.1 * signal else
           "real time: no drop")
    return dict(blocks=n_blocks, frames=[len(g) for g in got], wall_s=wall, signal_s=signal,
                samples_dropped=ms.samples_dropped_total, rate_set_by=who,
                source_wait_ms_a_block=[sum(t.wait_s) * 1e3 / n_blocks for t in tees],
                max_abs_err_vs_cpu_channel_step=worst)


def held_stopped(cfg, frames, state, rec, resets, what):
    """A live run stopped from outside (rx.stop) against the CPU step over
    its recording, the autocorrelation reset before each block of `resets`
    as the session reset it (a retune's): the run took its last recorded
    block from the source and may have stopped before stepping it, so the
    CPU steps the recording with and without that block, and the card's
    carries must equal one of the two exactly (phase_fix, the resampler's
    position, moves every block), its frames that one's within GRAPH_TOL.
    Returns (blocks stepped, the worst frame difference)."""
    step = make_step(cfg, Params(), device="cpu")
    state_cpu = init_state(cfg, Params().fir_lowpass_taps, device="cpu")
    want, after = [], []
    for b, blk in enumerate(rec):
        if b in resets:
            state_cpu = reset_autocorr(state_cpu)
        state_cpu, out = step(state_cpu, torch.from_numpy(np.asarray(blk.samples)),
                              StepControls(int(blk.dropped), 0, 0.0))
        want.append([f for _, f in _valid_frames(out)])
        after.append(state_cpu)
    for n in (len(rec), len(rec) - 1):
        if torch.equal(state.phase_fix.cpu(), after[n - 1].phase_fix):
            return n, held_to_cpu_step(frames, state, sum(want[:n], []), after[n - 1], what)
    raise AssertionError(f"{what}: the card's carries are the CPU step's after neither "
                         f"{len(rec)} nor {len(rec) - 1} recorded blocks")


def live_front_doors(cfg, so, cap, tmp, smi, n_blocks=8):
    """TSDR over cplugin (pace=1), its source recorded by a TeeSource:
    started in the background, the plugin's samplerate, base frequency and
    gain set while it streams and seen by the plugin, then stopped (its
    readasync returns, its thread joins), and held against the CPU step
    over its recording (held_stopped); cli.main --source cplugin against
    --source rawfile over the same capture (frames within PLUGIN_TOL, K1
    once a block). Returns K1's launches through the command line."""
    resets = []  # the blocks before which the session reset the autocorrelation: on its
    # own thread, as it takes a block from the tee, so the tee's last block is that block

    def on_value(ev):
        if ev.value_id == VALUE_ID.AUTOCORRECT_RESET:
            resets.append(len(tee.blocks) - 1)

    rx = TSDR(on_value=on_value, block_samples=cfg.block_samples, device=DEV)
    rx.load_source("cplugin", f"{so} -- {cap['path']} {int(cfg.samplerate)} uint8 pace=1")
    plugin = rx._source
    rx._source = tee = TeeSource(plugin)  # TSDR loads sources by name only: tee the loaded one
    rx.set_resolution(cfg.height, cfg.refreshrate)
    frames = []
    rx.start(on_frame=frames.append, background=True)
    deadline = time.time() + 60
    while len(frames) < 2:
        assert time.time() < deadline and rx.is_running, "TSDR cplugin: no frames"
        time.sleep(0.005)
    assert rx.session.source is tee
    reader = plugin._reader
    assert tee.set_samplerate(cfg.samplerate / 2) == cfg.samplerate  # a file's rate is fixed
    rx.set_base_freq(433.92e6)
    rx.set_gain(0.5)
    seen = len(frames)
    while len(frames) < seen + 2:
        assert time.time() < deadline and rx.is_running, "TSDR cplugin: stopped streaming"
        time.sleep(0.005)
    st = plugin_stats(plugin)
    assert st["basefreq"] == 433920000 and st["gain"] == 0.5 and st["setsamplerate_calls"] == 1, st
    t0 = time.perf_counter()
    rx.stop()
    stop_ms = (time.perf_counter() - t0) * 1e3
    assert not rx.is_running and not reader.is_alive() and plugin_stats(plugin)["active"] == 0
    sess = rx.session
    assert sess.samples_dropped_total <= tee.samples_dropped, "drops counted past the recording"
    gaps_in(tee.blocks, cap["values"], LIVE_PUSH)
    assert resets, "set_base_freq reset no autocorrelation"
    stepped, err = held_stopped(cfg, frames, sess.state, tee.blocks, resets,
                                "TSDR cplugin background")
    assert sess.samples_dropped_total == sum(b.dropped for b in tee.blocks[:stepped])
    rx.close()
    tsdr = dict(frames=len(frames), blocks_recorded=len(tee.blocks), blocks_stepped=stepped,
                autocorrelation_reset_before_blocks=resets,
                samples_dropped=sess.samples_dropped_total, stop_ms=stop_ms,
                basefreq=st["basefreq"], gain=st["gain"], max_abs_err_vs_cpu_replay=err)

    saved = {}
    for name, spec in (("rawfile", f"{cap['path']} {cfg.samplerate} uint8"),
                       ("cplugin", f"{so} block=1 -- {cap['path']} {int(cfg.samplerate)} uint8")):
        out = os.path.join(tmp, f"cli_{name}")
        with card_counts() as launches:
            log, dt = run_cli(["--source", name, "--source-params", spec,
                               "--block-samples", str(cfg.block_samples),
                               "--height", str(cfg.height), "--rate", str(cfg.refreshrate),
                               "--out", out, "--save-every", "1", "--format", "npy",
                               "--blocks", str(n_blocks), "--device", str(DEV)])
        only(launches, box_resample_strided_cuda=n_blocks)
        saved[name] = [np.load(os.path.join(out, f)) for f in sorted(os.listdir(out))]
    assert len(saved["cplugin"]) == len(saved["rawfile"]) > 0, {k: len(v) for k, v in saved.items()}
    err = max(float(np.abs(a - b).max()) for a, b in zip(saved["cplugin"], saved["rawfile"]))
    assert err <= PLUGIN_TOL, err
    print(f"live front doors (64MS/s, {smi}): " + json.dumps(dict(
        tsdr_cplugin_background=tsdr, cli_cplugin_frames=len(saved["cplugin"]),
        cli_cplugin_vs_rawfile_max_abs=err, k1_launches_cli_cplugin=n_blocks)))
    return n_blocks


def live_phase(smi, simlive_k1):
    """Phase 12: the live path (see its section note). A worker thread's
    exception fails the run. Returns K1's launches by path."""
    t0 = time.time()
    g64 = GEOMETRIES["64MS/s"]
    so = native.build_replay_plugin()
    print(f"built the replay plugin ({os.path.basename(so)}) in {time.time() - t0:.1f} s; threads "
          f"alive: {sorted(t.name for t in threading.enumerate())}")
    launches = {"simlive Session 8MS/s, 8 blocks": simlive_k1}
    with worker_faults(), tempfile.TemporaryDirectory() as tmp:
        cap = plugin_formats(g64, so, tmp, smi)
        launches[f"cplugin uint8 block=1 Session 64MS/s, {LIVE_BLOCKS} blocks"] = cap["k1"]
        print(f"live formats took {time.time() - t0:.1f} s")
        launches.update(plugin_paced(g64, so, cap, smi))
        print(f"live paced and overload took {time.time() - t0:.1f} s")
        pace_sweep(g64, so, cap, smi)
        print(f"live pace sweep took {time.time() - t0:.1f} s")
        launches["config 5 live MultiSession 8 cplugin float32 overloaded, 8 blocks (own "
                 "process)"] = live_channels(CH5, so, tmp, smi)
        print(f"live config 5 took {time.time() - t0:.1f} s")
        rates = {name: simlive_producer_rate(cfg, 1.5) for name, cfg in
                 (("8MS/s", GEOMETRIES["8MS/s"]), ("16MS/s", CH5), ("64MS/s", g64))}
        print(f"live simlive producer, unthrottled, consumer discarding ({smi}): "
              + json.dumps(rates))
        print(f"live simlive MultiSession 8x16MS/s pace=1 ({smi}): "
              + json.dumps(simlive_channels(CH5, smi)))
        launches["cli --source cplugin 64MS/s, 8 blocks"] = live_front_doors(g64, so, cap, tmp,
                                                                             smi)
    print(f"live phase took {time.time() - t0:.1f} s")
    return launches


KERNELS = {  # id: (wrapper, source, the TPU kernel it replaces)
    "K1": (box_resample_strided_cuda, "strided_resample.cu",
           "tempestsdr_tpu/pallas/strided_kernel.py:65"),
    "K2": (fused_demod_resample_cuda, "fused_demod_resample.cu",
           "tempestsdr_tpu/pallas/fused_kernel.py:155"),
    "K2'": (fused_demod_resample_u16_cuda, "fused_demod_resample.cu",
            "bench/fused_u16_probe.py:42"),
    "K3": (box_resample_pallas_cuda, "chunked_resample.cu",
           "tempestsdr_tpu/pallas/resample_kernel.py:35"),
    "K4": (box_resample_pallas_windows_cuda, "chunked_resample.cu",
           "tempestsdr_tpu/pallas/resample_kernel.py:58"),
    # K4's input gather, which the TPU wrapper left to XLA
    "gather": (gather_windows, "chunked_resample.cu",
               "tempestsdr_tpu/pallas/resample_kernel.py:91"),
}


# ---- phase 13: the downloads into pinned memory -----------------------------


def _host_pool():
    """The caching host allocator's blocks made and the bytes it holds."""
    st = torch.cuda.host_memory_stats()
    return {k: st[k] for k in ("num_host_alloc", "allocated_bytes.current",
                               "active_bytes.current") if k in st}


def pinned_downloads(name, make, per_block, frame_shape, steady_blocks):
    """One configuration's pinned downloads: `make(on_frame, on_plot)` a
    session, whose frames come down through session_mod._download. Every
    row it downloads bit for bit the stack's .cpu(); the frames kept from
    its first 4 blocks unchanged after 8 more; then two steady stretches of
    steady_blocks that keep nothing (ms a block of the session and of its
    downloads, download_stats); then a stack of `per_block` frames
    downloaded alone, consecutive rows and gathered ones, bit for bit the
    stack's .cpu(). Returns the row it prints."""
    make(None, None).run(max_blocks=4)  # the capture, the cuFFT plans, the pool's first blocks
    real, checked = session_mod._download, [0]

    def checking(stack, rows):
        got = real(stack, rows)
        want = stack[rows].cpu().numpy()
        assert len(got) == len(rows) and all(
            g.dtype == w.dtype and g.tobytes() == w.tobytes() for g, w in zip(got, want)), name
        checked[0] += len(got)
        return got

    kept, clones = [], []

    def keep(values):
        kept.append(values)
        clones.append(np.array(values, copy=True))

    session_mod._download = checking
    try:
        sess = make(keep, keep)
        sess.run(max_blocks=4)
        first = len(kept)
        sess.run(max_blocks=8)  # the same session 8 blocks on: its graph rewrites its outputs
        held_pool = _host_pool()
    finally:
        session_mod._download = real
    assert first >= 1 and checked[0] >= first, (name, first, checked[0])
    for i, (a, b) in enumerate(zip(kept, clones)):
        assert a.tobytes() == b.tobytes(), (name, "a kept row changed", i)
    held = dict(rows_checked=checked[0], kept_rows=len(kept), kept_from_first_4_blocks=first,
                kept_bytes=int(sum(k.nbytes for k in kept)), pool_while_held=held_pool)
    del kept, clones, sess

    turns = []
    for _ in range(2):
        spent = {}
        undo = _timed(session_mod, "_download", spent)
        try:
            sess = make(lambda *a: None, lambda *a: None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.run(max_blocks=steady_blocks)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            undo()
        st = sess.download_stats
        assert st.downloads > 0, name
        turns.append(dict(ms_a_block=dt * 1e3 / steady_blocks,
                          download_ms_a_block=spent.get("_download", 0.0) * 1e3 / steady_blocks,
                          downloads=st.downloads, bytes_a_block=st.bytes / steady_blocks,
                          fresh_pinned=st.fresh_pinned, pinned_hit_share=st.pinned_hit_share))
    assert turns[-1]["pinned_hit_share"] >= 0.9, turns  # every bucket met in the first turn

    stack = torch.randn((per_block + 2, *frame_shape), device=DEV)
    for rows in (list(range(1, per_block + 1)), [per_block + 1, 0] + list(range(2, per_block))):
        got = session_mod._download(stack, rows)
        want = stack[rows].cpu().numpy()
        assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want)), (name, "alone")
    stats_us = {}
    for what, fn in (("flat", torch.cuda.host_memory_stats),
                     ("_pinned_blocks", lambda: session_mod._pinned_blocks(DEV))):
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        stats_us[what] = (time.perf_counter() - t0) * 1e3
    return dict(config=name, held=held, steady_blocks=steady_blocks, turns=turns,
                stats_read_us=stats_us, pool_after=_host_pool())


def pinned_download_phase(smi):
    """Phase 13: pinned_downloads at 64 MS/s (Session at batch 1, one
    frame of 628 x 3397 a valid block) and at config 5 (MultiSession over 8
    channels, K = 4: up to 32 frames of 628 x 849 a block)."""
    print("host memory stats keys " + json.dumps(sorted(torch.cuda.host_memory_stats())))
    g64 = GEOMETRIES["64MS/s"]
    raster = render_test_pattern(g64.height, g64.width // 2)
    src64 = ReplayU8(g64, raster, 8, loop=True)
    warm_compile_step(g64, Params(), raw_dtype=np.uint8, device=DEV)

    def session64(on_frame, on_plot):
        return Session(g64, Params(), src64, SessionCallbacks(
            on_frame=on_frame, on_plot=None if on_plot is None else lambda ev: on_plot(ev.values)),
            device=DEV)

    wide = pinned_downloads("64MS/s Session", session64, 1,
                            (g64.height, g64.width), 64)
    print("pinned downloads " + json.dumps(dict(card=smi, **wide)))
    srcs = [ReplayU8(CH5, render_test_pattern(CH5.height, CH5.width // 2 + 8 * c), 6, loop=True)
            for c in range(N_CH)]

    def multi(on_frame, on_plot):
        return MultiSession(CH5, Params(), srcs,
                            on_frame=None if on_frame is None else lambda c, f: on_frame(f),
                            on_plot=None if on_plot is None else lambda c, ev: on_plot(ev.values),
                            device=DEV)

    frames_a_block = 23  # 49 MB of 628 x 849 frames, a premade block's mean (PERF.md section 4)
    many = pinned_downloads("8x16MS/s MultiSession", multi, frames_a_block,
                            (CH5.height, CH5.width), 16)
    print("pinned downloads " + json.dumps(dict(card=smi, **many)))
    return wide, many


# ---- phase 14: the uploads through the runners' pinned staging buffers --------

UPLOAD_DTYPES = (np.uint8, np.int16, np.float32)
UPLOAD_BLOCKS = 8  # 64 MS/s: two batches of 4, about 5 frames
UPLOAD_CH_BLOCKS = 3  # config 5: about 8 frames a channel
GUARD_SLEEP_CYCLES = 200_000_000  # about 0.1 s of the card's clock queued ahead of a call


def host_copy_ms(n_rows, n2, dtype, reps=21):
    """ms to copy n_rows rows of n2 samples into a pinned [n_rows, n2]
    buffer: by np.copyto into its numpy view (the runner's choice) and by
    torch's CPU copy_ (on its intra-op threads), beside the pageable
    np.stack the runner made before; medians of reps in turns. Each rep
    reads other rows, views into a looped stream of at least 256 MB (as
    the benchmark's premade source yields its blocks), so the source is
    cold in the host's caches as a stream's next block is."""
    itemsize = np.dtype(dtype).itemsize
    sets = max(2, (256 << 20) // (n_rows * n2 * itemsize))
    looped = np.resize(emanation(CH5, dtype, 1)[1], sets * n_rows * (n2 + 7) + n2)
    rows = [looped[r * (n2 + 7): r * (n2 + 7) + n2] for r in range(sets * n_rows)]
    host = torch.empty((n_rows, n2), dtype=torch.from_numpy(looped[:0]).dtype, pin_memory=True)
    view = host.numpy()
    ways = {"np.copyto": lambda pick: [np.copyto(view[i], r) for i, r in enumerate(pick)],
            "torch copy_": lambda pick: [host[i].copy_(torch.from_numpy(r))
                                         for i, r in enumerate(pick)],
            "np.stack (pageable, before)": np.stack}
    times = {k: [] for k in ways}
    for rep in range(reps):
        for j, (k, fn) in enumerate(ways.items()):
            pick = rows[((rep * len(ways) + j) % sets) * n_rows:][:n_rows]
            t0 = time.perf_counter()
            fn(pick)
            times[k].append((time.perf_counter() - t0) * 1e3)
    for way in ("np.copyto", "torch copy_"):
        view.fill(0)
        ways[way](rows[:n_rows])
        assert view.tobytes() == np.stack(rows[:n_rows]).tobytes(), way
    return dict(rows=n_rows, row_bytes=n2 * itemsize, dtype=np.dtype(dtype).name,
                threads=torch.get_num_threads(), source_sets=sets,
                ms={k: float(np.median(v)) for k, v in times.items()})


def stats_change(runner, before):
    """What runner.upload_stats counted since `before` (a copy of them)."""
    return {k: getattr(runner.upload_stats, k) - getattr(before, k)
            for k in ("uploads", "bytes", "staged", "waits")}


def uploaded(runner, batches, what):
    """The runner over the batches (each its [rows, 2n] raws, given as a
    list of 1-D rows or as an array, with no controls) from a fresh state,
    a packed fetch after each call as a session makes it, none waiting and
    every call staged but a lone row's (copied in directly): (the valid
    frames as (row, frame) in stream order, the state)."""
    before = dataclasses.replace(runner.upload_stats)
    n = runner.n_blocks
    state = (stack_states(runner.config, n, device=DEV) if isinstance(runner, ChannelRunner)
             else init_state(runner.config, device=DEV))
    frames = []
    for raws in batches:
        state, out, packed = runner.run(state, raws, np.zeros((n, 3)))
        packed.tolist()
        frames += [(r, f) for (r, *_), f in _valid_frames(out, (n,))]
    got = stats_change(runner, before)
    staged = len(batches) if n > 1 else 0
    assert got["uploads"] == len(batches) and got["staged"] == staged and got["waits"] == 0, (
        what, got)
    return frames, state


def back_to_back(runner, blocks, want, want_state, what):
    """Two calls of a K = 4 runner without a fetch between them, the second
    batch written into the caller's array the first call was given as soon
    as that call returns, the first call's copies held back behind a sleep
    on the card: the second call waits once for them, and both calls' frames
    and the state are still the CPU step's."""
    k = runner.n_blocks
    state = init_state(runner.config, device=DEV)
    before = dataclasses.replace(runner.upload_stats)
    raws = np.stack(blocks[:k])
    torch.cuda._sleep(GUARD_SLEEP_CYCLES)
    state, out, _ = runner.run(state, raws, np.zeros((k, 3)))
    first = StepOutputs(*(x.clone() for x in out))
    raws[:] = np.stack(blocks[k:2 * k])
    state, out, packed = runner.run(state, raws, np.zeros((k, 3)))
    packed.tolist()
    frames = [f for o in (first, out) for _, f in _valid_frames(o, (k,))]
    got = stats_change(runner, before)
    assert got["uploads"] == got["staged"] == 2 and got["waits"] == 1, (what, got)
    return dict(max_abs_err_vs_cpu_step=held_to_cpu_step(frames, state, want, want_state, what),
                frames=len(frames), **got)


def block_uploads(g64, dtype):
    """The BlockRunner at K = 1 (a list of one view a call, as Session
    passes it) and K = 4 (a [4, 2n] array) over UPLOAD_BLOCKS blocks of
    `dtype`, each against the CPU step over the same blocks; then the two
    calls back to back."""
    name = np.dtype(dtype).name
    blocks = np.split(emanation(g64, dtype, UPLOAD_BLOCKS)[1], UPLOAD_BLOCKS)
    want, want_state = cpu_step(g64, Params(), blocks)
    rows = {}
    for k in (1, 4):
        runner = BlockRunner(g64, Params(), k, DEV)
        batches = ([[b] for b in blocks] if k == 1 else
                   [np.stack(blocks[b:b + k]) for b in range(0, UPLOAD_BLOCKS, k)])
        frames, state = uploaded(runner, batches, f"BlockRunner K={k} {name}")
        rows[f"K={k}"] = dict(frames=len(frames), max_abs_err_vs_cpu_step=held_to_cpu_step(
            [f for _, f in frames], state, want, want_state, f"pinned upload K={k} {name}"))
    rows["back to back, K=4"] = back_to_back(runner, blocks, want, want_state,
                                             f"back to back {name}")
    return rows


def channel_uploads(dtype):
    """Config 5's ChannelRunner (C = 8, unrolled) over UPLOAD_CH_BLOCKS
    blocks of `dtype`, each channel its own stretch of the emanation, a
    list of 8 rows a call as MultiSession passes them, against the CPU's
    channel step over the same blocks."""
    name = np.dtype(dtype).name
    flat = emanation(CH5, dtype, N_CH + UPLOAD_CH_BLOCKS)[1]
    n2 = 2 * CH5.block_samples
    batches = [[flat[(b + c) * n2:(b + c + 1) * n2] for c in range(N_CH)]
               for b in range(UPLOAD_CH_BLOCKS)]
    want, _, want_state = eager_channel_frames(
        make_channels_step_hybrid(CH5, Params(), N_CH, device="cpu"),
        [np.stack(b) for b in batches])
    frames, state = uploaded(ChannelRunner(CH5, Params(), N_CH, DEV), batches,
                             f"ChannelRunner C=8 {name}")
    per = [[f for c, f in frames if c == ch] for ch in range(N_CH)]
    err = 0.0
    for ch in range(N_CH):
        assert len(per[ch]) == len(want[ch]) > 0, (name, ch, len(per[ch]), len(want[ch]))
        err = max([err] + [float(np.abs(a - b).max()) for a, b in zip(per[ch], want[ch])])
    assert err <= GRAPH_TOL, (name, err)
    same_ints(state, want_state, f"pinned upload C=8 {name}")
    return dict(frames=sum(map(len, per)), max_abs_err_vs_cpu_step=err)


def steady_uploads(name, sess, steady_blocks):
    """A session over 4 blocks (the capture, the pool's first blocks), then
    steady_blocks more: in the steady stretch no wait, no pinned block made
    but the downloads' own, and every call staged (none at one row a call,
    whose row is copied in directly)."""
    sess.run(max_blocks=4)
    before, made = dataclasses.replace(sess.upload_stats), session_mod._pinned_blocks(DEV)
    fresh = sess.download_stats.fresh_pinned
    sess.run(max_blocks=steady_blocks)
    got = stats_change(sess._runner, before)
    by_uploads = (session_mod._pinned_blocks(DEV) - made) - (sess.download_stats.fresh_pinned
                                                             - fresh)
    staged = got["uploads"] if sess._runner.n_blocks > 1 else 0
    assert got["uploads"] > 0 and got["staged"] == staged and got["waits"] == 0, (name, got)
    assert by_uploads == 0, (name, by_uploads)
    return dict(session=name, staged_share=got["staged"] / got["uploads"],
                pinned_blocks_made_by_uploads=by_uploads, **got)


def pinned_upload_phase(smi):
    """Phase 14 (see the module docstring, 9e)."""
    n2 = 2 * CH5.block_samples
    copies = [host_copy_ms(N_CH, n2, np.uint8), host_copy_ms(1, n2, np.uint8),
              host_copy_ms(N_CH, n2, np.float32)]
    print("pinned uploads host copy " + json.dumps(dict(card=smi, copies=copies)))
    g64 = GEOMETRIES["64MS/s"]
    held = {}
    for dtype in UPLOAD_DTYPES:
        held[f"64MS/s BlockRunner {np.dtype(dtype).name}"] = block_uploads(g64, dtype)
        held[f"config 5 ChannelRunner {np.dtype(dtype).name}"] = channel_uploads(dtype)
    print("pinned uploads held " + json.dumps(dict(card=smi, **held)))
    raster = render_test_pattern(g64.height, g64.width // 2)
    sessions = {f"64MS/s Session, batch {k}": Session(
        g64, Params(), ReplayU8(g64, raster, 8, loop=True), batch_blocks=k, device=DEV)
        for k in (1, 4)}
    srcs = [ReplayU8(CH5, render_test_pattern(CH5.height, CH5.width // 2 + 8 * c), 6, loop=True)
            for c in range(N_CH)]
    sessions["8x16MS/s MultiSession"] = MultiSession(CH5, Params(), srcs,
                                                     on_frame=lambda c, f: None, device=DEV)
    loops = [steady_uploads(name, sess, 32) for name, sess in sessions.items()]
    print("pinned uploads loops " + json.dumps(dict(card=smi, loops=loops)))
    return copies, held, loops


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--first-block" and sys.argv[2] in ("cold", "warm"):
        return first_block(sys.argv[2])
    if sys.argv[1:] == ["--live-channels-overload"]:
        return live_channels_overload()
    if sys.argv[1:] == ["--profiled-fault"]:
        return profiled_fault()
    if sys.argv[1:]:
        sys.exit("usage: chip_smoke.py")
    smoke()


def smoke():
    """The smoke run (see the module docstring)."""
    smi = card()
    t_start = time.time()
    build.build(kernels.SOURCES)
    build_s = time.time() - t_start
    print(f"built kernels in {build_s:.1f} s")
    t0 = time.time()
    assert native.available(), "the native I/O runtime did not build"
    print(f"built the native I/O runtime ({os.path.basename(native.lib_path())}) in "
          f"{time.time() - t0:.1f} s")
    for name in kernels.SOURCES:
        print(build.BUILD_LOG.get(name, "").strip())

    errs = {name: check_kernels(cfg) for name, cfg in GEOMETRIES.items()}
    torch.cuda.synchronize()
    print("max_abs_err " + json.dumps(errs))
    edges = {name: check_edges(cfg) for name, cfg in GEOMETRIES.items()}
    print("max_abs_err (unaligned, negative num, phase in the tail; gather exact) "
          + json.dumps(edges))
    for name, e in edges.items():
        for kid, err in e.items():
            errs[name][kid] = max(errs[name][kid], err)
    floors = {name: measure_floors(cfg) for name, cfg in GEOMETRIES.items()}
    print("floors " + json.dumps(floors))
    perf = {name: measure_kernels(cfg) for name, cfg in GEOMETRIES.items()}
    print("timing " + json.dumps(perf))

    g64 = GEOMETRIES["64MS/s"]
    rows = {"K1": run_session("default 64MS/s", g64, 12)}
    assert rows["K1"]["plots"] >= 2 and rows["K1"]["frames"] >= 6, rows["K1"]
    k4_row = run_session("default 8MS/s", GEOMETRIES["8MS/s"], 4)
    assert k4_row["frames"] > k4_row["blocks"], k4_row  # several frames per block
    for kid, resampler in (("K2", "fused"), ("K3", "pallas"), ("K4", "pallas_windows")):
        ran = (kid, "gather") if kid == "K4" else (kid,)
        rows[kid] = run_session(f"{resampler} 64MS/s", g64, 8, Params(resampler=resampler),
                                tuple(KERNELS[k][0].__name__ for k in ran))
    rows["gather"] = rows["K4"]
    launches = {kid: row["launches"][KERNELS[kid][0].__name__] for kid, row in rows.items()}
    launches["K2'"] = stream_k2_u16(g64, 8)
    print("step on the card vs on the CPU (8MS/s, 3 blocks), frames max abs diff "
          + json.dumps(check_against_cpu(GEOMETRIES["8MS/s"])))
    profile_steady(g64)
    print(f"per-block host fetch round trip: {fetch_cost_us():.1f} us")
    graph_launches, graph_k2 = graph_step_phase(g64, smi)
    branch_nodes_phase(smi)
    pp_row = post_process_phase(smi)
    flag_launches = flags_phase(smi)

    with tempfile.TemporaryDirectory() as tmp:
        front_door(g64, tmp, rows["K1"]["per_block_ms_under_profiler"])
        auto_resolution_round_trip(GEOMETRIES["8MS/s"], tmp)
        batched_session(g64)
        live_controls(g64, tmp)
    intake_k1, intake_k2 = intake_phase(smi)
    flips_phase(smi)
    flag_launches["K1"].update(flags_front_doors(smi))
    assert superresolution(g64) == 1 << 21  # 2^23 stitched samples a cycle
    numbers_worth_a_line(build_s)
    channel_launches = channels_phase(smi)
    flag_launches["K1"].update(channel_flags_phase(smi))
    sharded_launches, range_row = sharded_phase(smi)
    live_launches = live_phase(smi, channel_launches.pop("simlive"))
    pinned_download_phase(smi)
    pinned_upload_phase(smi)
    print(f"smoke run took {time.time() - t_start:.1f} s after the card query")

    kern = []
    for kid, (fn, src, replaces) in KERNELS.items():
        p = perf["64MS/s"][kid]
        kern.append(dict(
            name=f"{kid} {fn.__name__}", route="cuda", source=f"tempestsdr_tpu_torch/csrc/{src}",
            replaces=replaces, launches=launches[kid],
            max_abs_err=max(e[kid] for e in errs.values()), ms=p["ms"], plain_ms=p["plain_ms"],
            bound_ms=p["bound_ms"], bound_by=p["bound_by"], library_ms=None))
        kern[-1].update(ms_warm=p["ms_warm"], ms_each_of_8=p["ms_each_of_8"])
        if kid in channel_launches:
            kern[-1]["launches_by_path"] = {
                ("default Session 64MS/s" if kid == "K1" else "fused Session 64MS/s"):
                    launches[kid],
                ("MultiSession 8x16MS/s graph, 4 blocks" if kid == "K1"
                 else "fused channel graph 8x16MS/s, 4 blocks"): channel_launches[kid]}
            kern[-1]["launches_by_path"].update(graph_launches if kid == "K1" else graph_k2)
            kern[-1]["launches_by_path"].update(intake_k1 if kid == "K1" else intake_k2)
        if kid == "K3":
            kern[-1]["launches_by_path"] = {"pallas Session 64MS/s": launches[kid]}
        if kid in flag_launches:
            kern[-1]["launches_by_path"].update(flag_launches[kid])
        if kid == "K1":
            kern[-1]["launches_by_path"].update(sharded_launches)
            kern[-1]["launches_by_path"].update(live_launches)
            kern[-1]["range_entry"] = dict(
                wrapper=box_resample_range_strided_cuda.__name__, ms=range_row["ms"],
                wrapper_ms=range_row["wrapper_ms"],
                plain_ms=range_row["plain_ms"], bound_ms=range_row["bound_ms"],
                bound_by=range_row["bound_by"], copy_floor_ms=range_row["copy_floor_ms"],
                max_abs_err=range_row["max_abs_err"],
                launches=sharded_launches["time-sharded T=4 64MS/s, 12 blocks "
                                          "(range entry, each rank)"])
        if kid == "K4":
            g = perf["64MS/s"]["gather"]
            kern[-1].update(gather_ms=g["ms"], gather_plain_ms=g["plain_ms"],
                            wrapper_ms=p["wrapper_ms"])
    # the branch nodes' set kernel (no TPU kernel: it stands for XLA's
    # conditional): its launches and device ms on the main path (the default
    # 64 MS/s Session), its plain version computing the same two condition
    # values with torch, the bound of its bytes (1 read, 2 x 4 written), and
    # max_abs_err 0: every node-form replay equals the select form bit for bit
    pred = torch.ones((), dtype=torch.bool, device=DEV)
    set_row = rows["K1"]["set_kernel"]
    kern.append(dict(
        name=f"graph_cond {SET_KERNEL}", route="cuda",
        source="tempestsdr_tpu_torch/csrc/graph_cond.cu",
        replaces="tempestsdr_tpu/stream/pipeline.py:686", launches=set_row["launches"],
        max_abs_err=0.0, ms=set_row["ms"],
        plain_ms=time_launches(lambda: torch.stack([pred, ~pred]).to(torch.int32)),
        bound_ms=bound(9, 0)["bound_ms"], bound_by="bytes", library_ms=None))
    # the post-process kernels (no TPU kernel: XLA fuses the JAX package's
    # chain): a post-process's three launches, their launches on the main
    # paths counted by IF-body counters in the replays (pp_runners_agree),
    # ms a post-process at 64 MS/s (628 x 3397, one frame) beside the plain
    # chain's and the bytes bound (the frame and the screen read, the new
    # screen and the emitted frame written), max_abs_err 0: frames bit for
    # bit the plain chain's
    pp_ms = pp_row["ms_per_post_process"]
    kern.append(dict(
        name="post_process stats, search, apply", route="cuda",
        source="tempestsdr_tpu_torch/csrc/post_process.cu",
        replaces="none: tempestsdr_tpu/stream/pipeline.py:216, fused by XLA",
        launches=pp_row["main_paths"]["ChannelRunner config 5 unrolled, 6 blocks"]["launches"],
        launches_by_path={k: v["launches"] for k, v in pp_row["main_paths"].items()},
        max_abs_err=0.0, ms=pp_ms["628x3397 C=1"]["kernels"]["ms"],
        plain_ms=pp_ms["628x3397 C=1"]["plain"]["ms"],
        bound_ms=pp_ms["628x3397 C=1"]["bytes_bound"], bound_by="bytes", library_ms=None,
        ms_by_geometry={k: v["kernels"]["ms"] for k, v in pp_ms.items()}))
    print(f"card: {smi}")
    print(json.dumps({"floors": floors}))
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
