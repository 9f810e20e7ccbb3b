"""Host-side streaming session: feeds source blocks through the step and
fans results out to the reference's callback channels (tsdr_readasync,
TSDRLibrary.c:467-536). Interactive controls (sync shift, motion blur,
autocorrelation reset/dump, live params, framerate nudge) are plain method
calls applied between blocks — no locks.

The steps run through a BlockRunner (stream/graph.py) of batch_blocks
blocks: on the card one CUDA-graph replay per batch (batch_blocks=1
replays a one-block graph), as the JAX Session scans batch_blocks blocks
per dispatch; on the CPU the same device step in a loop. Per batch: each
block copied into the runner's pinned staging buffer and its copy to the
card queued at once (no stacked host array, no blocking copy; at batch 1
the one block copied in directly), the replay, ONE packed fetch of every block's frame-valid flags and small
values (plots, meters), then the valid frames and the completed rounds'
plots copied to the host (on the card into pinned memory from torch's
caching host allocator, behind one wait for the stream), fanned out to
the callbacks in stream order. That dispatch, up to the fan-out, is
_dispatch_rows, which MultiSession (stream/multisession.py) shares.
batch_blocks > 1 costs batch_blocks x block latency for the controls.
Under a profiler the loop is spans (utils/profiling.py span):
tsdr/source for each block's arrival, tsdr/dispatch for each batch,
holding the runner's tsdr/upload (the blocks copied in, a batch's
through pinned memory) and tsdr/replay, tsdr/fetch, tsdr/download and
tsdr/fanout, and tsdr/callback around each of the caller's callbacks.
upload_stats are the runner's (UploadStats), download_stats the
session's (DownloadStats).

A session holds its runner's graph state while it runs (the runner's state
is the session's, updated in place; _lease_runner); when the run ends it
takes its state back in tensors of its own, so a later session of the same
key may hold the runner.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..config import PLL_HEADROOM_FRAC, PipelineConfig
from ..device import resolve_device
from ..errors import TSDRError, TSDRStatus
from ..events import PLOT_ID, VALUE_ID, PlotEvent, ValueEvent
from ..params import DIRECTION, Params
from ..sources.base import Source
from ..utils.profiling import IngestMeter, auto_batch_blocks, span
from .graph import PACKED, BlockRunner, UploadStats, host_controls
from .state import (
    StreamState,
    init_state,
    reset_autocorr,
    state_compatible,
    state_from_numpy,
    state_leaves,
    state_to_numpy,
)

AUTOGAIN_REPORT_EVERY_FRAMES = 5  # dsp.c:20

# ---- warm start (live-resolution-change support) ---------------------------
# The reference re-derives geometry mid-stream (tsdr_setresolution ->
# set_internal_samplerate, TSDRLibrary.c:552-566). Here a geometry is a new
# BlockRunner, and its first batch pays what nothing later pays: the build and
# load of the CUDA kernels (kernels/build.py), the cuFFT plan of ac_fft_size,
# the allocator's first blocks and the graph's capture. warm_compile_step
# pays that WHILE the current session still streams, so the stop -> start
# switch costs only the stream gap. Runners are cached by (config, params,
# batch_blocks, device); a Session takes the cached one or caches the one it
# builds.

_WARM_LOCK = threading.Lock()
_WARM_STEPS: dict = {}


def resolve_batch_blocks(config: PipelineConfig, batch_blocks,
                         latency_s: float = 0.25, device="cuda") -> int:
    """Resolve a Session batch_blocks argument: an int passes through;
    "auto" sizes the batch from the device's measured dispatch floor vs the
    block's real-time duration under a control-latency cap (utils.profiling.
    auto_batch_blocks). Shared by Session and warm_compile_step so a warm
    key resolved here matches the session's."""
    if batch_blocks == "auto":
        return auto_batch_blocks(config, latency_s=latency_s, device=device)
    return max(int(batch_blocks), 1)


def _cached_runner(key, make):
    """The cached runner of this key, made with make() and cached on first
    use (MultiSession's channel runners share the cache)."""
    with _WARM_LOCK:
        runner = _WARM_STEPS.get(key)
        if runner is None:
            runner = _WARM_STEPS[key] = make()
    return runner


def _lease_runner(key, make):
    """A runner of this key held for one run: the cached one, leased, or a
    private one from make() when another holder has the cached one. The
    run ends with the runner's release(state), which hands the holder its
    state in tensors of its own."""
    runner = _cached_runner(key, make)
    if not runner.lease():
        runner = make()
        runner.lease()
    return runner


def _block_runner(config: PipelineConfig, params: Params, batch_blocks: int, device) -> tuple:
    """A Session's runner key and the maker of its BlockRunner."""
    return ((config, params, int(batch_blocks), device),
            lambda: BlockRunner(config, params, batch_blocks, device))


def warm_compile_step(config: PipelineConfig, params: Params, *,
                      batch_blocks=1, raw_dtype=np.float32,
                      max_control_latency_s: float = 0.25, device="cuda") -> None:
    """Build AND warm the BlockRunner a future Session(config, params,
    batch_blocks, device) will use, so that session's first batch pays no
    kernel build, FFT plan, first allocation or graph capture: one batch of
    zero blocks on a state of its own. Blocking (returns once the device has
    finished); call from a background thread to overlap with a live session.
    A runner another session holds right now is warm already and is left
    alone. raw_dtype must match the source's block dtype
    (Source.block_dtype()): the runner captures one graph per raw dtype, and
    uint8/int8 blocks take K2 under resampler="fused". batch_blocks may be
    "auto" (resolved like Session's)."""
    dev = resolve_device(device)
    batch_blocks = resolve_batch_blocks(config, batch_blocks, max_control_latency_s, dev)
    runner = _cached_runner(*_block_runner(config, params, batch_blocks, dev))
    state = init_state(config, params.fir_lowpass_taps, dev)
    if not runner.lease():
        return
    try:
        runner.run(state, np.zeros((batch_blocks, 2 * config.block_samples), raw_dtype),
                   host_controls([0] * batch_blocks, 0, 0.0))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        runner.release(state)


def _normalize_host(raw: np.ndarray) -> np.ndarray:
    """Host-side mirror of ops.demod.normalize_iq (TSDRPlugin_RawFile.c
    scale factors) for the superbandwidth gather path."""
    dt = raw.dtype
    if dt == np.float32:
        return raw
    if dt == np.int8:
        return raw.astype(np.float32) / 128.0
    if dt == np.uint8:
        return (raw.astype(np.float32) - 128.0) / 128.0
    if dt == np.int16:
        return raw.astype(np.float32) / 32767.0
    if dt == np.uint16:
        return (raw.astype(np.float32) - 32767.0) / 32767.0
    raise TypeError(f"unsupported IQ dtype {dt}")


@dataclass
class SessionCallbacks:
    on_frame: Optional[Callable[[np.ndarray], None]] = None
    on_value: Optional[Callable[[ValueEvent], None]] = None
    on_plot: Optional[Callable[[PlotEvent], None]] = None
    on_stopped: Optional[Callable[[], None]] = None
    on_exception: Optional[Callable[[BaseException], None]] = None


class Session:
    def __init__(self, config: PipelineConfig, params: Params, source: Source,
                 callbacks: SessionCallbacks | None = None, batch_blocks: int | str = 1,
                 max_control_latency_s: float = 0.25, device="cuda"):
        """batch_blocks > 1 runs that many blocks per dispatch — one stacked
        upload, one graph replay on the card, then the fetches — at the cost
        of batch_blocks x block latency for interactive controls.

        batch_blocks="auto" sizes the batch from the device's measured
        per-dispatch floor vs the block's real-time duration so a live
        session both keeps up with real time (floor share <= ~10 % of the
        stream cadence) and honors max_control_latency_s — the worst-case
        delay before an interactive control takes effect with a throttled
        source. Explicit batch_blocks=1 stays available for lowest latency;
        benchmarking replay should size batches explicitly."""
        self.device = resolve_device(device)
        self.config = config
        self.params = params
        self.source = source
        self.callbacks = callbacks or SessionCallbacks()
        self.batch_blocks = resolve_batch_blocks(config, batch_blocks,
                                                 max_control_latency_s, self.device)
        self._pending_params: Optional[Params] = None
        self._runner = _cached_runner(*_block_runner(config, params, self.batch_blocks,
                                                     self.device))
        self.state: StreamState = init_state(config, params.fir_lowpass_taps, self.device)
        self._pending_sync = 0
        self._motionblur = 0.0
        self._pending_ac_reset = False
        self._pending_refresh = 0.0
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._loop_ident: Optional[int] = None
        self._agruns = 0
        self._last_refresh = None
        self._last_plots: tuple = ()
        # cumulative source-reported drops (UHD/Mirics samples_dropped
        # semantics, TSDRPlugin.h:49) — observability for overload diagnosis
        self.samples_dropped_total = 0
        self.download_stats = DownloadStats()
        self.meter = IngestMeter()

    @property
    def upload_stats(self) -> UploadStats:
        """The uploads of the session's runner (stream/graph.py), counted
        across every holder of that runner."""
        return self._runner.upload_stats

    def set_params(self, new_params: Params) -> None:
        """Live param-flag change (the reference toggles params_int while
        streaming, TSDRLibrary.c:604-611). Applied at the next loop
        iteration: the step is rebuilt, carried state survives, and the
        reference's buffer-clear on a lowpass_before_sync flip
        (dsp.c:178-186) is reproduced."""
        if new_params != self.params:
            self._pending_params = new_params

    def _apply_pending_params(self) -> None:
        new = self._pending_params
        self._pending_params = None
        if new is None or new == self.params:
            return
        flip_lowpass = new.lowpass_before_sync != self.params.lowpass_before_sync
        runner = _lease_runner(*_block_runner(self.config, new, self.batch_blocks, self.device))
        old_state = self._runner.release(self.state)
        self.params, self._runner = new, runner
        fresh = init_state(self.config, new.fir_lowpass_taps, self.device)
        if state_compatible(old_state, fresh):
            self.state = old_state
            if flip_lowpass:
                self.state = self.state._replace(
                    screenbuffer=torch.zeros_like(self.state.screenbuffer))
        else:
            self.state = fresh

    # ---- interactive control surface (tsdr_* API equivalents) ----

    def sync_shift(self, pixels: int, direction: int = DIRECTION.CUSTOM) -> None:
        """tsdr_sync (TSDRLibrary.c:576-602)."""
        if pixels == 0:
            return
        w, h = self.config.width, self.config.height
        d = DIRECTION(direction)
        if d == DIRECTION.CUSTOM:
            off = pixels
        elif d == DIRECTION.UP:
            self._check(0 <= pixels <= h, "shift exceeds height")
            off = pixels * w
        elif d == DIRECTION.DOWN:
            self._check(0 <= pixels <= h, "shift exceeds height")
            off = -pixels * w
        elif d == DIRECTION.LEFT:
            self._check(0 <= pixels <= w, "shift exceeds width")
            off = pixels
        else:  # RIGHT
            self._check(0 <= pixels <= w, "shift exceeds width")
            off = -pixels
        self._pending_sync += off

    @staticmethod
    def _check(cond: bool, msg: str):
        if not cond:
            raise TSDRError(TSDRStatus.WRONG_VIDEOPARAMS, msg)

    def set_motionblur(self, coeff: float) -> None:
        """tsdr_motionblur (TSDRLibrary.c:568-574)."""
        if not 0.0 <= coeff <= 1.0:
            raise TSDRError(TSDRStatus.WRONG_VIDEOPARAMS, "motionblur outside [0,1]")
        self._motionblur = coeff

    def reset_autocorr(self) -> None:
        """PARAM_AUTOCORR_PLOTS_RESET equivalent."""
        self._pending_ac_reset = True

    def dump_autocorr(self, path: str = "autocorr.csv", windows: bool = False) -> bool:
        """PARAM_AUTOCORR_DUMP equivalent: write the latest round's raw
        autocorrelation half-range |R(j)| to CSV as "ms, dB" rows, exactly
        like dump_autocorrect (frameratedetector.c:64-85: t = 1000*lag/sr,
        dB = 10*log10(|R|), full half-range of the pow2 FFT, raw — not the
        running average). `windows=True` instead dumps the two accumulated
        analysis windows (an extra of this package). Returns False if no
        estimation round has completed yet.

        Safe from any thread: ac_calls and ac_last_full are read in ONE copy
        from one reference to the state, queued behind the batches already
        launched, so both belong to the same round."""
        if windows:
            if not self._last_plots:
                return False
            with open(path, "w") as f:
                f.write("ms, dB\n")
                for ev in self._last_plots:
                    t = (ev.offset + np.arange(len(ev.values))) / ev.samplerate * 1000.0
                    db = 10.0 * np.log10(np.maximum(np.abs(ev.values), 1e-30))
                    for ti, di in zip(t, db):
                        f.write(f"{ti:f}, {di:f}\n")
            self._emit_value(ValueEvent(VALUE_ID.AUTOCORRECT_DUMPED, 0, 0))
            return True
        st = self.state
        both = torch.cat([st.ac_calls.to(torch.float64).reshape(1),
                          st.ac_last_full.to(torch.float64)]).cpu().numpy()
        calls, r = int(both[0]), both[1:]
        if calls == 0:
            return False
        sr = self.config.samplerate
        t = np.arange(r.shape[0]) / sr * 1000.0
        db = 10.0 * np.log10(np.maximum(np.abs(r), 1e-300))
        with open(path, "w") as f:
            f.write("ms, dB\n")
            for ti, di in zip(t, db):
                f.write(f"{ti:f}, {di:f}\n")
        self._emit_value(ValueEvent(VALUE_ID.AUTOCORRECT_DUMPED, 0, 0))
        return True

    def set_basefreq(self, freq: float) -> None:
        """tsdr_setbasefreq (TSDRLibrary.c:195-205): retune + flush the
        cached autocorrelation estimate."""
        self.source.set_basefreq(freq)
        self._pending_ac_reset = True

    def set_gain(self, gain: float) -> None:
        self.source.set_gain(gain)

    def current_refreshrate(self) -> float:
        """Nominal + carried PLL delta. Safe to call from any thread: a
        caller on another thread than a streaming loop gets the host mirror
        refreshed at every emitted frame (_fan_out), which costs no device
        synchronization behind the loop's queued work; the loop's own
        thread (a callback) and callers of an idle session read the delta
        from one reference to the state."""
        off_thread = self._running and threading.get_ident() != self._loop_ident
        if off_thread and self._last_refresh is not None:
            return self._last_refresh
        st = self.state
        return float(self.config.refreshrate + st.pll.refresh_delta.cpu().numpy())

    def nudge_refreshrate(self, delta_hz: float) -> float:
        """Manual framerate nudge — the GUI's framerate hold-buttons
        (Main.java:1012-1020 onFrameRateChanged -> setFrameRate). The
        reference re-derives geometry on every nudge (setResolution ->
        set_internal_samplerate); here the nudge rides the same carried PLL
        refresh_delta the PLL itself uses, so small corrections apply LIVE
        with no rebuild. Saturates at the static headroom
        (config.PLL_HEADROOM_FRAC of nominal); returns the refresh rate that
        will be in effect after the nudge — when it stops tracking the
        requests, the caller should treat the target rate as a geometry
        change (warm_resolution + restart)."""
        self._pending_refresh += float(delta_hz)
        lim = self.config.refreshrate * PLL_HEADROOM_FRAC
        cur = self.current_refreshrate() - self.config.refreshrate
        return self.config.refreshrate + max(-lim, min(lim, cur + self._pending_refresh))

    def _apply_refresh_nudge(self) -> None:
        lim = self.config.refreshrate * PLL_HEADROOM_FRAC
        d = float(self.state.pll.refresh_delta.cpu().numpy()) + self._pending_refresh
        self._pending_refresh = 0.0
        self.state = self.state._replace(
            pll=self.state.pll._replace(
                refresh_delta=torch.tensor(np.float32(max(-lim, min(lim, d))),
                                           device=self.device)))

    # ---- checkpoint / resume: the JAX package's .npz format and leaf order ----

    def save_state(self, path) -> None:
        path = os.fspath(path)
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez(path, *state_to_numpy(self.state))

    def load_state(self, path) -> None:
        path = os.fspath(path)
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path) as z:
            flat = [z[k] for k in z.files]
        ref = state_leaves(self.state)
        if len(flat) != len(ref) or any(
            tuple(x.shape) != tuple(y.shape) or x.dtype != y.detach().cpu().numpy().dtype
            for x, y in zip(flat, ref)
        ):
            raise TSDRError(TSDRStatus.INVALID_PARAMETER_VALUE,
                            "checkpoint does not match this session's geometry/params")
        self.state = state_from_numpy(flat, self.device)

    # ---- the streaming loop ----

    def _apply_pending_controls(self) -> None:
        """Params, autocorrelation reset and refresh nudge, applied as each
        block ARRIVES (before it is queued), so under batching they act on
        the whole pending batch."""
        if self._pending_params is not None:
            self._apply_pending_params()
        if self._pending_ac_reset:
            self.state = reset_autocorr(self.state)
            self._pending_ac_reset = False
            self._emit_value(ValueEvent(VALUE_ID.AUTOCORRECT_RESET, 0, 0))
        if self._pending_refresh:
            self._apply_refresh_nudge()

    def _source_blocks(self):
        """The source's blocks as (interleaved samples, drops), the pending
        controls applied and the drops counted as each arrives; ends with
        the stream or once the session stops."""
        for blk in self.source.stream(self.config.block_samples):
            if not self._running:
                return
            self._apply_pending_controls()
            self.samples_dropped_total += blk.dropped
            yield np.asarray(blk.samples).reshape(-1), blk.dropped

    def _superres_blocks(self):
        """Superbandwidth mode (PARAM_AUTOCORR_SUPERRESOLUTION): frequency
        hops gathered from the source's blocks at native rate, stitched
        into a HOPS-x-rate stream and yielded as blocks of float32 samples
        with no drops — the reference's superb_run -> am_demod
        path (TSDRLibrary.c:271-278); each native block's drops go to the
        stitcher. The Session's config must already be built for
        hops*native rate (api.TSDR does this when the param is set): this
        raises before anything streams when it is not."""
        from ..superband import SuperBandwidth

        sb = SuperBandwidth(
            self.source.samplerate(),
            self.config.refreshrate,
            retune=getattr(self.source, "set_freq_offset", lambda off: None),
            device=self.device,
        )
        if abs(self.config.samplerate - sb.output_samplerate) > 1:
            raise TSDRError(
                TSDRStatus.WRONG_VIDEOPARAMS,
                f"superresolution config needs samplerate {sb.output_samplerate}",
            )

        n = self.config.block_samples

        def stitched():
            carry = np.empty(0, np.complex64)
            # hop gathering happens at the source's native block size
            for raw, dropped in self._source_blocks():
                f = _normalize_host(raw)
                out = sb.feed((f[0::2] + 1j * f[1::2]).astype(np.complex64), dropped)
                if out is None:
                    continue
                carry = np.concatenate([carry, out]) if carry.size else out
                while carry.size >= n and self._running:
                    block, carry = carry[:n], carry[n:]
                    inter = np.empty(2 * n, np.float32)
                    inter[0::2] = block.real
                    inter[1::2] = block.imag
                    yield inter, 0

        return stitched()

    def _dispatch_blocks(self, raws: list, dropped: list) -> int:
        """One dispatch (a tsdr/dispatch span): the runner's K blocks (each
        block's drop count in its own slot, the pending sync shift in slot
        0 only) through _dispatch_rows, then each block's callbacks in
        stream order. Returns the frames emitted."""
        with span("tsdr/dispatch"):
            sync, self._pending_sync = self._pending_sync, 0
            self.state, rows = _dispatch_rows(
                self._runner, self.state, raws, host_controls(dropped, sync, self._motionblur),
                self.download_stats, plots=True)  # dump_autocorr(windows=True) reads them
            total = 0
            with span("tsdr/fanout"):
                for values, frames, plots in rows:
                    got = self._fan_out(values, frames, plots)
                    total += got
                    self.meter.update(self.config.block_samples, got)
            return total

    def run(self, max_blocks: Optional[int] = None, max_frames: Optional[int] = None):
        """Synchronous loop (blocking like tsdr_readasync, TSDRLibrary.c:515).
        Returns the number of frames emitted. The blocks are the source's
        or, under superresolution, the stitched stream's. The limits are
        tested after each dispatch, so a batched session overshoots
        max_blocks to a whole batch; a trailing partial batch at the end of
        the stream is not dispatched. Each block's arrival (the source's
        next(), the controls applied as it arrives) is a tsdr/source span;
        with the dispatches' spans they tile the loop."""
        blks = self._superres_blocks() if self.params.superresolution else self._source_blocks()
        self._runner = _lease_runner(*_block_runner(self.config, self.params, self.batch_blocks,
                                                    self.device))
        self._running = True
        self._loop_ident = threading.get_ident()
        blocks = frames = 0
        pending_raws: list = []
        pending_dropped: list = []
        try:
            while True:
                with span("tsdr/source"):
                    blk = next(blks, None)
                    if blk is None:
                        break
                    # each block's drop count rides at its own slot so
                    # compensation fires at the drop's true stream position
                    pending_raws.append(blk[0])
                    pending_dropped.append(blk[1])
                if len(pending_raws) < self.batch_blocks:
                    continue
                # the runner stages a batch's blocks in its pinned buffer
                raws, dropped = pending_raws, pending_dropped
                pending_raws, pending_dropped = [], []
                frames += self._dispatch_blocks(raws, dropped)
                blocks += len(dropped)
                if max_blocks is not None and blocks >= max_blocks:
                    break
                if max_frames is not None and frames >= max_frames:
                    break
        except BaseException as e:  # propagate like announceexception
            if self.callbacks.on_exception:
                self.callbacks.on_exception(e)
            else:
                raise
        finally:
            self.state = self._runner.release(self.state)
            self._running = False
            self.source.stop()
            if self.callbacks.on_stopped:
                self.callbacks.on_stopped()
        return frames

    def start_async(self, **kw) -> None:
        """TSDRLibrary.java:288-338 startAsync equivalent."""
        if self._thread is not None and self._thread.is_alive():
            raise TSDRError(TSDRStatus.ALREADY_RUNNING, "session already streaming")
        # mark running BEFORE the thread is scheduled: a caller polling
        # is_running right after start_async must not observe a not-yet-
        # started loop as "stopped" (run() re-asserts and clears in finally)
        self._running = True
        self._thread = threading.Thread(target=self.run, kwargs=kw, daemon=True)
        self._thread.start()

    def stop(self, join: bool = True) -> None:
        self._running = False
        self.source.stop()
        if join and self._thread is not None:
            self._thread.join(timeout=30)

    @property
    def is_running(self) -> bool:
        return self._running

    # ---- output fan-out ----

    def _emit_value(self, ev: ValueEvent):
        if self.callbacks.on_value:
            with span("tsdr/callback"):
                self.callbacks.on_value(ev)

    def _fan_out(self, vals: dict, frames: list, plots) -> int:
        """One block's fetched values, downloaded frames and plot events
        (frame window, line window; None without a completed round) -> the
        reference's callback streams; returns the number of frames."""
        if frames:
            rr = vals["refreshrate"]
            changed = rr != self._last_refresh
            self._last_refresh = rr
            if self.params.framerate_pll and changed:
                self._emit_value(ValueEvent(VALUE_ID.PLL_FRAMERATE, rr, 0))
        for fr in frames:
            if self.callbacks.on_frame:
                with span("tsdr/callback"):
                    self.callbacks.on_frame(fr)
            # reference cadence quirk (dsp.c:231-235 `runs++ > 5`): first
            # report on frame 7, then every 7 frames
            if self._agruns > AUTOGAIN_REPORT_EVERY_FRAMES:
                self._agruns = 0
                self._emit_value(ValueEvent(VALUE_ID.AUTOGAIN_VALUES, vals["ag_min"],
                                            vals["ag_max"]))
                self._emit_value(ValueEvent(VALUE_ID.SNR, vals["ag_snr"], 0))
            else:
                self._agruns += 1
        if plots is not None:
            self._last_plots = plots
            if self.callbacks.on_plot:
                for p in plots:
                    with span("tsdr/callback"):
                        self.callbacks.on_plot(p)
            self._emit_value(ValueEvent(VALUE_ID.AUTOCORRECT_FRAMES_COUNT, 0,
                                        int(vals["ac_calls"])))
        return len(frames)


@dataclass
class DownloadStats:
    """A session's copies to the host: the downloads (one a stacked copy),
    their bytes, and the fresh pinned blocks torch's caching host allocator
    made across them (its allocation count before and after; 0 on the CPU).
    A download that finds a cached block free is a hit."""
    downloads: int = 0
    bytes: int = 0
    fresh_pinned: int = 0

    @property
    def pinned_hit_share(self) -> float:
        return 1.0 - self.fresh_pinned / max(self.downloads, 1)


def _pinned_blocks(device: torch.device) -> int:
    """The pinned blocks torch's caching host allocator has made so far
    (0 off the card): host_memory_stats()'s allocation count, read from its
    nested form, which skips the flattening and sorting that cost about
    35 us a call on an H100's host."""
    if device.type != "cuda":
        return 0
    return torch.cuda.memory.host_memory_stats_as_nested_dict()["num_host_alloc"]


def _wait_for_copies(device: torch.device) -> None:
    """On the card, wait once for the current stream: every copy queued on
    it has landed."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _to_host(stack: torch.Tensor, rows: list) -> torch.Tensor:
    """Queue the copy of rows (at least one) of a stacked tensor into host
    memory of its own (a run of consecutive rows as a slice, others gathered
    first): from the card into pinned memory of torch's caching host
    allocator, not waited for; on the CPU a plain copy."""
    if rows == list(range(rows[0], rows[0] + len(rows))):
        picked = stack[rows[0]:rows[0] + len(rows)]
    else:
        picked = stack[rows]
    on_cuda = picked.is_cuda
    host = torch.empty(picked.shape, dtype=picked.dtype, pin_memory=on_cuda)
    return host.copy_(picked, non_blocking=on_cuda)


def _download(stack: torch.Tensor, rows: list) -> list:
    """Rows of a stacked tensor as numpy arrays, in one copy to the host and
    one wait for the stream, which covers any copy queued before it. The
    rows are views of a host block of their own, never of the stack: a
    pinned block goes back to the allocator's cache only once every row of
    it is dropped, so a caller keeps what it holds across blocks."""
    if not rows:
        return []
    host = _to_host(stack, rows)
    _wait_for_copies(stack.device)
    return list(host.numpy())


def _download_outputs(out, frame_shape: tuple, frame_rows: list, plot_rows: list,
                      stats: DownloadStats) -> tuple:
    """A dispatch's valid frames (through this module's _download, looked
    up at each call, so a wrapper set on it sees both sessions' frames) and
    its completed rounds' plots (each row the frame window, then the line
    window), in a tsdr/download span and counted in stats. The plots' copy
    is queued ahead of the frames', so the frames' one wait covers both.
    Returns (frames, plots), lists of numpy rows."""
    if not frame_rows and not plot_rows:
        return [], []
    device = out.frame.device
    with span("tsdr/download"):
        made = _pinned_blocks(device)
        plot_host = _to_host(torch.cat([out.ac_frame_plot, out.ac_line_plot], dim=1),
                             plot_rows) if plot_rows else None
        frames = _download(out.frame.reshape(-1, *frame_shape), frame_rows)
        if plot_host is not None and not frame_rows:
            _wait_for_copies(device)
        plots = [] if plot_host is None else list(plot_host.numpy())
        stats.downloads += bool(frame_rows) + bool(plot_rows)
        stats.bytes += sum(a.nbytes for a in frames) + sum(a.nbytes for a in plots)
        stats.fresh_pinned += _pinned_blocks(device) - made
    return frames, plots


def _dispatch_rows(runner: BlockRunner, state: StreamState, raws, controls,
                   stats: DownloadStats, plots: bool) -> tuple:
    """What a dispatch of either session does before its fan-out: the
    runner's call on raws and controls, ONE packed fetch of its rows (a
    Session's blocks, a MultiSession's channels), then the valid frames in
    one download and, with `plots`, the completed rounds' plots in another
    (_download_outputs). Returns (state, rows): per row its packed values
    by PACKED name, its frames in slot order, and its plot events (frame
    window, line window), or None without a completed round or without
    `plots`."""
    state, out, packed = runner.run(state, raws, controls)
    with span("tsdr/fetch"):
        rows = packed.tolist()  # the one fetch of the dispatch
    cfg = runner.config
    kf = cfg.frames_per_block
    slots = [(r, j) for r, row in enumerate(rows) for j in range(kf) if row[len(PACKED) + j]]
    rounds = [r for r, row in enumerate(rows) if plots and row[PACKED.index("ac_plot_valid")]]
    frames, plot_rows = _download_outputs(out, (cfg.height, cfg.width),
                                          [r * kf + j for r, j in slots], rounds, stats)
    per_row = [[] for _ in rows]
    for (r, _), frame in zip(slots, frames):
        per_row[r].append(frame)
    fw, sr = out.ac_frame_plot.shape[-1], cfg.samplerate
    events = {r: (PlotEvent(PLOT_ID.FRAME, cfg.ac_frame_window[0], p[:fw], sr),
                  PlotEvent(PLOT_ID.LINE, cfg.ac_line_window[0], p[fw:], sr))
              for r, p in zip(rounds, plot_rows)}
    return state, [(dict(zip(PACKED, row)), per_row[r], events.get(r))
                   for r, row in enumerate(rows)]
