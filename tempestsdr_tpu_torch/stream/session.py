"""Host-side streaming session: feeds source blocks through the step and
fans results out to the reference's callback channels (tsdr_readasync,
TSDRLibrary.c:467-536). Interactive controls (sync shift, motion blur,
autocorrelation reset/dump, live params, framerate nudge) are plain method
calls applied between blocks — no locks.

batch_blocks > 1 uploads that many blocks in one stacked copy and runs the
steps one after another before any frame or plot is fetched, at the cost of
batch_blocks x block latency for the controls. The step already knows on the
host which frames and plots completed (Step.last), so a block that completes
neither costs no fetch here; one that does fetches its frames and one packed
tensor of the small values.
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
from ..utils.profiling import IngestMeter, auto_batch_blocks
from .pipeline import Step, StepControls, make_step
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
# Step, and its first block pays what nothing later pays: the build and load
# of the CUDA kernels (kernels/build.py), the cuFFT plan of ac_fft_size and
# the allocator's first blocks of each shape. warm_compile_step pays that
# WHILE the current session still streams, so the stop -> start switch costs
# only the stream gap. Warmed Steps are cached by (config, params,
# batch_blocks, device); Session._build_steps reuses them.

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


def _upload(raws: np.ndarray, device) -> torch.Tensor:
    """One host -> device copy of a block [2n] or a stack of blocks [k, 2n],
    in the source's raw dtype: uint8/int8 blocks reach K2
    (resampler="fused") as they come off the source."""
    return torch.from_numpy(np.ascontiguousarray(raws)).to(device)


def _step_blocks(step: Step, state: StreamState, raws, dropped, sync: int, motionblur: float):
    """Run one step per row of raws. dropped and sync are one-shot events:
    each block's drop count rides its own slot, the sync shift slot 0 only.
    Returns the state and, per block in stream order, (StepOutputs,
    StepHost): Step.last is per call, so it is taken here, before the next
    step replaces it."""
    per_block = []
    for i, dr in enumerate(dropped):
        controls = StepControls(int(dr), int(sync) if i == 0 else 0, float(motionblur))
        state, out = step(state, raws[i], controls)
        per_block.append((out, step.last))
    return state, per_block


def warm_compile_step(config: PipelineConfig, params: Params, *,
                      batch_blocks=1, raw_dtype=np.float32,
                      max_control_latency_s: float = 0.25, device="cuda") -> None:
    """Build AND warm the Step a future Session(config, params,
    batch_blocks, device) will use, so that session's first block pays no
    kernel build, FFT plan or first allocation. Blocking (returns once the
    device has finished); call from a background thread to overlap with a
    live session: the dummy blocks run on a state of their own, and a Step
    keeps no per-call scratch that two threads share. raw_dtype must match
    the source's block dtype (Source.block_dtype()) so the warmed path
    (decode, or K2 on uint8/int8) is the one used. batch_blocks may be
    "auto" (resolved like Session's)."""
    dev = resolve_device(device)
    batch_blocks = resolve_batch_blocks(config, batch_blocks, max_control_latency_s, dev)
    key = (config, params, int(batch_blocks), dev)
    with _WARM_LOCK:
        step = _WARM_STEPS.get(key)
        if step is None:
            step = _WARM_STEPS[key] = make_step(config, params, dev)
    state = init_state(config, params.fir_lowpass_taps, dev)
    raws = _upload(np.zeros((batch_blocks, 2 * config.block_samples), raw_dtype), dev)
    state, _ = _step_blocks(step, state, raws, [0] * batch_blocks, 0, 0.0)
    # the branches a block of zeros does not take: an estimation round, an emit
    step.warm(state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
        upload, the steps back to back, then the fetches — at the cost of
        batch_blocks x block latency for interactive controls.

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
        self._build_steps(params)
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
        self._last_plots: list = []
        # cumulative source-reported drops (UHD/Mirics samples_dropped
        # semantics, TSDRPlugin.h:49) — observability for overload diagnosis
        self.samples_dropped_total = 0
        self.meter = IngestMeter()

    def _build_steps(self, params: Params) -> None:
        key = (self.config, params, self.batch_blocks, self.device)
        with _WARM_LOCK:
            step = _WARM_STEPS.get(key)  # warm_compile_step ran for this key
        self._step = step if step is not None else make_step(self.config, params, self.device)

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
        old_state = self.state
        self.params = new
        self._build_steps(new)
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

        Safe from any thread: the loop replaces self.state between blocks
        and writes only the ring (ac_buf) in place; ac_calls and
        ac_last_full are fresh tensors each round, so both are read from ONE
        reference to the state and belong to the same round."""
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
        calls = int(st.ac_calls)
        r = st.ac_last_full.cpu().numpy()
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
        refreshed at every emitted frame (_dispatch), which costs no device
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

    def _dispatch_blocks(self, raws: np.ndarray, dropped) -> int:
        """One dispatch: upload the stacked blocks, run their steps (the
        pending sync shift on slot 0 only), then fan each block's outputs
        out in stream order. Returns the frames emitted."""
        sync = self._pending_sync
        self._pending_sync = 0
        self.state, per_block = _step_blocks(
            self._step, self.state, _upload(raws, self.device), dropped, sync, self._motionblur)
        frames = 0
        for out, host in per_block:
            got = self._dispatch(out, host)
            frames += got
            self.meter.update(self.config.block_samples, got)
        return frames

    def run(self, max_blocks: Optional[int] = None, max_frames: Optional[int] = None):
        """Synchronous loop (blocking like tsdr_readasync, TSDRLibrary.c:515).
        Returns the number of frames emitted. The limits are tested after
        each dispatch, so a batched session overshoots max_blocks to a whole
        batch; a trailing partial batch at the end of the stream is not
        dispatched."""
        if self.params.superresolution:
            return self._run_superres(max_blocks, max_frames)
        self._running = True
        self._loop_ident = threading.get_ident()
        blocks = frames = 0
        pending_raws: list = []
        pending_dropped: list = []
        try:
            for blk in self.source.stream(self.config.block_samples):
                if not self._running:
                    break
                self._apply_pending_controls()
                # each block's drop count rides at its own slot so
                # compensation fires at the drop's true stream position
                pending_raws.append(np.asarray(blk.samples).reshape(-1))
                pending_dropped.append(blk.dropped)
                self.samples_dropped_total += blk.dropped
                if len(pending_raws) < self.batch_blocks:
                    continue
                # batch 1 uploads the block as it is; a batch, one stacked copy
                raws = pending_raws[0][None] if self.batch_blocks == 1 else np.stack(pending_raws)
                dropped = pending_dropped
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
            self._running = False
            self.source.stop()
            if self.callbacks.on_stopped:
                self.callbacks.on_stopped()
        return frames

    def _run_superres(self, max_blocks: Optional[int], max_frames: Optional[int]):
        """Superbandwidth mode (PARAM_AUTOCORR_SUPERRESOLUTION): gather
        frequency hops from the source at native rate, stitch them into a
        HOPS-x-rate stream, and feed that through the pipeline — the
        reference's superb_run -> am_demod path (TSDRLibrary.c:271-278).

        The Session's config must already be built for hops*native rate
        (api.TSDR does this when the param is set)."""
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
        self._running = True
        self._loop_ident = threading.get_ident()
        blocks = frames = 0
        n = self.config.block_samples
        carry = np.empty(0, np.complex64)
        try:
            # hop gathering happens at the source's native block size
            for blk in self.source.stream(n):
                if not self._running:
                    break
                self._apply_pending_controls()
                self.samples_dropped_total += blk.dropped
                f = _normalize_host(np.asarray(blk.samples))
                iq = (f[0::2] + 1j * f[1::2]).astype(np.complex64)
                out = sb.feed(iq, blk.dropped)
                if out is None:
                    continue
                carry = np.concatenate([carry, out]) if carry.size else out
                # whole batches of the stitched stream go through the steps
                bb = self.batch_blocks
                while carry.size >= bb * n and self._running:
                    batch, carry = carry[: bb * n], carry[bb * n:]
                    inter = np.empty(2 * bb * n, np.float32)
                    inter[0::2] = batch.real
                    inter[1::2] = batch.imag
                    frames += self._dispatch_blocks(inter.reshape(bb, 2 * n), [0] * bb)
                    blocks += bb
                    if max_blocks is not None and blocks >= max_blocks:
                        self._running = False
                    if max_frames is not None and frames >= max_frames:
                        self._running = False
        finally:
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
            self.callbacks.on_value(ev)

    def _dispatch(self, out, host) -> int:
        """One block's StepOutputs and StepHost -> the reference's callback
        streams; returns the number of frames emitted."""
        slots = [i for i, ok in enumerate(host.frame_valid) if ok]
        if not slots and not host.round_done:
            return 0
        rr, ag_min, ag_max, ag_snr, ac_calls = torch.stack([
            out.refreshrate.to(torch.float64), out.ag_min.to(torch.float64),
            out.ag_max.to(torch.float64), out.ag_snr.to(torch.float64),
            out.ac_calls.to(torch.float64),
        ]).tolist()
        if slots:
            stack = out.frame.unsqueeze(0) if out.frame.dim() == 2 else out.frame[slots]
            emitted = list(stack.cpu().numpy())
            changed = rr != self._last_refresh
            self._last_refresh = rr
            if self.params.framerate_pll and changed:
                self._emit_value(ValueEvent(VALUE_ID.PLL_FRAMERATE, rr, 0))
        else:
            emitted = []
        for fr in emitted:
            if self.callbacks.on_frame:
                self.callbacks.on_frame(fr)
            # reference cadence quirk (dsp.c:231-235 `runs++ > 5`): first
            # report on frame 7, then every 7 frames
            if self._agruns > AUTOGAIN_REPORT_EVERY_FRAMES:
                self._agruns = 0
                self._emit_value(ValueEvent(VALUE_ID.AUTOGAIN_VALUES, ag_min, ag_max))
                self._emit_value(ValueEvent(VALUE_ID.SNR, ag_snr, 0))
            else:
                self._agruns += 1
        if host.round_done:
            sr = self.config.samplerate
            f_off, _ = self.config.ac_frame_window
            l_off, _ = self.config.ac_line_window
            plots = [
                PlotEvent(PLOT_ID.FRAME, f_off, out.ac_frame_plot.cpu().numpy(), sr),
                PlotEvent(PLOT_ID.LINE, l_off, out.ac_line_plot.cpu().numpy(), sr),
            ]
            self._last_plots = plots
            if self.callbacks.on_plot:
                for p in plots:
                    self.callbacks.on_plot(p)
            self._emit_value(ValueEvent(VALUE_ID.AUTOCORRECT_FRAMES_COUNT, 0, int(ac_calls)))
        return len(emitted)
