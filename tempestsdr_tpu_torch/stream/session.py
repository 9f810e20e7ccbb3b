"""Host-side streaming session: feeds source blocks through the step and
fans results out to the reference's callback channels (tsdr_readasync,
TSDRLibrary.c:467-536). Interactive controls (sync shift, motion blur,
autocorrelation reset) are plain method calls applied between blocks.

One block per step (batch_blocks=1). The step already knows on the host
which frames and plots completed (Step.last), so a block that completes
neither costs no fetch here; one that does fetches its frames and one packed
tensor of the small values.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import resolve_device
from ..errors import TSDRError, TSDRStatus
from ..events import PLOT_ID, VALUE_ID, PlotEvent, ValueEvent
from ..params import DIRECTION, Params
from ..sources.base import Source
from .pipeline import StepControls, make_step
from .state import (
    StreamState,
    init_state,
    reset_autocorr,
    state_from_numpy,
    state_leaves,
    state_to_numpy,
)

AUTOGAIN_REPORT_EVERY_FRAMES = 5  # dsp.c:20


@dataclass
class SessionCallbacks:
    on_frame: Optional[Callable[[np.ndarray], None]] = None
    on_value: Optional[Callable[[ValueEvent], None]] = None
    on_plot: Optional[Callable[[PlotEvent], None]] = None
    on_stopped: Optional[Callable[[], None]] = None
    on_exception: Optional[Callable[[BaseException], None]] = None


class Session:
    def __init__(self, config: PipelineConfig, params: Params, source: Source,
                 callbacks: SessionCallbacks | None = None, batch_blocks: int = 1,
                 device="cuda"):
        if batch_blocks != 1:
            raise NotImplementedError(
                "not ported yet: batch_blocks > 1 (ROADMAP.md Queue 1: session batching)")
        if params.superresolution:
            raise NotImplementedError(
                "not ported yet: superresolution (ROADMAP.md Queue 1: superband.py)")
        self.device = resolve_device(device)
        self.config = config
        self.params = params
        self.source = source
        self.callbacks = callbacks or SessionCallbacks()
        self.batch_blocks = 1
        self._step = make_step(config, params, self.device)
        self.state: StreamState = init_state(config, params.fir_lowpass_taps, self.device)
        self._pending_sync = 0
        self._motionblur = 0.0
        self._pending_ac_reset = False
        self._running = False
        self._agruns = 0
        self._last_refresh = None
        self.samples_dropped_total = 0

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

    def run(self, max_blocks: Optional[int] = None, max_frames: Optional[int] = None):
        """Synchronous loop (blocking like tsdr_readasync, TSDRLibrary.c:515).
        Returns the number of frames emitted."""
        self._running = True
        blocks = frames = 0
        try:
            for blk in self.source.stream(self.config.block_samples):
                if not self._running:
                    break
                if self._pending_ac_reset:
                    self.state = reset_autocorr(self.state)
                    self._pending_ac_reset = False
                    self._emit_value(ValueEvent(VALUE_ID.AUTOCORRECT_RESET, 0, 0))
                self.samples_dropped_total += blk.dropped
                controls = StepControls(int(blk.dropped), int(self._pending_sync),
                                        float(self._motionblur))
                self._pending_sync = 0
                # 1-D in the source's raw dtype: uint8/int8 blocks reach K2
                # (resampler="fused") as they come off the source
                raw = torch.from_numpy(np.ascontiguousarray(blk.samples).reshape(-1)).to(self.device)
                self.state, out = self._step(self.state, raw, controls)
                blocks += 1
                frames += self._dispatch(out)
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

    # ---- output fan-out ----

    def _emit_value(self, ev: ValueEvent):
        if self.callbacks.on_value:
            self.callbacks.on_value(ev)

    def _dispatch(self, out) -> int:
        """StepOutputs -> the reference's callback streams; returns the
        number of frames emitted."""
        host = self._step.last
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
            if self.callbacks.on_plot:
                for p in plots:
                    self.callbacks.on_plot(p)
            self._emit_value(ValueEvent(VALUE_ID.AUTOCORRECT_FRAMES_COUNT, 0, int(ac_calls)))
        return len(emitted)
