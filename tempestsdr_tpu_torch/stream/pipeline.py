"""The per-block streaming step, single channel.

step(state, raw, controls) does for one block of raw IQ what the
reference's threads do (SURVEY.md §3.2-3.4), as tempestsdr_tpu's make_step:

  raw -> normalize -> AM demod ---------> autocorrelation ring (+ FFT round)
                         |
     drop compensation (exact phase arithmetic), PLL-modulated rate
                         |
     [optional FIR low-pass]
                         |
     fractional box resample to pixel rate (Params.resampler: K1, K3 or K4
     on the card, or a plain form; nearest-neighbour; or K2, which also
     does the decode and demod above in the same launch)
                         |
     manual-sync pixel skip + frame fold
                         |
     per completed frame: autogain / collapse / sync search / PLL /
     autoshift or markers / motion-blur IIR

Where the JAX step branches on device values with lax.cond (sync skip,
emit, the K > 1 slots, the FFT round, K1's margin fallback), this step reads
the few integers they depend on in ONE host fetch per block — n_out, drop
flag, fold fill, pending skip and ring fill, packed into one tensor — and
branches in Python. The slices the JAX step takes at traced offsets become
plain slices at those host offsets, asserted in range (lax.dynamic_slice
would clamp). K1 and K2 need no branch: their tap loops cover the whole
PLL headroom. Autoshift needs the detected position as a roll shift, one more
fetch per emitted frame, only with Params.autoshift.

The step updates the fold buffer and the autocorrelation ring in place: it
consumes the state it is given, like the JAX Session's donated step.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..config import (
    FRAC_BITS,
    NORMALISATION_LOWPASS_COEFF,
    PIXEL_SPECIAL_VALUE_G,
    PLL_HEADROOM_FRAC,
    PipelineConfig,
)
from ..device import resolve_device
from ..params import Params
from ..kernels.chunked_resample import box_resample_pallas_cuda, box_resample_pallas_windows_cuda
from ..kernels.fused_demod_resample import fused_demod_resample_cuda
from ..kernels.strided_resample import box_resample_strided_cuda
from ..ops.autocorr import accumulate_running_mean, autocorrelation_magnitude
from ..ops.demod import am_demod, normalize_iq
from ..ops.fir import design_lowpass_fir, fir_apply_block
from ..ops.frame import autogain_run, collapse_v_h, time_lowpass
from ..ops.resample import (
    box_resample_block_chunked,
    box_resample_strided,
    nn_resample_block,
    plan_strided,
)
from ..ops.sync import (
    FRAMERATE_DX_LOWPASS_COEFF_HEIGHT,
    FRAMERATE_DX_LOWPASS_COEFF_WIDTH,
    find_the_sweet_spot,
    framerate_pll,
)
from .state import StepOutputs, StreamState


class StepControls(NamedTuple):
    """Per-block host inputs: plugin-reported drops, manual sync shift in
    pixels (tsdr_sync), motion-blur coefficient."""

    samples_dropped: int = 0
    syncoffset: int = 0
    motionblur: float = 0.0

    @staticmethod
    def default() -> "StepControls":
        return StepControls(0, 0, 0.0)


class StepHost(NamedTuple):
    """What the last step branched on, as host values (read by Session so
    it fetches only what a callback needs)."""

    frame_valid: tuple  # one bool per emit slot
    round_done: bool


def _pick_resampler(config: PipelineConfig, params: Params):
    """Params.resampler -> a box resampler, with the JAX package's choices
    and fallbacks (all share the exact int64 carry contract). The kernel
    wrappers run their plain versions on CPU tensors, so on the CPU "auto"
    and "pallas_strided" run the plain strided form, "pallas" and
    "pallas_windows" the plain chunked form. On CUDA tensors:
    "auto"/"pallas_strided" at m == 2 -> K1, "pallas" -> K3,
    "pallas_windows" -> K4; "strided" and "chunked" are the plain forms."""
    choice = params.resampler
    plan = plan_strided(config.samples_per_pixel, config.resample_taps)
    if choice in ("auto", "pallas_strided"):
        if plan is None:
            return box_resample_block_chunked
        return box_resample_strided_cuda if plan[0] == 2 else box_resample_strided
    if choice == "strided":
        return box_resample_strided
    if choice == "chunked":
        return box_resample_block_chunked
    if choice == "pallas":
        return box_resample_pallas_cuda
    if choice == "pallas_windows":
        return box_resample_pallas_windows_cuda
    if choice == "fused":
        # the fused preconditions failed (_fused_wanted): the strided form
        return box_resample_strided
    raise ValueError(f"unknown resampler {choice!r}")


def _fused_wanted(config: PipelineConfig, params: Params) -> bool:
    """Static preconditions of K2 (Params.resampler == "fused"), as the JAX
    package's: no FIR (K2 resamples the raw envelope), box mode, the m == 2
    geometry and a block of a multiple of 4096 samples. The raw block's
    dtype (1-D uint8/int8) is checked per call."""
    if params.resampler != "fused" or params.nearest_neighbour or params.fir_lowpass_taps:
        return False
    plan = plan_strided(config.samples_per_pixel, config.resample_taps)
    return plan is not None and plan[0] == 2 and config.block_samples % 4096 == 0


def _collapse(config: PipelineConfig, params: Params, frame2d):
    if params.fast_sync:
        return collapse_v_h(frame2d, False, widen=False)
    return collapse_v_h(frame2d, config.high_precision_sync)


def _sync_positions(config: PipelineConfig, params: Params, sync_x, sync_y, pll, wprof, hprof):
    """Sweet-spot search on both profiles + the PLL (syncdetector.c:171-186)."""
    sx, _, _ = find_the_sweet_spot(
        sync_x, wprof, int(config.width * np.float32(0.05)), FRAMERATE_DX_LOWPASS_COEFF_WIDTH)
    sy, _, _ = find_the_sweet_spot(
        sync_y, hprof, int(config.height * np.float32(0.01)), FRAMERATE_DX_LOWPASS_COEFF_HEIGHT)
    pll = framerate_pll(pll, sx.vx, enabled=params.framerate_pll,
                        max_delta=PLL_HEADROOM_FRAC * config.refreshrate)
    return sx, sy, pll


def _sync_apply(params: Params, data2d, sx, sy):
    """Autoshift (circular shift moving the detected strips to the frame
    edges) or green crosshair markers (syncdetector.c:187-218)."""
    if params.autoshift:
        dy, dx = torch.stack([sy.dx, sx.dx]).tolist()
        return torch.roll(data2d, shifts=(-dy, -dx), dims=(0, 1))
    if params.debug_markers:
        h, w = data2d.shape
        dev = data2d.device
        col = torch.arange(w, dtype=torch.int32, device=dev)[None, :] == sx.dx
        row = torch.arange(h, dtype=torch.int32, device=dev)[:, None] == sy.dx
        marker = torch.tensor(PIXEL_SPECIAL_VALUE_G, dtype=torch.float32, device=dev)
        return torch.where(col | row, marker, data2d)
    return data2d


def _post_process_default_order(config, params, frame2d, screen, ag, sync_x, sync_y, pll,
                                motionblur):
    """Autogain before sync, lowpass after (dsp.c:192-226, both order flags
    0). The collapse runs on the raw frame: the sweet-spot metric is
    invariant under autogain's affine map, so the positions are the same
    and normalize, shift and motion blur fuse into one elementwise pass."""
    f = frame2d
    _, mn, mx, snr = autogain_run(f, ag[0], ag[1], NORMALISATION_LOWPASS_COEFF, stats_only=True)
    ag = (mn, mx, snr)
    wprof, hprof = _collapse(config, params, f)
    sync_x, sync_y, pll = _sync_positions(config, params, sync_x, sync_y, pll, wprof, hprof)
    span = torch.where(mx == mn, torch.ones_like(mx), mx - mn)
    norm = (f - mn) / span
    syncres = _sync_apply(params, norm, sync_x, sync_y)
    screen = time_lowpass(screen, syncres, motionblur)
    return screen, screen, ag, sync_x, sync_y, pll


def _post_process(config, params, frame2d, screen, ag, sync_x, sync_y, pll, motionblur):
    """dsp_post_process (dsp.c:134-239): the configurable-order chain."""
    if not params.autogain_after_proc and not params.lowpass_before_sync:
        return _post_process_default_order(config, params, frame2d, screen, ag, sync_x,
                                           sync_y, pll, motionblur)
    inp = frame2d
    if not params.autogain_after_proc:
        inp, mn, mx, snr = autogain_run(inp, ag[0], ag[1], NORMALISATION_LOWPASS_COEFF)
        ag = (mn, mx, snr)
    if params.lowpass_before_sync:
        screen = time_lowpass(screen, inp, motionblur)
        wprof, hprof = _collapse(config, params, screen)
        sync_x, sync_y, pll = _sync_positions(config, params, sync_x, sync_y, pll, wprof, hprof)
        syncres = _sync_apply(params, screen, sync_x, sync_y)
        if params.autogain_after_proc:
            result, mn, mx, snr = autogain_run(syncres, ag[0], ag[1], NORMALISATION_LOWPASS_COEFF)
            ag = (mn, mx, snr)
        else:
            result = syncres
    else:
        wprof, hprof = _collapse(config, params, inp)
        sync_x, sync_y, pll = _sync_positions(config, params, sync_x, sync_y, pll, wprof, hprof)
        syncres = _sync_apply(params, inp, sync_x, sync_y)
        screen = time_lowpass(screen, syncres, motionblur)
        if params.autogain_after_proc:
            result, mn, mx, snr = autogain_run(screen, ag[0], ag[1], NORMALISATION_LOWPASS_COEFF)
            ag = (mn, mx, snr)
        else:
            result = screen
    return result, screen, ag, sync_x, sync_y, pll


def _check_range(start: int, size: int, length: int, what: str) -> None:
    """A slice the JAX step takes with lax.dynamic_update_slice, which would
    clamp an out-of-range start; the buffer sizes (state.framebuf_len, the
    ring's ac_round + block) keep every start in range, and this holds it."""
    if not (0 <= start and start + size <= length):
        raise RuntimeError(f"{what} [{start}, {start + size}) outside [0, {length})")


class Step:
    """The single-channel step for one (config, params, device); see the
    module docstring. `last` holds the host values of the calling thread's
    latest call: a Step keeps nothing else per call, so a warmed Step may be
    stepped from a second thread (each on a state of its own) while a
    session streams. Params.superresolution is the session's business: the
    step never reads it."""

    def __init__(self, config: PipelineConfig, params: Params, device):
        self.config, self.params = config, params
        self.device = resolve_device(device)
        self.resample = _pick_resampler(config, params)
        self.fused = _fused_wanted(config, params)
        self.fir_taps = None
        if params.fir_lowpass_taps:
            self.fir_taps = torch.from_numpy(design_lowpass_fir(
                params.fir_lowpass_taps, min(1.0 / config.samples_per_pixel, 0.98))).to(self.device)
        self.run_autocorr = config.autocorr and not params.autocorr_plots_off
        if self.run_autocorr and config.ac_round_samples < config.block_samples:
            raise ValueError("autocorr round shorter than a block; shrink block_samples")
        # two-frame drop-compensation granularity (TSDRLibrary.c:284)
        self.block2 = int(round(2 * config.frame_pixels * config.samples_per_pixel))
        f32 = lambda v: torch.tensor(np.float32(v), device=self.device)  # noqa: E731
        self.rr_f32 = f32(config.refreshrate)
        self.inv0_f32 = f32(config.inv0_fix)
        self._per_thread = threading.local()

    @property
    def last(self) -> StepHost | None:
        return getattr(self._per_thread, "last", None)

    def _full(self, v, dtype):
        return torch.full((), v, dtype=dtype, device=self.device)

    def __call__(self, state: StreamState, raw, controls: StepControls = StepControls()):
        cfg, params = self.config, self.params
        n, taps, mp = cfg.block_samples, cfg.resample_taps, cfg.max_block_pixels
        fp, h, w = cfg.frame_pixels, cfg.height, cfg.width
        raw = torch.as_tensor(raw).to(self.device)
        dropped = int(controls.samples_dropped)

        # ---- drop compensation folded into the phase (dsp.c:313-368):
        # (skip_before - dropped) % block2 is a floor modulo
        phase = state.phase_fix
        if dropped > 0:
            skip_before = torch.clamp(phase, min=0) >> FRAC_BITS
            new_skip = torch.remainder(skip_before - dropped, self.block2)
            phase = phase + ((new_skip - skip_before) << FRAC_BITS)

        # ---- the PLL's delta modulates the fixed-point samples-per-pixel, in
        # f32 with the JAX operation order (one unit of inv_fix moves the phase)
        delta = state.pll.refresh_delta
        corr_factor = delta / (self.rr_f32 + delta)
        inv_corr = torch.round(self.inv0_f32 * corr_factor).to(torch.int64)
        inv_fix = cfg.inv0_fix - inv_corr

        # ---- demod + resample: K2 in one launch, or the demod, the optional
        # FIR (the autocorrelation ring takes the pre-FIR envelope) and the
        # chosen resampler
        fir_tail = state.fir_tail
        if self.fused and raw.dim() == 1 and raw.dtype in (torch.uint8, torch.int8):
            env, pixels, n_out, phase2 = fused_demod_resample_cuda(
                raw, state.tail, phase, inv_fix, n_samples=n, max_pix=mp, taps=taps,
                inv_nominal=cfg.samples_per_pixel)
            new_tail = env[n - taps:].clone()
        else:
            env = am_demod(normalize_iq(raw))
            env_rs = env
            if self.fir_taps is not None:
                env_rs, fir_tail = fir_apply_block(env, state.fir_tail, self.fir_taps)
            x_ext = torch.cat([state.tail, env_rs])
            if params.nearest_neighbour:
                pixels, n_out, phase2 = nn_resample_block(env_rs, phase, inv_fix, n_samples=n,
                                                          max_pix=mp)
            else:
                pixels, n_out, phase2 = self.resample(
                    x_ext, phase, inv_fix, n_samples=n, max_pix=mp, taps=taps,
                    inv_nominal=cfg.samples_per_pixel)
            new_tail = x_ext[x_ext.shape[0] - taps:].clone()

        # ---- the one host fetch of the block
        drop_all = phase >= (n << FRAC_BITS)
        n_out_h, drop_all_h, fill_h, skip_h, ac_fill_h = torch.stack([
            n_out.to(torch.int64), drop_all.to(torch.int64), state.fill.to(torch.int64),
            state.skip_pixels.to(torch.int64), state.ac_fill.to(torch.int64),
        ]).tolist()

        # ---- autocorrelation ring (frameratedetector.c:215-230)
        ac_buf, ac_fill, round_done = state.ac_buf, ac_fill_h, False
        ac = (state.ac_avg_frame, state.ac_avg_line, state.ac_calls, state.ac_last_full)
        if self.run_autocorr:
            purge = dropped != 0
            fed = not drop_all_h and not purge
            ac_fill = 0 if purge else ac_fill_h
            if fed:
                _check_range(ac_fill, n, ac_buf.shape[0], "autocorrelation ring write")
                ac_buf[ac_fill:ac_fill + n] = env
                ac_fill += n
            round_done = ac_fill >= cfg.ac_round_samples
            if round_done:
                ac_fill -= cfg.ac_round_samples
                ac = self._ac_round(ac_buf, *ac)

        # ---- manual sync shift as a pixel skip (tsdr_sync)
        pend = (skip_h + int(controls.syncoffset)) % fp
        k = min(pend, n_out_h)
        if k > 0:
            pixels = torch.cat([pixels[k:], torch.zeros((k,), dtype=torch.float32,
                                                        device=self.device)])
        n_valid = n_out_h - k
        pend -= k

        # ---- frame fold: pixels past n_valid are zero and rewritten before read
        framebuf = state.framebuf
        _check_range(fill_h, mp, framebuf.shape[0], "fold write")
        framebuf[fill_h:fill_h + mp] = pixels
        fill2 = fill_h + n_valid

        # ---- emit every completed frame
        post = (state.screenbuffer, (state.ag_min, state.ag_max, state.ag_snr),
                state.sync_x, state.sync_y, state.pll)
        mb = float(controls.motionblur)
        k_frames = cfg.frames_per_block
        valid = [fill2 >= (i + 1) * fp for i in range(k_frames)]
        frames = []
        for i, ok in enumerate(valid):
            if ok:
                window = framebuf[i * fp:(i + 1) * fp].view(h, w)
                result, *post = _post_process(cfg, params, window, *post, mb)
                frames.append(result)
            else:
                frames.append(None)
        emitted = sum(valid)
        if emitted:
            # move the leftover (< one frame) to the front; the source and the
            # destination never overlap (buffer length, state.framebuf_len)
            src = framebuf[emitted * fp:emitted * fp + (framebuf.shape[0] - fp if k_frames == 1 else fp)]
            framebuf[:src.shape[0]] = src
        fill_new = fill2 - emitted * fp
        screen, ag, sync_x, sync_y, pll = post

        zeros = lambda: torch.zeros((h, w), dtype=torch.float32, device=self.device)  # noqa: E731
        if k_frames == 1:
            frame_out = frames[0] if valid[0] else zeros()
            frame_valid = self._full(valid[0], torch.bool)
        else:
            frame_out = torch.stack([f if f is not None else zeros() for f in frames])
            frame_valid = torch.tensor(valid, dtype=torch.bool).to(self.device)

        ac_avg_frame, ac_avg_line, ac_calls, ac_last_full = ac
        runs, frame_count = state.runs, state.frame_count
        if emitted:
            runs = runs + emitted
            frame_count = frame_count + emitted
        new_state = StreamState(
            phase_fix=phase2,
            tail=new_tail,
            fir_tail=fir_tail,
            skip_pixels=self._full(pend, torch.int32),
            fill=self._full(fill_new, torch.int32),
            framebuf=framebuf,
            screenbuffer=screen,
            ag_min=ag[0],
            ag_max=ag[1],
            ag_snr=ag[2],
            sync_x=sync_x,
            sync_y=sync_y,
            pll=pll,
            runs=runs,
            frame_count=frame_count,
            ac_buf=ac_buf,
            ac_fill=self._full(ac_fill, torch.int32),
            ac_avg_frame=ac_avg_frame,
            ac_avg_line=ac_avg_line,
            ac_calls=ac_calls,
            ac_last_full=ac_last_full,
        )
        outputs = StepOutputs(
            frame=frame_out,
            frame_valid=frame_valid,
            n_pixels=n_out,
            refreshrate=self.rr_f32 + pll.refresh_delta,
            pll_locked=pll.locked,
            ag_min=ag[0],
            ag_max=ag[1],
            ag_snr=ag[2],
            sync_dx=sync_x.dx,
            sync_dy=sync_y.dx,
            ac_frame_plot=ac_avg_frame,
            ac_line_plot=ac_avg_line,
            ac_plot_valid=self._full(round_done, torch.bool),
            ac_calls=ac_calls,
        )
        self._per_thread.last = StepHost(tuple(valid), round_done)
        return new_state, outputs

    def warm(self, state: StreamState) -> None:
        """Run, on `state` and for nothing, the two branches a first block
        rarely takes: an estimation round (the FFT plan of ac_fft_size) and
        one frame's post-processing. For warm starts; the results are
        dropped, but the ring of `state` is shifted as a round shifts it."""
        if self.run_autocorr:
            self._ac_round(state.ac_buf, state.ac_avg_frame, state.ac_avg_line, state.ac_calls,
                           state.ac_last_full)
        cfg = self.config
        window = state.framebuf[:cfg.frame_pixels].view(cfg.height, cfg.width)
        _post_process(cfg, self.params, window, state.screenbuffer,
                      (state.ag_min, state.ag_max, state.ag_snr), state.sync_x, state.sync_y,
                      state.pll, 0.0)

    def _ac_round(self, buf, avg_f, avg_l, calls, last_full):
        """One estimation round: FFT autocorrelation of the ring's first
        ac_fft samples, running averages over the two lag windows, then the
        leftover (one block) moves to the front of the ring."""
        cfg = self.config
        ac_fft, ac_round = cfg.ac_fft_size, cfg.ac_round_samples
        fw_off, fw_len = cfg.ac_frame_window
        lw_off, lw_len = cfg.ac_line_window
        r = autocorrelation_magnitude(buf[:ac_fft])
        calls = calls + 1
        avg_f = accumulate_running_mean(avg_f, r[fw_off:fw_off + fw_len], calls)
        avg_l = accumulate_running_mean(avg_l, r[lw_off:lw_off + lw_len], calls)
        last_full = r[:ac_fft // 2].clone()
        # ac_round >= block_samples, so the two ranges do not overlap
        buf[:buf.shape[0] - ac_round] = buf[ac_round:]
        return avg_f, avg_l, calls, last_full


def make_step(config: PipelineConfig, params: Params, device="cuda", batched: bool = False) -> Step:
    """Build the per-block step for one channel:
    step(state, raw [2*block_samples] any supported dtype, controls) ->
    (state', StepOutputs). batched steps (a channel axis) are not ported yet."""
    if batched:
        raise NotImplementedError(
            "not ported yet: batched (ROADMAP.md Queue 1: multi-channel)")
    return Step(config, params, device)
