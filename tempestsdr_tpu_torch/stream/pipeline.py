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

make_step returns the device step (DeviceStep, built by _make_step_parts as
the JAX package builds its step): one device program that reads nothing to
the host between the raw block going in and the outputs coming out. Every
lax.cond of the JAX step is a select here, as a vmap turns it into one: the
FFT round and each emit slot's post-process run every block, and their
results are committed with torch.where on the device predicate (round_done,
fill2 >= (k+1)*frame_pixels); a slot that does not fire gives zeros. Every
offset the JAX step traces (the ring write at fill0, the sync skip by k,
the fold write at fill, the leftover move from emitted*frame_pixels, the
autoshift roll) is device index arithmetic, base + arange, kept in range by
the buffer lengths (state.framebuf_len, the ring's ac_round + block). The
controls ride as 0-d tensors. So K steps can be captured into one CUDA graph
(stream/graph.py), as the JAX package scans K steps in one program.

Step is the host-branching form the channel steps (below) and the sharded
steps (parallel/timeshard.py) are built from: Step.device_part (drop
compensation, the PLL rate, demod or K2, the FIR, the resample; it ends in
five integers: n_out, drop flag, fold fill, pending skip and ring fill),
ONE host fetch of those, then Step.host_part (ring write and FFT round,
sync skip, fold, emit and post-process, assembly), which branches in
Python and slices at the fetched offsets, asserted in range.

Both update the fold buffer and the autocorrelation ring in place: they
consume the state they are given, like the JAX Session's donated step.
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
from .state import StepOutputs, StreamState, state_from_leaves, state_leaves


class StepControls(NamedTuple):
    """Per-block host inputs: plugin-reported drops, manual sync shift in
    pixels (tsdr_sync), motion-blur coefficient. Host scalars or 0-d
    tensors (the device step moves either onto its device without reading
    it); for the channel steps each field may also be a length-C sequence,
    numpy array or tensor (a scalar applies to every channel)."""

    samples_dropped: int = 0
    syncoffset: int = 0
    motionblur: float = 0.0

    @staticmethod
    def default() -> "StepControls":
        return StepControls(0, 0, 0.0)


CONTROL_DTYPES = (torch.int64, torch.int32, torch.float32)  # StepControls' fields


def controls_on(controls: StepControls, device) -> StepControls:
    """StepControls as 0-d tensors of their JAX dtypes on `device`: a
    tensor is converted on its device (a host tensor is copied up), a host
    scalar is a fill. Nothing is read back to the host."""
    out = []
    for v, dtype in zip(controls, CONTROL_DTYPES):
        if isinstance(v, torch.Tensor):
            out.append(v.to(device=device, dtype=dtype).reshape(()))
        else:
            out.append(torch.full((), v, dtype=dtype, device=device))
    return StepControls(*out)


class StepHost(NamedTuple):
    """What the last host-branching step branched on, as host values."""

    frame_valid: tuple  # one bool per emit slot
    round_done: bool


class DevicePart(NamedTuple):
    """What Step.device_part leaves for the host part."""

    env: torch.Tensor  # f32[n], the envelope the autocorrelation ring takes
    pixels: torch.Tensor  # f32[max_pix]
    n_out: torch.Tensor  # i32
    phase2: torch.Tensor  # i64, the phase after the block
    new_tail: torch.Tensor  # f32[taps]
    fir_tail: torch.Tensor
    ints: torch.Tensor  # i64[5]: n_out, drop_all, fill, skip_pixels, ac_fill


class RingPlan(NamedTuple):
    """The autocorrelation ring's bookkeeping for one block, on the host."""

    fed: bool  # the block's envelope goes into the ring at fill0
    fill0: int
    ac_fill: int  # the fill after the block (and its round, if one completes)
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
    if params.resampler != "fused":
        return False
    if params.nearest_neighbour or params.fir_lowpass_taps:
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
    edges: torch.roll by (-dy, -dx), as two gathers at device-side indices)
    or green crosshair markers (syncdetector.c:187-218)."""
    h, w = data2d.shape
    dev = data2d.device
    if params.autoshift:
        rows = torch.remainder(torch.arange(h, device=dev) + sy.dx, h)
        cols = torch.remainder(torch.arange(w, device=dev) + sx.dx, w)
        return data2d.index_select(0, rows).index_select(1, cols)
    if params.debug_markers:
        col = torch.arange(w, dtype=torch.int32, device=dev)[None, :] == sx.dx
        row = torch.arange(h, dtype=torch.int32, device=dev)[:, None] == sy.dx
        return torch.where(col | row, PIXEL_SPECIAL_VALUE_G, data2d)
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


def _select(pred, a, b):
    """Commit `a` where the 0-d bool tensor pred holds, else `b`, across
    matching (named) tuples of tensors; b may hold Python scalars."""
    if isinstance(a, tuple):
        vals = [_select(pred, x, y) for x, y in zip(a, b)]
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    return torch.where(pred, a, b)


class _Blocks:
    """What both step forms share: the block's geometry, the chosen
    resampler, the FIR taps and the f32 constants of the PLL-modulated
    rate, all on one device, and the front of the step (demod, FIR,
    resample) from the phase after drop compensation."""

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
        f32 = lambda v: torch.full((), float(np.float32(v)), dtype=torch.float32,  # noqa: E731
                                   device=self.device)
        self.rr_f32 = f32(config.refreshrate)
        self.inv0_f32 = f32(config.inv0_fix)

    def resample_block(self, state: StreamState, raw, phase, env=None):
        """The PLL-modulated rate, then demod + resample from `phase`: K2 in
        one launch, or the demod, the optional FIR (the autocorrelation ring
        takes the pre-FIR envelope) and the chosen resampler. `env` is the
        block's envelope when the caller demodulated it (raw is then unused).
        Returns (env, pixels, n_out, phase2, new_tail, fir_tail)."""
        cfg, params = self.config, self.params
        n, taps, mp = cfg.block_samples, cfg.resample_taps, cfg.max_block_pixels
        # the PLL's delta modulates the fixed-point samples-per-pixel, in f32
        # with the JAX operation order (one unit of inv_fix moves the phase)
        delta = state.pll.refresh_delta
        corr_factor = delta / (self.rr_f32 + delta)
        inv_corr = torch.round(self.inv0_f32 * corr_factor).to(torch.int64)
        inv_fix = cfg.inv0_fix - inv_corr

        fir_tail = state.fir_tail
        if env is None and self.fused and raw.dim() == 1 and raw.dtype in (torch.uint8, torch.int8):
            env, pixels, n_out, phase2 = fused_demod_resample_cuda(
                raw, state.tail, phase, inv_fix, n_samples=n, max_pix=mp, taps=taps,
                inv_nominal=cfg.samples_per_pixel)
            return env, pixels, n_out, phase2, env[n - taps:].clone(), fir_tail
        if env is None:
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
        return env, pixels, n_out, phase2, x_ext[x_ext.shape[0] - taps:].clone(), fir_tail


# ---- the device step ---------------------------------------------------------


def _make_step_parts(blocks: _Blocks):
    """The JAX package's _make_step_parts (tempestsdr_tpu/stream/pipeline.py)
    on one device, its lax.conds as selects:

      pre(state, raw, controls) -> inter     (drops, rate, demod, resample,
          ring write, sync skip, fold write: the per-sample work)
      ac_round_fn(ops, round_done) -> ops'   (FFT + running averages and the
          ring's leftover move, committed where round_done)
      emit_fn(carry, window, mb) -> (carry', frame)   (one frame's post-process)
      no_emit_fn(carry, window) -> (carry, 0)         (a slot that does not fire)
      emit_chain(ops) -> (ops', frames, valid)        (the K emit slots, each
          committed where fill2 >= (k+1)*frame_pixels, and the leftover move)
      emit_ops_of / ac_ops_of(state, inter) -> ops
      assemble(state, inter, ac_ops, emit_ops, frames, valid) -> (state', outputs)

    Every tensor argument is on blocks.device; controls are 0-d tensors
    (controls_on)."""
    cfg, params, dev = blocks.config, blocks.params, blocks.device
    n, mp, fp = cfg.block_samples, cfg.max_block_pixels, cfg.frame_pixels
    h, w = cfg.height, cfg.width
    k_frames = cfg.frames_per_block
    run_autocorr = blocks.run_autocorr
    if run_autocorr:
        ac_round, ac_fft = cfg.ac_round_samples, cfg.ac_fft_size
        fw_off, fw_len = cfg.ac_frame_window
        lw_off, lw_len = cfg.ac_line_window
    # index ramps of the traced offsets, made once
    pix_idx = torch.arange(mp, device=dev)
    ring_idx = torch.arange(n, device=dev)
    # the leftover a block's emits leave at emitted*fp: for K == 1 the whole
    # spill past the frame (framebuf_len - fp == mp), for K > 1 one frame
    # (the buffer is (K+1)*fp long, so the read never leaves it)
    left_idx = torch.arange(mp if k_frames == 1 else fp, device=dev)
    never = torch.zeros((), dtype=torch.bool, device=dev)

    def pre(state: StreamState, raw, controls: StepControls):
        # ---- drop compensation folded into the phase (dsp.c:313-368):
        # (skip_before - dropped) % block2 is a floor modulo
        dropped = controls.samples_dropped
        skip_before = torch.clamp(state.phase_fix, min=0) >> FRAC_BITS
        new_skip = torch.where(dropped > 0, torch.remainder(skip_before - dropped, blocks.block2),
                               skip_before)
        phase = state.phase_fix + ((new_skip - skip_before) << FRAC_BITS)
        drop_all = phase >= (n << FRAC_BITS)

        env, pixels, n_out, phase2, new_tail, fir_tail = blocks.resample_block(state, raw, phase)

        # ---- autocorrelation ring (frameratedetector.c:215-230): a drop
        # purges it, a block past the drop is not fed; the write rewrites
        # the ring's own values where the block is not fed
        if run_autocorr:
            purge = dropped != 0
            fed = ~drop_all & ~purge
            fill0 = torch.where(purge, 0, state.ac_fill)
            at = fill0.to(torch.int64) + ring_idx
            ac_buf = state.ac_buf
            ac_buf.index_copy_(0, at, torch.where(fed, env, ac_buf[at]))
            ac_fill = torch.where(fed, fill0 + n, fill0)
            round_done = ac_fill >= ac_round
            ac_fill = torch.where(round_done, ac_fill - ac_round, ac_fill)
        else:
            round_done = never
            ac_buf, ac_fill = state.ac_buf, state.ac_fill

        # ---- manual sync shift as a pixel skip (tsdr_sync): the first k
        # pixels dropped, zeros shifted in
        pend = torch.remainder(state.skip_pixels + controls.syncoffset, fp)
        k = torch.minimum(pend, n_out)
        src = k.to(torch.int64) + pix_idx
        pixels = torch.where(src < mp, pixels[src.clamp(max=mp - 1)], 0.0)
        n_valid = n_out - k
        pend = pend - k

        # ---- frame fold: pixels past n_valid are zero and rewritten before read
        framebuf = state.framebuf
        framebuf.index_copy_(0, state.fill.to(torch.int64) + pix_idx, pixels)
        fill2 = state.fill + n_valid
        return dict(phase2=phase2, new_tail=new_tail, fir_tail=fir_tail, pend=pend,
                    framebuf=framebuf, fill2=fill2, emit=fill2 >= fp, n_out=n_out,
                    ac_buf=ac_buf, ac_fill=ac_fill, round_done=round_done,
                    motionblur=controls.motionblur)

    def ac_round_fn(ops, round_done):
        buf, avg_f, avg_l, calls, last_full = ops
        r = autocorrelation_magnitude(buf[:ac_fft])
        calls1 = calls + 1
        new = (accumulate_running_mean(avg_f, r[fw_off:fw_off + fw_len], calls1),
               accumulate_running_mean(avg_l, r[lw_off:lw_off + lw_len], calls1),
               calls1,
               r[:ac_fft // 2])
        # the leftover (one block; ac_round >= n, so the ranges are apart)
        # to the front of the ring
        m = buf.shape[0] - ac_round
        buf[:m] = torch.where(round_done, buf[ac_round:], buf[:m])
        return (buf,) + _select(round_done, new, (avg_f, avg_l, calls, last_full))

    def emit_fn(carry, window, motionblur):
        screen, ag, sx, sy, pll = carry
        result, screen, ag, sx, sy, pll = _post_process(cfg, params, window, screen, ag, sx, sy,
                                                        pll, motionblur)
        return (screen, ag, sx, sy, pll), result

    def no_emit_fn(carry, window):
        return carry, 0.0

    def emit_chain(ops):
        """Every emit slot in stream order: slot k post-processes the fold
        buffer's k-th frame every block, and commits where fill2 >=
        (k+1)*fp, the carried state chained through; then one leftover
        move from emitted*fp to the front (onto itself when nothing was
        emitted). Returns (ops', frames, valid): frames (h, w) and valid 0-d
        for K == 1, (K, h, w) and (K,) for K > 1."""
        framebuf, fill2, screen, ag, sx, sy, pll, motionblur = ops
        carry = (screen, ag, sx, sy, pll)
        frames, valids = [], []
        for slot in range(k_frames):
            ek = fill2 >= (slot + 1) * fp
            window = framebuf[slot * fp:(slot + 1) * fp].view(h, w)
            carry, fk = _select(ek, emit_fn(carry, window, motionblur),
                                no_emit_fn(carry, window))
            frames.append(fk)
            valids.append(ek)
        valid = torch.stack(valids)
        emitted = valid.sum(dtype=torch.int32)
        framebuf[:left_idx.shape[0]] = framebuf[emitted.to(torch.int64) * fp + left_idx]
        screen, ag, sx, sy, pll = carry
        emit_ops = (framebuf, fill2 - emitted * fp, screen, ag, sx, sy, pll, motionblur)
        if k_frames == 1:
            return emit_ops, frames[0], valids[0]
        return emit_ops, torch.stack(frames), valid

    def emit_ops_of(state: StreamState, inter):
        return (inter["framebuf"], inter["fill2"], state.screenbuffer,
                (state.ag_min, state.ag_max, state.ag_snr), state.sync_x, state.sync_y,
                state.pll, inter["motionblur"])

    def ac_ops_of(state: StreamState, inter):
        return (inter["ac_buf"], state.ac_avg_frame, state.ac_avg_line, state.ac_calls,
                state.ac_last_full)

    def assemble(state: StreamState, inter, ac_ops, emit_ops, frame_out, frame_valid):
        ac_buf, ac_avg_frame, ac_avg_line, ac_calls, ac_last_full = ac_ops
        framebuf, fill, screen, ag, sync_x, sync_y, pll, _mb = emit_ops
        n_emitted = (frame_valid.to(torch.int32) if frame_valid.dim() == 0
                     else frame_valid.sum(dtype=torch.int32))
        new_state = StreamState(
            phase_fix=inter["phase2"], tail=inter["new_tail"], fir_tail=inter["fir_tail"],
            skip_pixels=inter["pend"], fill=fill, framebuf=framebuf, screenbuffer=screen,
            ag_min=ag[0], ag_max=ag[1], ag_snr=ag[2], sync_x=sync_x, sync_y=sync_y, pll=pll,
            runs=state.runs + n_emitted, frame_count=state.frame_count + n_emitted.to(torch.int64),
            ac_buf=ac_buf, ac_fill=inter["ac_fill"], ac_avg_frame=ac_avg_frame,
            ac_avg_line=ac_avg_line, ac_calls=ac_calls, ac_last_full=ac_last_full)
        outputs = StepOutputs(
            frame=frame_out, frame_valid=frame_valid, n_pixels=inter["n_out"],
            refreshrate=blocks.rr_f32 + pll.refresh_delta, pll_locked=pll.locked,
            ag_min=ag[0], ag_max=ag[1], ag_snr=ag[2], sync_dx=sync_x.dx, sync_dy=sync_y.dx,
            ac_frame_plot=ac_avg_frame, ac_line_plot=ac_avg_line,
            ac_plot_valid=inter["round_done"], ac_calls=ac_calls)
        return new_state, outputs

    return (pre, ac_round_fn, emit_fn, no_emit_fn, emit_ops_of, ac_ops_of, assemble,
            emit_chain)


class DeviceStep(_Blocks):
    """The single-channel device step for one (config, params, device); see
    the module docstring. It keeps nothing per call, so one DeviceStep may
    be stepped from several threads, each on a state of its own.
    Params.superresolution is the session's business: the step never reads
    it."""

    def __init__(self, config: PipelineConfig, params: Params, device):
        super().__init__(config, params, device)
        (self._pre, self._ac_round_fn, _, _, self._emit_ops_of, self._ac_ops_of,
         self._assemble, self._emit_chain) = _make_step_parts(self)

    def __call__(self, state: StreamState, raw, controls: StepControls = StepControls()):
        raw = torch.as_tensor(raw).to(self.device)
        inter = self._pre(state, raw, controls_on(controls, self.device))
        ac_ops = self._ac_ops_of(state, inter)
        if self.run_autocorr:
            ac_ops = self._ac_round_fn(ac_ops, inter["round_done"])
        emit_ops, frame_out, valid = self._emit_chain(self._emit_ops_of(state, inter))
        return self._assemble(state, inter, ac_ops, emit_ops, frame_out, valid)


def make_step(config: PipelineConfig, params: Params, device="cuda",
              batched: bool = False) -> DeviceStep:
    """Build the per-block device step for one channel:
    step(state, raw [2*block_samples] any supported dtype, controls) ->
    (state', StepOutputs), reading nothing to the host. batched is accepted
    for the JAX package's API and changes nothing: its batched step exists
    for vmap, which the port does not use, so the port's runs the same
    kernels as the plain one."""
    return DeviceStep(config, params, device)


# ---- the host-branching step -------------------------------------------------


def _check_range(start: int, size: int, length: int, what: str) -> None:
    """A slice the JAX step takes with lax.dynamic_update_slice, which would
    clamp an out-of-range start; the buffer sizes (state.framebuf_len, the
    ring's ac_round + block) keep every start in range, and this holds it."""
    if not (0 <= start and start + size <= length):
        raise RuntimeError(f"{what} [{start}, {start + size}) outside [0, {length})")


class Step(_Blocks):
    """The host-branching single-channel step for one (config, params,
    device), the parts of the channel and sharded steps; see the module
    docstring. `last` holds the host values of the calling thread's latest
    call: a Step keeps nothing else per call, so it may be stepped from
    several threads, each on a state of its own."""

    def __init__(self, config: PipelineConfig, params: Params, device):
        super().__init__(config, params, device)
        self._per_thread = threading.local()

    @property
    def last(self) -> StepHost | None:
        return getattr(self._per_thread, "last", None)

    def _full(self, v, dtype):
        return torch.full((), v, dtype=dtype, device=self.device)

    def __call__(self, state: StreamState, raw, controls: StepControls = StepControls()):
        raw = torch.as_tensor(raw).to(self.device)
        part = self.device_part(state, raw, controls)
        # ---- the one host fetch of the block
        host = part.ints.tolist()
        new_state, outputs, last = self.host_part(state, part, host, controls)
        self._per_thread.last = last
        return new_state, outputs

    def device_part(self, state: StreamState, raw, controls: StepControls,
                    env=None) -> DevicePart:
        """Everything up to the fetch, all launched without waiting: drop
        compensation, the PLL-modulated rate, demod or K2, the optional FIR
        and the resample. `env` is the block's envelope when the caller
        demodulated it (the channel steps' stacked demod); raw is then
        unused."""
        n = self.config.block_samples
        dropped = int(controls.samples_dropped)

        # ---- drop compensation folded into the phase (dsp.c:313-368):
        # (skip_before - dropped) % block2 is a floor modulo
        phase = state.phase_fix
        if dropped > 0:
            skip_before = torch.clamp(phase, min=0) >> FRAC_BITS
            new_skip = torch.remainder(skip_before - dropped, self.block2)
            phase = phase + ((new_skip - skip_before) << FRAC_BITS)
        env, pixels, n_out, phase2, new_tail, fir_tail = self.resample_block(state, raw, phase, env)

        drop_all = phase >= (n << FRAC_BITS)
        ints = torch.stack([
            n_out.to(torch.int64), drop_all.to(torch.int64), state.fill.to(torch.int64),
            state.skip_pixels.to(torch.int64), state.ac_fill.to(torch.int64),
        ])
        return DevicePart(env, pixels, n_out, phase2, new_tail, fir_tail, ints)

    def ring_plan(self, dropped: int, drop_all: int, ac_fill: int) -> RingPlan:
        """The ring's bookkeeping from host values (frameratedetector.c:
        215-230): a drop purges the ring, a block past the drop is not fed,
        a round completes when the fill reaches ac_round_samples."""
        if not self.run_autocorr:
            return RingPlan(False, ac_fill, ac_fill, False)
        purge = dropped != 0
        fed = not drop_all and not purge
        fill0 = 0 if purge else ac_fill
        ac_fill = fill0 + self.config.block_samples if fed else fill0
        round_done = ac_fill >= self.config.ac_round_samples
        if round_done:
            ac_fill -= self.config.ac_round_samples
        return RingPlan(fed, fill0, ac_fill, round_done)

    def write_ring(self, ac_buf, fill0: int, env) -> None:
        """env [..., n] into ac_buf [..., L] at fill0, in place: one ring, or
        a stack of rings fed at one fill (the channel steps' shared write)."""
        n = self.config.block_samples
        _check_range(fill0, n, ac_buf.shape[-1], "autocorrelation ring write")
        ac_buf[..., fill0:fill0 + n] = env

    def host_part(self, state: StreamState, part: DevicePart, host, controls: StepControls,
                  plan: RingPlan | None = None, tensors: bool = True):
        """Everything after the fetch, given its five integers `host`: the
        ring write (unless `plan` says the caller made it) and FFT round, the
        sync skip, the fold, every completed frame's post-process, and the
        new state and outputs. Returns (state', StepOutputs, StepHost).

        tensors=False leaves what the host knows as host values for a caller
        that stacks channels (skip_pixels, fill, ac_fill: ints; frame_valid,
        ac_plot_valid: bools, one per slot for K > 1; frame: a tensor or
        None per slot; refreshrate: None)."""
        cfg, params = self.config, self.params
        mp, fp, h, w = cfg.max_block_pixels, cfg.frame_pixels, cfg.height, cfg.width
        n_out_h, drop_all_h, fill_h, skip_h, ac_fill_h = host
        pixels = part.pixels

        # ---- autocorrelation ring (frameratedetector.c:215-230)
        ac_buf = state.ac_buf
        ac = (state.ac_avg_frame, state.ac_avg_line, state.ac_calls, state.ac_last_full)
        if plan is None:
            plan = self.ring_plan(int(controls.samples_dropped), drop_all_h, ac_fill_h)
            if plan.fed:
                self.write_ring(ac_buf, plan.fill0, part.env)
        if plan.round_done:
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

        if tensors:
            scalar = self._full
            zeros = lambda: torch.zeros((h, w), dtype=torch.float32, device=self.device)  # noqa: E731
            if k_frames == 1:
                frame_out = frames[0] if valid[0] else zeros()
                frame_valid = self._full(valid[0], torch.bool)
            else:
                frame_out = torch.stack([f if f is not None else zeros() for f in frames])
                frame_valid = torch.stack([self._full(v, torch.bool) for v in valid])
            refreshrate = self.rr_f32 + pll.refresh_delta
        else:
            scalar = lambda v, dtype: v  # noqa: E731
            frame_out, frame_valid = (frames[0], valid[0]) if k_frames == 1 else (frames, valid)
            refreshrate = None

        ac_avg_frame, ac_avg_line, ac_calls, ac_last_full = ac
        runs, frame_count = state.runs, state.frame_count
        if emitted:
            runs = runs + emitted
            frame_count = frame_count + emitted
        new_state = StreamState(
            phase_fix=part.phase2,
            tail=part.new_tail,
            fir_tail=part.fir_tail,
            skip_pixels=scalar(pend, torch.int32),
            fill=scalar(fill_new, torch.int32),
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
            ac_fill=scalar(plan.ac_fill, torch.int32),
            ac_avg_frame=ac_avg_frame,
            ac_avg_line=ac_avg_line,
            ac_calls=ac_calls,
            ac_last_full=ac_last_full,
        )
        outputs = StepOutputs(
            frame=frame_out,
            frame_valid=frame_valid,
            n_pixels=part.n_out,
            refreshrate=refreshrate,
            pll_locked=pll.locked,
            ag_min=ag[0],
            ag_max=ag[1],
            ag_snr=ag[2],
            sync_dx=sync_x.dx,
            sync_dy=sync_y.dx,
            ac_frame_plot=ac_avg_frame,
            ac_line_plot=ac_avg_line,
            ac_plot_valid=scalar(plan.round_done, torch.bool),
            ac_calls=ac_calls,
        )
        return new_state, outputs, StepHost(tuple(valid), plan.round_done)

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


# ---- the channel steps -----------------------------------------------------
# Each takes a stacked state (every leaf with a leading channel axis C, rows
# owning their memory: parallel.channels.stack_states), raws [C, 2n] and
# per-channel controls, and returns the stacked state and stacked
# StepOutputs: frame [C, H, W] and frame_valid [C] (K == 1), or [C, K, H, W]
# and [C, K]. A channel is stepped through views of its rows, so its fold
# buffer and ring are written in place; every other leaf it returns goes back
# with one torch.stack per leaf (a leaf no channel changed stays the stacked
# tensor it was), and what the host knows (fills, flags) with one host ->
# device copy per leaf. `last` is a tuple of one StepHost per channel.


def _per_channel(value, n: int) -> list:
    """A StepControls field for n channels: a length-n sequence, array or
    tensor, or one scalar for all (a CUDA tensor costs a fetch)."""
    if isinstance(value, (torch.Tensor, np.ndarray)):
        value = value.tolist()
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"a control has {len(value)} values for {n} channels")
        return list(value)
    return [value] * n


def _channel_controls(controls: StepControls, n: int) -> list:
    return [StepControls(*vals) for vals in zip(*(_per_channel(v, n) for v in controls))]


def _channel_rows(states: StreamState, n: int) -> list:
    """Per channel, a StreamState of views of that channel's rows."""
    leaves = state_leaves(states)
    return [state_from_leaves([x[c] for x in leaves]) for c in range(n)]


class _Restack:
    """Puts per-channel leaves back on a channel axis. A set of leaves that
    are each channel's own row view of one stacked tensor is that tensor (no
    launch); tensors are stacked once (the same set twice, once); host values
    go up in one copy (non-blocking, so no wait on the card)."""

    def __init__(self, stacked_leaves, rows, device):
        self.device = device
        self.origin = {}
        for i, parent in enumerate(stacked_leaves):
            for c, row in enumerate(rows):
                self.origin[id(state_leaves(row)[i])] = (i, c)
        self.parents = stacked_leaves
        self.memo = {}

    def __call__(self, vals, dtype=None):
        if all(isinstance(v, torch.Tensor) for v in vals):
            where = [self.origin.get(id(v)) for v in vals]
            if all(o is not None and o == (where[0][0], c) for c, o in enumerate(where)):
                return self.parents[where[0][0]]
            key = tuple(id(v) for v in vals)
            if key not in self.memo:
                self.memo[key] = torch.stack(vals)
            return self.memo[key]
        host = torch.tensor(vals, dtype=dtype)
        return host.to(self.device, non_blocking=True) if self.device.type == "cuda" else host


def _assemble(step: Step, states: StreamState, rows: list, results: list):
    """(stacked state', stacked StepOutputs) from per-channel results of
    host_part(tensors=False)."""
    cfg = step.config
    restack = _Restack(state_leaves(states), rows, step.device)
    per_leaf = zip(*(state_leaves(r[0]) for r in results))
    new_states = state_from_leaves([
        restack(list(vals), parent.dtype)
        for vals, parent in zip(per_leaf, state_leaves(states))])
    fields = {}
    for name, vals in zip(StepOutputs._fields, zip(*(r[1] for r in results))):
        vals = list(vals)
        if name == "frame" and not all(isinstance(v, torch.Tensor) for v in vals):
            k = cfg.frames_per_block
            frames = torch.zeros((len(vals),) + ((k,) if k > 1 else ()) + (cfg.height, cfg.width),
                                 dtype=torch.float32, device=step.device)
            for c, f in enumerate(vals):
                for slot, fk in enumerate(f if k > 1 else [f]):
                    if fk is not None:
                        (frames[c, slot] if k > 1 else frames[c]).copy_(fk)
            fields[name] = frames
        elif name == "refreshrate":
            fields[name] = step.rr_f32 + new_states.pll.refresh_delta
        else:
            fields[name] = restack(vals, torch.bool)
    return new_states, StepOutputs(**fields)


class _ChannelsStep:
    """Every channel step: each channel's device part, ONE host fetch of the
    [C, 5] integers for all channels, the ring writes (with shared_ring, one
    2-D write into the stacked rings when every channel is fed at one fill;
    else one per fed channel), then each channel's host part, which runs a
    round or a frame's post-process only for the channels whose integers say
    so. n_channels=None takes the count from raws."""

    def __init__(self, config: PipelineConfig, params: Params, n_channels: int | None, device,
                 *, shared_ring: bool = False, stacked_demod: bool = False):
        self.step = Step(config, params, device)
        self.config, self.params, self.device = config, params, self.step.device
        self.n_channels = n_channels
        self.shared_ring, self.stacked_demod = shared_ring, stacked_demod
        self._per_thread = threading.local()

    @property
    def last(self):
        return getattr(self._per_thread, "last", None)

    def __call__(self, states: StreamState, raws, controls: StepControls = StepControls()):
        step = self.step
        raws = torch.as_tensor(raws).to(self.device)
        n_ch = raws.shape[0] if self.n_channels is None else self.n_channels
        if raws.dim() != 2 or raws.shape[0] != n_ch:
            raise ValueError(f"raws must be [{n_ch}, 2n], got {tuple(raws.shape)}")
        ctrls = _channel_controls(controls, n_ch)
        rows = _channel_rows(states, n_ch)
        feed = None
        if self.stacked_demod:
            # one demod over every channel's block: each row is 2n values,
            # so flattening keeps every I/Q pair together (bit-identical to
            # per-channel demod, an elementwise computation)
            feed = am_demod(normalize_iq(raws.reshape(-1))).reshape(n_ch, -1)
        parts = [step.device_part(rows[c], raws[c], ctrls[c], None if feed is None else feed[c])
                 for c in range(n_ch)]
        # ---- the one host fetch of the block, for every channel
        host = torch.stack([p.ints for p in parts]).tolist()
        plans = [None] * n_ch
        if self.shared_ring and step.run_autocorr:
            plans = [step.ring_plan(int(ctrls[c].samples_dropped), host[c][1], host[c][4])
                     for c in range(n_ch)]
            if all(p.fed for p in plans) and len({p.fill0 for p in plans}) == 1:
                envs = feed if feed is not None else torch.stack([p.env for p in parts])
                step.write_ring(states.ac_buf, plans[0].fill0, envs)
            else:  # a drop desynchronised the fills: per-channel writes
                for c, p in enumerate(plans):
                    if p.fed:
                        step.write_ring(rows[c].ac_buf, p.fill0, parts[c].env)
        results = [step.host_part(rows[c], parts[c], host[c], ctrls[c], plans[c], tensors=False)
                   for c in range(n_ch)]
        self._per_thread.last = tuple(r[2] for r in results)
        return _assemble(step, states, rows, results)


def make_channels_step_hybrid(config: PipelineConfig, params: Params, n_channels: int, *,
                              cond_mode: str = "unrolled", demod_mode: str = "per-channel",
                              device="cuda"):
    """The production multi-channel step (MultiSession's): per channel the
    single-channel device part (K1 at m == 2, or K2 with resampler="fused"),
    ONE packed host fetch of every channel's five integers, the ring write as
    one 2-D write when every channel is fed at one fill (per-channel writes
    after a drop desynchronises them), then per channel the host part.

    demod_mode="stacked" demodulates all channels' raw blocks in one call
    (bit-identical to per-channel demod); resampler="fused" forces
    per-channel demod, since K2 takes the raw bytes.

    cond_mode is validated for API parity with the JAX package, where it
    chooses between real per-channel branches ("unrolled") and any()-gated
    bodies ("batched"), and it changes nothing here: the host knows from the
    fetch which channels crossed a boundary, so the bodies run only for
    those. "batched" keeps the reference's one-frame-per-block error."""
    if cond_mode not in ("batched", "unrolled"):
        raise ValueError(f"unknown cond_mode {cond_mode!r}")
    if cond_mode == "batched" and config.frames_per_block > 1:
        raise ValueError(
            "cond_mode='batched' supports one frame per block; use the "
            "default cond_mode='unrolled' for multi-frame blocks")
    if demod_mode not in ("per-channel", "stacked"):
        raise ValueError(f"unknown demod_mode {demod_mode!r}")
    return _ChannelsStep(config, params, n_channels, device, shared_ring=True,
                         stacked_demod=demod_mode == "stacked" and params.resampler != "fused")


def make_channels_step_unrolled(config: PipelineConfig, params: Params, n_channels: int,
                                device="cuda"):
    """The JAX package's unrolled step (the single-channel step repeated over
    the channels' rows): here the hybrid step with per-channel ring writes."""
    return _ChannelsStep(config, params, n_channels, device)


def make_channels_step(config: PipelineConfig, params: Params, n_channels: int = 0,
                       device="cuda"):
    """The JAX package's gated multi-channel step: here the hybrid step with
    per-channel ring writes. Keeps the reference's one-frame-per-block
    limit. n_channels=0 takes the count from raws, as the reference's vmap
    does."""
    if config.frames_per_block > 1:
        raise ValueError(
            "make_channels_step supports one frame per block; use "
            "make_channels_step_hybrid/unrolled for multi-frame blocks")
    return _ChannelsStep(config, params, n_channels or None, device)


def make_multi_step(config: PipelineConfig, params: Params, device="cuda"):
    """The JAX package's vmap(step) over a channel axis, the count taken
    from raws: here the hybrid step with per-channel ring writes."""
    return _ChannelsStep(config, params, None, device)


def make_scan_runner(config: PipelineConfig, params: Params, n_blocks: int, device="cuda"):
    """run(state, raw_blocks [n_blocks, 2n], controls) -> (state, outputs
    stacked over the blocks, as lax.scan stacks them). Every block gets the
    same controls, as in the reference. The n_blocks device steps are one
    CUDA-graph replay on the card (stream/graph.py; the state returned is
    the runner's, which a caller passes back at no copy) and a loop on the
    CPU; the outputs are the caller's."""
    from .graph import BlockRunner

    runner = BlockRunner(config, params, n_blocks, device)

    def run(state, raw_blocks, controls: StepControls = StepControls()):
        raw_blocks = torch.as_tensor(raw_blocks)
        if raw_blocks.shape[0] != n_blocks:
            raise ValueError(f"{raw_blocks.shape[0]} blocks, the runner takes {n_blocks}")
        ctl = torch.stack([torch.as_tensor(v, dtype=torch.float64).reshape(()).to(runner.device)
                           for v in controls]).expand(n_blocks, 3)
        state, out, _ = runner.run(state, raw_blocks, ctl)
        if runner.graphed:
            out = StepOutputs(*(x.clone() for x in out))
        return state, out

    return run
