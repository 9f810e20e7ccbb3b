"""The per-block streaming steps: one channel, and C channels on one card.

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
lax.cond of the JAX step is a _cond on its device predicate: the FFT round
(round_done), each emit slot (fill2 >= (k+1)*frame_pixels; a slot that
does not fire gives zeros) and the sync-skip shift (k > 0). Captured into
a CUDA graph (stream/graph.py's runners), a _cond is a pair of IF nodes
(kernels/graph_cond.py), so a replay runs only the taken branch, as XLA
runs a lax.cond (the sharded steps' back half too, captured between their
collectives by stream.graph.StagedRunner). Everywhere else (the CPU, the
eager step on the card) it is a select, as a vmap makes it: both branches
run and torch.where commits the taken one. Every offset the JAX step traces (the
ring write at fill0, the sync skip by k, the fold write at fill, the
leftover move from emitted*frame_pixels, the autoshift roll) is device
index arithmetic, base + arange, kept in range by the buffer lengths
(state.framebuf_len, the ring's ac_round + block). The controls ride as
tensors. So K steps can be captured into one CUDA graph, as the JAX
package scans K steps in one program.

The channel steps (ChannelsStep: make_channels_step_hybrid and the
unrolled, gated and multi forms) and the sharded steps
(parallel/timeshard.py) are built from the same parts and are device
programs too: per channel `pre` on that channel's rows, one 2-D ring write,
then the round and emit bodies per channel, each behind its channel's own
_cond (cond_mode="unrolled", the JAX hybrid's real per-channel lax.conds),
or once over the channel axis behind one _cond on any() of the channels'
predicates with a per-channel select inside (cond_mode="batched", the JAX
gated forms; the post-process ops take a leading axis).

Every step updates the fold buffer and the autocorrelation ring in place:
it consumes the state it is given, like the JAX Session's donated step.
"""

from __future__ import annotations

import functools
import operator
import threading
from typing import Callable, NamedTuple

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
from ..kernels import graph_cond
from ..kernels.chunked_resample import box_resample_pallas_cuda, box_resample_pallas_windows_cuda
from ..kernels.fused_demod_resample import fused_demod_resample_cuda
from ..kernels.post_process import PostSpec, covers, post_process_cuda
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


def _post_spec(config: PipelineConfig, params: Params) -> PostSpec:
    """The static half of a frame's post-process, from the step's config and
    Params (fast_sync: f32 sums into f32 profiles; else f64 profiles, their
    sums f64 under config.high_precision_sync)."""
    return PostSpec(
        minsize_x=int(config.width * np.float32(0.05)),
        minsize_y=int(config.height * np.float32(0.01)),
        pll_enabled=params.framerate_pll, max_delta=PLL_HEADROOM_FRAC * config.refreshrate,
        autoshift=params.autoshift, markers=params.debug_markers,
        precise=config.high_precision_sync and not params.fast_sync, widen=not params.fast_sync)


def _collapse(spec: PostSpec, frame2d):
    return collapse_v_h(frame2d, spec.precise, widen=spec.widen)


def _sync_positions(spec: PostSpec, sync_x, sync_y, pll, wprof, hprof):
    """Sweet-spot search on both profiles + the PLL (syncdetector.c:171-186)."""
    sx, _, _ = find_the_sweet_spot(sync_x, wprof, spec.minsize_x, FRAMERATE_DX_LOWPASS_COEFF_WIDTH)
    sy, _, _ = find_the_sweet_spot(sync_y, hprof, spec.minsize_y,
                                   FRAMERATE_DX_LOWPASS_COEFF_HEIGHT)
    pll = framerate_pll(pll, sx.vx, enabled=spec.pll_enabled, max_delta=spec.max_delta)
    return sx, sy, pll


def _sync_apply(spec: PostSpec, data2d, sx, sy):
    """Autoshift (circular shift moving the detected strips to the frame
    edges: torch.roll by (-dy, -dx), as two gathers at device-side indices)
    or green crosshair markers (syncdetector.c:187-218). data2d [..., H, W]
    with sync states of [...] leaves."""
    h, w = data2d.shape[-2:]
    dev = data2d.device
    if spec.autoshift:
        rows = torch.remainder(torch.arange(h, device=dev) + sy.dx[..., None], h)
        cols = torch.remainder(torch.arange(w, device=dev) + sx.dx[..., None], w)
        out = torch.take_along_dim(data2d, rows[..., :, None], dim=-2)
        return torch.take_along_dim(out, cols[..., None, :], dim=-1)
    if spec.markers:
        col = torch.arange(w, dtype=torch.int32, device=dev) == sx.dx[..., None, None]
        row = torch.arange(h, dtype=torch.int32, device=dev)[:, None] == sy.dx[..., None, None]
        return torch.where(col | row, PIXEL_SPECIAL_VALUE_G, data2d)
    return data2d


def _post_process_default_order(frame2d, screen, ag, sync_x, sync_y, pll, motionblur,
                                spec: PostSpec):
    """Autogain before sync, lowpass after (dsp.c:192-226, both order flags
    0). The collapse runs on the raw frame: the sweet-spot metric is
    invariant under autogain's affine map, so the positions are the same
    and normalize, shift and motion blur fuse into one elementwise pass.
    The plain chain that kernels/post_process.py runs as three launches
    on the card."""
    f = frame2d
    _, mn, mx, snr = autogain_run(f, ag[0], ag[1], NORMALISATION_LOWPASS_COEFF, stats_only=True)
    ag = (mn, mx, snr)
    wprof, hprof = _collapse(spec, f)
    sync_x, sync_y, pll = _sync_positions(spec, sync_x, sync_y, pll, wprof, hprof)
    span = torch.where(mx == mn, torch.ones_like(mx), mx - mn)
    norm = (f - mn[..., None, None]) / span[..., None, None]
    syncres = _sync_apply(spec, norm, sync_x, sync_y)
    screen = time_lowpass(screen, syncres, motionblur)
    return screen, screen, ag, sync_x, sync_y, pll


def _post_process(config, params, frame2d, screen, ag, sync_x, sync_y, pll, motionblur):
    """dsp_post_process (dsp.c:134-239): the configurable-order chain, on
    one frame [H, W] or a stack [C, H, W] with carries of [C] leaves. The
    default order runs the post-process kernels (kernels/post_process.py)
    on a CUDA frame with f64 profiles, else the plain chain."""
    spec = _post_spec(config, params)
    if not params.autogain_after_proc and not params.lowpass_before_sync:
        run = (post_process_cuda if frame2d.device.type == "cuda" and covers(spec)
               else _post_process_default_order)
        return run(frame2d, screen, ag, sync_x, sync_y, pll, motionblur, spec)
    inp = frame2d
    if not params.autogain_after_proc:
        inp, mn, mx, snr = autogain_run(inp, ag[0], ag[1], NORMALISATION_LOWPASS_COEFF)
        ag = (mn, mx, snr)
    if params.lowpass_before_sync:
        screen = time_lowpass(screen, inp, motionblur)
        wprof, hprof = _collapse(spec, screen)
        sync_x, sync_y, pll = _sync_positions(spec, sync_x, sync_y, pll, wprof, hprof)
        syncres = _sync_apply(spec, screen, sync_x, sync_y)
        if params.autogain_after_proc:
            result, mn, mx, snr = autogain_run(syncres, ag[0], ag[1], NORMALISATION_LOWPASS_COEFF)
            ag = (mn, mx, snr)
        else:
            result = syncres
    else:
        wprof, hprof = _collapse(spec, inp)
        sync_x, sync_y, pll = _sync_positions(spec, sync_x, sync_y, pll, wprof, hprof)
        syncres = _sync_apply(spec, inp, sync_x, sync_y)
        screen = time_lowpass(screen, syncres, motionblur)
        if params.autogain_after_proc:
            result, mn, mx, snr = autogain_run(screen, ag[0], ag[1], NORMALISATION_LOWPASS_COEFF)
            ag = (mn, mx, snr)
        else:
            result = screen
    return result, screen, ag, sync_x, sync_y, pll


def _map(fn, *trees):
    """fn over the matching tensor leaves of (named) tuples."""
    a = trees[0]
    if isinstance(a, tuple):
        vals = [_map(fn, *xs) for xs in zip(*trees)]
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    return fn(*trees)


def _lead(pred, x):
    """pred [..] shaped to broadcast over the leading axes of x."""
    return pred.reshape(pred.shape + (1,) * (x.dim() - pred.dim()))


def _select(pred, a, b):
    """Commit `a` where the bool tensor pred holds, else `b`, across matching
    (named) tuples of tensors: pred 0-d, or [C] over the leading channel axis
    of every leaf (the JAX package's _select_tree); b may hold Python
    scalars."""
    return _map(lambda x, y: torch.where(_lead(pred, x), x, y), a, b)


_TAKEN = threading.local()  # .masks: the predicates of the selects under way


def _write_taken(dst, src) -> None:
    """A branch's in-place write, dst <- src, where the branch is taken: a
    plain copy in a branch that runs only when taken (an IF node's body),
    masked by the enclosing selects' predicates where both branches run."""
    masks = getattr(_TAKEN, "masks", [])
    if masks:
        mask = functools.reduce(operator.and_, masks)
        src = torch.where(_lead(mask, dst), src, dst)
    dst.copy_(src)


def _both(pred, true_fn, false_fn, *operands):
    """The select form of a branch: both sides run (the true side's in-place
    writes masked by pred, _write_taken), and pred commits the true side's
    outputs over the false side's."""
    masks = getattr(_TAKEN, "masks", None)
    if masks is None:
        masks = _TAKEN.masks = []
    masks.append(pred)
    try:
        a = true_fn(*operands)
    finally:
        masks.pop()
    return a if false_fn is None else _select(pred, a, false_fn(*operands))


def _branch(pred, true_fn, false_fn, operands):
    """One lax.cond on a 0-d predicate: IF nodes while a CUDA graph captures
    it (graph_cond.if_else, which raises outside a runner's capture), else
    the select form. The tests put a host `if` here to run only the taken
    side on the CPU."""
    if graph_cond.capturing(pred):
        return graph_cond.if_else(pred, true_fn, false_fn, operands)
    return _both(pred, true_fn, false_fn, *operands)


def _cond(pred, true_fn, false_fn, operands=()):
    """lax.cond(pred, true_fn, false_fn, *operands) on the card's terms (see
    the module docstring). pred 0-d: one branch. pred [C] (the channel axis
    of the operands): the JAX package's gated form, one branch on any(pred)
    whose taken side runs both sides over the channels and commits per
    channel (_both).

    Each side returns matching (named) tuples of tensors; the false side may
    put Python numbers in place of tensors. A side may write an operand in
    place only through _write_taken, and then the false side writes nothing
    there. false_fn None: the branch only writes in place (true_fn returns
    ()), and has no untaken side."""
    if pred.dim():
        gated = functools.partial(_both, pred, true_fn, false_fn)
        return _branch(pred.any(), gated, false_fn, operands)
    return _branch(pred, true_fn, false_fn, operands)


class _Blocks:
    """What every step form shares: the block's geometry, the chosen
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

    def rate(self, state: StreamState):
        """The fixed-point samples-per-pixel the PLL's delta modulates, in
        f32 with the JAX operation order (one unit of inv_fix moves the
        phase)."""
        delta = state.pll.refresh_delta
        corr_factor = delta / (self.rr_f32 + delta)
        inv_corr = torch.round(self.inv0_f32 * corr_factor).to(torch.int64)
        return self.config.inv0_fix - inv_corr

    def resample_block(self, state: StreamState, raw, phase, env=None):
        """The PLL-modulated rate, then demod + resample from `phase`: K2 in
        one launch, or the demod, the optional FIR (the autocorrelation ring
        takes the pre-FIR envelope) and the chosen resampler. `env` is the
        block's envelope when the caller demodulated it (raw is then unused).
        Returns (env, pixels, n_out, phase2, new_tail, fir_tail)."""
        cfg, params = self.config, self.params
        n, taps, mp = cfg.block_samples, cfg.resample_taps, cfg.max_block_pixels
        inv_fix = self.rate(state)
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


class StepParts(NamedTuple):
    """The pieces of the step (_make_step_parts); see there."""

    pre: Callable
    drop_phase: Callable
    pre_back: Callable
    ac_round_fn: Callable
    emit_chain: Callable
    emit_ops_of: Callable
    ac_ops_of: Callable
    assemble: Callable
    finish: Callable


def _make_step_parts(blocks: _Blocks, ac_write_external: bool = False,
                     env_external: bool = False) -> StepParts:
    """The JAX package's _make_step_parts (tempestsdr_tpu/stream/pipeline.py)
    on one device, its lax.conds as _conds:

      pre(state, raw, controls) -> inter     (drops, rate, demod, resample,
          then pre_back: the per-sample work of one channel)
      drop_phase(state, dropped) -> (phase, drop_all)   (drop compensation)
      pre_back(state, controls, drop_all, env, pixels, n_out, phase2,
          new_tail, fir_tail) -> inter       (ring bookkeeping and write, sync
          skip, fold write; the time-sharded body's back half too)
      ac_round_fn(ops, round_done) -> ops'   (FFT + running averages and the
          ring's leftover move, behind a _cond on round_done)
      emit_chain(ops) -> (ops', frames, valid)        (the K emit slots, each
          one frame's post-process, emit_fn, behind a _cond on fill2 >=
          (k+1)*frame_pixels, else no_emit_fn's zeros; and the leftover move)
      emit_ops_of / ac_ops_of(state, inter) -> ops
      assemble(state, inter, ac_ops, emit_ops, frames, valid) -> (state', outputs)
      finish(state, inter) -> (state', outputs)       (the round, the emit
          chain and assemble: the step after pre)

    Every part after pre takes one channel's values or a stack of channels
    on a leading axis ([C] predicates, frames [C, H, W]): run once over C
    channels, ac_round_fn and emit_chain are the JAX package's any()-gated
    jax.vmap(ac_round_fn) and jax.vmap(emit_fn) with per-channel select
    commits.

    ac_write_external: pre leaves the ring write to the caller and returns
    the block's envelope, its fed flag and its fill as env, ac_fed and
    ac_fill0 (the channel steps' one 2-D write). env_external: pre takes
    the block's envelope in place of its raw IQ (the caller demodulated
    every channel at once).

    Every tensor argument is on blocks.device; controls are tensors
    (controls_on, channel_controls_on)."""
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

    def drop_phase(state: StreamState, dropped):
        # drop compensation folded into the phase (dsp.c:313-368):
        # (skip_before - dropped) % block2 is a floor modulo
        skip_before = torch.clamp(state.phase_fix, min=0) >> FRAC_BITS
        new_skip = torch.where(dropped > 0, torch.remainder(skip_before - dropped, blocks.block2),
                               skip_before)
        phase = state.phase_fix + ((new_skip - skip_before) << FRAC_BITS)
        return phase, phase >= (n << FRAC_BITS)

    def pre(state: StreamState, raw, controls: StepControls):
        phase, drop_all = drop_phase(state, controls.samples_dropped)
        res = blocks.resample_block(state, raw, phase, env=raw if env_external else None)
        return pre_back(state, controls, drop_all, *res)

    def pre_back(state: StreamState, controls: StepControls, drop_all, env, pixels, n_out,
                 phase2, new_tail, fir_tail):
        # ---- autocorrelation ring (frameratedetector.c:215-230): a drop
        # purges it, a block past the drop is not fed; the write rewrites
        # the ring's own values where the block is not fed
        if run_autocorr:
            purge = controls.samples_dropped != 0
            fed = ~drop_all & ~purge
            fill0 = torch.where(purge, 0, state.ac_fill)
            ac_buf = state.ac_buf
            if not ac_write_external:
                at = fill0.to(torch.int64) + ring_idx
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

        def shift(px):  # in place: the block's pixels are its own
            src = k.to(torch.int64) + pix_idx
            _write_taken(px, torch.where(src < mp, px[src.clamp(max=mp - 1)], 0.0))
            return ()

        _cond(k > 0, shift, None, (pixels,))
        n_valid = n_out - k
        pend = pend - k

        # ---- frame fold: pixels past n_valid are zero and rewritten before read
        framebuf = state.framebuf
        framebuf.index_copy_(0, state.fill.to(torch.int64) + pix_idx, pixels)
        fill2 = state.fill + n_valid
        inter = dict(phase2=phase2, new_tail=new_tail, fir_tail=fir_tail, pend=pend,
                     framebuf=framebuf, fill2=fill2, emit=fill2 >= fp, n_out=n_out,
                     ac_buf=ac_buf, ac_fill=ac_fill, round_done=round_done,
                     motionblur=controls.motionblur)
        if ac_write_external and run_autocorr:
            inter.update(env=env, ac_fed=fed, ac_fill0=fill0)
        return inter

    def round_body(buf, avg_f, avg_l, calls, last_full):
        r = autocorrelation_magnitude(buf[..., :ac_fft])
        calls1 = calls + 1
        new = (accumulate_running_mean(avg_f, r[..., fw_off:fw_off + fw_len], calls1),
               accumulate_running_mean(avg_l, r[..., lw_off:lw_off + lw_len], calls1),
               calls1,
               r[..., :ac_fft // 2])
        # the leftover (one block; ac_round >= n, so the ranges are apart)
        # to the front of the ring
        m = buf.shape[-1] - ac_round
        _write_taken(buf[..., :m], buf[..., ac_round:])
        return new

    def no_round(buf, avg_f, avg_l, calls, last_full):
        return avg_f, avg_l, calls, last_full

    def ac_round_fn(ops, round_done):
        return (ops[0],) + _cond(round_done, round_body, no_round, ops)

    def emit_fn(carry, window, motionblur):
        screen, ag, sx, sy, pll = carry
        result, screen, ag, sx, sy, pll = _post_process(cfg, params, window, screen, ag, sx, sy,
                                                        pll, motionblur)
        return (screen, ag, sx, sy, pll), result

    def no_emit_fn(carry, window):
        return carry, 0.0

    def emit_chain(ops):
        """Every emit slot in stream order: slot k post-processes the fold
        buffer's k-th frame where fill2 >= (k+1)*fp (a _cond; the window is
        sliced outside it, read-only, as the JAX step slices it), the
        carried state chained through; then one leftover move from
        emitted*fp to the front (onto itself when nothing was emitted).
        Returns (ops', frames, valid): frames [..., H, W] and valid [...]
        for K == 1, [..., K, H, W] and [..., K] for K > 1."""
        framebuf, fill2, screen, ag, sx, sy, pll, motionblur = ops
        lead = framebuf.shape[:-1]
        carry = (screen, ag, sx, sy, pll)
        frames, valids = [], []
        for slot in range(k_frames):
            ek = fill2 >= (slot + 1) * fp
            window = framebuf[..., slot * fp:(slot + 1) * fp].reshape(lead + (h, w))
            carry, fk = _cond(ek, functools.partial(emit_fn, motionblur=motionblur), no_emit_fn,
                              (carry, window))
            frames.append(fk)
            valids.append(ek)
        valid = torch.stack(valids, dim=-1)
        emitted = valid.sum(dim=-1, dtype=torch.int32)
        at = emitted.to(torch.int64)[..., None] * fp + left_idx
        framebuf[..., :left_idx.shape[0]] = torch.gather(framebuf, -1, at)
        screen, ag, sx, sy, pll = carry
        emit_ops = (framebuf, fill2 - emitted * fp, screen, ag, sx, sy, pll, motionblur)
        if k_frames == 1:
            return emit_ops, frames[0], valids[0]
        return emit_ops, torch.stack(frames, dim=-3), valid

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
        n_emitted = (frame_valid.to(torch.int32) if k_frames == 1
                     else frame_valid.sum(dim=-1, dtype=torch.int32))
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

    def finish(state: StreamState, inter):
        ac_ops = ac_ops_of(state, inter)
        if run_autocorr:
            ac_ops = ac_round_fn(ac_ops, inter["round_done"])
        emit_ops, frame_out, valid = emit_chain(emit_ops_of(state, inter))
        return assemble(state, inter, ac_ops, emit_ops, frame_out, valid)

    return StepParts(pre, drop_phase, pre_back, ac_round_fn, emit_chain, emit_ops_of, ac_ops_of,
                     assemble, finish)


class DeviceStep(_Blocks):
    """The single-channel device step for one (config, params, device); see
    the module docstring. It keeps nothing per call, so one DeviceStep may
    be stepped from several threads, each on a state of its own.
    Params.superresolution is the session's business: the step never reads
    it."""

    def __init__(self, config: PipelineConfig, params: Params, device):
        super().__init__(config, params, device)
        self.parts = _make_step_parts(self)

    def __call__(self, state: StreamState, raw, controls: StepControls = StepControls()):
        raw = torch.as_tensor(raw).to(self.device)
        inter = self.parts.pre(state, raw, controls_on(controls, self.device))
        return self.parts.finish(state, inter)


def make_step(config: PipelineConfig, params: Params, device="cuda",
              batched: bool = False) -> DeviceStep:
    """Build the per-block device step for one channel:
    step(state, raw [2*block_samples] any supported dtype, controls) ->
    (state', StepOutputs), reading nothing to the host. batched is accepted
    for the JAX package's API, where it marks a step that a caller vmaps
    over channels (forcing the XLA resampler forms there); the port's
    channel steps batch over channels themselves (cond_mode="batched"), so
    the flag changes nothing here: the step runs the kernels the plain one
    runs."""
    return DeviceStep(config, params, device)


# ---- the channel steps -----------------------------------------------------


def channel_controls_on(controls: StepControls, n: int, device) -> StepControls:
    """StepControls for n channels as [n] tensors of their JAX dtypes on
    `device`. Each field is a length-n sequence, numpy array or tensor, or
    one value for every channel; a tensor is converted on its device, so
    nothing is read back to the host."""
    out = []
    for v, dtype in zip(controls, CONTROL_DTYPES):
        if isinstance(v, torch.Tensor):
            t = v.to(device=device, dtype=dtype)
        elif isinstance(v, (list, tuple, np.ndarray)):
            t = torch.as_tensor(np.asarray(v)).to(device=device, dtype=dtype)
        else:
            t = torch.full((n,), v, dtype=dtype, device=device)
        if t.dim() == 0:
            t = t.expand(n)
        if tuple(t.shape) != (n,):
            raise ValueError(f"a control has {t.shape[0]} values for {n} channels")
        out.append(t)
    return StepControls(*out)


def _channel_rows(states: StreamState, n: int) -> list:
    """Per channel, a StreamState of views of that channel's rows."""
    leaves = state_leaves(states)
    return [state_from_leaves([x[c] for x in leaves]) for c in range(n)]


class ChannelsStep(_Blocks):
    """Every channel step, a device program as the JAX package's
    make_channels_step_hybrid: per channel `pre` on that channel's row views
    (K1 or K2 per channel; the fold written in place), then

      - the ring write as ONE 2-D indexed write into the stacked rings at
        per-channel offsets fill0[c] + arange(n), where a row that is not
        fed rewrites its own values (the JAX write_shared and
        write_per_channel branches in one operation, with no branch);
      - cond_mode="unrolled": per channel the round and the emit chain on
        its row slices, each behind that channel's own _cond (IF nodes in a
        captured graph: only the channels that cross a round or frame
        boundary run a body, as in the JAX hybrid step);
        cond_mode="batched": the round and the emit chain ONCE over the
        channel axis behind a _cond on any() of the [C] predicate, committed
        per channel inside (the JAX gated forms' any()-gated
        jax.vmap(ac_round_fn) and jax.vmap(emit_fn));
      - assemble over the channel axis.

    It takes a stacked state (every leaf with a leading channel axis C, rows
    owning their memory: parallel.channels.stack_states), raws [C, 2n] and
    per-channel controls (channel_controls_on), and returns the stacked state
    and StepOutputs: frame [C, H, W] and frame_valid [C] (K == 1), or
    [C, K, H, W] and [C, K]. Nothing is read to the host, so a block can be
    captured into a CUDA graph (stream/graph.py, ChannelRunner). The fold
    buffers and rings are written in place. n_channels=None takes the count
    from raws."""

    def __init__(self, config: PipelineConfig, params: Params, n_channels: int | None, device, *,
                 cond_mode: str = "unrolled", stacked_demod: bool = False):
        super().__init__(config, params, device)
        self.n_channels, self.cond_mode = n_channels, cond_mode
        self.stacked_demod = stacked_demod
        self.parts = _make_step_parts(self, ac_write_external=True, env_external=stacked_demod)
        self._ring_idx = torch.arange(config.block_samples, device=self.device)

    def __call__(self, states: StreamState, raws, controls: StepControls = StepControls()):
        p = self.parts
        raws = torch.as_tensor(raws).to(self.device)
        n_ch = raws.shape[0] if self.n_channels is None else self.n_channels
        if raws.dim() != 2 or raws.shape[0] != n_ch:
            raise ValueError(f"raws must be [{n_ch}, 2n], got {tuple(raws.shape)}")
        ctl = channel_controls_on(controls, n_ch, self.device)
        rows = _channel_rows(states, n_ch)
        feed = raws
        if self.stacked_demod:
            # one demod over every channel's block: each row is 2n values,
            # so flattening keeps every I/Q pair together (bit-identical to
            # per-channel demod, an elementwise computation)
            feed = am_demod(normalize_iq(raws.reshape(-1))).reshape(n_ch, -1)
        inters = [p.pre(rows[c], feed[c], StepControls(*(v[c] for v in ctl)))
                  for c in range(n_ch)]
        own = {"framebuf", "ac_buf", "motionblur"} | ({"env"} if self.stacked_demod else set())
        inter = {k: torch.stack([i[k] for i in inters]) for k in inters[0] if k not in own}
        inter.update(framebuf=states.framebuf, ac_buf=states.ac_buf, motionblur=ctl.motionblur)
        if self.run_autocorr:
            envs = feed if self.stacked_demod else inter.pop("env")
            at = inter.pop("ac_fill0").to(torch.int64)[:, None] + self._ring_idx
            fed = inter.pop("ac_fed")[:, None]
            states.ac_buf.scatter_(1, at, torch.where(fed, envs, states.ac_buf.gather(1, at)))
        if self.cond_mode == "batched":
            return p.finish(states, inter)
        ac_ops, emit_ops = p.ac_ops_of(states, inter), p.emit_ops_of(states, inter)
        acs, emits, frames, valids = [], [], [], []
        for c in range(n_ch):
            ac_c = _map(lambda x: x[c], ac_ops)
            if self.run_autocorr:
                ac_c = p.ac_round_fn(ac_c, inter["round_done"][c])
            emit_c, frame_c, valid_c = p.emit_chain(_map(lambda x: x[c], emit_ops))
            acs.append(ac_c[1:])
            emits.append(emit_c[1:])
            frames.append(frame_c)
            valids.append(valid_c)
        stack = lambda *xs: torch.stack(xs)  # noqa: E731
        # the ring and the fold buffer were written in place through the rows
        ac_ops = (states.ac_buf,) + _map(stack, *acs)
        emit_ops = (states.framebuf,) + _map(stack, *emits)
        return p.assemble(states, inter, ac_ops, emit_ops, torch.stack(frames), torch.stack(valids))


def make_channels_step_hybrid(config: PipelineConfig, params: Params, n_channels: int, *,
                              cond_mode: str = "unrolled", demod_mode: str = "per-channel",
                              device="cuda") -> ChannelsStep:
    """The production multi-channel step (MultiSession's), a device program
    (ChannelsStep): per channel `pre` (K1 at m == 2, or K2 with
    resampler="fused"), the ring write as one 2-D write, then the round and
    emit bodies per channel (cond_mode="unrolled") or once over the channel
    axis (cond_mode="batched", one frame per block, the reference's limit).

    demod_mode="stacked" demodulates all channels' raw blocks in one call
    (bit-identical to per-channel demod); resampler="fused" forces
    per-channel demod, since K2 takes the raw bytes."""
    if cond_mode not in ("batched", "unrolled"):
        raise ValueError(f"unknown cond_mode {cond_mode!r}")
    if cond_mode == "batched" and config.frames_per_block > 1:
        raise ValueError(
            "cond_mode='batched' supports one frame per block; use the "
            "default cond_mode='unrolled' for multi-frame blocks")
    if demod_mode not in ("per-channel", "stacked"):
        raise ValueError(f"unknown demod_mode {demod_mode!r}")
    return ChannelsStep(config, params, n_channels, device, cond_mode=cond_mode,
                        stacked_demod=demod_mode == "stacked" and params.resampler != "fused")


def make_channels_step_unrolled(config: PipelineConfig, params: Params, n_channels: int,
                                device="cuda") -> ChannelsStep:
    """The JAX package's unrolled step (the single-channel step repeated over
    the channels' rows): the bodies per channel, no stacked demod."""
    return ChannelsStep(config, params, n_channels, device)


def make_channels_step(config: PipelineConfig, params: Params, n_channels: int = 0,
                       device="cuda") -> ChannelsStep:
    """The JAX package's gated multi-channel step: the bodies once over the
    channel axis, committed per channel (its any() gate is a select too).
    Keeps the reference's one-frame-per-block limit. n_channels=0 takes the
    count from raws, as the reference's vmap does."""
    if config.frames_per_block > 1:
        raise ValueError(
            "make_channels_step supports one frame per block; use "
            "make_channels_step_hybrid/unrolled for multi-frame blocks")
    return ChannelsStep(config, params, n_channels or None, device, cond_mode="batched")


def make_multi_step(config: PipelineConfig, params: Params, device="cuda") -> ChannelsStep:
    """The JAX package's vmap(step) over a channel axis, the count taken
    from raws: every body once over the channel axis, committed per
    channel, at any frames per block (a vmap of the step's emit slots)."""
    return ChannelsStep(config, params, None, device, cond_mode="batched")


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
