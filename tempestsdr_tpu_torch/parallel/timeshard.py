"""The time-sharded wideband step (config 4, overlap-save halo exchange): one
IQ stream too fast for one card, each block split into T contiguous
segments over the mesh's 'time' row, one rank per segment. Per block each
rank:

  - demodulates its segment (and runs the optional FIR, whose left halo is
    the previous segment's tail: the reference's resampler carry,
    dsp.c:256-307, in overlap-save form);
  - computes its own global pixel range from the exact int64 phase with no
    communication (pixel p belongs to the segment holding floor(a_p); the
    first segment also owns a pixel that starts in the previous block);
  - resamples that range from [left halo | segment | right halo]: on the
    card K1's range entry at the m == 2 geometry, else a plain range form;
  - adds its pixels into the block's pixel vector through one psum
    (positions outside a rank's range are zero, so the sum places them).

The rest runs replicated on every rank, from collective results: the
single-channel device step's back half (stream.pipeline._make_step_parts:
pre_back's ring write of the all-gathered envelope, sync skip and fold
write, then the round, the emit chain and assemble), behind selects. No
value is read to the host inside a block outside the mesh's collectives;
every rank returns the same StreamState and StepOutputs as the
single-channel step.

All halos and tails come from one all_gather of every rank's head and tail
samples (the JAX package's ppermutes; no send/recv). Ranks must call the
step together, block by block.
"""

from __future__ import annotations

import torch

from ..config import FRAC_BITS, PipelineConfig
from ..kernels.strided_resample import box_resample_range_strided_cuda
from ..ops.demod import am_demod, normalize_iq
from ..ops.fir import fir_apply_block
from ..ops.resample import (
    box_resample_range,
    box_resample_range_strided,
    nn_resample_range,
    plan_strided,
    resample_counts,
)
from ..params import Params
from ..stream.pipeline import (
    StepControls,
    _Blocks,
    _channel_rows,
    _make_step_parts,
    channel_controls_on,
    controls_on,
)
from ..stream.state import StepOutputs, state_from_leaves, state_leaves
from .mesh import Mesh


def _ceil_div(a, b):
    return -((-a) // b)


def _pick_range_resampler(config: PipelineConfig, params: Params):
    """The range form for Params.resampler, as the single-channel step picks
    its block form: K1's range entry (its plain version on CPU tensors)
    wherever the single step would run K1, K3 or K4 at m == 2 (those have no
    range entry); the plain strided range form for "strided" and at m != 2;
    the chunked range form for "chunked" or when no strided plan exists."""
    plan = plan_strided(config.samples_per_pixel, config.resample_taps)
    if params.resampler == "chunked" or plan is None:
        return box_resample_range
    if params.resampler == "strided" or plan[0] != 2:
        return box_resample_range_strided
    return box_resample_range_strided_cuda


class TimeShardedStep:
    """One rank's part of the time-sharded step; see the module docstring.
    step(state, raw_seg [2*S], controls) -> (state', StepOutputs), S =
    block_samples // T; the state is this rank's replica."""

    def __init__(self, config: PipelineConfig, params: Params, mesh: Mesh, device=None):
        if config.frames_per_block > 1:
            raise ValueError(
                "time-sharded step supports one frame per block (the wideband "
                "config shards a sub-frame block across devices); shrink "
                "block_samples below one frame's worth of samples")
        T = mesh.shape["time"]
        n = config.block_samples
        if n % T:
            raise ValueError("block_samples must divide by the time-axis size")
        self.config, self.params, self.mesh, self.T, self.S = config, params, mesh, T, n // T
        self.blocks = _Blocks(config, params, mesh.device if device is None else device)
        self.parts = _make_step_parts(self.blocks)
        self.device = self.blocks.device
        need = max(config.resample_taps, params.fir_lowpass_taps - 1)
        if self.S < need:
            raise ValueError(f"a segment of {self.S} samples is shorter than its halo ({need})")
        self.max_pix_local = int(self.S * config.pixelrate / config.samplerate * 1.02) + 2
        self.nn_mode = bool(params.nearest_neighbour)
        self.range_resample = _pick_range_resampler(config, params)

    def __call__(self, state, raw_seg, controls: StepControls = StepControls()):
        cfg, blocks, mesh = self.config, self.blocks, self.mesh
        n, S, T, taps = cfg.block_samples, self.S, self.T, cfg.resample_taps
        mpl = self.max_pix_local
        t = mesh.time_index
        raw = torch.as_tensor(raw_seg).to(self.device)
        if raw.shape != (2 * S,):
            raise ValueError(
                f"raw_seg must be this rank's [{2 * S}] segment, got {tuple(raw.shape)}")
        controls = controls_on(controls, self.device)
        env = am_demod(normalize_iq(raw))  # (S,)

        # ---- drop compensation and the PLL-modulated rate, replicated: the
        # single-channel step's scalar math
        phase, drop_all = self.parts.drop_phase(state, controls.samples_dropped)
        inv_fix = blocks.rate(state)

        # the ring takes the whole block's pre-FIR envelope
        env_full = mesh.all_gather(env, tiled=True) if blocks.run_autocorr else env

        # ---- optional FIR: the left halo is the previous segment's tail,
        # the carry the last segment's
        fir_tail, env_rs = state.fir_tail, env
        if blocks.fir_taps is not None:
            k = blocks.fir_taps.shape[0] - 1
            tails = mesh.all_gather(env[S - k:])
            env_rs, _ = fir_apply_block(env, state.fir_tail if t == 0 else tails[t - 1],
                                        blocks.fir_taps)
            fir_tail = tails[T - 1].clone()

        # ---- this rank's global pixel range, from the exact phase: the
        # pixels whose window starts in its segment; the first rank also owns
        # those starting in the previous block's tail (a negative phase),
        # which the JAX body leaves to no rank (pixel 0 of such a block stays
        # 0 there)
        n_out, phase2 = resample_counts(phase, inv_fix, n)
        n_out64 = n_out.to(torch.int64)
        seg = t * S

        def first_pixel(sample):  # the first pixel with a_p >= sample, in [0, n_out]
            return torch.minimum(torch.clamp(_ceil_div((sample << FRAC_BITS) - phase, inv_fix),
                                             min=0), n_out64)

        p_start = torch.zeros_like(n_out64) if t == 0 else first_pixel(seg)
        p_end = first_pixel(seg + S)

        if self.nn_mode:
            # NN's (n*p)//n_out ignores the phase and can reach past the
            # halos: it reads the whole block's post-FIR envelope
            env_full_rs = env_full if (blocks.run_autocorr and blocks.fir_taps is None) \
                else mesh.all_gather(env_rs, tiled=True)
            pix_local = nn_resample_range(env_full_rs, n_out, p_start, p_end, n_samples=n,
                                          max_pix=mpl)
            new_tail = env_full_rs[n - taps:].clone()
        else:
            edges = mesh.all_gather(torch.cat([env_rs[:taps], env_rs[S - taps:]]))  # [T, 2 taps]
            left = state.tail if t == 0 else edges[t - 1, taps:]
            right = edges[t + 1, :taps] if t < T - 1 else torch.zeros_like(state.tail)
            x_local = torch.cat([left, env_rs, right])
            new_tail = edges[T - 1, taps:].clone()
            pix_local = self.range_resample(x_local, phase, inv_fix, p_start, p_end, seg,
                                            max_pix=mpl, taps=taps,
                                            inv_nominal=cfg.samples_per_pixel)

        # ---- the block's pixel vector: each rank's range at its offset,
        # zero elsewhere, summed over the row
        mp = cfg.max_block_pixels
        placed = torch.zeros((mp + mpl,), dtype=torch.float32, device=self.device)
        placed.index_copy_(0, p_start + torch.arange(mpl, device=self.device), pix_local)
        pixels = mesh.psum(placed[:mp])

        # ---- the replicated rest: the device step's back half
        inter = self.parts.pre_back(state, controls, drop_all, env_full, pixels, n_out, phase2,
                                    new_tail, fir_tail)
        return self.parts.finish(state, inter)


def make_time_sharded_step(config: PipelineConfig, params: Params, mesh: Mesh, device=None):
    """This rank's time-sharded step over the mesh's 'time' row:
    step(state, raw_seg [2*S], controls) -> (state', outputs), the state and
    outputs replicated over the row. device: this rank's torch device
    (default: the mesh's for this rank)."""
    return TimeShardedStep(config, params, mesh, device)


class GridStep:
    """The time-sharded body unrolled over this rank's local channels
    (configs 4 and 5 together): states stacked on a leading channel axis
    (parallel.stack_states), raws [c_local, 2*S] (each local channel's
    segment), controls per channel as the channel steps take them.
    Returns the stacked state' and StepOutputs."""

    def __init__(self, config: PipelineConfig, params: Params, mesh: Mesh, device=None):
        self.body = TimeShardedStep(config, params, mesh, device)
        self.device = self.body.device

    def __call__(self, states, raws, controls: StepControls = StepControls()):
        raws = torch.as_tensor(raws).to(self.device)
        n_ch = raws.shape[0]
        ctl = channel_controls_on(controls, n_ch, self.device)
        rows = _channel_rows(states, n_ch)
        results = [self.body(rows[c], raws[c], StepControls(*(v[c] for v in ctl)))
                   for c in range(n_ch)]
        leaves = zip(*(state_leaves(s) for s, _ in results))
        new = state_from_leaves([torch.stack(v) for v in leaves])
        return new, StepOutputs(*(torch.stack(v) for v in zip(*(o for _, o in results))))


def make_grid_step(config: PipelineConfig, params: Params, mesh: Mesh, device=None):
    """This rank's {ch, time} grid step: its row's local channels, each
    time-sharded over the row (see GridStep)."""
    return GridStep(config, params, mesh, device)
