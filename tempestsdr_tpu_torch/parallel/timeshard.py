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
write, then the round, the emit chain and assemble). No value is read to
the host inside a block outside the mesh's collectives; every rank returns
the same StreamState and StepOutputs as the single-channel step.

All halos and tails come from one all_gather of every rank's head and tail
samples (the JAX package's ppermutes; no send/recv). Ranks must call the
step together, block by block.

The step is cut at its collectives into stages (stream.graph.Stage): the
front (demod, drop compensation, the rate, the counts, this rank's pixel
range, the samples it sends), the FIR when there is one, the range
resample and the placed pixel vector, and the back half. The eager step
(TimeShardedStep.__call__, GridStep.__call__) runs them in order with the
collectives between them, every branch a select. make_time_sharded_step
and make_grid_step return them through a stream.graph.StagedRunner: on the
card each stage is a CUDA graph replayed between the collectives, the back
half's branches (the FFT round, the emit, the sync-skip shift) IF nodes,
as the JAX body's lax.conds run only their taken side; on the CPU the eager
step.
"""

from __future__ import annotations

import functools

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
from ..stream.graph import Stage, StagedRunner
from ..stream.state import StepOutputs, StreamState, state_from_leaves, state_leaves
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
    """One rank's part of the time-sharded step, run eagerly; see the module
    docstring. step(state, raw_seg [2*S], controls) -> (state', StepOutputs),
    S = block_samples // T; the state is this rank's replica. `stages` are
    its stretches between collectives (stream.graph.Stage over one local
    channel's context)."""

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
        self.t = mesh.time_index
        self.stages = self._stages()

    def _stages(self) -> list:
        """The stages and the collectives after each: the envelope gathered
        for the ring (autocorrelation on); with a FIR the tails (its left
        halos), then the edges or, nearest-neighbour, the whole post-FIR
        envelope; without, the edges or that envelope straight away; then
        the pixel vector's psum."""
        mesh, blocks = self.mesh, self.blocks
        gather = mesh.all_gather
        tiled = functools.partial(mesh.all_gather, tiled=True)
        front = [("env", tiled, "env_full")] if blocks.run_autocorr else []
        send = ("env_rs", tiled, "env_full_rs") if self.nn_mode else ("edges_send", gather, "edges")
        if blocks.fir_taps is not None:
            stages = [Stage(self._front, tuple(front) + (("fir_send", gather, "tails"),)),
                      Stage(self._fir, (send,))]
        elif not self.nn_mode:
            stages = [Stage(self._front, tuple(front) + (send,))]
        elif blocks.run_autocorr:  # the ring's gather is the whole envelope already
            stages = [Stage(self._front, tuple(front))]
        else:
            stages = [Stage(self._front, (("env", tiled, "env_full_rs"),))]
        return stages + [Stage(self._resample, (("placed", mesh.psum, "pixels"),)),
                         Stage(self._back)]

    def _front(self, ctx) -> dict:
        """Demod, drop compensation, the PLL-modulated rate, the block's
        counts, this rank's pixel range and the samples it sends."""
        cfg, blocks, state = self.config, self.blocks, ctx["state"]
        n, S, taps = cfg.block_samples, self.S, cfg.resample_taps
        env = am_demod(normalize_iq(ctx["raw"]))  # (S,)

        # ---- drop compensation and the PLL-modulated rate, replicated: the
        # single-channel step's scalar math
        phase, drop_all = self.parts.drop_phase(state, ctx["controls"].samples_dropped)
        inv_fix = blocks.rate(state)

        # ---- this rank's global pixel range, from the exact phase: the
        # pixels whose window starts in its segment; the first rank also owns
        # those starting in the previous block's tail (a negative phase),
        # which the JAX body leaves to no rank (pixel 0 of such a block stays
        # 0 there)
        n_out, phase2 = resample_counts(phase, inv_fix, n)
        n_out64 = n_out.to(torch.int64)
        seg = self.t * S

        def first_pixel(sample):  # the first pixel with a_p >= sample, in [0, n_out]
            return torch.minimum(torch.clamp(_ceil_div((sample << FRAC_BITS) - phase, inv_fix),
                                             min=0), n_out64)

        p_start = torch.zeros_like(n_out64) if self.t == 0 else first_pixel(seg)
        out = dict(env=env, phase=phase, drop_all=drop_all, inv_fix=inv_fix, n_out=n_out,
                   phase2=phase2, p_start=p_start, p_end=first_pixel(seg + S))
        if blocks.fir_taps is not None:
            out["fir_send"] = env[S - (blocks.fir_taps.shape[0] - 1):]
        elif not self.nn_mode:
            out["edges_send"] = _edges(env, S, taps)
        return out

    def _fir(self, ctx) -> dict:
        """The FIR: the left halo is the previous segment's tail, the carry
        the last segment's."""
        T, t, tails = self.T, self.t, ctx["tails"]
        env_rs, _ = fir_apply_block(ctx["env"], ctx["state"].fir_tail if t == 0 else tails[t - 1],
                                    self.blocks.fir_taps)
        out = dict(env_rs=env_rs, fir_tail=tails[T - 1].clone())
        if not self.nn_mode:
            out["edges_send"] = _edges(env_rs, self.S, self.config.resample_taps)
        return out

    def _resample(self, ctx) -> dict:
        """This rank's pixel range, placed in the block's pixel vector at its
        offset (zero elsewhere)."""
        cfg, state = self.config, ctx["state"]
        n, S, T, t, taps = cfg.block_samples, self.S, self.T, self.t, cfg.resample_taps
        mpl = self.max_pix_local
        if self.nn_mode:
            # NN's (n*p)//n_out ignores the phase and can reach past the
            # halos: it reads the whole block's post-FIR envelope
            env_full_rs = ctx["env_full_rs"] if "env_full_rs" in ctx else ctx["env_full"]
            pix_local = nn_resample_range(env_full_rs, ctx["n_out"], ctx["p_start"], ctx["p_end"],
                                          n_samples=n, max_pix=mpl)
            new_tail = env_full_rs[n - taps:].clone()
        else:
            edges = ctx["edges"]  # [T, 2 taps]
            left = state.tail if t == 0 else edges[t - 1, taps:]
            right = edges[t + 1, :taps] if t < T - 1 else torch.zeros_like(state.tail)
            x_local = torch.cat([left, ctx.get("env_rs", ctx["env"]), right])
            new_tail = edges[T - 1, taps:].clone()
            pix_local = self.range_resample(x_local, ctx["phase"], ctx["inv_fix"], ctx["p_start"],
                                            ctx["p_end"], t * S, max_pix=mpl, taps=taps,
                                            inv_nominal=cfg.samples_per_pixel)
        mp = cfg.max_block_pixels
        placed = torch.zeros((mp + mpl,), dtype=torch.float32, device=self.device)
        placed.index_copy_(0, ctx["p_start"] + torch.arange(mpl, device=self.device), pix_local)
        return dict(placed=placed[:mp], new_tail=new_tail)

    def _back(self, ctx) -> dict:
        """The replicated rest: the device step's back half."""
        state = ctx["state"]
        inter = self.parts.pre_back(state, ctx["controls"], ctx["drop_all"],
                                    ctx.get("env_full", ctx["env"]), ctx["pixels"], ctx["n_out"],
                                    ctx["phase2"], ctx["new_tail"],
                                    ctx.get("fir_tail", state.fir_tail))
        new_state, outputs = self.parts.finish(state, inter)
        return dict(new_state=new_state, outputs=outputs)

    # ---- what stream.graph.StagedRunner takes

    def inputs(self, raw_seg, controls: StepControls):
        raw = torch.as_tensor(raw_seg).to(self.device)
        if raw.shape != (2 * self.S,):
            raise ValueError(
                f"raw_seg must be this rank's [{2 * self.S}] segment, got {tuple(raw.shape)}")
        return raw, controls_on(controls, self.device)

    def contexts(self, state, raw, controls: StepControls) -> list:
        return [dict(state=state, raw=raw, controls=controls)]

    def outputs(self, ctxs) -> StepOutputs:
        return ctxs[0]["outputs"]

    def new_state(self, ctxs) -> StreamState:
        return ctxs[0]["new_state"]

    def __call__(self, state, raw_seg, controls: StepControls = StepControls()):
        ctxs = self.contexts(state, *self.inputs(raw_seg, controls))
        for stage in self.stages:
            for ctx in ctxs:
                ctx.update(stage.run(ctx))
            stage.exchange(ctxs)
        return self.new_state(ctxs), self.outputs(ctxs)


def _edges(env, S: int, taps: int):
    """The samples a rank sends as its neighbours' halos: its first and its
    last `taps`."""
    return torch.cat([env[:taps], env[S - taps:]])


def make_time_sharded_step(config: PipelineConfig, params: Params, mesh: Mesh, device=None):
    """This rank's time-sharded step over the mesh's 'time' row:
    step(state, raw_seg [2*S], controls) -> (state', outputs), the state and
    outputs replicated over the row. device: this rank's torch device
    (default: the mesh's for this rank). On the card its stages replay as
    CUDA graphs between the collectives (stream.graph.StagedRunner: the
    state returned is the runner's, the outputs the caller's); on the CPU
    it is the eager TimeShardedStep."""
    return StagedRunner(TimeShardedStep(config, params, mesh, device))


class GridStep(TimeShardedStep):
    """The time-sharded body over this rank's local channels (configs 4 and
    5 together), run eagerly: states stacked on a leading channel axis
    (parallel.stack_states), raws [c_local, 2*S] (each local channel's
    segment), controls per channel as the channel steps take them. Each
    stage runs on every local channel before the collectives, which run per
    channel. Returns the stacked state' and StepOutputs."""

    def inputs(self, raws, controls: StepControls):
        raws = torch.as_tensor(raws).to(self.device)
        if raws.dim() != 2 or raws.shape[1] != 2 * self.S:
            raise ValueError(f"raws must be [channels, {2 * self.S}], got {tuple(raws.shape)}")
        return raws, channel_controls_on(controls, raws.shape[0], self.device)

    def contexts(self, states, raws, controls: StepControls) -> list:
        rows = _channel_rows(states, raws.shape[0])
        return [dict(state=rows[c], raw=raws[c], controls=StepControls(*(v[c] for v in controls)))
                for c in range(raws.shape[0])]

    def outputs(self, ctxs) -> StepOutputs:
        return StepOutputs(*(torch.stack(v) for v in zip(*(c["outputs"] for c in ctxs))))

    def new_state(self, ctxs) -> StreamState:
        leaves = zip(*(state_leaves(c["new_state"]) for c in ctxs))
        return state_from_leaves([torch.stack(v) for v in leaves])


def make_grid_step(config: PipelineConfig, params: Params, mesh: Mesh, device=None):
    """This rank's {ch, time} grid step: its row's local channels, each
    time-sharded over the row (see GridStep); on the card through a
    stream.graph.StagedRunner, every stage graph covering all local
    channels and the back half's branches one pair of IF nodes per channel,
    as the JAX body's unrolled per-channel conds."""
    return StagedRunner(GridStep(config, params, mesh, device))
