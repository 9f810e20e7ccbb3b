"""K blocks of the device step per call: one CUDA-graph replay on the card.

The JAX package runs K blocks in one lax.scan program (make_scan_runner,
and Session(batch_blocks=K) "per device dispatch"). The PyTorch counterpart
is a CUDA graph: the device step (pipeline.make_step) reads nothing to the
host, so K of its calls can be captured once and replayed per batch.

BlockRunner(config, params, n_blocks, device).run(state, raws, controls):
raws [K, 2n] in the source's dtype, controls [K, 3] (samples_dropped,
syncoffset, motionblur per block, as numbers or one float64 tensor).
Returns (state', outputs stacked over the blocks, packed), where packed is
float64 [K, PACKED + frames_per_block]: per block the small values a
session reads once per batch (refreshrate, autogain, round count and flag,
then one frame_valid flag per emit slot; see packed_values).

On a CUDA device the runner captures, once per raw dtype, the K steps into
one torch.cuda.CUDAGraph over static buffers: the raw blocks [K, 2n], the
controls [K, 3] and the state (init_state's leaves, read and written in
place by the graph, like the JAX Session's donated state). The capture
runs inside kernels.graph_cond.branch_nodes, so every branch of the step
(pipeline._cond: the FFT round, each emit slot, the sync-skip shift, per
channel in the channel step) is a pair of CUDA-graph IF nodes and a replay
runs only the taken side, as the JAX program's lax.conds do; a branch that
cannot be made a node raises. Before capture one step runs on a side
stream on a scratch copy of the state, in the select form (both sides of
every branch run), so every body's kernels, the cuFFT plan, the kernels'
library load and the allocator's first blocks are made outside the graph.
A replay then copies in only the leaves of `state` that are not the
runner's own (the first call, a checkpoint, an autocorrelation reset, a
refresh nudge, another owner) and returns the runner's state: a caller
that passes it back pays no copy. The outputs and packed are the
graph's and are rewritten by the next replay. A failed capture or replay
raises; there is no eager fallback on the card.

On the CPU (the tests) the same device step runs eagerly in a loop, its
branches as selects.

ChannelRunner(config, params, n_channels, device) is the same runner over
the channel step (pipeline.make_channels_step_hybrid): one block of C
channels a call, as the JAX MultiSession dispatches one jitted block per
call. raws [C, 2n], controls [C, 3] (one row per channel), the stacked
state (parallel.stack_states); packed is float64 [C, PACKED + K].

The graph's state is one per runner, so one caller at a time may hold it:
lease() marks the runner taken (False when another holder has it) and
release(state) hands the holder its state in tensors of its own.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..kernels import graph_cond
from ..params import Params
from .pipeline import CONTROL_DTYPES, StepControls, make_channels_step_hybrid, make_step
from .state import StepOutputs, StreamState, init_state, state_compatible, state_leaves

PACKED = ("refreshrate", "ag_min", "ag_max", "ag_snr", "ac_calls", "ac_plot_valid")


def packed_values(out: StepOutputs) -> torch.Tensor:
    """One block's (or a stack's) small outputs as float64 [..., PACKED +
    K]: the PACKED fields, then frame_valid per emit slot. Exact: the
    integers and flags are small, the floats float32."""
    fields = [getattr(out, name).to(torch.float64) for name in PACKED]
    valid = out.frame_valid.to(torch.float64)
    if valid.dim() == fields[0].dim():  # K == 1: one flag per block
        valid = valid.unsqueeze(-1)
    return torch.cat([torch.stack(fields, dim=-1), valid], dim=-1)


def _block_controls(ctl: torch.Tensor) -> StepControls:
    """A row of the float64 controls buffer as the step's controls (0-d
    each), or the [C, 3] buffer as the channel step's ([C] each)."""
    return StepControls(*(ctl[..., j].to(dtype) for j, dtype in enumerate(CONTROL_DTYPES)))


def _stack(outs) -> StepOutputs:
    return StepOutputs(*(torch.stack(list(vals)) for vals in zip(*outs)))


class _Graph(NamedTuple):
    """One capture: the graph, its static inputs and outputs, and its branch
    nodes (their bodies' memory pool lives as long as the graph)."""

    graph: torch.cuda.CUDAGraph
    raws: torch.Tensor
    ctl: torch.Tensor
    outputs: StepOutputs
    packed: torch.Tensor
    branches: graph_cond.Branches


class BlockRunner:
    """See the module docstring."""

    rows = "blocks"  # what the leading axis of raws and controls counts

    def __init__(self, config: PipelineConfig, params: Params, n_blocks: int, device="cuda"):
        if n_blocks < 1:
            raise ValueError("a runner takes at least one block")
        self.config, self.params, self.n_blocks = config, params, int(n_blocks)
        self.step = self._make_step(device)
        self.device = self.step.device
        self.graphed = self.device.type == "cuda"
        self._graphs: dict = {}  # raw dtype -> _Graph
        self._static: StreamState | None = None
        self._lock = threading.Lock()
        self._held = False

    # ---- one holder of the graph's state at a time

    def lease(self) -> bool:
        """Take the runner; False when another holder has it."""
        with self._lock:
            if self._held:
                return False
            self._held = True
            return True

    def release(self, state: StreamState) -> StreamState:
        """Give the runner back; returns `state` with every leaf that is the
        runner's own replaced by a copy, so the next holder's replays do
        not write the returned state."""
        if self._static is not None:
            own = {id(x) for x in state_leaves(self._static)}
            state = type(state)(*_map_leaves(state, lambda x: x.clone() if id(x) in own else x))
        with self._lock:
            self._held = False
        return state

    # ---- what a subclass changes: the step, the state, the captured body

    def _make_step(self, device):
        return make_step(self.config, self.params, device)

    def _new_state(self) -> StreamState:
        return init_state(self.config, self.params.fir_lowpass_taps, self.device)

    def _body(self, state, raws, ctl, warm_up=False):
        """K device steps, their outputs stacked (one step to warm up)."""
        outs = []
        for i in range(1 if warm_up else self.n_blocks):
            state, out = self.step(state, raws[i], _block_controls(ctl[i]))
            outs.append(out)
        return state, _stack(outs)

    # ---- the K blocks

    def run(self, state: StreamState, raws, controls):
        raws = torch.as_tensor(raws)
        if raws.dim() != 2 or raws.shape[0] != self.n_blocks:
            raise ValueError(f"{tuple(raws.shape)} {self.rows}, the runner takes "
                             f"[{self.n_blocks}, 2n]")
        ctl = torch.as_tensor(controls, dtype=torch.float64)
        if tuple(ctl.shape) != (self.n_blocks, 3):
            raise ValueError(f"controls {tuple(ctl.shape)}, the runner takes [{self.n_blocks}, 3]")
        if not self.graphed:
            state, out = self._body(state, raws.to(self.device), ctl.to(self.device))
            return state, out, packed_values(out)
        g = self._graphs.get(raws.dtype)
        if g is None:
            g = self._graphs[raws.dtype] = self._capture(raws.dtype)
        self._copy_in(state)
        g.raws.copy_(raws)
        g.ctl.copy_(ctl)
        g.graph.replay()
        return self._static, g.outputs, g.packed

    def _copy_in(self, state: StreamState) -> None:
        if not state_compatible(state, self._static):
            raise ValueError("the state does not match this runner's geometry and params")
        for dst, src in zip(state_leaves(self._static), state_leaves(state)):
            if src is not dst:
                dst.copy_(src)

    def _capture(self, dtype) -> _Graph:
        cfg, dev, k = self.config, self.device, self.n_blocks
        if self._static is None:
            self._static = self._new_state()
        raws = torch.zeros((k, 2 * cfg.block_samples), dtype=dtype, device=dev)
        ctl = torch.zeros((k, 3), dtype=torch.float64, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            scratch = type(self._static)(*_map_leaves(self._static, torch.clone))
            self._body(scratch, raws, ctl, warm_up=True)
        torch.cuda.current_stream(dev).wait_stream(side)
        # keep_graph: the captured graph stays readable (raw_cuda_graph), so
        # a measurement can count its nodes (census)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # thread_local: a session streaming on another thread may keep
        # synchronizing while this thread captures (a warm start)
        with graph_cond.branch_nodes(dev) as branches, \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            state, outputs = self._body(self._static, raws, ctl)
            packed = packed_values(outputs)
            for dst, src in zip(state_leaves(self._static), state_leaves(state)):
                if src is not dst:
                    dst.copy_(src)
        graph.instantiate()
        return _Graph(graph, raws, ctl, outputs, packed, branches)

    def census(self, dtype=torch.uint8) -> dict:
        """The node counts of the graph captured for raws of `dtype`:
        parent, IF and body nodes (graph_cond.census)."""
        g = self._graphs[dtype]
        return graph_cond.census(g.graph.raw_cuda_graph(), g.branches.bodies)


class ChannelRunner(BlockRunner):
    """The runner over the channel step: one block of n_channels channels a
    call (raws [C, 2n], controls [C, 3], the stacked state), one CUDA-graph
    replay on the card; see the module docstring. The rows of the static
    state are views the capture wrote through, so a replay writes each
    channel's fold buffer and ring in place."""

    rows = "channels"

    def __init__(self, config: PipelineConfig, params: Params, n_channels: int, device="cuda", *,
                 cond_mode: str = "unrolled"):
        self.cond_mode = cond_mode
        super().__init__(config, params, n_channels, device)

    def _make_step(self, device):
        return make_channels_step_hybrid(self.config, self.params, self.n_blocks,
                                         cond_mode=self.cond_mode, device=device)

    def _new_state(self) -> StreamState:
        from ..parallel.channels import stack_states

        return stack_states(self.config, self.n_blocks, self.params.fir_lowpass_taps, self.device)

    def _body(self, state, raws, ctl, warm_up=False):
        return self.step(state, raws, _block_controls(ctl))


def _map_leaves(state: StreamState, fn) -> list:
    """fn over every leaf, keeping the nested NamedTuples' structure."""
    return [type(x)(*map(fn, x)) if isinstance(x, tuple) else fn(x) for x in state]


def host_controls(dropped, sync: int, motionblur: float) -> np.ndarray:
    """A batch's controls [K, 3]: each block's drop count in its own slot,
    the sync shift in slot 0 only (both one-shot events, the JAX Session's
    contract), the motion blur on every block."""
    ctl = np.zeros((len(dropped), 3), np.float64)
    ctl[:, 0] = dropped
    ctl[0, 1] = sync
    ctl[:, 2] = motionblur
    return ctl
