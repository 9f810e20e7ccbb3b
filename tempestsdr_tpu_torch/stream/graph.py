"""K blocks of the device step per call: one CUDA-graph replay on the card.

The JAX package runs K blocks in one lax.scan program (make_scan_runner,
and Session(batch_blocks=K) "per device dispatch"). The PyTorch counterpart
is a CUDA graph: the device step (pipeline.make_step) reads nothing to the
host, so K of its calls can be captured once and replayed per batch.

BlockRunner(config, params, n_blocks, device).run(state, raws, controls):
raws [K, 2n] in the source's dtype (or a list of K blocks), controls [K,
3] (samples_dropped, syncoffset, motionblur per block, as numbers or one
float64 tensor). Returns (state', outputs stacked over the blocks,
packed), where packed is float64 [K, PACKED + frames_per_block]: per block
the small values a session reads once per batch (refreshrate, autogain,
round count and flag, then one frame_valid flag per emit slot; see
packed_values). A call is two spans (utils/profiling.py span): tsdr/upload
(the rows staged, their copies into the graph's static inputs queued) and
tsdr/replay; a capture is tsdr/capture. upload_stats (UploadStats) counts
the calls, their bytes, those staged through pinned memory and the waits
on a staging buffer still in flight.

On a CUDA device the runner captures, once per raw dtype, the K steps into
one torch.cuda.CUDAGraph over static buffers: the raw blocks [K, 2n], the
controls [K, 3] and the state (init_state's leaves, read and written in
place by the graph, like the JAX Session's donated state). The capture
runs inside kernels.graph_cond.branch_nodes, so every branch of the step
(pipeline._cond: the FFT round, each emit slot, the sync-skip shift, per
channel in the channel step) is a pair of CUDA-graph IF nodes and a replay
runs only the taken side, as the JAX program's lax.conds do; a branch that
cannot be made a node raises. Beside each graph the runner keeps pinned
host buffers shaped like its raws and controls: a call copies each host
row of the caller's into its row there (np.copyto, one thread) and queues
that row's copy to the card at once (non_blocking), so row i's DMA runs
while the host copies row i + 1, and the replay follows on the same
stream; an event recorded after the last copy guards the buffers, and the
next call waits on it before it writes them (in a session's loop the
fetch has waited already). Rows already on the card
are copied there directly, and so are a one-row call's raws and controls
(a Session at batch 1), as blocking copies: CUDA's own copy of one
pageable row overlaps its CPU copy with the DMA, where a staged row's DMA
follows its copy. The caller's arrays are free once run returns.

Before capture one step runs on a side stream on a scratch copy of the
state, in the select form (both sides of every branch run), so every
body's kernels, the cuFFT plan, the kernels' library load and the
allocator's first blocks are made outside the graph. A replay then copies
in only the leaves of `state` that are not the runner's own (the first
call, a checkpoint, an autocorrelation reset, a refresh nudge, another
owner) and returns the runner's state: a caller that passes it back pays
no copy. The outputs and packed are the graph's and are rewritten by the
next replay. A failed capture or replay raises; there is no eager
fallback on the card.

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

StagedRunner(program) runs a step that a collective cuts into stages (the
sharded steps, parallel/timeshard.py): on the card each stage is a CUDA
graph of its own, captured once per raw dtype, and a call replays them in
order with the program's collectives run eagerly between them, each reading
a stage's static outputs and writing the next stage's static inputs; the
last stage is captured inside branch_nodes, so its branches are IF nodes.
On the CPU it runs the program's eager composition of the same stages.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..kernels import graph_cond
from ..params import Params
from ..utils.profiling import span
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
    """One capture: the graph, its static inputs and outputs, its branch
    nodes (their bodies' memory pool lives as long as the graph), the
    pinned host buffers its inputs are staged in (None at one row) and the
    event recorded after their last copies."""

    graph: torch.cuda.CUDAGraph
    raws: torch.Tensor
    ctl: torch.Tensor
    outputs: StepOutputs
    packed: torch.Tensor
    branches: graph_cond.Branches
    host_raws: torch.Tensor | None
    host_ctl: torch.Tensor | None
    copied: torch.cuda.Event


@dataclass
class UploadStats:
    """A runner's uploads: its calls, their bytes (raws and controls), the
    calls that staged their host rows through its pinned buffer (none on
    the CPU, none of one row), and the calls that found a staging buffer's
    copies still in flight and waited for them."""
    uploads: int = 0
    bytes: int = 0
    staged: int = 0
    waits: int = 0

    @property
    def staged_share(self) -> float:
        return self.staged / max(self.uploads, 1)


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
        self.upload_stats = UploadStats()

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
        with span("tsdr/upload"):
            rows = _rows(raws, self.n_blocks, self.rows)
            ctl = torch.as_tensor(controls, dtype=torch.float64)
            if tuple(ctl.shape) != (self.n_blocks, 3):
                raise ValueError(f"controls {tuple(ctl.shape)}, the runner takes "
                                 f"[{self.n_blocks}, 3]")
            stats = self.upload_stats
            stats.uploads += 1
            stats.bytes += sum(row.nbytes for row in rows) + ctl.nbytes
            if self.graphed:
                g = self.prepare(rows[0].dtype)
                _copy_in(self._static, state)
                if len(rows) == 1:
                    # CUDA's own copy of a pageable row overlaps its CPU copy
                    # with the DMA; staged here, the DMA would follow the copy
                    g.raws[0].copy_(rows[0])
                    g.ctl.copy_(ctl)
                else:
                    if not all(x.is_cuda for x in [*rows, ctl]) and not g.copied.query():
                        stats.waits += 1  # the last call's copies out of the buffers
                        g.copied.synchronize()
                    stats.staged += _stage(rows, g.host_raws, g.raws)
                    _stage([ctl], [g.host_ctl], [g.ctl])
                    g.copied.record()
            else:
                raws, ctl = torch.stack(rows).to(self.device), ctl.to(self.device)
        with span("tsdr/replay"):
            if self.graphed:
                g.graph.replay()
                return self._static, g.outputs, g.packed
            state, out = self._body(state, raws, ctl)
            return state, out, packed_values(out)

    def prepare(self, dtype) -> _Graph:
        """The graph for raws of `dtype`, captured first if this runner has
        none yet (run does this at first use; the capture synchronizes)."""
        g = self._graphs.get(dtype)
        if g is None:
            with span("tsdr/capture"):
                g = self._graphs[dtype] = self._capture(dtype)
        return g

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
            _write_leaves(self._static, state)
        graph.instantiate()
        # one row goes in directly (run): no staging buffers
        host_raws, host_ctl = ((torch.empty(raws.shape, dtype=dtype, pin_memory=True),
                                torch.empty(ctl.shape, dtype=ctl.dtype, pin_memory=True))
                               if k > 1 else (None, None))
        return _Graph(graph, raws, ctl, outputs, packed, branches, host_raws, host_ctl,
                      torch.cuda.Event())

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


@contextlib.contextmanager
def sync_debug(mode):
    """torch.cuda.set_sync_debug_mode(mode) within ("error": a synchronizing
    operation raises), the mode before it after."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class Stage(NamedTuple):
    """One stretch of a step between two collective points. run(ctx) returns
    the values one local channel's context gains (a dict of tensors and
    tuples of tensors); then each exchange (source key, collective,
    destination key), in order, sets ctx[destination] to the collective of
    ctx[source]."""

    run: Callable
    exchanges: tuple = ()

    def exchange(self, ctxs, into: bool = False) -> None:
        """The exchanges over every channel's context; into: write each
        result into the destination's tensor (a replay's static input)."""
        for ctx in ctxs:
            for src, collective, dst in self.exchanges:
                got = collective(ctx[src])
                if into:
                    ctx[dst].copy_(got)
                else:
                    ctx[dst] = got


class GraphStages:
    """How StagedRunner captures and replays its stages on a card: the
    warm-up on a side stream, one CUDA graph a stage (the last inside
    graph_cond.branch_nodes), replays under set_sync_debug_mode("error") and
    the exchanges outside it. A test hands the runner another object with
    these members (sync_debug, warm_up, capture) to follow the runner's
    data flow on the CPU."""

    def __init__(self, device):
        self.device = device
        self.sync_debug = sync_debug

    @contextlib.contextmanager
    def warm_up(self):
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            yield
        main.wait_stream(side)

    def capture(self, fn, nodes: bool):
        """fn() captured into a graph: (_StageGraph, what fn returned)."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with (graph_cond.branch_nodes(self.device) if nodes else
              contextlib.nullcontext()) as branches, \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn()
        graph.instantiate()
        return _StageGraph(graph, branches), out


class _StageGraph(NamedTuple):
    """A stage's graph and its branch nodes (None without: their bodies'
    memory pool lives as long as the graph)."""

    graph: torch.cuda.CUDAGraph
    branches: graph_cond.Branches | None

    def replay(self) -> None:
        self.graph.replay()

    def census(self) -> dict:
        bodies = self.branches.bodies if self.branches is not None else []
        return graph_cond.census(self.graph.raw_cuda_graph(), bodies)


class _Staged(NamedTuple):
    """One capture of a staged program: a graph per stage, the static raw
    block and controls, the channels' static contexts and the static
    outputs."""

    graphs: list
    raw: torch.Tensor
    ctl: StepControls
    ctxs: list
    outputs: StepOutputs


class StagedRunner:
    """A step cut into stages by its collectives (see the module docstring)
    as one callable, step(state, raw, controls) -> (state', outputs).

    The program gives: device; stages (Stage, in order); inputs(raw,
    controls) -> (raw, controls) as tensors on its device (validated);
    contexts(state, raw, controls) -> a context dict per local channel;
    outputs(contexts) -> StepOutputs of a finished call; and its own
    __call__, the eager composition of the stages, which runs on the CPU.

    On the card the first call for a raw dtype and shape runs the program
    once on a scratch copy of the state (on a side stream: the cuFFT plans,
    the kernels' libraries and the allocator's first blocks are made outside
    the graphs; its collectives give each exchange's shape), then captures
    each stage into a graph over static tensors, the last stage with its
    branches as IF nodes and the state written back into the runner's
    state. A call copies in the leaves of `state` that are not the runner's,
    the raw block and the controls, replays the stages with the exchanges
    between them, and returns the runner's state (as the JAX step donates
    its own) and a device-side copy of the outputs (the caller's across
    calls). Every replay runs under set_sync_debug_mode("error"); a failed
    capture or replay raises, and nothing falls back to the eager step.
    Every rank of the mesh calls it together, as the program's own step."""

    def __init__(self, program, stages=None):
        self.program, self.device = program, program.device
        if stages is None and self.device.type == "cuda":
            stages = GraphStages(self.device)
        self.stages = stages
        self._staged: dict = {}  # (raw dtype, raw shape) -> _Staged
        self._static: StreamState | None = None

    def __call__(self, state: StreamState, raw, controls: StepControls = StepControls()):
        prog = self.program
        if self.stages is None:
            return prog(state, raw, controls)
        raw, ctl = prog.inputs(raw, controls)
        key = (raw.dtype, tuple(raw.shape))
        s = self._staged.get(key)
        if s is None:
            with span("tsdr/capture"):
                s = self._staged[key] = self._capture(state, raw, ctl)
        _copy_in(self._static, state)
        debug = self.stages.sync_debug
        with debug("error"):
            s.raw.copy_(raw)
            for dst, src in zip(s.ctl, ctl):
                dst.copy_(src)
        for graph, stage in zip(s.graphs, prog.stages):
            with debug("error"):
                graph.replay()
            with debug("default"):
                stage.exchange(s.ctxs, into=True)
        with debug("error"):
            outputs = StepOutputs(*(x.clone() for x in s.outputs))
        return self._static, outputs

    def _capture(self, state: StreamState, raw, ctl) -> _Staged:
        prog, stages = self.program, self.stages
        if self._static is None:
            self._static = type(state)(*_map_leaves(state, lambda x: x.to(self.device,
                                                                          copy=True)))
        raw_s = torch.zeros_like(raw)
        ctl_s = StepControls(*(torch.zeros_like(v) for v in ctl))
        with stages.warm_up():
            scratch = type(state)(*_map_leaves(self._static, torch.clone))
            warm = prog.contexts(scratch, raw_s, ctl_s)
            for stage in prog.stages:
                for ctx in warm:
                    ctx.update(stage.run(ctx))
                stage.exchange(warm)
        ctxs = prog.contexts(self._static, raw_s, ctl_s)
        graphs, outputs = [], None
        for i, stage in enumerate(prog.stages):
            last = i == len(prog.stages) - 1

            def body(stage=stage, last=last):
                new = [stage.run(ctx) for ctx in ctxs]
                if not last:
                    return new, None
                for ctx, got in zip(ctxs, new):
                    _write_leaves(ctx["state"], got["new_state"])
                return new, prog.outputs(new)

            graph, (new, outputs) = stages.capture(body, nodes=last)
            graphs.append(graph)
            for ctx, got in zip(ctxs, new):
                ctx.update(got)
            for c, ctx in enumerate(ctxs):
                for _, _, dst in stage.exchanges:
                    ctx[dst] = torch.zeros_like(warm[c][dst])
        return _Staged(graphs, raw_s, ctl_s, ctxs, outputs)

    def census(self, dtype=torch.uint8) -> list:
        """Per stage, the node counts of the graphs captured for raws of
        `dtype` (graph_cond.census: parent, IF and body nodes)."""
        s = next(v for (d, _), v in self._staged.items() if d == dtype)
        return [g.census() for g in s.graphs]


def _rows(raws, n_rows: int, what: str) -> list:
    """A runner's raws as its n_rows rows, tensors over the caller's memory
    (no copy): a list of 1-D blocks as it is, an array or tensor [n_rows,
    2n] by its leading axis. Any other shape raises, the shape of a list
    named as its stack's."""
    if isinstance(raws, list):
        if any(np.shape(row) != np.shape(raws[0]) for row in raws):
            raise ValueError("all input arrays must have the same shape")
        shape = (len(raws), *np.shape(raws[0])) if raws else (0,)
    else:
        raws = raws if isinstance(raws, torch.Tensor) else np.asarray(raws)
        shape = tuple(raws.shape)
    if len(shape) != 2 or shape[0] != n_rows:
        raise ValueError(f"{shape} {what}, the runner takes [{n_rows}, 2n]")
    return [row if isinstance(row, torch.Tensor) else torch.as_tensor(np.asarray(row))
            for row in raws]


def _stage(rows, hosts, dsts) -> bool:
    """rows[i] into dsts[i]: a row on the card copied there directly, any
    other first copied into hosts[i] (a pinned buffer on the card) by
    np.copyto on this thread, then its copy into dsts[i] queued at once,
    non-blocking, so its DMA runs while the host copies the next row.
    Returns whether a row went through hosts."""
    staged = False
    for row, host, dst in zip(rows, hosts, dsts):
        if not row.is_cuda:
            np.copyto(host.numpy(), row.numpy())
            row, staged = host, True
        dst.copy_(row, non_blocking=True)
    return staged


def _write_leaves(dst: StreamState, src: StreamState) -> None:
    """Every leaf of src copied into dst's, where the two are not one tensor."""
    for d, s in zip(state_leaves(dst), state_leaves(src)):
        if s is not d:
            d.copy_(s)


def _copy_in(static: StreamState, state: StreamState) -> None:
    """A caller's state into a runner's static one (its own leaves stay)."""
    if not state_compatible(state, static):
        raise ValueError("the state does not match this runner's geometry and params")
    _write_leaves(static, state)


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
