"""Channel data parallelism (config 5): independent IQ channels, one per
monitored emitter, each with its own state on a leading channel axis. On
one card the channel steps of stream.pipeline run them; make_channel_step
spreads them over the mesh's 'ch' rows, one process per rank, each rank
running the hybrid channels step over its own channels. No collective
runs in steady state: the reference's independent receivers, scaled over
processes and cards instead of threads. On the card a rank's step is one
CUDA-graph replay a block (stream.graph.ChannelRunner, the capture
MultiSession runs), its per-channel branches IF nodes."""

from __future__ import annotations

import torch

from ..config import PipelineConfig
from ..params import Params
from ..stream.graph import ChannelRunner, sync_debug
from ..stream.pipeline import StepControls, channel_controls_on
from ..stream.state import StepOutputs, StreamState, init_state, state_from_leaves, state_leaves


def stack_states(config: PipelineConfig, n_channels: int, fir_ntaps: int = 0,
                 device="cuda") -> StreamState:
    """Per-channel StreamState stacked on a leading channel axis. Every row
    owns its memory (a copy per row, never a broadcast view): the step
    writes the fold buffer and the ring in place through a channel's rows."""
    one = init_state(config, fir_ntaps, device)
    return state_from_leaves([
        x.unsqueeze(0).repeat((n_channels,) + (1,) * x.dim()) for x in state_leaves(one)])


class ChannelMeshStep:
    """One rank's channel step (make_channel_step): step(states, raws
    [per_rank, 2n], controls of per_rank values) -> (states', outputs). On
    the card one ChannelRunner replay a call, under set_sync_debug_mode
    ("error"): the state returned is the runner's (as the JAX step donates
    its own; leaves that are not the runner's are copied in), the outputs
    a device-side copy, the caller's across calls. On the CPU the eager
    channel step (`step`)."""

    def __init__(self, config: PipelineConfig, params: Params, n_channels: int, cond_mode: str,
                 device):
        self.runner = ChannelRunner(config, params, n_channels, device, cond_mode=cond_mode)
        self.step, self.device = self.runner.step, self.runner.device
        self.n_channels, self.cond_mode = n_channels, cond_mode

    def __call__(self, states: StreamState, raws, controls: StepControls = StepControls()):
        if not self.runner.graphed:
            return self.step(states, raws, controls)
        raws = torch.as_tensor(raws).to(self.device)
        ctl = self.controls(controls)
        self.runner.prepare(raws.dtype)
        with sync_debug("error"):
            states, out, _ = self.runner.run(states, raws, ctl)
            return states, StepOutputs(*(x.clone() for x in out))

    def controls(self, controls: StepControls) -> torch.Tensor:
        """The controls as the runner takes them: float64 [C, 3] on the
        device (each field exact in float64)."""
        return torch.stack([v.to(torch.float64) for v in
                            channel_controls_on(controls, self.n_channels, self.device)], dim=-1)


def make_channel_step(config: PipelineConfig, params: Params, mesh, n_channels: int = None, *,
                      cond_mode: str = "unrolled", device=None):
    """This rank's part of the channel step sharded over the mesh's 'ch'
    axis: the device channel step (stream.pipeline.make_channels_step_hybrid,
    no host read inside a block, cond_mode passed through) over
    n_channels // C local channels, the channels
    [row * per_rank, (row + 1) * per_rank) of its row (mesh.ch_index; the
    ranks of one row run the same channels), through a ChannelMeshStep (on
    the card one CUDA-graph replay a block). It takes that block of the
    stacked state, raws [per_rank, 2n] and per-channel controls.

    n_channels defaults to one per 'ch' row and must divide evenly, so every
    rank runs the same body. device: this rank's torch device (default: the
    mesh's for this rank)."""
    n_dev = mesh.shape["ch"]
    if n_channels is None:
        n_channels = n_dev
    if n_channels % n_dev:
        raise ValueError(
            f"n_channels={n_channels} must be a multiple of the mesh's "
            f"{n_dev} 'ch' devices")
    return ChannelMeshStep(config, params, n_channels // n_dev, cond_mode,
                           mesh.device if device is None else device)
