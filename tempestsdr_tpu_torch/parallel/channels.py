"""Channel data parallelism (config 5): independent IQ channels, one per
monitored emitter, each with its own state on a leading channel axis. On
one card the channel steps of stream.pipeline run them; make_channel_step
spreads them over the mesh's 'ch' rows, one process per rank, each rank
running the hybrid channels step over its own channels. No collective
runs in steady state: the reference's independent receivers, scaled over
processes and cards instead of threads."""

from __future__ import annotations

from ..config import PipelineConfig
from ..params import Params
from ..stream.pipeline import make_channels_step_hybrid
from ..stream.state import StreamState, init_state, state_from_leaves, state_leaves


def stack_states(config: PipelineConfig, n_channels: int, fir_ntaps: int = 0,
                 device="cuda") -> StreamState:
    """Per-channel StreamState stacked on a leading channel axis. Every row
    owns its memory (a copy per row, never a broadcast view): the step
    writes the fold buffer and the ring in place through a channel's rows."""
    one = init_state(config, fir_ntaps, device)
    return state_from_leaves([
        x.unsqueeze(0).repeat((n_channels,) + (1,) * x.dim()) for x in state_leaves(one)])


def make_channel_step(config: PipelineConfig, params: Params, mesh, n_channels: int = None, *,
                      cond_mode: str = "unrolled", device=None):
    """This rank's part of the channel step sharded over the mesh's 'ch'
    axis: the device channel step (stream.pipeline.make_channels_step_hybrid,
    no host read inside a block, cond_mode passed through) over
    n_channels // C local channels, the channels
    [row * per_rank, (row + 1) * per_rank) of its row (mesh.ch_index; the
    ranks of one row run the same channels). It takes that block of the
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
    return make_channels_step_hybrid(config, params, n_channels // n_dev, cond_mode=cond_mode,
                                     device=mesh.device if device is None else device)
