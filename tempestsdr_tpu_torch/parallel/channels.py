"""Stacked per-channel state for the multi-channel steps (config 5)."""

from __future__ import annotations

from ..config import PipelineConfig
from ..stream.state import StreamState, init_state, state_from_leaves, state_leaves


def stack_states(config: PipelineConfig, n_channels: int, fir_ntaps: int = 0,
                 device="cuda") -> StreamState:
    """Per-channel StreamState stacked on a leading channel axis. Every row
    owns its memory (a copy per row, never a broadcast view): the step
    writes the fold buffer and the ring in place through a channel's rows."""
    one = init_state(config, fir_ntaps, device)
    return state_from_leaves([
        x.unsqueeze(0).repeat((n_channels,) + (1,) * x.dim()) for x in state_leaves(one)])
