"""StreamState — every piece of cross-block state of the streaming step, as
a NamedTuple of tensors with the same leaf order, shapes and dtypes as
tempestsdr_tpu.stream.state (so a JAX checkpoint's flat leaves load here):
resampler phase and tail, sync-shift skip, fold fill and buffer, motion-blur
screen, autogain bounds, sync and PLL carries, autocorrelation ring and
averages.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import resolve_device
from ..ops.sync import PLLState, SweetspotState


class StreamState(NamedTuple):
    phase_fix: torch.Tensor  # i64 — fixed-point resampler phase
    tail: torch.Tensor  # f32[taps] — previous block's last envelope samples
    fir_tail: torch.Tensor  # f32[max(fir_ntaps-1,1)] — FIR carry (unused here)
    skip_pixels: torch.Tensor  # i32 — manual-sync pixel skip (mod frame)
    fill: torch.Tensor  # i32 — write position within the current frame
    framebuf: torch.Tensor  # f32[framebuf_len(config)]
    screenbuffer: torch.Tensor  # f32[H, W] — motion-blur IIR state
    ag_min: torch.Tensor  # f32
    ag_max: torch.Tensor  # f32
    ag_snr: torch.Tensor  # f32
    sync_x: SweetspotState
    sync_y: SweetspotState
    pll: PLLState
    runs: torch.Tensor  # i32 — autogain report cadence
    frame_count: torch.Tensor  # i64
    ac_buf: torch.Tensor  # f32[ac_round + block]
    ac_fill: torch.Tensor  # i32
    ac_avg_frame: torch.Tensor  # f32[frame_window]
    ac_avg_line: torch.Tensor  # f32[line_window]
    ac_calls: torch.Tensor  # i32
    ac_last_full: torch.Tensor  # f32[ac_fft//2] — latest round's raw |R(j)|


class StepOutputs(NamedTuple):
    frame: torch.Tensor  # f32[H, W] (K == 1) or f32[K, H, W]
    frame_valid: torch.Tensor  # bool, or bool[K] for K > 1
    n_pixels: torch.Tensor  # i32
    refreshrate: torch.Tensor  # f32 — nominal + PLL delta
    pll_locked: torch.Tensor  # bool
    ag_min: torch.Tensor  # f32
    ag_max: torch.Tensor  # f32
    ag_snr: torch.Tensor  # f32
    sync_dx: torch.Tensor  # i32
    sync_dy: torch.Tensor  # i32
    ac_frame_plot: torch.Tensor  # f32[frame_window]
    ac_line_plot: torch.Tensor  # f32[line_window]
    ac_plot_valid: torch.Tensor  # bool
    ac_calls: torch.Tensor  # i32


def framebuf_len(config: PipelineConfig) -> int:
    """Fold-buffer length: frame + one block's pixels for K == 1; also the
    multi-emit leftover read at emitted*fp for K > 1, i.e. (K+1)*fp."""
    fp, mp = config.frame_pixels, config.max_block_pixels
    k = config.frames_per_block
    return fp + mp if k == 1 else max(fp + mp, (k + 1) * fp)


def init_state(config: PipelineConfig, fir_ntaps: int = 0, device="cuda") -> StreamState:
    device = resolve_device(device)
    h, w = config.height, config.width
    fw = config.ac_frame_window[1] if config.autocorr else 1
    lw = config.ac_line_window[1] if config.autocorr else 1
    ac_cap = (config.ac_round_samples + config.block_samples) if config.autocorr else 1

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return StreamState(
        phase_fix=z((), torch.int64),
        tail=z((config.resample_taps,), torch.float32),
        fir_tail=z((max(fir_ntaps - 1, 1),), torch.float32),
        skip_pixels=z((), torch.int32),
        fill=z((), torch.int32),
        framebuf=z((framebuf_len(config),), torch.float32),
        screenbuffer=z((h, w), torch.float32),
        ag_min=z((), torch.float32),
        ag_max=z((), torch.float32),
        ag_snr=torch.ones((), dtype=torch.float32, device=device),
        sync_x=SweetspotState.init(device),
        sync_y=SweetspotState.init(device),
        pll=PLLState.init(device),
        runs=z((), torch.int32),
        frame_count=z((), torch.int64),
        ac_buf=z((ac_cap,), torch.float32),
        ac_fill=z((), torch.int32),
        ac_avg_frame=z((fw,), torch.float32),
        ac_avg_line=z((lw,), torch.float32),
        ac_calls=z((), torch.int32),
        ac_last_full=z((config.ac_fft_size // 2 if config.autocorr else 1,), torch.float32),
    )


def state_leaves(state: StreamState) -> list:
    """The flat leaves in the JAX tree order (nested NamedTuples inline)."""
    out = []
    for x in state:
        if isinstance(x, tuple):
            out.extend(x)
        else:
            out.append(x)
    return out


def state_from_leaves(leaves) -> StreamState:
    """Inverse of state_leaves."""
    it = iter(leaves)
    vals = []
    for name in StreamState._fields:
        if name in ("sync_x", "sync_y"):
            vals.append(SweetspotState(next(it), next(it), next(it)))
        elif name == "pll":
            vals.append(PLLState(next(it), next(it), next(it)))
        else:
            vals.append(next(it))
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over")
    return StreamState(*vals)


def state_from_numpy(leaves, device="cuda") -> StreamState:
    """A StreamState from the flat numpy leaves of a JAX StreamState — the
    arrays Session.save_state writes with np.savez, in order."""
    device = resolve_device(device)
    return state_from_leaves(
        [torch.from_numpy(np.array(x, copy=True)).to(device) for x in leaves])


def state_to_numpy(state: StreamState) -> list:
    return [x.detach().cpu().numpy() for x in state_leaves(state)]


def state_compatible(a: StreamState, b: StreamState) -> bool:
    """Same leaf shapes and dtypes — safe to carry across a rebuilt step."""
    fa, fb = state_leaves(a), state_leaves(b)
    return len(fa) == len(fb) and all(
        x.shape == y.shape and x.dtype == y.dtype for x, y in zip(fa, fb))


def reset_autocorr(state: StreamState) -> StreamState:
    """PARAM_AUTOCORR_PLOTS_RESET / retune flush
    (frameratedetector.c:97-104,197-201): clear accumulated averages."""
    return state._replace(
        ac_buf=torch.zeros_like(state.ac_buf),
        ac_fill=torch.zeros_like(state.ac_fill),
        ac_avg_frame=torch.zeros_like(state.ac_avg_frame),
        ac_avg_line=torch.zeros_like(state.ac_avg_line),
        ac_calls=torch.zeros_like(state.ac_calls),
        ac_last_full=torch.zeros_like(state.ac_last_full),
    )
