"""Per-frame post-processing primitives (TempestSDR/src/dsp.c):
time_lowpass <- dsp_timelowpass_run (:22-33), autogain_run <-
dsp_autogain_run (:41-94), collapse_v_h <- dsp_average_v_h (:96-110)."""

from __future__ import annotations

import torch

SPECIAL_THRESHOLD = 250.0  # dsp.c:57 — values beyond this are debug markers


def _f32(v: float, device) -> torch.Tensor:
    """A 0-d float32 constant made on `device` by a fill, not a host copy
    (a host -> device copy cannot be captured into a CUDA graph)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def time_lowpass(screenbuffer: torch.Tensor, frame: torch.Tensor, motionblur) -> torch.Tensor:
    """IIR frame averaging (dsp.c:22-33): screen*mb + frame*(1-mb), f32.
    frame [..., H, W], motionblur a number or [...]."""
    mb = torch.as_tensor(motionblur, dtype=torch.float32, device=frame.device)[..., None, None]
    return screenbuffer * mb + frame * (1.0 - mb)


def autogain_run(frame: torch.Tensor, lastmin, lastmax, norm: float = 0.1,
                 stats_only: bool = False):
    """Dynamic-range normalization with IIR min/max tracking (dsp.c:41-94).

    frame [..., H, W] with lastmin/lastmax [...]: a leading axis is a stack
    of frames, each normalized on its own. Returns (normalized or None,
    lastmin', lastmax', snr), all f32.
    Special pixels (|v| > 250) pass through unscaled and are left out of
    min/max — except element 0, which seeds min=max like the reference
    (dsp.c:50-59). SNR quirk kept: the mean's sum skips specials but divides
    by the full size (:60-68), the variance sums run over every pixel
    (:72-88)."""
    f = frame
    hw = (-2, -1)
    flat0 = f[..., 0, 0]
    special = (f > SPECIAL_THRESHOLD) | (f < -SPECIAL_THRESHOLD)
    big = _f32(3.4e38, f.device)
    cur_min = torch.minimum(torch.where(special, big, f).amin(dim=hw), flat0)
    cur_max = torch.maximum(torch.where(special, -big, f).amax(dim=hw), flat0)

    one_minus = _f32(1.0 - norm, f.device)
    norm_t = _f32(norm, f.device)
    lastmax2 = one_minus * lastmax + norm_t * cur_max
    lastmin2 = one_minus * lastmin + norm_t * cur_min
    span = torch.where(lastmax2 == lastmin2, torch.ones_like(lastmax2), lastmax2 - lastmin2)

    out = None if stats_only else torch.where(
        special, f, (f - lastmin2[..., None, None]) / span[..., None, None])

    n = f.shape[-2] * f.shape[-1]
    mean = torch.where(special, torch.zeros_like(f), f).sum(dim=hw, dtype=torch.float32) / n
    d = f - mean[..., None, None]
    sum2 = (d * d).sum(dim=hw, dtype=torch.float32)
    sum3 = d.sum(dim=hw, dtype=torch.float32)
    var = (sum2 - sum3 * sum3 / n) / (n - 1)
    snr = mean / torch.sqrt(torch.clamp(var, min=1e-30))
    return out, lastmin2, lastmax2, snr


def collapse_v_h(frame: torch.Tensor, precise: bool = True, widen: bool = True):
    """Column and row sums of an (..., H, W) frame (dsp.c:96-110) ->
    (width_profile [..., W], height_profile [..., H]). precise=True
    accumulates in f64; widen=True returns f64 profiles for the double-math
    sync search."""
    dt = torch.float64 if precise else torch.float32
    out = torch.float64 if widen else dt
    wprof = frame.sum(dim=-2, dtype=dt).to(out)
    hprof = frame.sum(dim=-1, dtype=dt).to(out)
    return wprof, hprof
