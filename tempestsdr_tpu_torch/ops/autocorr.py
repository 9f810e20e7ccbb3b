"""FFT-based autocorrelation, the reference's spectral pipeline.

R = IFFT(|FFT(x)|) — the spectrum magnitude, not the power
(TempestSDR/src/fft.c:49-64, :34-45); the reference's 1/N forward scaling
with an unnormalized inverse nets out to numpy-convention ifft(abs(fft(x))).
A plain op in complex64 through torch.fft (cuFFT on the card, pocketfft on
the CPU); the JAX package computes it outside any Pallas kernel too.
"""

from __future__ import annotations

import torch


def autocorrelation_magnitude(x: torch.Tensor) -> torch.Tensor:
    """x: f32[..., n] (n a power of two) -> |R(j)| f32[..., n], one FFT
    plan over the leading axes."""
    spec = torch.fft.fft(x.to(torch.complex64))
    r = torch.fft.ifft(spec.abs().to(torch.complex64))
    return r.abs().to(torch.float32)


def accumulate_running_mean(avg: torch.Tensor, new: torch.Tensor, calls) -> torch.Tensor:
    """Running average across estimation rounds (frameratedetector.c:44-61):
    calls == 0 overwrites, else avg' = (avg*(calls-1) + new)/calls (f32).
    avg and new [..., L], calls a number or [...]."""
    calls = torch.as_tensor(calls, dtype=torch.float32, device=avg.device)[..., None]
    blended = (avg * (calls - 1.0) + new) / torch.clamp(calls, min=1.0)
    return torch.where(calls == 0, new, blended).to(torch.float32)
