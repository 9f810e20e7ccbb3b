"""Streaming windowed-sinc FIR low-pass, the optional anti-alias stage
before the resampler (Params.fir_lowpass_taps; the reference has none).

The block convolution carries ntaps - 1 tail samples across blocks
(overlap-save). It is one F.conv1d with VALID padding, as the JAX package
leaves it to one lax.conv: a library convolution, not a kernel of this
repository. The package turns TF32 off on import, so the convolution runs
in full float32 on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def design_lowpass_fir(ntaps: int, cutoff_norm: float) -> np.ndarray:
    """Hamming-windowed sinc, cutoff_norm = f_c / (fs/2) in (0, 1)."""
    if ntaps % 2 == 0:
        raise ValueError("ntaps must be odd")
    m = np.arange(ntaps) - (ntaps - 1) / 2
    h = np.sinc(cutoff_norm * m) * cutoff_norm
    h *= np.hamming(ntaps)
    h /= h.sum()
    return h.astype(np.float32)


def fir_apply_block(x: torch.Tensor, tail: torch.Tensor, taps: torch.Tensor):
    """Causal streaming FIR over one block.

    x: f32[n] new samples; tail: f32[ntaps-1] previous samples; taps: f32[ntaps].
    Returns (y f32[n], new_tail f32[ntaps-1]) with
    y[i] = sum_k taps[k] * xc[i + ntaps-1 - k], xc = concat(tail, x).
    """
    ntaps = taps.shape[0]
    xc = torch.cat([tail, x])
    y = F.conv1d(xc[None, None, :], taps.flip(0)[None, None, :])[0, 0]
    return y, xc[xc.shape[0] - (ntaps - 1):].clone()
