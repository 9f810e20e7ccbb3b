"""Circular 5-tap Gaussian smoothing of 1-D profiles (gaussian.c:14-57):
coefficients exp(-2*a^2*i^2/N^2), a=1, N=5, i in [-2,2], normalized — a
circular convolution with the symmetric kernel."""

from __future__ import annotations

import functools
import math

import torch

_ALPHA = 1.0
_N = 5


@functools.lru_cache(None)
def _coeffs():
    cs = [math.exp(-2.0 * _ALPHA * _ALPHA * i * i / (_N * _N)) for i in (-2, -1, 0, 1, 2)]
    norm = sum(cs)
    return tuple(c / norm for c in cs)


def gaussian_blur_circular(profile: torch.Tensor) -> torch.Tensor:
    """profile: f[..., n] -> blurred f[..., n] (circular boundary), summed
    in the JAX package's order so the result is bit-identical."""
    out = torch.zeros_like(profile)
    for k, coeff in zip((-2, -1, 0, 1, 2), _coeffs()):
        # out[j] = sum_k c_k * profile[(j+k) mod n]  (gaussian.c:52-57)
        out = out + coeff * torch.roll(profile, -k, dims=-1)
    return out
