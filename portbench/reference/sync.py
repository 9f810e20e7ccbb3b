"""The blanking-strip sync search and the frame-rate PLL, after the reference
TempestSDR's syncdetector.c (findbestfit :26-58, findthesweetspot :71-119,
frameratepll :133-153) and its circular Gaussian blur (gaussian.c:14-57).

A frozen copy of the receiver's plain math for these steps, in float64 as
the reference's double math runs, one profile at a time: the tracked strip
centre is an integer, and every integer here has to come out as the
receiver's, so the operation order (and the fused multiply-add of the
centre's blend) is kept."""

from __future__ import annotations

import math

import numpy as np
import torch

LOWPASS_HEIGHT = 0.1  # syncdetector.c:15
LOWPASS_WIDTH = 0.9  # syncdetector.c:16
PLL_SPEED_HI = 1e-5  # syncdetector.c:18
PLL_SPEED_LO = 1e-6  # syncdetector.c:19
PLL_LOCKED = 0.5  # syncdetector.c:20


def _coeffs():
    cs = [math.exp(-2.0 * i * i / 25.0) for i in (-2, -1, 0, 1, 2)]
    norm = sum(cs)
    return [c / norm for c in cs]


def blur(profile: torch.Tensor) -> torch.Tensor:
    """Circular 5-tap Gaussian (a = 1, N = 5), summed from the leftmost tap."""
    out = torch.zeros_like(profile)
    for k, c in zip((-2, -1, 0, 1, 2), _coeffs()):
        out = out + c * torch.roll(profile, -k, dims=-1)
    return out


_DEKKER = 134217729.0  # 2^27 + 1


def _split(v):
    t = v * _DEKKER
    hi = t - (t - v)
    return hi, v - hi


def _fma(x, c, y):
    """x*c + y rounded once (error-compensated in float64), as the
    receiver's compiled blend contracts it."""
    p = x * c
    (xh, xl), (ch, cl) = _split(x), _split(c)
    p_err = ((xh * ch - p) + xh * cl + xl * ch) + xl * cl
    s = p + y
    b = s - p
    s_err = (p - (s - b)) + (y - b)
    return s + (s_err + p_err)


def sweet_spot(state: tuple, data: torch.Tensor, minsize: int, coeff: float):
    """One detection round on a float64 profile. state = (stripsize, dx, vx)
    as Python ints; returns the new state."""
    stripsize, dx, vx = state
    n = data.shape[0]
    dev = data.device
    data = blur(data)
    total = data.sum(dtype=torch.float64)
    minsize = max(int(minsize), 1)
    curr = min(max(stripsize, minsize), n >> 1)
    cand = [curr, curr - 4, curr + 4, curr >> 1, curr << 1]
    valid = [i == 0 or (minsize <= c < n >> 1 and c != curr) for i, c in enumerate(cand)]
    safe = torch.tensor([c if v else curr for c, v in zip(cand, valid)], dtype=torch.int64,
                        device=dev)
    zero = torch.zeros(1, dtype=torch.float64, device=dev)
    csum = torch.cat([zero, torch.cumsum(torch.cat([data, data]), 0, dtype=torch.float64)])
    lo = csum[:n]
    idx = safe[:, None] + torch.arange(n, device=dev)
    w = csum[idx] - lo[None, :]
    s = safe.to(torch.float64)[:, None]
    m = (total - w) / (torch.full((), float(n), dtype=torch.float64, device=dev) - s) - w / s
    m = m * m
    j = torch.argmax(m, dim=1).tolist()
    fits = m.amax(dim=1).tolist()
    best, best_fit = 0, -math.inf
    for i in range(5):  # first maximum wins
        if valid[i] and fits[i] > best_fit:
            best, best_fit = i, fits[i]
    start = max(j[best] - 1, 0)  # the reference's id-off-by-one (:46-56)
    size = int(safe[best])
    # IIR centre tracking with wraparound (:101-118)
    h2 = n // 2
    dxnl = (start + size // 2) % n
    raw = dxnl - dx
    dx0 = dx + n if raw > h2 else dx
    if raw < -h2:
        dxnl += n
    blended = _fma(np.float64(dxnl), np.float64(coeff), (1.0 - np.float64(coeff)) * np.float64(dx0))
    dx1 = int(np.round(blended)) % n
    rv = dx1 - dx0
    vx1 = n - rv if rv > h2 else (-n - rv if rv < -h2 else rv)
    return (size, dx1, vx1)


def pll(state: tuple, vx: int, enabled: bool, max_delta: float):
    """(avg_speed float64, locked bool, refresh_delta float32) -> the same,
    from the horizontal velocity vx."""
    avg_speed, _locked, delta = state
    avg = np.float64(avg_speed) * 0.99 + 0.01 * np.float64(vx)
    locked = bool(-PLL_LOCKED < avg < PLL_LOCKED)
    if not enabled:
        return (avg, locked, np.float32(delta))
    diff = avg * PLL_SPEED_LO if locked else np.float64(vx) * PLL_SPEED_HI
    if vx == 0:
        diff = np.float64(0.0)
    new = np.float32(np.float32(delta) - np.float32(diff))
    lim = np.float32(max_delta)
    return (avg, locked, np.float32(min(max(new, -lim), lim)))
