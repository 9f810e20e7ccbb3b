"""Blanking-strip sync detection and the frame-rate PLL
(TempestSDR/src/syncdetector.c), the counterpart of tempestsdr_tpu.ops.sync.

find_best_fit <- findbestfit (:26-58) with the reference's id-lags-window-
by-one quirk; find_the_sweet_spot <- findthesweetspot (:71-119): blur, probe
strip sizes {curr, curr-4, curr+4, curr/2, curr*2}, first-wins argmax, IIR
centre tracking with wraparound (round half to even, as torch.round does);
framerate_pll <- frameratepll (:133-153) with a clamp to the static PLL
headroom; find_the_sweet_spot_pair, both axes in one batched search (a
reference form, on no step path). Profile math follows the profile's dtype: f64 by default, f32
under Params.fast_sync, where each window sum and the total are rounded once
to f32 from a sum accumulated in f64 (_doubled_cumsum), a deliberate
departure from the JAX package's f32 running sum.

Everything stays on the profile's device: the per-candidate window sums are
one gather of the doubled cumsum at device-side offsets, and the winner is
taken with torch.take, so the search needs no host round trip and can be
captured into a CUDA graph.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .gaussian import gaussian_blur_circular

FRAMERATE_DX_LOWPASS_COEFF_HEIGHT = 0.1  # syncdetector.c:15
FRAMERATE_DX_LOWPASS_COEFF_WIDTH = 0.9  # syncdetector.c:16
FRAMERATE_PLL_SPEED_HI = 1e-5  # syncdetector.c:18
FRAMERATE_PLL_SPEED_LO = 1e-6  # syncdetector.c:19
FRAMERATE_PLL_LOCKED_VALUE = 0.5  # syncdetector.c:20


class SweetspotState(NamedTuple):
    """Per-axis detector carry (syncdetector.h sweetspot_data_t), all i32."""

    stripsize: torch.Tensor
    dx: torch.Tensor
    vx: torch.Tensor

    @staticmethod
    def init(device="cuda") -> "SweetspotState":
        device = resolve_device(device)
        return SweetspotState(*(torch.zeros((), dtype=torch.int32, device=device)
                                for _ in range(3)))


class PLLState(NamedTuple):
    """Frame-rate PLL carry (syncdetector.h syncdetector_t)."""

    avg_speed: torch.Tensor  # f64
    locked: torch.Tensor  # bool
    refresh_delta: torch.Tensor  # f32 — offset vs nominal refreshrate

    @staticmethod
    def init(device="cuda") -> "PLLState":
        device = resolve_device(device)
        return PLLState(
            torch.zeros((), dtype=torch.float64, device=device),
            torch.zeros((), dtype=torch.bool, device=device),
            torch.zeros((), dtype=torch.float32, device=device),
        )


def _doubled_cumsum(data: torch.Tensor) -> torch.Tensor:
    """[..., n] -> [..., 2n + 1] f64: 0, then the running sum of data twice.
    Always accumulated in f64: an f32 profile's window sums (differences of
    this sum) are rounded to f32 once, after the subtraction. Taken from an
    f32 running sum 2n long, they lose their low bits (at 3397 columns its
    rounding, 0.25, exceeds the gap between neighbouring strips' metrics),
    and the winning strip is then decided by rounding, which differs with
    the order of the additions (a card's against the CPU's). This departs
    on purpose from the JAX package's fast_sync, which differences an f32
    running sum: the two can pick different strips at a near-tie, and the
    port's pick is the f64 search's at least as often
    (tests/test_torch_ops.py::test_fast_sync_at_flagship_width_against_jax)."""
    zero = torch.zeros(data.shape[:-1] + (1,), dtype=torch.float64, device=data.device)
    return torch.cat([zero, torch.cumsum(torch.cat([data, data], dim=-1), -1,
                                         dtype=torch.float64)], dim=-1)


def find_best_fit(data: torch.Tensor, totalsum, stripsize):
    """Best circular strip of width `stripsize` (syncdetector.c:26-58).
    Returns (bestfit, bestid i32); the winning window start j maps to id
    max(j-1, 0) like the reference."""
    n = data.shape[0]
    csum = _doubled_cumsum(data)
    s = int(stripsize)
    w = (csum[s:s + n] - csum[:n]).to(data.dtype)
    m = (totalsum - w) / (float(n) - s) - w / s
    m = m * m
    j = torch.argmax(m).to(torch.int32)
    return m.max(), torch.clamp(j - 1, min=0)


def _candidate_sizes(state: SweetspotState, n: int, minsize: int):
    """Probe set {curr, curr-4, curr+4, curr>>1, curr<<1} in probe order
    (syncdetector.c:88-93): (safe sizes i32[..., 5], valid bool[..., 5])."""
    minsize = max(int(minsize), 1)
    size2 = n >> 1
    curr = torch.clamp(state.stripsize, minsize, size2)
    cand = torch.stack([curr, curr - 4, curr + 4, curr >> 1, curr << 1], dim=-1).to(torch.int32)
    # the base size is always evaluated (an OR, not valid[0] = True: a
    # Python value written into a card tensor is a host -> device copy)
    first = torch.arange(5, device=cand.device) == 0
    curr = curr[..., None]
    valid = (cand >= minsize) & (cand < size2) & (cand != curr) | first
    safe = torch.where(valid, cand, curr)
    return safe, valid


_DEKKER = 134217729.0  # 2^27 + 1: splits an f64 into two halves of 26 bits


def _split(v: torch.Tensor):
    t = v * _DEKKER
    hi = t - (t - v)
    return hi, v - hi


def _fused_blend(x: torch.Tensor, c: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x*c + y as the JAX step's compiled blend computes it: XLA contracts
    the product and the sum into one fused multiply-add, and a blend that
    lands on a half rounds the other way when rounded twice (the round to
    pixels then moves the tracked centre by one). x holds integers below
    2^24. In f32 the product and the sum are exact in f64, so one rounding
    back to f32 is the fused one. In f64 the result is error-compensated:
    the product's error (Dekker's split) and the sum's (TwoSum) are added
    back, their own sum rounded before the last rounding, so it equals the
    fused result on the grid that
    tests/test_torch_ops.py::test_iir_track_rounds_as_the_compiled_jax_step
    holds, not provably everywhere."""
    if x.dtype == torch.float32:
        return (x.double() * c.double() + y.double()).float()
    p = x * c
    (xh, xl), (ch, cl) = _split(x), _split(c)
    p_err = ((xh * ch - p) + xh * cl + xl * ch) + xl * cl
    s = p + y
    b = s - p
    s_err = (p - (s - b)) + (y - b)
    return s + (s_err + p_err)


def _iir_track(state: SweetspotState, beststripsize, beststripstart, n: int,
               lowpasscoeff: float, dt=torch.float64) -> SweetspotState:
    """IIR strip-centre tracking with wraparound + wrap-corrected velocity
    (syncdetector.c:101-118); the blend rounded as one fused multiply-add
    (_fused_blend)."""
    h2 = n // 2
    dxnl = torch.remainder(beststripstart + torch.div(beststripsize, 2, rounding_mode="floor"), n)
    rawdiff = dxnl - state.dx
    dx0 = torch.where(rawdiff > h2, state.dx + n, state.dx)
    dxnl = torch.where(rawdiff < -h2, dxnl + n, dxnl)
    lastx = dx0
    c = torch.full((), lowpasscoeff, dtype=dt, device=dxnl.device)
    one = torch.full((), 1.0, dtype=dt, device=dxnl.device)
    dx1 = torch.remainder(
        torch.round(_fused_blend(dxnl.to(dt), c, (one - c) * dx0.to(dt))).to(torch.int64), n
    ).to(torch.int32)
    rawvx = dx1 - lastx
    vx = torch.where(
        rawvx > h2, n - rawvx, torch.where(rawvx < -h2, -n - rawvx, rawvx)
    ).to(torch.int32)
    return SweetspotState(beststripsize.to(torch.int32), dx1, vx)


def find_the_sweet_spot(state: SweetspotState, data: torch.Tensor, minsize: int,
                        lowpasscoeff: float):
    """One detection round on a collapsed profile (syncdetector.c:71-119).
    data [..., n] with a state of [...] leaves: a leading axis is a stack of
    independent searches. Returns (state', blurred_profile, strip_start i32)."""
    n = data.shape[-1]
    data = gaussian_blur_circular(data)
    dt = data.dtype
    totalsum = data.sum(dim=-1, dtype=torch.float64).to(dt)
    safe, valid = _candidate_sizes(state, n, minsize)

    csum = _doubled_cumsum(data)
    lo = csum[..., :n]
    idx = safe.to(torch.int64)[..., None] + torch.arange(n, device=data.device)  # [..., 5, n]
    hi = torch.gather(csum[..., None, :].expand(idx.shape[:-1] + csum.shape[-1:]), -1, idx)
    w = (hi - lo[..., None, :]).to(dt)
    s = safe.to(dt)[..., None]
    m = ((totalsum[..., None, None] - w)
         / (torch.full((), float(n), dtype=dt, device=data.device) - s) - w / s)
    m = m * m
    j = torch.argmax(m, dim=-1).to(torch.int32)  # first maximum: first-wins
    neg_inf = torch.full((), float("-inf"), dtype=dt, device=data.device)
    fits = torch.where(valid, m.amax(dim=-1), neg_inf)
    ids = torch.clamp(j - 1, min=0)  # the reference's id-off-by-one (:46-56)
    # gathered at the winner, not ids[win]: indexing by a 0-d tensor reads
    # it on the host
    win = torch.argmax(fits, dim=-1, keepdim=True)
    beststripstart = torch.take_along_dim(ids, win, dim=-1).squeeze(-1)
    beststripsize = torch.take_along_dim(safe, win, dim=-1).squeeze(-1)
    state = _iir_track(state, beststripsize, beststripstart, n, lowpasscoeff, dt=dt)
    return state, data, beststripstart


def find_the_sweet_spot_pair(state_x: SweetspotState, data_x: torch.Tensor, minsize_x: int,
                             coeff_x: float, state_y: SweetspotState, data_y: torch.Tensor,
                             minsize_y: int, coeff_y: float):
    """Both axes' detection rounds (syncdetector.c:176-186) as one batched
    search: one doubled cumsum over a zero-padded (2, 2L) f64 matrix, the
    ten candidates' window sums, one metric and masked argmax over (10, L).
    The same candidate math as find_the_sweet_spot; only the f64 summation
    order of the padded cumsum can differ, which can flip a strict near-tie.
    A reference form: the JAX package records it as a measured negative
    result, and no step takes it.
    Returns (state_x', state_y', (blur_x, blur_y), (start_x, start_y))."""
    nx, ny = data_x.shape[0], data_y.shape[0]
    L = max(nx, ny)
    dev, f64 = data_x.device, torch.float64
    bx, by = gaussian_blur_circular(data_x), gaussian_blur_circular(data_y)
    tx, ty = bx.sum(), by.sum()
    safe_x, valid_x = _candidate_sizes(state_x, nx, minsize_x)
    safe_y, valid_y = _candidate_sizes(state_y, ny, minsize_y)

    rows = torch.zeros((2, 2 * L), dtype=f64, device=dev)
    rows[0, :2 * nx] = torch.cat([bx, bx])
    rows[1, :2 * ny] = torch.cat([by, by])
    csum = torch.cat([torch.zeros((2, 1), dtype=f64, device=dev), torch.cumsum(rows, dim=1)], dim=1)
    # candidate sizes are < n/2 <= L, so every length-L run stays in bounds;
    # columns past a row's n are masked below
    span = torch.arange(L, device=dev)[None, :]
    hi = torch.cat([csum[0][safe_x.to(torch.int64)[:, None] + span],
                    csum[1][safe_y.to(torch.int64)[:, None] + span]])
    w = hi - csum[:, :L].repeat_interleave(5, dim=0)
    s = torch.cat([safe_x, safe_y]).to(f64)[:, None]
    n_row = torch.cat([torch.full((5,), float(nx), dtype=f64, device=dev),
                       torch.full((5,), float(ny), dtype=f64, device=dev)])[:, None]
    t_row = torch.cat([tx.expand(5), ty.expand(5)]).to(f64)[:, None]
    m = (t_row - w) / (n_row - s) - w / s
    m = m * m
    m = torch.where(span < n_row, m, torch.full_like(m, float("-inf")))
    j = torch.argmax(m, dim=1).to(torch.int32)
    fits = torch.where(torch.cat([valid_x, valid_y]), m.max(dim=1).values,
                       torch.full((10,), float("-inf"), dtype=f64, device=dev))
    ids = torch.clamp(j - 1, min=0)  # the reference's id-off-by-one (:46-56)
    win_x, win_y = torch.argmax(fits[:5]), torch.argmax(fits[5:])
    start_x, start_y = torch.take(ids, win_x), torch.take(ids, 5 + win_y)
    sx = _iir_track(state_x, torch.take(safe_x, win_x), start_x, nx, coeff_x)
    sy = _iir_track(state_y, torch.take(safe_y, win_y), start_y, ny, coeff_y)
    return sx, sy, (bx, by), (start_x, start_y)


def framerate_pll(pll: PLLState, vx, *, enabled: bool, max_delta: float | None = None) -> PLLState:
    """PLL update from the horizontal-axis velocity (syncdetector.c:133-153),
    with |refresh_delta| clamped to the static headroom max_delta (Hz)."""
    vx64 = vx.to(torch.float64)
    avg = pll.avg_speed * 0.99 + 0.01 * vx64
    locked = (avg < FRAMERATE_PLL_LOCKED_VALUE) & (avg > -FRAMERATE_PLL_LOCKED_VALUE)
    if not enabled:
        return PLLState(avg, locked, pll.refresh_delta)
    diff = torch.where(locked, avg * FRAMERATE_PLL_SPEED_LO, vx64 * FRAMERATE_PLL_SPEED_HI)
    diff = torch.where(vx == 0, torch.zeros_like(diff), diff)
    delta = pll.refresh_delta - diff.to(torch.float32)
    if max_delta is not None:
        lim = float(np.float32(max_delta))
        delta = torch.clamp(delta, -lim, lim)
    return PLLState(avg, locked, delta)
