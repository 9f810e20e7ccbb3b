"""Fractional box resampling, samplerate -> pixelrate: the plain PyTorch
counterpart of tempestsdr_tpu.ops.resample — the strided (m pixels per
sample) form, the chunked form for any rate, and nearest-neighbour.

Each output pixel is the integral of the piecewise-constant envelope over
the pixel's window [a_p, a_p + inv), a_p = phase + p*inv, times the rate
(the reference's dsp_resample_process, TempestSDR/src/dsp.c:256-307). The
phase is an exact int64 fixed-point carry (FRAC_BITS fractional bits): the
carries n_out and new_phase are exact integers, with floor `//` and an
arithmetic `>>` on negative values as in the JAX package.

box_resample_strided is the plain version of kernel K1
(kernels/strided_resample.py): the same function the JAX step runs off the
TPU and the one K1 is held against on the card. It keeps the JAX form's
G-aligned windows and its float operation order so the two agree to the
last bit on the CPU; only the TPU interleave matmul became an index
reshape. box_resample_block_chunked is the plain version of kernels K3 and
K4 (kernels/chunked_resample.py) and likewise keeps the JAX form's windows
and float order; only its final reduction sums in torch's order.

The range forms (box_resample_range_strided, box_resample_range,
nn_resample_range) resample one time shard's pixels of a block, for the
time-sharded step (parallel/timeshard.py); box_resample_range_strided is
the plain version of K1's range entry. box_resample_block (dense, per-pixel
int64) and box_resample_gather_i32 are reference forms on no step path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import FRAC_BITS, PLL_HEADROOM_FRAC

_INV_SCALE = 2.0 ** (-FRAC_BITS)  # exact in f32


def _f32(v: float, device) -> torch.Tensor:
    """A 0-d float32 constant made on `device` by a fill (capturable into a
    CUDA graph, unlike a host -> device copy)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def resample_counts(phase_fix: torch.Tensor, inv_fix: torch.Tensor, n_samples: int):
    """Pixels completed this block and the next-block phase: (n_out i32,
    new_phase_fix i64), exact integer math. A far-positive phase (a
    drop-compensation skip draining) clamps n_out to 0."""
    size_fix = int(n_samples) << FRAC_BITS
    n_out64 = torch.clamp((size_fix - phase_fix) // inv_fix, min=0)
    new_phase = phase_fix + n_out64 * inv_fix - size_fix
    return n_out64.to(torch.int32), new_phase


def box_resample_block_chunked(x_ext, phase_fix, inv_fix, *, n_samples: int, max_pix: int,
                               taps: int, inv_nominal: float, chunk: int = 128):
    """Resample one block at any rate (same contract as box_resample_strided).

    Pixels go in chunks of `chunk`; the exact int64 phase gives each chunk's
    first window start, within a chunk the positions are an f32 ramp, and
    each chunk reduces the dense overlap weights against one contiguous
    G-aligned window:

        out[p] = rate * sum_j clip(min(pos_p + inv, j + 1) - max(pos_p, j), 0) * win[j]

    The weight tensor is (n_chunks, chunk, w_pad) f32: about 1 GB at the
    64 MS/s geometry, built in place to hold the peak at two of them.
    """
    dev = x_ext.device
    n_out, new_phase = resample_counts(phase_fix, inv_fix, n_samples)
    inv_f = inv_fix.to(torch.float32) * _INV_SCALE
    rate_f = _f32(float(1 << FRAC_BITS), dev) / inv_fix.to(torch.float32)

    G = 32
    n_chunks = -(-max_pix // chunk)
    w_in = int(np.ceil(chunk * inv_nominal * 1.02)) + taps + 2
    w_rows = -(-(w_in + G - 1) // G) + 1
    w_pad = w_rows * G

    c = torch.arange(n_chunks, dtype=torch.int64, device=dev)
    base = phase_fix + (c * chunk) * inv_fix
    start = (base >> FRAC_BITS).to(torch.int32)  # floor; may be -1 at block start
    frac = (base - (start.to(torch.int64) << FRAC_BITS)).to(torch.float32) * _INV_SCALE

    n_rows = -(-(x_ext.shape[0] + w_pad) // G)
    x2 = torch.cat([x_ext, torch.zeros((n_rows * G - x_ext.shape[0],), dtype=x_ext.dtype,
                                       device=dev)]).reshape(n_rows, G)
    target = start + taps
    row0 = torch.clamp(torch.div(target, G, rounding_mode="floor"), 0, n_rows - w_rows)
    rows = row0.to(torch.int64)[:, None] + torch.arange(w_rows, device=dev)[None, :]
    win = x2[rows].reshape(n_chunks, w_pad)
    misalign = (target - row0 * G).to(torch.float32)

    r = torch.arange(chunk, dtype=torch.float32, device=dev)
    pos = ((frac + misalign)[:, None] + r[None, :] * inv_f)[:, :, None]  # (n_chunks, chunk, 1)
    j = torch.arange(w_pad, dtype=torch.float32, device=dev)
    w = torch.minimum(pos + inv_f, j + 1.0)
    w.sub_(torch.maximum(pos, j)).clamp_(min=0.0)
    out = torch.bmm(w, win[:, :, None]).reshape(n_chunks * chunk) * rate_f
    del w

    valid = torch.arange(max_pix, dtype=torch.int32, device=dev) < n_out
    pixels = out[:max_pix]
    return torch.where(valid, pixels, torch.zeros_like(pixels)), n_out, new_phase


def nn_resample_block(x, phase_fix, inv_fix, *, n_samples: int, max_pix: int):
    """Nearest-neighbour mode (dsp.c:274-277): out[p] = x[(size*p) // n_out],
    from an f32 estimate with the JAX package's exact int64 floor
    correction. x: f32[n_samples] (this block's envelope, no tail)."""
    dev = x.device
    n_out, new_phase = resample_counts(phase_fix, inv_fix, n_samples)
    n_out64 = n_out.to(torch.int64)

    p = torch.arange(max_pix, dtype=torch.int64, device=dev)
    num = n_samples * p
    ratio = _f32(float(n_samples), dev) / torch.clamp(n_out, min=1).to(torch.float32)
    q = (p.to(torch.float32) * ratio).to(torch.int64)
    # exact floor correction: the largest q with q*n_out <= num
    q = torch.where(q * n_out64 > num, q - 1, q)
    q = torch.where((q + 1) * n_out64 <= num, q + 1, q)
    q = torch.where(q * n_out64 > num, q - 1, q)

    valid = p < n_out64
    idx = torch.clamp(q, 0, n_samples - 1)
    pixels = torch.where(valid, x[idx], torch.zeros((), dtype=torch.float32, device=dev))
    return pixels, n_out, new_phase


def plan_strided(inv_nominal: float, taps: int, *, L: int | None = None,
                 pll_frac: float | None = None, max_drift: float = 6.0):
    """Feasibility plan of the strided form: (m, taps_eff, L, margin), or
    None when the geometry does not fit (downsampling, or too much drift).
    m = round(1/inv) pixels advance ~one sample; taps_eff covers the drift
    over a chunk of L samples, PLL excursions up to pll_frac included."""
    if pll_frac is None:
        pll_frac = PLL_HEADROOM_FRAC  # framerate_pll clamps delta to this
    if inv_nominal <= 0 or inv_nominal > 1.0:
        return None
    m = max(int(round(1.0 / inv_nominal)), 1)
    delta = m * inv_nominal - 1.0
    delta_cap = abs(delta) + m * inv_nominal * pll_frac
    if L is None:
        L = int(min(max(max_drift / max(delta_cap, 1e-9), 256), 8192))
        L = 1 << (L.bit_length() - 1)  # floor pow2
    drift = L * delta_cap
    if drift > max_drift or L < 256:
        return None
    margin = int(np.ceil(drift))
    taps_eff = taps + 1 + 2 * margin
    return m, taps_eff, L, margin


def box_resample_strided(x_ext, phase_fix, inv_fix, *, n_samples: int, max_pix: int,
                         taps: int, inv_nominal: float, L: int | None = None, G: int = 8):
    """Resample one block for a near-rational upsampling geometry.

    x_ext: f32[taps + n_samples] — the previous block's last `taps` envelope
        samples, then this block's.
    phase_fix, inv_fix: 0-d int64 tensors (fixed-point window start of the
        next pixel relative to this block's first sample; samples per pixel).
    Returns (pixels f32[max_pix], n_out i32, new_phase i64); pixels past
    n_out are zero.
    """
    plan = plan_strided(inv_nominal, taps, L=L)
    if plan is None:
        raise ValueError("geometry unsuitable for the strided form")
    n_out, new_phase = resample_counts(phase_fix, inv_fix, n_samples)
    pixels = _strided_pixels(x_ext, phase_fix, inv_fix, n_out, plan=plan,
                             max_pix=max_pix, taps=taps, G=G)
    return pixels, n_out, new_phase


def _strided_pixels(x_ext, phase_fix, inv_fix, n_valid, *, plan, max_pix: int,
                    taps: int, G: int):
    """Pixel p = (c*L + q)*m + b: each chunk c gathers one G-aligned window,
    and pixel (c, b, q)'s window start lies within a small static tap range
    of window sample q, so the gather becomes taps_eff + G static shifted
    slices with exact overlap weights from an f32 residual ramp."""
    m, taps_eff, L, margin = plan
    dev = x_ext.device
    inv_f = inv_fix.to(torch.float32) * _INV_SCALE
    rate_f = _f32(float(1 << FRAC_BITS), dev) / inv_fix.to(torch.float32)
    # drift per q from the exact fixed-point difference
    delta_f = (m * inv_fix - (1 << FRAC_BITS)).to(torch.float32) * _INV_SCALE

    pix_per_chunk = m * L
    n_chunks = -(-max_pix // pix_per_chunk)
    w = L + taps_eff + 2
    w_rows = -(-(w + G - 1) // G) + 1
    w_pad = w_rows * G
    zeros = lambda k: torch.zeros((k,), dtype=x_ext.dtype, device=dev)  # noqa: E731
    x_pad = torch.cat([zeros(margin), x_ext, zeros(w_pad)])

    c = torch.arange(n_chunks, dtype=torch.int64, device=dev)
    base = phase_fix + (c * pix_per_chunk) * inv_fix
    start = (base >> FRAC_BITS).to(torch.int32)
    frac = (base - (start.to(torch.int64) << FRAC_BITS)).to(torch.float32) * _INV_SCALE + _f32(
        float(margin), dev)
    n_rows = -(-x_pad.shape[0] // G)
    x2 = torch.cat([x_pad, zeros(n_rows * G - x_pad.shape[0])]).reshape(n_rows, G)
    target = torch.clamp(start + taps, 0, x_pad.shape[0] - w)
    frac = frac + (start + taps - target).to(torch.float32)
    row0 = torch.clamp(torch.div(target, G, rounding_mode="floor"), 0, n_rows - w_rows)
    rows = row0.to(torch.int64)[:, None] + torch.arange(w_rows, device=dev)[None, :]
    win = x2[rows].reshape(n_chunks, w_pad)
    misalign = (target - row0 * G).to(torch.float32)

    q = torch.arange(L, dtype=torch.float32, device=dev)
    b = torch.arange(m, dtype=torch.float32, device=dev)
    rel = (frac + misalign)[:, None, None] + b[None, :, None] * inv_f + q[None, None, :] * delta_f
    acc = torch.zeros((n_chunks, m, L), dtype=torch.float32, device=dev)
    for t in range(taps_eff + G):  # + G absorbs the row misalignment
        lo = torch.clamp(rel, min=float(t))
        hi = torch.clamp(rel + inv_f, max=float(t + 1))
        wt = torch.clamp(hi - lo, min=0.0)
        acc = acc + wt * win[:, t:t + L][:, None, :]

    # (c, b, q) -> pixel order p = c*L*m + q*m + b
    pixels = acc.transpose(1, 2).reshape(-1)[:max_pix] * rate_f
    valid = torch.arange(max_pix, dtype=torch.int32, device=dev) < n_valid
    return torch.where(valid, pixels, torch.zeros_like(pixels))


def box_resample_block(x_ext, phase_fix, inv_fix, *, n_samples: int, max_pix: int, taps: int):
    """The dense form: every pixel's window from its own exact int64 start,
    `taps` gathered samples each. Same contract as box_resample_strided; the
    reference form the others are checked against (no step path takes it)."""
    dev = x_ext.device
    n_out, new_phase = resample_counts(phase_fix, inv_fix, n_samples)
    p = torch.arange(max_pix, dtype=torch.int64, device=dev)
    a = phase_fix + p * inv_fix
    b = a + inv_fix
    i0 = (a >> FRAC_BITS).to(torch.int32)  # arithmetic shift == floor
    scale = _f32(float(1 << FRAC_BITS), dev) / inv_fix.to(torch.float32)
    acc = torch.zeros((max_pix,), dtype=torch.float32, device=dev)
    for t in range(taps):
        idx = i0 + t
        lo = torch.maximum(a, idx.to(torch.int64) << FRAC_BITS)
        hi = torch.minimum(b, (idx + 1).to(torch.int64) << FRAC_BITS)
        w = torch.clamp(hi - lo, min=0).to(torch.float32) * _INV_SCALE
        g = x_ext[torch.clamp(idx + taps, 0, x_ext.shape[0] - 1).to(torch.int64)]
        acc = acc + w * g
    valid = p < n_out.to(torch.int64)
    return torch.where(valid, acc * scale, torch.zeros_like(acc)), n_out, new_phase


def box_resample_gather_i32(x_ext, phase_fix, inv_fix, *, n_samples: int, max_pix: int,
                            taps: int, inv_nominal: float, chunk: int = 256):
    """The gather form: box_resample_block_chunked's per-chunk exact bases
    and f32 ramps, with the `taps` samples a pixel touches gathered by int32
    index (no dense window). Same contract and carries; the JAX package
    keeps it as a measured alternative, and no step path takes it."""
    dev = x_ext.device
    n_out, new_phase = resample_counts(phase_fix, inv_fix, n_samples)
    inv_f = inv_fix.to(torch.float32) * _INV_SCALE
    rate_f = _f32(float(1 << FRAC_BITS), dev) / inv_fix.to(torch.float32)

    n_chunks = -(-max_pix // chunk)
    c = torch.arange(n_chunks, dtype=torch.int64, device=dev)
    base = phase_fix + (c * chunk) * inv_fix
    start = (base >> FRAC_BITS).to(torch.int32)
    frac = (base - (start.to(torch.int64) << FRAC_BITS)).to(torch.float32) * _INV_SCALE

    r = torch.arange(chunk, dtype=torch.float32, device=dev)
    pos = frac[:, None] + r[None, :] * inv_f  # (n_chunks, chunk), relative to start
    i_loc = torch.floor(pos).to(torch.int32)
    idx0 = start[:, None] + i_loc + taps  # each pixel's first tap in x_ext
    sub = pos - i_loc.to(torch.float32)  # in [0, 1)

    acc = torch.zeros((n_chunks, chunk), dtype=torch.float32, device=dev)
    limit = x_ext.shape[0] - 1
    for t in range(taps):
        lo = torch.clamp(sub, min=float(t))
        hi = torch.clamp(sub + inv_f, max=float(t + 1))
        w = torch.clamp(hi - lo, min=0.0)
        g = x_ext[torch.clamp(idx0 + t, 0, limit).to(torch.int64)]
        acc = acc + w * g
    out = (acc * rate_f).reshape(n_chunks * chunk)[:max_pix]
    valid = torch.arange(max_pix, dtype=torch.int32, device=dev) < n_out
    return torch.where(valid, out, torch.zeros_like(out)), n_out, new_phase


# ---- the range forms: one shard's pixels of a time-sharded block ----------
# A shard holds x_local = [taps left halo | its S samples | taps right halo]
# and produces the global pixels [p_start, p_end) whose window starts fall in
# its segment; seg_offset is the global index of the segment's first sample.
# Pixels past p_end - p_start are zero.


def _seg64(seg_offset):
    """A segment offset as the range forms take it: an int, or a 0-d
    integer tensor (as int64)."""
    return seg_offset if isinstance(seg_offset, int) else seg_offset.to(torch.int64)


def shard_phase(phase_fix, inv_fix, p_start, seg_offset):
    """The shard's window-start phase relative to its own segment: pixel
    p_start + i starts at shard_phase + i*inv in x_local's segment samples."""
    return phase_fix + p_start.to(torch.int64) * inv_fix - (_seg64(seg_offset) << FRAC_BITS)


def box_resample_range_strided(x_local, phase_fix, inv_fix, p_start, p_end, seg_offset, *,
                               max_pix: int, taps: int, inv_nominal: float,
                               L: int | None = None, G: int = 8):
    """The strided form over one shard's pixel range: exactly the single-block
    strided problem with the shifted base phase eff_phase (chunks aligned to
    p_start, so f32 residuals may round differently from the whole-block
    form at the ~1e-5-sample level). The plain version of K1's range entry
    (kernels/strided_resample.py box_resample_range_strided_cuda)."""
    plan = plan_strided(inv_nominal, taps, L=L)
    if plan is None:
        raise ValueError("geometry unsuitable for the strided form; use chunked")
    eff_phase = shard_phase(phase_fix, inv_fix, p_start, seg_offset)
    n_local = torch.clamp(p_end - p_start, min=0).to(torch.int32)
    return _strided_pixels(x_local, eff_phase, inv_fix, n_local, plan=plan, max_pix=max_pix,
                           taps=taps, G=G)


def box_resample_range(x_local, phase_fix, inv_fix, p_start, p_end, seg_offset, *,
                       max_pix: int, taps: int, inv_nominal: float):
    """The chunked form over one shard's pixel range, at any rate: chunks of
    128 pixels from p_start, each chunk's base from the exact int64 phase,
    one G-aligned window of x_local per chunk and dense overlap weights."""
    dev = x_local.device
    inv_f = inv_fix.to(torch.float32) * _INV_SCALE
    rate_f = _f32(float(1 << FRAC_BITS), dev) / inv_fix.to(torch.float32)

    chunk, G = 128, 32
    n_chunks = -(-max_pix // chunk)
    w_in = int(np.ceil(chunk * inv_nominal * 1.02)) + taps + 2
    w_rows = -(-(w_in + G - 1) // G) + 1
    w_pad = w_rows * G

    c = torch.arange(n_chunks, dtype=torch.int64, device=dev)
    base = phase_fix + (p_start.to(torch.int64) + c * chunk) * inv_fix
    start = (base >> FRAC_BITS).to(torch.int32)
    frac = (base - (start.to(torch.int64) << FRAC_BITS)).to(torch.float32) * _INV_SCALE

    loc = start + (taps - _seg64(seg_offset))  # window start within x_local
    n_rows = -(-(x_local.shape[0] + w_pad) // G)
    x2 = torch.cat([x_local, torch.zeros((n_rows * G - x_local.shape[0],), dtype=x_local.dtype,
                                         device=dev)]).reshape(n_rows, G)
    row0 = torch.clamp(torch.div(loc, G, rounding_mode="floor"), 0, n_rows - w_rows)
    rows = row0.to(torch.int64)[:, None] + torch.arange(w_rows, device=dev)[None, :]
    win = x2[rows].reshape(n_chunks, w_pad)
    misalign = (loc - row0 * G).to(torch.float32)

    r = torch.arange(chunk, dtype=torch.float32, device=dev)
    pos = ((frac + misalign)[:, None] + r[None, :] * inv_f)[:, :, None]
    j = torch.arange(w_pad, dtype=torch.float32, device=dev)
    w = torch.minimum(pos + inv_f, j + 1.0)
    w.sub_(torch.maximum(pos, j)).clamp_(min=0.0)
    out = torch.bmm(w, win[:, :, None]).reshape(n_chunks * chunk) * rate_f
    del w

    pixels = out[:max_pix]
    n_local = (p_end - p_start).to(torch.int32)
    valid = torch.arange(max_pix, dtype=torch.int32, device=dev) < n_local
    return torch.where(valid, pixels, torch.zeros_like(pixels))


def nn_resample_range(x_full, n_out, p_start, p_end, *, n_samples: int, max_pix: int):
    """Nearest-neighbour over one shard's pixel range: out[p] =
    x_full[(n*p) // n_out] for the global pixels p of [p_start, p_end).
    The mapping is global in p and in x (it ignores the phase, so it can
    reach past the halos): x_full is the whole block's gathered envelope.
    The same f32 estimate and exact int64 floor correction as
    nn_resample_block."""
    dev = x_full.device
    n_out64 = torch.clamp(n_out, min=1).to(torch.int64)
    p = p_start.to(torch.int64) + torch.arange(max_pix, dtype=torch.int64, device=dev)
    num = n_samples * p
    ratio = _f32(float(n_samples), dev) / torch.clamp(n_out, min=1).to(torch.float32)
    q = (p.to(torch.float32) * ratio).to(torch.int64)
    q = torch.where(q * n_out64 > num, q - 1, q)
    q = torch.where((q + 1) * n_out64 <= num, q + 1, q)
    q = torch.where(q * n_out64 > num, q - 1, q)

    n_local = torch.clamp(p_end - p_start, min=0).to(torch.int32)
    valid = torch.arange(max_pix, dtype=torch.int32, device=dev) < n_local
    idx = torch.clamp(q, 0, n_samples - 1)
    return torch.where(valid, x_full[idx], torch.zeros((), dtype=torch.float32, device=dev))
