"""The window arithmetic of K1, K2, K3 and K4 (kernels/window_plan.py, the
host statement of csrc/staged_window.cuh and of K2's window and ownership)
and the wrappers' sizing, on the CPU in pure Python and numpy: each staged
window, after its round-down to a 16-byte boundary, contains every sample
its pixels' taps index, at both ends of the PLL headroom and for negative,
zero and late phases; a window fits shared memory at any rate; the
division-free pixel count equals the carries' n_out; K2's tiles write every
envelope sample exactly once; and a numpy model of each kernel's tiling (one
chunk, tile or group of tiles per thread block, staged aligned window,
per-chunk f32 ramp; K1's range entry from its shard's phase and count) and
of K4's window gather (one 16-byte piece per thread) equals the TPU kernel
it replaces (the range entry: the JAX range form), run in interpret mode by the JAX package
on the same inputs (K1 within 4e-4, tests/test_ops.py:249; K3 and K4 within
3e-4, tests/test_pallas.py:99; K2 within 2e-5 with the envelope exact,
tests/test_pallas.py:75; the gather exactly), and the port's plain version
within the kernel's tolerance on the card (K1 and K2 2e-5, K3 and K4 3e-4);
carries exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempestsdr_tpu.pallas.fused_kernel import fused_demod_resample as tpu_k2
from tempestsdr_tpu.pallas.strided_kernel import box_resample_strided_pallas

from tempestsdr_tpu_torch import ops as tops
from tempestsdr_tpu_torch.config import FRAC_BITS, PLL_HEADROOM_FRAC, PipelineConfig
from tempestsdr_tpu_torch.kernels import chunked_resample as k3
from tempestsdr_tpu_torch.kernels import fused_demod_resample as k2
from tempestsdr_tpu_torch.kernels import strided_resample as k1
from tempestsdr_tpu_torch.kernels.window_plan import (
    SMEM_PER_BLOCK,
    aligned_window,
    k2_smem_bytes,
    k2_tiles,
    k2_window,
    slot_floats,
    valid_pixels,
)

GEOMETRIES = {  # the README's flagship and demo geometries
    "64MS/s": PipelineConfig(samplerate=64e6, height=628, refreshrate=60.0,
                             block_samples=786432),
    "8MS/s": PipelineConfig(samplerate=8e6, height=628, refreshrate=60.0, block_samples=450560),
}
PLL_ENDS = (1 - PLL_HEADROOM_FRAC, 1 + PLL_HEADROOM_FRAC / (1 - PLL_HEADROOM_FRAC))
ONE = 1 << FRAC_BITS
F32 = np.float32
INV_SCALE = F32(2.0 ** -FRAC_BITS)
SMEM_PER_SM = 233472  # bytes of shared memory on a Hopper SM, 1 KB reserved per resident block


def phases(n):
    """Negative (the first window starts in the tail), zero, near the
    block's end, and past it (negative numerator, n_out == 0)."""
    return {"in the tail": -ONE - 12345, "zero": 0, "near the end": (n - 3) * ONE,
            "past the block": (n + 5) * ONE}


@pytest.mark.parametrize("w0", [-7, -4, -1, 0, 1, 2, 3, 4, 1023, 786431])
@pytest.mark.parametrize("misalign", [0, 1, 2, 3])
def test_aligned_window_is_16_byte_aligned_and_covers(w0, misalign):
    """The staged range starts and ends on 16-byte boundaries of the
    address, contains the window, wastes at most 3 samples at each end, and
    fits the slot."""
    for length in (1, 4, 1036, 1038, 1049):
        a, off, n = aligned_window(w0, length, misalign)
        assert (a + misalign) % 4 == 0 and n % 4 == 0 and 0 <= off <= 3
        assert a + off == w0 and a + n >= w0 + length and n - off - length <= 3
        assert n <= slot_floats(length)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("inv_scale", PLL_ENDS + (1.0,))
def test_valid_pixels_equals_the_carries_count(geometry, inv_scale):
    """The division-free per-chunk count is min(max(n_out - p0, 0), total)
    with n_out from resample_counts, for every chunk and every phase,
    negative numerators included."""
    cfg = GEOMETRIES[geometry]
    n, inv = cfg.block_samples, round(cfg.samples_per_pixel * inv_scale * ONE)
    total = 2 * k1.TILE
    for phase in phases(n).values():
        n_out, _ = tops.resample_counts(torch.tensor(phase), torch.tensor(inv), n)
        n_out = int(n_out)
        num = n * ONE - phase
        for c in range(-(-cfg.max_block_pixels // total)):
            assert valid_pixels(c * total, total, num, inv) == min(max(n_out - c * total, 0),
                                                                   total)


def chunk_bases(phase, inv, p0):
    """(start, frac f32) of the window start of pixel p0, as the kernels
    take them from the exact int64 phase."""
    base = phase + p0 * inv
    start = base >> FRAC_BITS
    return start, F32(base - (start << FRAC_BITS)) * INV_SCALE


def k1_ramp(frac, margin, inv):
    """K1's f32 ramp of one chunk: (rel_e, rel_o, end_o) over its samples."""
    inv_f = F32(inv) * INV_SCALE
    delta2 = F32(2.0 * inv * 2.0 ** -FRAC_BITS - 1.0)
    s = np.arange(k1.TILE, dtype=F32)
    rel_e = (F32(margin) + frac) + s * delta2
    rel_o = rel_e + inv_f
    return rel_e, rel_o, rel_o + inv_f


@pytest.mark.parametrize("misalign", [0, 1])
@pytest.mark.parametrize("inv_scale", PLL_ENDS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_k1_staged_window_contains_every_tap(geometry, inv_scale, misalign):
    """For every chunk with a complete pixel: each pixel's window
    [rel, rel + inv) lies inside the two taps the kernel evaluates, and those
    index samples inside the staged range."""
    cfg = GEOMETRIES[geometry]
    n, taps = cfg.block_samples, cfg.resample_taps
    inv = round(cfg.samples_per_pixel * inv_scale * ONE)
    margin, taps_eff = k1.k1_margin(cfg.samples_per_pixel)
    wlen = k1.TILE + taps_eff
    s = np.arange(k1.TILE)
    for phase in phases(n).values():
        num = n * ONE - phase
        for c in range(-(-cfg.max_block_pixels // (2 * k1.TILE))):
            if valid_pixels(c * 2 * k1.TILE, 2 * k1.TILE, num, inv) == 0:
                continue  # not staged
            start, frac = chunk_bases(phase, inv, c * 2 * k1.TILE)
            a, off, cnt = aligned_window(start - margin + taps, wlen, misalign)
            rel_e, rel_o, end_o = k1_ramp(frac, margin, inv)
            for rel, end in ((rel_e, rel_o), (rel_o, end_o)):
                i0 = np.clip(rel.astype(np.int32), 0, taps_eff - 2)
                assert (np.floor(rel) >= i0).all() and (end <= i0 + 2).all()
                assert (off + s + i0 + 1).max() < cnt


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_k1_window_fits_shared_memory(geometry):
    """One window per thread block, without opting in to more than 48 KB,
    and eight blocks' windows (the kernel's launch bound) fit an SM."""
    _, taps_eff = k1.k1_margin(GEOMETRIES[geometry].samples_per_pixel)
    window = slot_floats(k1.TILE + taps_eff) * 4
    assert window <= 48 * 1024
    assert 8 * (window + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("inv0", [0.5000040625330081, 0.5007410968232985, 1 / 1.5123, 1.4038,
                                  7.3, 20.0, 60.0, 100.0])
def test_k3_window_fits_shared_memory(inv0):
    """group_tiles keeps a group's window within a thread block's shared
    memory at any rate, within half of it while it groups tiles, and raises
    where even a one-tile window does not fit."""
    taps = int(np.ceil(inv0 * 1.02)) + 1
    tiles = k3.group_tiles(inv0, taps)
    assert tiles in (1, 2, 4, 8)
    window = k3.window_bytes(inv0, taps, tiles)
    assert window == slot_floats(k3.window_len(inv0, taps, tiles)) * 4
    assert window <= (SMEM_PER_BLOCK // 2 if tiles > 1 else SMEM_PER_BLOCK)
    if inv0 < 2:
        assert tiles == k3.GROUP_TILES
    with pytest.raises(ValueError, match="shared memory"):
        k3.group_tiles(300.0, 307)


@pytest.mark.parametrize("misalign", [0, 3])
@pytest.mark.parametrize("inv_scale", PLL_ENDS)
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_k3_staged_window_contains_every_tap(geometry, inv_scale, misalign):
    """For every group with a complete pixel: every tile's window lies in
    the group's (the kernel's clamp to the group window never binds), and
    every sample a pixel sums lies inside the staged range."""
    cfg = GEOMETRIES[geometry]
    n, taps, inv0 = cfg.block_samples, cfg.resample_taps, cfg.samples_per_pixel
    inv = round(inv0 * inv_scale * ONE)
    inv_f = F32(inv) * INV_SCALE
    tiles = k3.group_tiles(inv0, taps)
    w_in, w_grp = k3.window_len(inv0, taps), k3.window_len(inv0, taps, tiles)
    group_pix = tiles * k3.TILE
    r = np.arange(k3.TILE, dtype=F32)
    for phase in phases(n).values():
        num = n * ONE - phase
        for g in range(-(-cfg.max_block_pixels // group_pix)):
            if valid_pixels(g * group_pix, group_pix, num, inv) == 0:
                continue
            start0, _ = chunk_bases(phase, inv, g * group_pix)
            a, off, cnt = aligned_window(start0 + taps, w_grp, misalign)
            for t in range(tiles):
                start, frac = chunk_bases(phase, inv, g * group_pix + t * k3.TILE)
                d = start - start0
                j1 = np.floor((frac + r * inv_f) + inv_f).max()
                assert 0 <= d and j1 <= w_in - 1 and d + j1 <= w_grp - 1
                assert off + d + j1 < cnt <= slot_floats(w_grp)


def stage(x, a, cnt):
    """The staged slot: x[a : a + cnt] with zeros outside x."""
    idx = a + np.arange(cnt)
    ok = (idx >= 0) & (idx < x.shape[0])
    return np.where(ok, x[np.clip(idx, 0, x.shape[0] - 1)], F32(0))


def two_tap_box(slot, off, rel, end, taps_eff, rate):
    """K1's and K2's pixel sum over the two taps a sub-sample window can
    touch, for the samples s of one chunk whose window starts at slot[off]."""
    s = np.arange(k1.TILE)
    i0 = np.clip(rel.astype(np.int32), 0, taps_eff - 2)

    def term(t):
        tf = t.astype(F32)
        w = np.maximum(np.minimum(end, tf + F32(1)) - np.maximum(rel, tf), F32(0))
        return w * slot[off + s + t]

    return (term(i0) + term(i0 + 1)) * rate


def k1_model(x, phase, inv, *, n_samples, max_pix, taps, inv_nominal, misalign):
    """K1's tiling in numpy: one chunk a thread block, its staged aligned
    window, the per-chunk f32 ramp and the two taps a pixel can touch."""
    num = n_samples * ONE - phase
    n_out = max(num // inv, 0)
    out = k1_pixels(x, phase, inv, lambda p0, total: valid_pixels(p0, total, num, inv),
                    max_pix=max_pix, taps=taps, inv_nominal=inv_nominal, misalign=misalign)
    return out, n_out, phase + n_out * inv - n_samples * ONE


def k1_range_model(x_local, eff_phase, inv, n_valid, *, max_pix, taps, inv_nominal, misalign):
    """K1's range entry in numpy: the same tiling from the shard's shifted
    phase, each chunk's count of valid pixels clamp(n_valid - p0, 0, 2*TILE)
    (the entry's rule, from a device count), no carries."""
    return k1_pixels(x_local, eff_phase, inv, lambda p0, total: min(max(n_valid - p0, 0), total),
                     max_pix=max_pix, taps=taps, inv_nominal=inv_nominal, misalign=misalign)


def k1_pixels(x, phase, inv, lim_of, *, max_pix, taps, inv_nominal, misalign):
    """Both K1 entries' pixels: lim_of(p0, total) is a chunk's count of
    valid pixels; a chunk with none stages nothing and stores zeros."""
    margin, taps_eff = k1.k1_margin(inv_nominal)
    rate = F32(float(ONE)) / F32(inv)
    out = np.full(max_pix, np.nan, F32)
    pix = 2 * k1.TILE
    for c in range(-(-max_pix // pix)):
        vals = np.zeros(pix, F32)
        lim = lim_of(c * pix, pix)
        if lim > 0:
            start, frac = chunk_bases(phase, inv, c * pix)
            a, off, cnt = aligned_window(start - margin + taps, k1.TILE + taps_eff, misalign)
            slot = stage(x, a, cnt)
            rel_e, rel_o, end_o = k1_ramp(frac, margin, inv)
            vals[0::2] = two_tap_box(slot, off, rel_e, rel_o, taps_eff, rate)
            vals[1::2] = two_tap_box(slot, off, rel_o, end_o, taps_eff, rate)
            vals[lim:] = 0
        seg = out[c * pix:(c + 1) * pix]
        seg[:] = vals[:seg.shape[0]]
    return out


def k3_model(x, phase, inv, *, n_samples, max_pix, taps, inv_nominal, misalign):
    """K3's tiling in numpy: one group of tiles a thread block, its one
    staged aligned window, each tile's f32 ramp from its own exact base, and a
    sequential sum over the samples a pixel touches."""
    tiles = k3.group_tiles(inv_nominal, taps)
    w_in, w_grp = k3.window_len(inv_nominal, taps), k3.window_len(inv_nominal, taps, tiles)
    num = n_samples * ONE - phase
    n_out = max(num // inv, 0)
    inv_f = F32(inv) * INV_SCALE
    rate = F32(1) / inv_f
    out = np.full(max_pix, np.nan, F32)
    group_pix = tiles * k3.TILE
    r = np.arange(k3.TILE, dtype=F32)
    for g in range(-(-max_pix // group_pix)):
        vals = np.zeros(group_pix, F32)
        lim = valid_pixels(g * group_pix, group_pix, num, inv)
        if lim > 0:
            start0, _ = chunk_bases(phase, inv, g * group_pix)
            a, off, cnt = aligned_window(start0 + taps, w_grp, misalign)
            slot = stage(x, a, cnt)
            for t in range(tiles):
                start, frac = chunk_bases(phase, inv, g * group_pix + t * k3.TILE)
                d = start - start0
                pos = frac + r * inv_f
                end = pos + inv_f
                j0 = np.maximum(np.floor(pos).astype(np.int64), 0)
                j1 = np.minimum(np.floor(end).astype(np.int64), min(w_in, w_grp - d) - 1)
                acc = np.zeros(k3.TILE, F32)
                for k in range(int((j1 - j0).max()) + 1):
                    j = j0 + k
                    jf = j.astype(F32)
                    w = np.maximum(np.minimum(end, jf + F32(1)) - np.maximum(pos, jf), F32(0))
                    inside = j <= j1
                    acc = np.where(inside, acc + w * slot[np.where(inside, off + d + j, 0)], acc)
                vals[t * k3.TILE:(t + 1) * k3.TILE] = acc * rate
            vals[lim:] = 0
        seg = out[g * group_pix:(g + 1) * group_pix]
        seg[:] = vals[:seg.shape[0]]
    return out, n_out, phase + n_out * inv - n_samples * ONE


@pytest.fixture()
def tpu_k3(monkeypatch):
    """The TPU kernel K3 in interpret mode (tests/test_pallas.py:14-25)."""
    import jax.experimental.pallas as pl
    import tempestsdr_tpu.pallas.resample_kernel as rk

    orig = pl.pallas_call
    monkeypatch.setattr(rk.pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    return rk.box_resample_pallas


def tpu_k1(*args, **kw):
    """The TPU kernel K1 in interpret mode."""
    return box_resample_strided_pallas(*args, interpret=True, **kw)


def held(model, tpu_kernel, tpu_tol, plain, tol, inv0, phase_name, misalign, n=8192,
         inv_scale=1.0):
    """The model on a seeded block against the TPU kernel (interpret mode,
    rtol = atol = tpu_tol) and the port's plain version (max abs tol):
    carries exact against both."""
    rng = np.random.default_rng(21)
    taps = int(np.ceil(inv0)) + 1
    x = np.concatenate([rng.random(taps), rng.random(n) * 1.5]).astype(F32)
    inv = round(inv0 * inv_scale * ONE)
    phase = phases(n)[phase_name]
    kw = dict(n_samples=n, max_pix=int(n / inv0 * 1.02) + 2, taps=taps, inv_nominal=inv0)
    got, n_out, new_phase = model(x, phase, inv, misalign=misalign, **kw)
    assert not np.isnan(got).any()
    ref, n_ref, phase_ref = tpu_kernel(jnp.asarray(x), jnp.int64(phase), jnp.int64(inv), **kw)
    assert n_out == int(n_ref) and new_phase == int(phase_ref)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tpu_tol, atol=tpu_tol)
    want, n_want, phase_want = plain(torch.from_numpy(x), torch.tensor(phase), torch.tensor(inv),
                                     **kw)
    assert n_out == int(n_want) and new_phase == int(phase_want)
    assert np.abs(got - want.numpy()).max() <= tol
    if phase_name == "past the block":
        assert n_out == 0 and not got.any()
    else:
        assert n_out > 0 and got[:n_out].any() and not got[n_out:].any()


@pytest.mark.parametrize("misalign", [0, 1, 3])
@pytest.mark.parametrize("phase_name", ["in the tail", "zero", "near the end", "past the block"])
def test_k1_tiling_model_matches_tpu_kernel_and_plain_version(phase_name, misalign):
    """Against the TPU kernel within 4e-4 (its tolerance against the XLA
    form, tests/test_ops.py:249: its chunk is 4096 samples, the model's
    1024) and the plain version within 2e-5 (K1's tolerance on the card;
    the plain form's chunk ramp rounds the window edges differently)."""
    held(k1_model, tpu_k1, 4e-4, tops.box_resample_strided, 2e-5, 0.5000040625330081,
         phase_name, misalign)


@pytest.mark.parametrize("inv_scale", PLL_ENDS)
def test_k1_tiling_model_at_pll_ends(inv_scale):
    held(k1_model, tpu_k1, 4e-4, tops.box_resample_strided, 2e-5, 0.5007410968232985, "zero", 2,
         inv_scale=inv_scale)


@pytest.mark.parametrize("misalign", [0, 1])
@pytest.mark.parametrize("inv_scale", (1.0,) + PLL_ENDS)
@pytest.mark.parametrize("phase", [-(1 << (FRAC_BITS - 2)), -ONE - 12345, 0])
def test_k1_range_model_matches_jax_range_form(phase, inv_scale, misalign):
    """K1's range entry over the T = 4 shards of a block (x_local and the
    pixel ranges built as tests/test_parallel.py:177-191 builds them), plus
    an empty range and a phase past its segment: equal to the JAX package's
    box_resample_range_strided within 2e-5 (K1's tolerance), exactly 0 past
    n_valid; and the port's plain range form equal to JAX's."""
    import tempestsdr_tpu.ops.resample as jr

    rng = np.random.default_rng(23)
    inv0, taps, S, T = 0.5000040625330081, 2, 8192, 4
    inv = round(inv0 * inv_scale * ONE)
    n = S * T
    env = (rng.random(n) * 1.5).astype(F32)
    x_full = np.concatenate([rng.random(taps).astype(F32), env, np.zeros(taps, F32)])
    n_out = max((n * ONE - phase) // inv, 0)
    mp = int(S / inv0 * 1.02) + 2
    cases = []
    for t in range(T):
        seg = t * S
        ceil = lambda a: -((-a) // inv)  # noqa: E731
        cases.append((seg, 0 if t == 0 else min(max(ceil((seg << FRAC_BITS) - phase), 0), n_out),
                      min(max(ceil(((seg + S) << FRAC_BITS) - phase), 0), n_out)))
    cases += [(S, 7, 7), (S, 4 * S + 50, 4 * S + 150)]  # empty; starts past the segment
    kw = dict(max_pix=mp, taps=taps, inv_nominal=inv0)
    for seg, p0, p1 in cases:
        x_local = x_full[seg:seg + S + 2 * taps]
        eff = phase + p0 * inv - (seg << FRAC_BITS)
        got = k1_range_model(x_local, eff, inv, max(p1 - p0, 0), misalign=misalign, **kw)
        want = np.asarray(jr.box_resample_range_strided(
            jnp.asarray(x_local), jnp.int64(phase), jnp.int64(inv), jnp.int64(p0), jnp.int64(p1),
            jnp.int64(seg), **kw))
        assert not np.isnan(got).any() and not got[max(p1 - p0, 0):].any()
        assert np.abs(got - want).max() <= 2e-5, (seg, p0, p1)
        plain = tops.box_resample_range_strided(
            torch.from_numpy(x_local), torch.tensor(phase), torch.tensor(inv), torch.tensor(p0),
            torch.tensor(p1), seg, **kw)
        np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("misalign", [0, 1, 3])
@pytest.mark.parametrize("phase_name", ["in the tail", "zero", "near the end", "past the block"])
def test_k3_tiling_model_matches_tpu_kernel_and_plain_version(tpu_k3, phase_name, misalign):
    """Against the TPU kernel and the plain version within 3e-4 (K3's
    tolerance on the card, tests/test_pallas.py:99: the TPU kernel's fracs
    have 24 bits and the chunked form's ramps start at each 128-pixel chunk,
    the model's at each 256-pixel tile)."""
    held(k3_model, tpu_k3, 3e-4, tops.box_resample_block_chunked, 3e-4, 0.5000040625330081,
         phase_name, misalign)


@pytest.mark.parametrize("rate", [1.99876, 1.5123, 0.71234, 1 / 7.3])
def test_k3_tiling_model_at_any_rate(tpu_k3, rate):
    held(k3_model, tpu_k3, 3e-4, tops.box_resample_block_chunked, 3e-4, 1 / rate, "zero", 1)


def window_sum(win, w_in, frac, inv_f, rate):
    """K3's and K4's pixels of one 256-pixel tile from its window `win` of
    w_in samples: pos restarts at the tile's frac, and each pixel sums the
    samples its window touches in ascending order."""
    r = np.arange(k3.TILE, dtype=F32)
    pos = frac + r * inv_f
    end = pos + inv_f
    j0 = np.maximum(np.floor(pos).astype(np.int64), 0)
    j1 = np.minimum(np.floor(end).astype(np.int64), w_in - 1)
    acc = np.zeros(k3.TILE, F32)
    for k in range(max(int((j1 - j0).max()) + 1, 0)):
        j = j0 + k
        jf = j.astype(F32)
        w = np.maximum(np.minimum(end, jf + F32(1)) - np.maximum(pos, jf), F32(0))
        inside = j <= j1
        acc = np.where(inside, acc + w * win[np.where(inside, j, 0)], acc)
    return acc * rate


def gather_model(x, phase, inv, *, max_pix, taps, inv_nominal):
    """The gather kernel's tiling in numpy: one thread per 16-byte piece of
    `windows`, flat over the rows; each forms its row's exact base, start and
    clipped first sample, reads four samples of x (0 past its end) and the
    row's first piece also writes the frac with the clip folded in."""
    n_tiles = -(-max_pix // k3.TILE)
    w_in = k3.k4_window_len(inv_nominal, taps)
    assert w_in % 4 == 0 and 0 <= w_in - k3.window_len(inv_nominal, taps) < 4
    w4 = w_in // 4
    windows = np.full((n_tiles * w4, 4), np.nan, F32)
    fracs = np.full(n_tiles, np.nan, F32)
    for i in range(n_tiles * w4):
        t, c = divmod(i, w4)
        start, frac = chunk_bases(phase, inv, t * k3.TILE)
        idx0 = min(max(start + taps, 0), x.shape[0])
        if c == 0:
            fracs[t] = frac + F32(start + taps - idx0)
        j = idx0 + 4 * c + np.arange(4)
        windows[i] = np.where(j < x.shape[0], x[np.minimum(j, x.shape[0] - 1)], F32(0))
    return windows.reshape(n_tiles, w_in), fracs


def k4_model(x, phase, inv, *, n_samples, max_pix, taps, inv_nominal, misalign):
    """K4's tiling in numpy on the gather model's rows: one group of rows a
    thread block, staged as one aligned stretch of `windows` (zeros past its
    end, for the last, partial group), each tile's f32 ramp from its frac."""
    windows, fracs = gather_model(x, phase, inv, max_pix=max_pix, taps=taps,
                                  inv_nominal=inv_nominal)
    n_tiles, w_in = windows.shape
    tiles = k3.k4_group_tiles(w_in)
    flat = windows.reshape(-1)
    num = n_samples * ONE - phase
    n_out = max(num // inv, 0)
    inv_f = F32(inv) * INV_SCALE
    rate = F32(1) / inv_f
    out = np.full(max_pix, np.nan, F32)
    group_pix = tiles * k3.TILE
    for g in range(-(-n_tiles // tiles)):
        vals = np.zeros(group_pix, F32)
        lim = valid_pixels(g * group_pix, group_pix, num, inv)
        if lim > 0:
            a, off, cnt = aligned_window(g * tiles * w_in, tiles * w_in, misalign)
            assert cnt <= slot_floats(tiles * w_in)
            slot = stage(flat, a, cnt)
            for t in range(min(tiles, n_tiles - g * tiles)):
                win = slot[off + t * w_in:off + (t + 1) * w_in]
                vals[t * k3.TILE:(t + 1) * k3.TILE] = window_sum(win, w_in, fracs[g * tiles + t],
                                                                 inv_f, rate)
            vals[lim:] = 0
        seg = out[g * group_pix:(g + 1) * group_pix]
        seg[:] = vals[:seg.shape[0]]
    return out, n_out, phase + n_out * inv - n_samples * ONE


@pytest.fixture()
def tpu_k4(monkeypatch):
    """The TPU kernel K4 in interpret mode; `calls` keeps the operands its
    wrapper handed to pallas_call (fracs, inv, windows)."""
    import jax.experimental.pallas as pl
    import tempestsdr_tpu.pallas.resample_kernel as rk

    orig = pl.pallas_call
    calls = []

    def interp(*a, **k):
        run = orig(*a, **{**k, "interpret": True})

        def keep(*operands):
            calls.append(operands)
            return run(*operands)

        return keep

    monkeypatch.setattr(rk.pl, "pallas_call", interp)
    rk.box_resample_pallas_windows.calls = calls
    return rk.box_resample_pallas_windows


@pytest.mark.parametrize("misalign", [0, 1, 3])
@pytest.mark.parametrize("phase_name", ["in the tail", "zero", "near the end", "past the block"])
def test_k4_tiling_model_matches_tpu_kernel_and_plain_version(tpu_k4, phase_name, misalign):
    """Against the TPU kernel and the plain version within 3e-4 (K4's
    tolerance on the card, tests/test_pallas.py:99: the chunked form's ramps
    start at each 128-pixel chunk, the model's at each 256-pixel tile; the
    TPU kernel sums a pixel's terms in another order)."""
    held(k4_model, tpu_k4, 3e-4, tops.box_resample_block_chunked, 3e-4, 0.5000040625330081,
         phase_name, misalign)


@pytest.mark.parametrize("rate", [1.99876, 1.5123, 0.71234, 1 / 7.3])
def test_k4_tiling_model_at_any_rate(tpu_k4, rate):
    held(k4_model, tpu_k4, 3e-4, tops.box_resample_block_chunked, 3e-4, 1 / rate, "zero", 1)


@pytest.mark.parametrize("inv0", [0.5000040625330081, 0.5007410968232985, 1 / 1.5123, 1.4038,
                                  7.3, 20.0, 60.0, 100.0])
def test_k4_rows_fit_shared_memory(inv0):
    """k4_group_tiles keeps a group's rows within a thread block's shared
    memory at any rate, within half of it while it groups rows, and raises
    where even one row does not fit; rows are whole 16-byte pieces."""
    taps = int(np.ceil(inv0 * 1.02)) + 1
    w_in = k3.k4_window_len(inv0, taps)
    assert w_in % 4 == 0 and 0 <= w_in - k3.window_len(inv0, taps) < 4
    tiles = k3.k4_group_tiles(w_in)
    assert tiles in (1, 2, 4, 8)
    rows = k3.k4_window_bytes(w_in, tiles)
    assert rows == slot_floats(tiles * w_in) * 4
    assert rows <= (SMEM_PER_BLOCK // 2 if tiles > 1 else SMEM_PER_BLOCK)
    if inv0 < 2:
        assert tiles == k3.GROUP_TILES
    with pytest.raises(ValueError, match="shared memory"):
        k3.k4_group_tiles(k3.k4_window_len(300.0, 307))


@pytest.mark.parametrize("rate", [1.99876, 1.5123, 0.71234])
@pytest.mark.parametrize("phase_name", ["in the tail", "zero", "near the end", "past the block"])
def test_gather_model_equals_plain_version_and_tpu_wrapper(tpu_k4, phase_name, rate):
    """The gather model's windows and fracs equal gather_windows on the CPU
    (its plain version) exactly, and the operands the TPU wrapper hands its
    kernel: fracs exactly, windows on the columns and rows both have (the
    TPU wrapper pads rows to 8 samples and the tile count to 8)."""
    rng = np.random.default_rng(23)
    n, inv0 = 4096, 1 / rate
    taps = int(np.ceil(inv0)) + 1
    x = np.concatenate([rng.random(taps), rng.random(n) * 1.5]).astype(F32)
    inv, phase = round(inv0 * ONE) + 777, phases(n)[phase_name]
    kw = dict(max_pix=int(n * rate * 1.02) + 2, taps=taps, inv_nominal=inv0)
    windows, fracs = gather_model(x, phase, inv, **kw)
    assert not np.isnan(windows).any() and not np.isnan(fracs).any()
    got = k3.gather_windows(torch.from_numpy(x), torch.tensor(phase), torch.tensor(inv), **kw)
    assert k3.gather_windows.launches == 0
    np.testing.assert_array_equal(got[0].numpy(), windows)
    np.testing.assert_array_equal(got[1].numpy(), fracs)
    tpu_k4(jnp.asarray(x), jnp.int64(phase), jnp.int64(inv), n_samples=n, **kw)
    (tpu_fracs, _, tpu_windows), = tpu_k4.calls
    cols = min(windows.shape[1], tpu_windows.shape[1])
    assert tpu_windows.shape[0] >= windows.shape[0] and cols >= k3.window_len(inv0, taps)
    np.testing.assert_array_equal(np.asarray(tpu_windows)[:windows.shape[0], :cols],
                                  windows[:, :cols])
    np.testing.assert_array_equal(np.asarray(tpu_fracs)[:fracs.shape[0], 0], fracs)


def decode(raw):
    """The envelope of interleaved 8-bit IQ as K2 decodes it: the pair's
    bytes as integers, sqrt(a*a + b*b) * (1/128) in f32 (a*a + b*b is an
    exact integer and numpy's f32 sqrt is correctly rounded)."""
    pair = raw.reshape(-1, 2).astype(np.int32) - (128 if raw.dtype == np.uint8 else 0)
    power = (pair[:, 0] * pair[:, 0] + pair[:, 1] * pair[:, 1]).astype(F32)
    return np.sqrt(power) * F32(0.0078125)


def k2_model(raw, tail, phase, inv, *, n_samples, max_pix, taps, inv_nominal):
    """K2's tiling in numpy: one tile of 1024 samples a thread block; the
    tile decodes its window (envelope indices from the even e0; the tail
    before the block, 0 past it) and, separately, the samples it owns, and
    resamples the window with K1's ramp and two taps. `writes` counts the
    stores to each envelope sample."""
    margin, taps_eff = k1.k1_margin(inv_nominal, k2.TILE)
    n = n_samples
    num = n * ONE - phase
    n_out = max(num // inv, 0)
    rate = F32(float(ONE)) / F32(inv)
    full = decode(raw)
    env, writes = np.full(n, np.nan, F32), np.zeros(n, np.int64)
    out = np.full(max_pix, np.nan, F32)
    pix = 2 * k2.TILE
    for c in range(k2_tiles(n, max_pix, k2.TILE)):
        own = slice(min(c * k2.TILE, n), min((c + 1) * k2.TILE, n))
        env[own] = decode(raw[2 * own.start:2 * own.stop])
        writes[own] += 1
        vals = np.zeros(pix, F32)
        lim = valid_pixels(c * pix, pix, num, inv)
        if lim > 0:
            e0, w_len, par = k2_window(c, phase, inv, margin, taps_eff, k2.TILE)
            e = e0 + np.arange(w_len)
            win = np.where((e >= 0) & (e < n), full[np.clip(e, 0, n - 1)],
                           np.where((e < 0) & (e >= -taps), tail[np.clip(taps + e, 0, taps - 1)],
                                    F32(0))).astype(F32)
            _, frac = chunk_bases(phase, inv, c * pix)
            rel_e, rel_o, end_o = k1_ramp(frac, margin, inv)
            vals[0::2] = two_tap_box(win, par, rel_e, rel_o, taps_eff, rate)
            vals[1::2] = two_tap_box(win, par, rel_o, end_o, taps_eff, rate)
            vals[lim:] = 0
        seg = out[c * pix:(c + 1) * pix]
        seg[:] = vals[:seg.shape[0]]
    return env, writes, out, n_out, phase + n_out * inv - n * ONE


@pytest.mark.parametrize("dtype", ["uint8", "int8"])
@pytest.mark.parametrize("phase_name", ["in the tail", "zero", "near the end", "past the block"])
def test_k2_tiling_model_matches_tpu_kernel_and_plain_version(phase_name, dtype):
    """Against the TPU fused kernel (interpret mode on the CPU) and the plain
    version: every envelope sample written exactly once and bit for bit
    theirs, carries exact, pixels within 2e-5 (tests/test_pallas.py:75; the
    plain strided form's chunk ramp rounds the window edges differently)."""
    rng = np.random.default_rng(22)
    n, inv0, taps = 1 << 14, 0.5000040625330081, 2
    raw = rng.integers(0, 256, size=2 * n).astype(np.uint8).view(dtype)
    tail = (rng.random(taps) * 1.5).astype(F32)
    inv, phase = round(inv0 * ONE) + 777, phases(n)[phase_name]
    kw = dict(n_samples=n, max_pix=int(n / inv0 * 1.02) + 2, taps=taps, inv_nominal=inv0)
    env, writes, got, n_out, new_phase = k2_model(raw, tail, phase, inv, **kw)
    assert (writes == 1).all() and not np.isnan(got).any()
    je, jp, jn, jph = tpu_k2(jnp.asarray(raw), jnp.asarray(tail), jnp.int64(phase),
                             jnp.int64(inv), **kw)
    te, tp, tn, tph = k2.fused_demod_resample(torch.from_numpy(raw), torch.from_numpy(tail),
                                              torch.tensor(phase), torch.tensor(inv), **kw)
    assert n_out == int(jn) == int(tn) and new_phase == int(jph) == int(tph)
    np.testing.assert_array_equal(env, np.asarray(je))
    np.testing.assert_array_equal(env, te.numpy())
    np.testing.assert_allclose(got, np.asarray(jp), rtol=2e-5, atol=2e-5)
    assert np.abs(got - tp.numpy()).max() <= 2e-5
    if phase_name == "past the block":
        assert n_out == 0 and not got.any()
    else:
        assert n_out > 0 and got[:n_out].any() and not got[n_out:].any()


@pytest.mark.parametrize("inv_scale", PLL_ENDS + (1.0,))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_k2_tiles_own_every_envelope_sample_once(geometry, inv_scale):
    """K2's grid covers every pixel and every envelope sample; tile c owns
    the samples [1024c, 1024c + 1024) below n, whole 16-byte quads, so each
    sample is stored exactly once whatever the phase; and the tile's window
    is K1's, widened to an even start: it contains every tap of every
    complete pixel and starts within one sample of K1's."""
    cfg = GEOMETRIES[geometry]
    n, max_pix = cfg.block_samples, cfg.max_block_pixels
    inv = round(cfg.samples_per_pixel * inv_scale * ONE)
    margin, taps_eff = k1.k1_margin(cfg.samples_per_pixel, k2.TILE)
    tiles = k2_tiles(n, max_pix, k2.TILE)
    assert tiles * 2 * k2.TILE >= max_pix and tiles * k2.TILE >= n and n % 4 == 0
    writes = np.zeros(n, np.int64)
    for c in range(tiles):
        writes[min(c * k2.TILE, n):min((c + 1) * k2.TILE, n)] += 1
    assert (writes == 1).all()
    s = np.arange(k2.TILE)
    for phase in phases(n).values():
        num = n * ONE - phase
        for c in range(tiles):
            if valid_pixels(c * 2 * k2.TILE, 2 * k2.TILE, num, inv) == 0:
                continue  # no window decoded
            e0, w_len, par = k2_window(c, phase, inv, margin, taps_eff, k2.TILE)
            start, frac = chunk_bases(phase, inv, c * 2 * k2.TILE)
            assert e0 % 2 == 0 and par in (0, 1) and e0 + par == start - margin
            rel_e, rel_o, end_o = k1_ramp(frac, margin, inv)
            for rel, end in ((rel_e, rel_o), (rel_o, end_o)):
                i0 = np.clip(rel.astype(np.int32), 0, taps_eff - 2)
                assert (np.floor(rel) >= i0).all() and (end <= i0 + 2).all()
                assert (par + s + i0 + 1).max() < w_len


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_k2_window_fits_shared_memory_and_drifts_as_stated(geometry):
    """One decoded window per thread block without opting in to more than
    48 KB, four 256-thread blocks' to an SM; and the window's drift from the
    owned range over a block is what csrc/fused_demod_resample.cu states: a
    few samples at the nominal 64 MS/s rate, some 680 at the nominal 8 MS/s
    rate and up to 1,600 at the PLL's ends, more than a tile."""
    cfg = GEOMETRIES[geometry]
    margin, taps_eff = k1.k1_margin(cfg.samples_per_pixel, k2.TILE)
    window = k2_smem_bytes(taps_eff, k2.TILE)
    assert window == (k2.TILE + taps_eff + 1) * 4 <= 48 * 1024
    assert 4 * (window + 1024) <= SMEM_PER_SM
    last = -(-cfg.block_samples // k2.TILE) - 1

    def drift(inv_scale):
        inv = round(cfg.samples_per_pixel * inv_scale * ONE)
        e0, _, _ = k2_window(last, 0, inv, margin, taps_eff, k2.TILE)
        return e0 + margin - last * k2.TILE

    nominal = drift(1.0)
    assert 5 <= nominal <= 8 if geometry == "64MS/s" else 640 <= nominal <= 700
    assert 1024 < drift(PLL_ENDS[1]) <= 1650 and -1650 <= drift(PLL_ENDS[0]) < 0
