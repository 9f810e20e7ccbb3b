"""The port's ops (tempestsdr_tpu_torch.ops, kernels) against their JAX
counterparts on the CPU: the same numpy inputs, made from a seed, through
both; integer results exact, floats within the tolerance stated at each
check."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tempestsdr_tpu.config import FRAC_BITS
from tempestsdr_tpu import ops as jops
from tempestsdr_tpu.ops.resample import resample_counts as j_resample_counts
from tempestsdr_tpu.ops.resample import plan_strided as j_plan_strided
from tempestsdr_tpu.pallas.strided_kernel import box_resample_strided_pallas
from tempestsdr_tpu.ops.sync import PLLState as JPLL, SweetspotState as JSS
from tempestsdr_tpu.ops.sync import _iir_track as j_iir
from tempestsdr_tpu.ops.sync import framerate_pll as j_pll

from tempestsdr_tpu_torch import ops as tops
from tempestsdr_tpu_torch.ops.resample import plan_strided as t_plan_strided
from tempestsdr_tpu_torch.ops.sync import PLLState as TPLL, SweetspotState as TSS
from tempestsdr_tpu_torch.kernels.strided_resample import box_resample_strided_cuda

RAW_RANGES = {
    "uint8": (0, 256), "int8": (-128, 128), "int16": (-32768, 32768),
    "uint16": (0, 65536),
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int16", "uint16", "float32"])
def test_demod_bit_exact(dtype):
    """normalize_iq + am_demod: bit-exact for every raw format (the /2^k
    scalings are exact, and the JAX pairing matmul and the port's i*i+q*q
    each round once)."""
    rng = np.random.default_rng(0)
    if dtype == "float32":
        raw = rng.normal(size=8192).astype(np.float32)
    else:
        lo, hi = RAW_RANGES[dtype]
        raw = rng.integers(lo, hi, size=8192).astype(dtype)
    want = np.asarray(jops.am_demod(jops.normalize_iq(jnp.asarray(raw))))
    got = _np(tops.am_demod(tops.normalize_iq(torch.from_numpy(raw))))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_np(tops.normalize_iq(torch.from_numpy(raw))),
                                  np.asarray(jops.normalize_iq(jnp.asarray(raw))))


@pytest.mark.parametrize("phase", [-(3 << 38), 0, 5 << 40, 40000 << 40])
@pytest.mark.parametrize("scale", [1.0, 1.001, 1 / 1.001])
def test_resample_counts_exact(phase, scale):
    """n_out and the new phase are exact int64 for negative, positive and
    drop-skip (far past the block) phases."""
    inv = round(0.500004 * scale * (1 << FRAC_BITS))
    n = 8192
    jn, jp = j_resample_counts(jnp.int64(phase), jnp.int64(inv), n)
    tn, tp = tops.resample_counts(torch.tensor(phase), torch.tensor(inv), n)
    assert int(jn) == int(tn) and int(jp) == int(tp)
    assert tn.dtype == torch.int32 and tp.dtype == torch.int64


@pytest.mark.parametrize("inv0", [0.500004, 0.5007411, 0.3333, 0.25, 1.2])
def test_plan_strided_matches(inv0):
    assert t_plan_strided(inv0, 2) == j_plan_strided(inv0, 2)


def _stream_resample(fn_j, fn_t, tol, seed=15):
    """Three streamed blocks at rate scales 1, 1.001 and 1/1.001 (as
    tests/test_ops.py does for the JAX kernels): carries exact, pixels
    within `tol`."""
    rng = np.random.default_rng(seed)
    n = 1 << 14
    inv0 = 0.500004
    taps = 2
    max_pix = int(n / inv0 * 1.02) + 2
    for scale in (1.0, 1.001, 1 / 1.001):
        inv = round(inv0 * scale * (1 << FRAC_BITS))
        pj = pt = 0
        tail = np.zeros(taps, np.float32)
        for _ in range(3):
            x = np.concatenate([tail, rng.normal(size=n).astype(np.float32)])
            a, na, pj = fn_j(jnp.asarray(x), jnp.int64(pj), jnp.int64(inv), n_samples=n,
                             max_pix=max_pix, taps=taps, inv_nominal=inv0)
            b, nb, pt = fn_t(torch.from_numpy(x), torch.tensor(pt), torch.tensor(inv),
                             n_samples=n, max_pix=max_pix, taps=taps, inv_nominal=inv0)
            assert int(na) == int(nb) and int(pj) == int(pt)
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=tol, atol=tol)
            pj, pt = int(pj), int(pt)
            tail = x[x.shape[0] - taps:]


def test_strided_matches_jax_strided():
    """The port's plain strided form keeps the JAX form's windows and float
    order: pixels within 1e-6 (bit-equal in practice)."""
    _stream_resample(jops.box_resample_strided, tops.box_resample_strided, 1e-6)


def test_strided_matches_jax_pallas_kernel_interpret():
    """Against K1 itself (the Pallas kernel in interpret mode on the CPU):
    its rel ramp and drift margin differ from the XLA form, so 4e-4, the
    tolerance tests/test_ops.py holds K1 to."""
    _stream_resample(box_resample_strided_pallas, tops.box_resample_strided, 4e-4)


def test_k1_wrapper_on_cpu_runs_plain_version():
    """CPU tensors take the plain version and count no launch."""
    before = box_resample_strided_cuda.launches
    _stream_resample(jops.box_resample_strided, box_resample_strided_cuda, 1e-6)
    assert box_resample_strided_cuda.launches == before


def test_k1_margin_covers_pll_headroom():
    """K1's tap loop spans the pixel windows of every sample of a tile at
    the PLL headroom's extreme rates (no fallback branch is needed)."""
    from tempestsdr_tpu_torch.config import PLL_HEADROOM_FRAC
    from tempestsdr_tpu_torch.kernels.strided_resample import TILE, k1_margin

    for inv0 in (0.5000040625330081, 0.5007410968232985):
        margin, taps_eff = k1_margin(inv0)
        for f in (1 - PLL_HEADROOM_FRAC / (1 + PLL_HEADROOM_FRAC),
                  1 + PLL_HEADROOM_FRAC / (1 - PLL_HEADROOM_FRAC)):
            inv = inv0 * f
            s = np.arange(TILE)
            for frac in (0.0, 0.999999):
                rel = margin + frac + s * (2 * inv - 1)
                assert rel.min() >= 0 and (rel + 2 * inv).max() <= taps_eff
                # the kernel reads taps floor(rel) and floor(rel)+1 of both parities
                assert np.floor(rel + inv).max() + 1 <= taps_eff - 1


def test_autocorrelation_matches():
    """complex64 FFT round trip: pocketfft orders its sums differently from
    JAX's, so rtol 1e-5 of the peak."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=1 << 14).astype(np.float32)
    want = np.asarray(jops.autocorrelation_magnitude(jnp.asarray(x)))
    got = _np(tops.autocorrelation_magnitude(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())
    avg = rng.random(64).astype(np.float32)
    new = rng.random(64).astype(np.float32)
    for calls in (0, 1, 3):
        np.testing.assert_array_equal(
            _np(tops.accumulate_running_mean(torch.from_numpy(avg), torch.from_numpy(new), calls)),
            np.asarray(jops.accumulate_running_mean(jnp.asarray(avg), jnp.asarray(new), calls)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gaussian_blur_bit_exact(dtype):
    x = np.random.default_rng(2).normal(size=401).astype(dtype)
    np.testing.assert_array_equal(
        _np(tops.gaussian_blur_circular(torch.from_numpy(x))),
        np.asarray(jops.gaussian_blur_circular(jnp.asarray(x))))


@pytest.mark.parametrize("special", [False, True])
def test_autogain_matches(special):
    """Min/max tracking is exact; the SNR sums are f32 sums in another order
    (rtol 1e-5)."""
    rng = np.random.default_rng(3)
    f = rng.random((50, 64)).astype(np.float32)
    if special:
        f[0, 0] = 512.0  # element 0 seeds min/max even when special
        f[7, 9] = -1024.0
    jo, jmn, jmx, jsnr = jops.autogain_run(jnp.asarray(f), jnp.float32(0.1), jnp.float32(0.8))
    to, tmn, tmx, tsnr = tops.autogain_run(torch.from_numpy(f), torch.tensor(0.1),
                                           torch.tensor(0.8))
    assert float(jmn) == float(tmn) and float(jmx) == float(tmx)
    np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tsnr), float(jsnr), rtol=1e-5)


@pytest.mark.parametrize("precise,widen", [(True, True), (False, True), (False, False)])
def test_collapse_and_lowpass(precise, widen):
    """Profiles are sums in another order: rtol 1e-12 in f64, 1e-5 in f32."""
    f = np.random.default_rng(4).random((50, 64)).astype(np.float32)
    jw, jh = jops.collapse_v_h(jnp.asarray(f), precise, widen=widen)
    tw, th = tops.collapse_v_h(torch.from_numpy(f), precise, widen=widen)
    assert str(tw.dtype).endswith(str(np.asarray(jw).dtype))
    tol = 1e-12 if precise else 1e-5
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=tol)
    np.testing.assert_allclose(_np(th), np.asarray(jh), rtol=tol)
    s = np.random.default_rng(5).random((50, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tops.time_lowpass(torch.from_numpy(s), torch.from_numpy(f), 0.3)),
        np.asarray(jops.time_lowpass(jnp.asarray(s), jnp.asarray(f), 0.3)))


def _strip_profile(n, start, width, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    p = 10.0 + rng.random(n)
    p[np.arange(start, start + width) % n] -= 8.0
    return p.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sweet_spot_exact(dtype):
    """Strip search: stripsize, dx and vx exact over a tracked sequence."""
    n = 400
    js, ts = JSS.init(), TSS.init("cpu")
    for i, (start, width) in enumerate([(300, 60), (303, 60), (310, 58), (2, 40), (395, 30)]):
        p = _strip_profile(n, start, width, i, dtype)
        js, jb, jstart = jops.find_the_sweet_spot(js, jnp.asarray(p), 20, 0.9)
        ts, tb, tstart = tops.find_the_sweet_spot(ts, torch.from_numpy(p), 20, 0.9)
        assert [int(v) for v in js] == [int(v) for v in ts], i
        assert int(jstart) == int(tstart)
        np.testing.assert_array_equal(_np(tb), np.asarray(jb))
        fit_j = jops.find_best_fit(jnp.asarray(p), jnp.sum(jnp.asarray(p)), 40)
        fit_t = tops.find_best_fit(torch.from_numpy(p), torch.from_numpy(p).sum(), 40)
        assert int(fit_j[1]) == int(fit_t[1])


@pytest.mark.parametrize("dtype,n,coeff", [(np.float64, 3397, 0.9), (np.float64, 628, 0.1),
                                           (np.float32, 3397, 0.9), (np.float32, 628, 0.1)])
def test_iir_track_rounds_as_the_compiled_jax_step(dtype, n, coeff):
    """The strip-centre IIR over every tracked centre and detected centre
    within a quarter of the profile of each other (a leading axis of
    states), against the JAX package's blend as its step compiles it (one
    fused multiply-add): dx and vx exact, the blends that land on a half
    included, at both axes' coefficients, in f64 and in fast_sync's f32."""
    dx0, d = np.meshgrid(np.arange(0, n, 7), np.arange(-n // 4, n // 4))
    start = ((dx0 + d) % n).astype(np.int32).ravel()
    dx0 = dx0.astype(np.int32).ravel()
    size = np.full_like(dx0, 0)
    want = jax.jit(lambda st, a, b: j_iir(st, a, b, n, coeff, jnp.dtype(dtype)))(
        JSS(jnp.asarray(size), jnp.asarray(dx0), jnp.asarray(size)), jnp.asarray(size),
        jnp.asarray(start))
    t = {np.float64: torch.float64, np.float32: torch.float32}[dtype]
    got = tops.sync._iir_track(
        TSS(torch.from_numpy(size), torch.from_numpy(dx0), torch.from_numpy(size)),
        torch.from_numpy(size), torch.from_numpy(start), n, coeff, dt=t)
    # the grid holds blends on a half that two roundings resolve the other way
    separate = np.round(start.astype(dtype) * dtype(coeff)
                        + (dtype(1) - dtype(coeff)) * dx0.astype(dtype)) % n
    assert (separate != np.asarray(want.dx)).sum() > 0
    np.testing.assert_array_equal(_np(got.dx), np.asarray(want.dx))
    np.testing.assert_array_equal(_np(got.vx), np.asarray(want.vx))


def test_fast_sync_window_sums_round_once():
    """fast_sync's window sums (differences of the doubled running sum) and
    total are each rounded to f32 once, from sums accumulated in f64: equal
    to the f32 rounding of the exact sums at the flagship width (3397
    columns of ~400), where an f32 running sum would be off by up to 0.25.
    The window search's f64 form takes the same running sum."""
    x = (np.random.default_rng(6).random(3397) * 400 + 200).astype(np.float32)
    csum = tops.sync._doubled_cumsum(torch.from_numpy(x))
    exact = np.concatenate([[0.0], np.cumsum(np.concatenate([x, x]).astype(np.float64))])
    assert csum.dtype == torch.float64
    for s in (169, 338, 1352):
        got = (csum[s:s + 3397] - csum[:3397]).to(torch.float32)
        want = (exact[s:s + 3397] - exact[:3397]).astype(np.float32)
        np.testing.assert_array_equal(_np(got), want)
    f32 = np.cumsum(np.concatenate([x, x]))  # the f32 running sum: off by more
    assert np.abs(f32 - exact[1:]).max() > 0.05


def _quiet_strip_profile(n, start, width, seed, quiet):
    """A raster's column profile at a video level of ~400 with a blanking
    strip at 50 whose noise is `quiet`: the quieter the strip, the closer
    the windows sliding inside it come to a tie."""
    rng = np.random.default_rng(seed)
    x = np.arange(n)
    p = 400.0 + 30.0 * np.sin(0.37 * x + seed) + 20.0 * rng.random(n)
    inside = (x - start) % n < width
    p[inside] = 50.0 + quiet * rng.random(int(inside.sum()))
    return p.astype(np.float32)


@pytest.mark.parametrize("quiet", [20.0, 1.0, 0.01])
def test_fast_sync_at_flagship_width_against_jax(quiet):
    """fast_sync at 3397 columns against the JAX package's f32 search and
    the f64 search (the default), one search from a cold and from a tracked
    state per profile. The port departs from the JAX fast_sync on purpose:
    its window sums are rounded once from an f64 running sum, where the
    JAX form differences an f32 running sum whose rounding (up to 0.25
    here) exceeds the gap between windows inside a quiet blanking strip, so
    that its winner depends on the order of the additions. Held: the f64
    searches agree exactly; with a strip as noisy as the video all three
    agree; the port's fast_sync departs from the f64 search no more often
    than the JAX fast_sync does. The counts of disagreement are printed."""
    n, key = 3397, (lambda r: tuple(int(v) for v in r[0]) + (int(r[2]),))
    jsearch = jax.jit(jops.find_the_sweet_spot, static_argnums=(2, 3))
    differ = {"jax f32 vs port f32": 0, "jax f32 vs f64": 0, "port f32 vs f64": 0}
    cases = 0
    for seed in range(20):
        p = _quiet_strip_profile(n, (seed * 97) % n, 338 + seed % 7, seed, quiet)
        for st in [(0, 0, 0), (338, (seed * 97 + 169) % n, 0)]:
            js = JSS(*(jnp.int32(v) for v in st))
            ts = TSS(*(torch.tensor(v, dtype=torch.int32) for v in st))
            j32 = key(jsearch(js, jnp.asarray(p), 20, 0.9))
            t32 = key(tops.find_the_sweet_spot(ts, torch.from_numpy(p), 20, 0.9))
            j64 = key(jsearch(js, jnp.asarray(p.astype(np.float64)), 20, 0.9))
            t64 = key(tops.find_the_sweet_spot(ts, torch.from_numpy(p.astype(np.float64)),
                                               20, 0.9))
            assert t64 == j64, (seed, st)
            differ["jax f32 vs port f32"] += j32 != t32
            differ["jax f32 vs f64"] += j32 != j64
            differ["port f32 vs f64"] += t32 != j64
            cases += 1
    print(f"quiet {quiet}: {cases} searches, disagreements {differ}")
    if quiet >= 20.0:
        assert set(differ.values()) == {0}, differ
    assert differ["port f32 vs f64"] <= differ["jax f32 vs f64"], differ


@pytest.mark.parametrize("enabled", [True, False])
def test_framerate_pll_matches(enabled):
    """Lock flag exact, the f64 average and the f32 delta bit-equal, with
    the clamp to the static headroom."""
    jp, tp = JPLL.init(), TPLL.init("cpu")
    for vx in [3, 3, -2, 0, 1, 400, 400, 400, 0, 0, -1]:
        jp = j_pll(jp, jnp.int32(vx), enabled=enabled, max_delta=0.002 * 50.0)
        tp = tops.framerate_pll(tp, torch.tensor(vx, dtype=torch.int32), enabled=enabled,
                                max_delta=0.002 * 50.0)
        assert bool(jp.locked) == bool(tp.locked)
        assert float(jp.avg_speed) == float(tp.avg_speed)
        assert float(jp.refresh_delta) == float(tp.refresh_delta)
    assert tp.avg_speed.dtype == torch.float64 and tp.refresh_delta.dtype == torch.float32
