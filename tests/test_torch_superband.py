"""The port's superbandwidth stitching (tempestsdr_tpu_torch.superband) and
the superresolution session against the JAX package's on the CPU: lags
exact, the stitched stream within 1e-4 of its peak magnitude, the hop state
machine's retunes equal, frames within rtol/atol 1e-4."""

import numpy as np
import pytest
import jax.numpy as jnp

from tempestsdr_tpu import superband as jsb
from tempestsdr_tpu.config import PipelineConfig as JConfig
from tempestsdr_tpu.params import Params as JParams
from tempestsdr_tpu.sources.synthetic import SyntheticSource as JSynthetic
from tempestsdr_tpu.stream import session as jsession

from tempestsdr_tpu_torch import superband as tsb
from tempestsdr_tpu_torch.config import PipelineConfig
from tempestsdr_tpu_torch.params import Params
from tempestsdr_tpu_torch.sources.synthetic import SyntheticSource
from tempestsdr_tpu_torch.stream import session as tsession

STITCH_TOL = 1e-4  # of the peak magnitude: complex64 FFTs of 4n points, summed in
# different orders by pocketfft and by JAX's FFT


def _mod_signal(n, seed=0, period=512):
    """Frame-periodic AM signal with sharp envelope edges (like a raster) so
    the derivative correlator has structure to lock onto
    (tests/test_superband.py)."""
    rng = np.random.default_rng(seed)
    base = np.repeat(rng.random(max(period // 16, 1)) > 0.4, 16)[:period]
    env = np.tile(base, n // period + 1)[:n].astype(np.float32)
    env = 0.4 + 0.6 * env
    ph = 2 * np.pi * 0.05 * np.arange(n)
    return (env * np.exp(1j * ph)).astype(np.complex64)


def _aperiodic(n, seed):
    """A noisy envelope with no period: one lag aligns it."""
    rng = np.random.default_rng(seed)
    env = 0.3 + np.repeat(rng.random(n // 8), 8).astype(np.float32)
    noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.01
    return (env * np.exp(2j * np.pi * 0.03 * np.arange(n)) + noise).astype(np.complex64)


def test_abs_diff_keeps_the_reference_quirk():
    """The first 'previous' value is the squared magnitude."""
    import torch

    iq = _aperiodic(64, 1)
    got = tsb._abs_diff(torch.from_numpy(iq)).numpy()
    # |z| of a complex64 is one f32 ulp apart between the two libraries
    np.testing.assert_allclose(got, np.asarray(jsb._abs_diff(jnp.asarray(iq))), rtol=0, atol=5e-7)
    assert got[0] == pytest.approx(np.abs(iq[0]) - np.abs(iq[0]) ** 2, abs=5e-7)
    assert abs(got[0] - (np.abs(iq[0]) - 0.0)) > 0.1  # not a plain difference from zero


@pytest.mark.parametrize("true_lag", [0, 1, 37, 513, 1200, 4095])
@pytest.mark.parametrize("kind", ["periodic", "aperiodic"])
def test_best_alignment_returns_the_reference_lag(kind, true_lag):
    """The lag is the JAX package's EXACTLY (first-wins argmax over the full
    lag range), and rolling by it realigns the envelope."""
    n = 4096
    ref = _mod_signal(n) if kind == "periodic" else _aperiodic(n, 3)
    other = np.roll(ref, true_lag)
    lag = int(tsb.best_alignment(ref, other, device="cpu"))
    assert lag == int(jsb.best_alignment(jnp.asarray(ref), jnp.asarray(other)))
    assert lag % 512 == true_lag % 512 if kind == "periodic" else lag == true_lag
    np.testing.assert_allclose(np.abs(np.roll(other, -lag)), np.abs(ref), atol=1e-5)


def test_best_alignment_takes_a_stack():
    n = 2048
    ref = _aperiodic(n, 5)
    others = np.stack([np.roll(ref, s) for s in (3, 700, 2047)])
    assert tsb.best_alignment(ref, others, device="cpu").tolist() == [3, 700, 2047]


@pytest.mark.parametrize("shifts", [(0, 0, 0), (37, 513, 1200), (2047, 1, 1024)])
def test_stitch_hops_matches_jax(shifts):
    """Hops that are shifted, scaled copies plus noise: the stitched stream
    within STITCH_TOL of the peak magnitude of the JAX result."""
    n = 2048
    rng = np.random.default_rng(sum(shifts))
    sig = _aperiodic(n, 7)
    hops = [sig]
    for i, s in enumerate(shifts):
        noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.005
        hops.append((np.roll(sig, s) * (0.8 + 0.1 * i) + noise).astype(np.complex64))
    hops = np.stack(hops)
    want = np.asarray(jsb.stitch_hops(hops))
    got = tsb.stitch_hops(hops, device="cpu")
    assert got.shape == (4 * n,) and got.dtype == np.complex64
    assert np.abs(got - want).max() <= STITCH_TOL * np.abs(want).max()


def test_stitch_identical_hops_reproduces_upsampled_spectrum():
    n = 2048
    sig = _mod_signal(n, seed=1)
    out = tsb.stitch_hops(np.stack([sig] * 4), device="cpu")
    np.testing.assert_allclose(np.fft.fft(out)[:n] / (4 * n), np.fft.fft(sig) / n,
                               rtol=1e-3, atol=1e-5)


def test_state_machine_hops_and_retunes():
    """The same feed through both state machines: the reference's retune
    sequence, the stitched block at the same feed, within STITCH_TOL."""
    sig = _mod_signal(200_000, seed=2)
    outs, retunes = {}, {}
    for which, mod, kw in (("j", jsb, {}), ("t", tsb, dict(device="cpu"))):
        retunes[which] = []
        sb = mod.SuperBandwidth(samplerate=100_000, refreshrate=50.0,
                                retune=retunes[which].append, hops=4, **kw)
        assert sb.samples_to_gather == 10 * 2000 and sb.output_samplerate == 400_000
        for feed in range(2000):
            out = sb.feed(sig[(feed * 4096 + np.arange(4096)) % len(sig)])
            if out is not None:
                break
        outs[which] = (feed, out)
        assert out.shape == (4 * sb.n,)
    assert retunes["t"] == retunes["j"] == [-100_000.0, 0.0, 100_000.0, 0.0]
    assert outs["t"][0] == outs["j"][0]
    peak = np.abs(outs["j"][1]).max()
    assert np.abs(outs["t"][1] - outs["j"][1]).max() <= STITCH_TOL * peak


def test_drop_purges_current_hop_and_reset_retunes():
    retunes = []
    sb = tsb.SuperBandwidth(samplerate=50_000, refreshrate=50.0, hops=2,
                            retune=retunes.append, device="cpu")
    iq = _mod_signal(4096, seed=3)
    sb.feed(iq)
    assert sb._gathered == 4096
    sb.feed(iq, dropped=100)
    assert sb._gathered == 0
    sb.reset()
    assert retunes == [0.0]


@pytest.mark.parametrize("dtype", [np.float32, np.int8, np.uint8, np.int16, np.uint16])
def test_normalize_host_matches_jax(dtype):
    rng = np.random.default_rng(11)
    if dtype == np.float32:
        raw = rng.standard_normal(512).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        raw = rng.integers(info.min, info.max + 1, size=512).astype(dtype)
    np.testing.assert_array_equal(tsession._normalize_host(raw), jsession._normalize_host(raw))


def test_normalize_host_refuses_other_dtypes():
    with pytest.raises(TypeError):
        tsession._normalize_host(np.zeros(4, np.float64))


SR_NATIVE = 250_000


def _superres_frames(which, batch, n_frames=4):
    kw = dict(samplerate=4 * SR_NATIVE, height=60, refreshrate=50.0, block_samples=4096,
              autocorr=False)
    frames = []
    if which == "j":
        src = JSynthetic()
        src.init(f"60 40 50 {SR_NATIVE} 0.01")
        sess = jsession.Session(JConfig(**kw), JParams(superresolution=True, framerate_pll=False),
                                src, jsession.SessionCallbacks(on_frame=frames.append),
                                batch_blocks=batch)
    else:
        src = SyntheticSource()
        src.init(f"60 40 50 {SR_NATIVE} 0.01")
        sess = tsession.Session(PipelineConfig(**kw),
                                Params(superresolution=True, framerate_pll=False), src,
                                tsession.SessionCallbacks(on_frame=frames.append),
                                batch_blocks=batch, device="cpu")
    got = sess.run(max_frames=n_frames)
    assert got == len(frames) >= n_frames
    return frames, sess


@pytest.mark.parametrize("batch", [1, 3])
def test_superresolution_session_matches_jax(batch):
    """A 250 kS/s native source, 60 x 40 raster, block 4096
    (tests/test_superband.py:67-120): hops gathered, stitched to 4x rate and
    streamed through a 4x-rate pipeline; the frames of the JAX session
    within rtol/atol 1e-4 (the stitched stream's tolerance carried through
    autogain)."""
    tf, tsess = _superres_frames("t", batch)
    jf, _ = _superres_frames("j", batch)
    assert len(tf) == len(jf)
    assert tf[0].shape == (60, tsess.config.width) and np.isfinite(tf[-1]).all()
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_superresolution_needs_the_hops_rate():
    """A superresolution session whose config is not at hops x the native
    rate raises WRONG_VIDEOPARAMS, as in the JAX package."""
    from tempestsdr_tpu_torch.errors import TSDRError, TSDRStatus

    src = SyntheticSource()
    src.init(f"60 40 50 {SR_NATIVE} 0.01")
    cfg = PipelineConfig(samplerate=SR_NATIVE, height=60, refreshrate=50.0, block_samples=4096,
                         autocorr=False)
    sess = tsession.Session(cfg, Params(superresolution=True), src, device="cpu")
    with pytest.raises(TSDRError) as ei:
        sess.run(max_frames=1)
    assert ei.value.status == TSDRStatus.WRONG_VIDEOPARAMS
