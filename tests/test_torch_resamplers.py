"""The port's other resamplers against the JAX package on the CPU: the plain
chunked form (the plain version of K3 and K4) against the JAX chunked form
and against the TPU kernels K3/K4 in interpret mode, K2's plain version
against the TPU fused kernels (u32 and u16 layouts, interpret mode), and
the byte-pair demod, nearest-neighbour and FIR ops. Inputs come from numpy
with a seed; integer results are exact, floats within the tolerance stated
at each check. Every kernel wrapper runs its plain version on CPU tensors
and raises on any other device than CPU or CUDA."""

import importlib.util
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import jax.experimental.pallas as pl

from tempestsdr_tpu.config import FRAC_BITS
from tempestsdr_tpu import ops as jops
from tempestsdr_tpu.ops.fir import design_lowpass_fir as j_design, fir_apply_block as j_fir
from tempestsdr_tpu.pallas.fused_kernel import fused_demod_resample as j_fused

from tempestsdr_tpu_torch import ops as tops
from tempestsdr_tpu_torch.config import PLL_HEADROOM_FRAC
from tempestsdr_tpu_torch.kernels import (
    box_resample_range_strided_cuda,
    box_resample_pallas_cuda,
    box_resample_pallas_windows_cuda,
    box_resample_strided_cuda,
    fused_demod_resample_cuda,
    fused_demod_resample_u16_cuda,
)
from tempestsdr_tpu_torch.kernels.chunked_resample import (
    TILE,
    gather_windows,
    gather_windows_plain,
    group_tiles,
    k4_window_len,
    window_len,
)
from tempestsdr_tpu_torch.kernels.fused_demod_resample import fused_demod_resample

RATES = (1.99876, 1.5123, 0.71234)  # as tests/test_pallas.py:79
PHASE = -123456789


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """The TPU resample kernels in interpret mode (tests/test_pallas.py:14-25)."""
    import tempestsdr_tpu.pallas.resample_kernel as rk

    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(rk.pl, "pallas_call", interp)
    return rk


def _block(rate, seed=0, n=4096):
    rng = np.random.default_rng(seed)
    inv = 1.0 / rate
    taps = int(np.ceil(inv)) + 1
    x = np.concatenate([np.zeros(taps), rng.normal(size=n)]).astype(np.float32)
    kw = dict(n_samples=n, max_pix=int(n * rate) + 2, taps=taps, inv_nominal=inv)
    return x, round(inv * (1 << FRAC_BITS)), kw


def _both(fn_j, fn_t, x, inv_fix, kw, phase=PHASE):
    a, na, pa = fn_j(jnp.asarray(x), jnp.int64(phase), jnp.int64(inv_fix), **kw)
    b, nb, pb = fn_t(torch.from_numpy(x), torch.tensor(phase), torch.tensor(inv_fix), **kw)
    assert int(na) == int(nb) and int(pa) == int(pb)
    assert nb.dtype == torch.int32 and pb.dtype == torch.int64
    return np.asarray(a), _np(b)


@pytest.mark.parametrize("rate", RATES)
def test_chunked_matches_jax_chunked(rate):
    """Same windows and f32 ramp as the JAX chunked form; only the final
    reduction sums in another order: pixels within 2e-5."""
    x, inv_fix, kw = _block(rate)
    a, b = _both(jops.box_resample_block_chunked, tops.box_resample_block_chunked, x, inv_fix, kw)
    np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("kernel", ["box_resample_pallas", "box_resample_pallas_windows"])
def test_chunked_matches_jax_k3_k4_interpret(interpret_pallas, kernel, rate):
    """Against the TPU kernels K3/K4 themselves (interpret mode): their
    24-bit fracs (K3) and window ramps differ from the chunked form, so
    3e-4, the tolerance of tests/test_pallas.py:99."""
    x, inv_fix, kw = _block(rate)
    a, b = _both(getattr(interpret_pallas, kernel), tops.box_resample_block_chunked, x,
                 inv_fix, kw)
    np.testing.assert_allclose(b, a, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("phase", [PHASE, -(1 << FRAC_BITS) - 12345, 4000 << FRAC_BITS])
@pytest.mark.parametrize("rate", RATES)
def test_gathered_windows_feed_k4_as_jax(interpret_pallas, rate, phase):
    """K4's inputs on the CPU: gather_windows, at the row width padded to a
    multiple of 4, with the TPU kernel's own weights and reduction
    (resample_kernel.py:58-67, in torch) gives the pixels of the TPU K4 in
    interpret mode within 3e-4 (tests/test_pallas.py:99; the padding
    columns get weight 0), as does the wrapper's CPU path; carries exact."""
    x, inv_fix, kw = _block(rate)
    a, b = _both(interpret_pallas.box_resample_pallas_windows, box_resample_pallas_windows_cuda,
                 x, inv_fix, kw, phase=phase)
    np.testing.assert_allclose(b, a, rtol=3e-4, atol=3e-4)
    xt, pt, it = torch.from_numpy(x), torch.tensor(phase), torch.tensor(inv_fix)
    windows, fracs = gather_windows(xt, pt, it, max_pix=kw["max_pix"], taps=kw["taps"],
                                    inv_nominal=kw["inv_nominal"])
    w_in = k4_window_len(kw["inv_nominal"], kw["taps"])
    assert windows.shape == (-(-kw["max_pix"] // TILE), w_in) and w_in % 4 == 0
    assert 0 <= w_in - window_len(kw["inv_nominal"], kw["taps"]) < 4
    inv_f = it.to(torch.float32) * 2.0 ** (-FRAC_BITS)
    pos = fracs[:, None, None] + torch.arange(TILE, dtype=torch.float32)[None, None, :] * inv_f
    jj = torch.arange(w_in, dtype=torch.float32)[None, :, None]
    w = torch.clamp(torch.minimum(pos + inv_f, jj + 1.0) - torch.maximum(pos, jj), min=0.0)
    pixels = (w * windows[:, :, None]).sum(dim=1).reshape(-1)[:kw["max_pix"]] * (1.0 / inv_f)
    n_out, _ = tops.resample_counts(pt, it, kw["n_samples"])
    pixels = torch.where(torch.arange(kw["max_pix"]) < n_out, pixels, torch.zeros(()))
    np.testing.assert_allclose(_np(pixels), a, rtol=3e-4, atol=3e-4)


def _load_u16_probe():
    # bench/ the directory is shadowed by bench.py the module: load by path
    path = os.path.join(os.path.dirname(__file__), "..", "bench", "fused_u16_probe.py")
    spec = importlib.util.spec_from_file_location("fused_u16_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.fused_demod_resample_u16


@pytest.mark.parametrize("layout", ["u32", "u16"])
@pytest.mark.parametrize("dtype", ["uint8", "int8"])
def test_fused_plain_matches_jax_fused_kernels(dtype, layout):
    """K2's plain version against the TPU fused kernels (interpret mode on
    the CPU), as tests/test_pallas.py:30-76 holds them: envelope exact,
    carries exact, pixels within 2e-5."""
    fn_j = j_fused if layout == "u32" else _load_u16_probe()
    rng = np.random.default_rng(7)
    n, inv0, taps = 1 << 14, 0.500004, 2
    raw = rng.integers(0, 256, size=2 * n).astype(np.uint8)
    if dtype == "int8":
        raw = raw.view(np.int8)
    tail = rng.normal(size=taps).astype(np.float32)
    inv_fix = round(inv0 * (1 << FRAC_BITS)) + 777
    kw = dict(n_samples=n, max_pix=int(n / inv0 * 1.02) + 2, taps=taps, inv_nominal=inv0)
    je, jp, jn, jph = fn_j(jnp.asarray(raw), jnp.asarray(tail), jnp.int64(-987654321),
                           jnp.int64(inv_fix), **kw)
    te, tp, tn, tph = fused_demod_resample(torch.from_numpy(raw), torch.from_numpy(tail),
                                           torch.tensor(-987654321), torch.tensor(inv_fix), **kw)
    assert int(jn) == int(tn) and int(jph) == int(tph)
    np.testing.assert_array_equal(_np(te), np.asarray(je))
    np.testing.assert_allclose(_np(tp), np.asarray(jp), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int16", "uint16", "float32"])
def test_demod_raw_interleaved_bit_exact(dtype):
    """Bit-exact against the JAX byte-pair decode for every format, and
    equal to am_demod(normalize_iq) for uint8/int8 (what K2 relies on)."""
    rng = np.random.default_rng(3)
    if dtype == "float32":
        raw = rng.normal(size=8192).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        raw = rng.integers(info.min, int(info.max) + 1, size=8192).astype(dtype)
    got = _np(tops.demod_raw_interleaved(torch.from_numpy(raw)))
    np.testing.assert_array_equal(got, np.asarray(jops.demod_raw_interleaved(jnp.asarray(raw))))
    if dtype in ("uint8", "int8"):
        np.testing.assert_array_equal(
            got, _np(tops.am_demod(tops.normalize_iq(torch.from_numpy(raw)))))


@pytest.mark.parametrize("phase", [PHASE, 0, 3000 << FRAC_BITS])
@pytest.mark.parametrize("rate", RATES)
def test_nn_resample_block_exact(rate, phase):
    """Nearest-neighbour: pixels (a pure gather) and carries exact, for
    upsampling and downsampling, including a drop skip (n_out == 0)."""
    x, inv_fix, kw = _block(rate, seed=4)
    kw = dict(n_samples=kw["n_samples"], max_pix=kw["max_pix"])
    n = kw["n_samples"]
    a, b = _both(jops.nn_resample_block, tops.nn_resample_block, x[x.shape[0] - n:], inv_fix,
                 kw, phase=phase)
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("ntaps,cutoff", [(15, 0.98), (31, 0.98), (31, 0.4)])
def test_design_lowpass_fir_exact(ntaps, cutoff):
    np.testing.assert_array_equal(tops.design_lowpass_fir(ntaps, cutoff), j_design(ntaps, cutoff))


@pytest.mark.parametrize("ntaps", [15, 31])
def test_fir_apply_block_streams(ntaps):
    """Three streamed blocks: tails exact; outputs are 15-31-term f32 sums
    in another order (conv1d vs lax.conv): rtol 1e-6, plus atol 3e-7
    (about 2 ulps at the inputs' magnitude) where a sum cancels towards 0."""
    rng = np.random.default_rng(5)
    h = j_design(ntaps, 0.98)
    jt = np.zeros(ntaps - 1, np.float32)
    tt = torch.zeros(ntaps - 1)
    for _ in range(3):
        x = rng.random(8192).astype(np.float32)
        jy, jt = j_fir(jnp.asarray(x), jnp.asarray(jt), jnp.asarray(h))
        ty, tt = tops.fir_apply_block(torch.from_numpy(x), tt, torch.from_numpy(h))
        np.testing.assert_array_equal(_np(tt), np.asarray(jt))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-6, atol=3e-7)


def _resample_args(rate=RATES[0]):
    x, inv_fix, kw = _block(rate, seed=6)
    return (torch.from_numpy(x), torch.tensor(PHASE), torch.tensor(inv_fix)), kw


def _fused_args():
    rng = np.random.default_rng(8)
    n, taps = 8192, 2
    raw = torch.from_numpy(rng.integers(0, 256, size=2 * n).astype(np.uint8))
    kw = dict(n_samples=n, max_pix=int(n / 0.5 * 1.02) + 2, taps=taps, inv_nominal=0.500004)
    return (raw, torch.zeros(taps), torch.tensor(PHASE),
            torch.tensor(round(0.500004 * (1 << FRAC_BITS)))), kw


def _gather_args():
    args, kw = _resample_args(RATES[1])
    return args, {k: v for k, v in kw.items() if k != "n_samples"}


def _range_args():
    """One time shard of a block: shard 1 of 4, as the time-sharded step
    hands it to K1's range entry."""
    rng = np.random.default_rng(9)
    S, taps, inv0 = 2048, 2, 0.500004
    inv = round(inv0 * (1 << FRAC_BITS))
    x_local = torch.from_numpy((rng.random(S + 2 * taps) * 1.5).astype(np.float32))
    p0, p1 = -((PHASE - (S << FRAC_BITS)) // inv), -((PHASE - ((2 * S) << FRAC_BITS)) // inv)
    return ((x_local, torch.tensor(PHASE), torch.tensor(inv), torch.tensor(p0), torch.tensor(p1),
             torch.tensor(S)), dict(max_pix=int(S / inv0 * 1.02) + 2, taps=taps, inv_nominal=inv0))


def _outputs(r):
    return r if isinstance(r, tuple) else (r,)


WRAPPERS = {
    "K1": (box_resample_strided_cuda, tops.box_resample_strided,
           lambda: _resample_args(1 / 0.500004)),
    "K2": (fused_demod_resample_cuda, fused_demod_resample, _fused_args),
    "K2'": (fused_demod_resample_u16_cuda, fused_demod_resample, _fused_args),
    "K3": (box_resample_pallas_cuda, tops.box_resample_block_chunked,
           lambda: _resample_args(RATES[1])),
    "K4": (box_resample_pallas_windows_cuda, tops.box_resample_block_chunked,
           lambda: _resample_args(RATES[2])),
    "gather": (gather_windows, gather_windows_plain, _gather_args),
    "K1 range": (box_resample_range_strided_cuda, tops.box_resample_range_strided, _range_args),
}


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_wrapper_on_cpu_runs_plain_version(kernel):
    """CPU tensors take the plain version (identical outputs) and count no
    launch."""
    wrapper, plain, make = WRAPPERS[kernel]
    args, kw = make()
    before = wrapper.launches
    for got, want in zip(_outputs(wrapper(*args, **kw)), _outputs(plain(*args, **kw))):
        assert torch.equal(got, want)
    assert wrapper.launches == before


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_wrapper_raises_off_cpu_and_cuda(kernel):
    """A tensor on neither the CPU nor a CUDA device (here "meta") raises:
    a wrapper never carries on with the plain version there."""
    wrapper, _, make = WRAPPERS[kernel]
    args, kw = make()
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*(a.to("meta") for a in args), **kw)


@pytest.mark.parametrize("inv0", [0.5000040625330081, 0.5007410968232985, 1 / 1.5123, 1.4038])
def test_k3_window_covers_pll_headroom(inv0):
    """Every pixel window of a 256-pixel tile, [pos, pos + inv) with
    pos = frac + r*inv, lies inside K3/K4's w_in-sample window at the PLL
    headroom's extreme rates, so the kernels' per-pixel sample range never
    runs past the window; and in K3's window of a group of tiles, which
    starts at the first tile's, every tile's own window start plus its
    pixels' reach stays inside the group's w_grp samples."""
    taps = int(np.ceil(inv0 * 1.02)) + 1
    w_in = window_len(inv0, taps)
    tiles = group_tiles(inv0, taps)
    w_grp = window_len(inv0, taps, tiles)
    assert tiles == 8 and w_grp >= w_in
    r = np.arange(TILE)
    for f in (1 - PLL_HEADROOM_FRAC, 1 + PLL_HEADROOM_FRAC / (1 - PLL_HEADROOM_FRAC)):
        inv = inv0 * f
        for frac in (0.0, 0.999999):
            end = frac + r * inv + inv
            assert np.floor(end).max() <= w_in - 1
            for t in range(tiles):
                # tile t's window starts d samples into the group's, frac_t into a sample
                d, frac_t = divmod(frac + t * TILE * inv, 1.0)
                assert d + np.floor(frac_t + r * inv + inv).max() <= w_grp - 1
