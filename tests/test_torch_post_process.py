"""The frame post-process kernels (tempestsdr_tpu_torch/kernels/
post_process.py) and their plain version (stream/pipeline.py
_post_process_default_order) on the CPU: the plain version bit for bit
against the default-order chain as the step ran it before the kernels (a
frozen copy below, built from ops/frame.py and ops/sync.py), on one frame
[H, W] and on stacks [8, H, W] at the two widths the benchmark runs (849
and 3397 pixels a line), the carries chained through K = 4 emit slots, with
autoshift, markers and the PLL on and off; a numpy model of the kernels'
own arithmetic (their tiles, fixed-order sums, block scan and argmax)
against the plain version, at those widths and at a superresolution
pipeline's 13,588; the kernels' tiling; which post-process the step picks
for which Params; what the CUDA entry refuses; and the plain version and
the device step under the host-read guard. The kernels themselves run only
on the card (chip_smoke.py's "post-process kernels" line holds them to the
plain version there)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from tempestsdr_tpu_torch.config import (
    NORMALISATION_LOWPASS_COEFF,
    PIXEL_SPECIAL_VALUE_G,
    PLL_HEADROOM_FRAC,
    PipelineConfig,
)
from tempestsdr_tpu_torch.kernels import post_process as pp
from tempestsdr_tpu_torch.ops.frame import autogain_run, collapse_v_h, time_lowpass
from tempestsdr_tpu_torch.ops.gaussian import _coeffs
from tempestsdr_tpu_torch.ops.sync import (
    FRAMERATE_DX_LOWPASS_COEFF_HEIGHT,
    FRAMERATE_DX_LOWPASS_COEFF_WIDTH,
    PLLState,
    SweetspotState,
    _fused_blend,
    find_the_sweet_spot,
    framerate_pll,
)
from tempestsdr_tpu_torch.params import Params
from tempestsdr_tpu_torch.sources.synthetic import render_test_pattern
from tempestsdr_tpu_torch.stream import init_state, make_step
from tempestsdr_tpu_torch.stream import pipeline as tpipe
from tempestsdr_tpu_torch.stream.pipeline import StepControls

from torch_host_guard import no_host_reads
from test_torch_device_step import one_torch_thread  # noqa: F401 (autouse)

REFRESH = 60.0
SLOTS = 4  # emit slots a block at 8 x 16 MS/s
FLAGS = {  # name -> (autoshift, markers, pll_enabled)
    "default": (False, False, True),
    "autoshift": (True, False, True),
    "markers": (False, True, True),
    "pll_off": (False, False, False),
}
SHAPES = [(628, 849), (628, 3397), (8, 628, 849), (8, 96, 3397)]
plain = tpipe._post_process_default_order


def spec_for(h, w, flags):
    autoshift, markers, pll_enabled = FLAGS[flags]
    return pp.PostSpec(int(w * np.float32(0.05)), int(h * np.float32(0.01)), pll_enabled,
                       PLL_HEADROOM_FRAC * REFRESH, autoshift, markers)


def chain_as_it_was(frame, screen, ag, sync_x, sync_y, pll, motionblur, spec):
    """The step's default-order post-process before the kernels
    (stream/pipeline.py _post_process_default_order with _collapse,
    _sync_positions and _sync_apply at f64 profiles), frozen."""
    f = frame
    _, mn, mx, snr = autogain_run(f, ag[0], ag[1], NORMALISATION_LOWPASS_COEFF, stats_only=True)
    wprof, hprof = collapse_v_h(f, True)
    sx, _, _ = find_the_sweet_spot(sync_x, wprof, spec.minsize_x, FRAMERATE_DX_LOWPASS_COEFF_WIDTH)
    sy, _, _ = find_the_sweet_spot(sync_y, hprof, spec.minsize_y,
                                   FRAMERATE_DX_LOWPASS_COEFF_HEIGHT)
    pll = framerate_pll(pll, sx.vx, enabled=spec.pll_enabled, max_delta=spec.max_delta)
    span = torch.where(mx == mn, torch.ones_like(mx), mx - mn)
    norm = (f - mn[..., None, None]) / span[..., None, None]
    h, w = norm.shape[-2:]
    if spec.autoshift:
        rows = torch.remainder(torch.arange(h) + sy.dx[..., None], h)
        cols = torch.remainder(torch.arange(w) + sx.dx[..., None], w)
        out = torch.take_along_dim(norm, rows[..., :, None], dim=-2)
        syncres = torch.take_along_dim(out, cols[..., None, :], dim=-1)
    elif spec.markers:
        col = torch.arange(w, dtype=torch.int32) == sx.dx[..., None, None]
        row = torch.arange(h, dtype=torch.int32)[:, None] == sy.dx[..., None, None]
        syncres = torch.where(col | row, PIXEL_SPECIAL_VALUE_G, norm)
    else:
        syncres = norm
    screen = time_lowpass(screen, syncres, motionblur)
    return screen, screen, (mn, mx, snr), sx, sy, pll


def emanation_frames(shape, n, seed):
    """n frames [*shape]: a raster with blanking strips that drifts a few
    pixels a frame, plus noise, with a few special pixels planted (element
    0 of some frames among them)."""
    rng = np.random.default_rng(seed)
    *lead, h, w = shape
    base = render_test_pattern(h, w, seed=seed)
    out = []
    for k in range(n):
        f = np.empty(shape, np.float32)
        for i in np.ndindex(*lead):
            shifted = np.roll(base, (3 * k + int(rng.integers(0, 3)), 5 * k + sum(i)), axis=(0, 1))
            f[i] = shifted + rng.normal(0.0, 0.02, (h, w)).astype(np.float32)
        flat = f.reshape(-1, h * w)
        for row in flat:
            at = rng.integers(0, h * w, 7)
            row[at] = rng.choice([300.0, -300.0, 1000.0, 255.0], 7)
        if k % 2:
            flat[:, 0] = 400.0
        out.append(torch.from_numpy(f))
    return out


def carries(lead, seed):
    """Carries of [*lead] leaves away from the initial state's zeros."""
    rng = np.random.default_rng(seed)

    def t(v, dtype):
        return torch.as_tensor(np.asarray(v), dtype=dtype).reshape(lead)

    n = math.prod(lead)
    ag = (t(rng.uniform(-0.1, 0.1, n), torch.float32), t(rng.uniform(0.8, 1.2, n), torch.float32),
          t(np.ones(n), torch.float32))
    sx = SweetspotState(t(rng.integers(40, 200, n), torch.int32),
                        t(rng.integers(0, 800, n), torch.int32), t(np.zeros(n), torch.int32))
    sy = SweetspotState(t(rng.integers(6, 30, n), torch.int32),
                        t(rng.integers(0, 90, n), torch.int32), t(np.zeros(n), torch.int32))
    pll = PLLState(t(rng.uniform(-2, 2, n), torch.float64), t(np.zeros(n), torch.bool),
                   t(rng.uniform(-0.05, 0.05, n), torch.float32))
    return ag, sx, sy, pll


def leaves(out):
    result, screen, ag, sx, sy, pll = out
    return [result, screen, *ag, *sx, *sy, *pll]


def run_slots(fn, spec, frames, lead, seed, motionblur):
    """fn over the frames, one emit slot each, the carries chained."""
    ag, sx, sy, pll = carries(lead, seed)
    screen = torch.zeros(frames[0].shape, dtype=torch.float32)
    outs = []
    for f in frames:
        out = fn(f, screen, ag, sx, sy, pll, motionblur, spec)
        _, screen, ag, sx, sy, pll = out
        outs.append(leaves(out))
    return outs


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_equals_the_chain_it_replaces(shape, flags):
    """The plain version (the step's default order on CPU tensors) against
    the chain as it was, every leaf bit for bit through K = 4 chained
    slots."""
    *lead, h, w = shape
    lead = tuple(lead)
    spec = spec_for(h, w, flags)
    frames = emanation_frames(shape, SLOTS, seed=sum(shape))
    mb = torch.full(lead, 0.3, dtype=torch.float32) if lead else torch.tensor(0.3)
    want = run_slots(chain_as_it_was, spec, frames, lead, 7, mb)
    got = run_slots(plain, spec, frames, lead, 7, mb)
    for k, (g, e) in enumerate(zip(got, want)):
        for i, (a, b) in enumerate(zip(g, e)):
            assert a.dtype == b.dtype and a.shape == b.shape, (k, i)
            assert torch.equal(a, b), (k, i)
    # the search moved the carries: the slots do not all repeat the first
    assert len({tuple(int(v) for v in o[5].reshape(-1)) for o in want}) > 1


# ---- the kernels' arithmetic, modelled in numpy -------------------------------

def _shfl_down_sum(v):
    """warp_sum: lane 0's value after the shuffle-down tree, over [..., 32]."""
    v = v.copy()
    for o in (16, 8, 4, 2, 1):
        v[..., :32 - o] = v[..., :32 - o] + v[..., o:]
    return v[..., 0]


def _inclusive_warp_scan(v):
    """The shuffle-up scan over [..., 32]: y + incl at each step."""
    v = v.copy()
    for o in (1, 2, 4, 8, 16):
        v[..., o:] = v[..., :-o] + v[..., o:]
    return v


def _model_stats(f):
    """post_process_stats_kernel over one frame f [H, W] (np.float32):
    (column sums [W] and row sums [H] finished as the search kernel finishes
    them, min, max)."""
    h, w = f.shape
    rows_per, n_rt, n_ct, _ = pp.tiling(h, w)
    threads = pp.COL_TILE // 4
    f64 = f.astype(np.float64)
    colpart = np.zeros((n_rt, w))
    rowpart = np.zeros((n_ct, h))
    for rt in range(n_rt):
        r0, r1 = rt * rows_per, min((rt + 1) * rows_per, h)
        col = np.zeros(w)
        for r in range(r0, r1):
            col = col + f64[r]
        colpart[rt] = col
        for ct in range(n_ct):
            tile = np.zeros((r1 - r0, pp.COL_TILE))
            c1 = min((ct + 1) * pp.COL_TILE, w)
            tile[:, :c1 - ct * pp.COL_TILE] = f64[r0:r1, ct * pp.COL_TILE:c1]
            acc = np.zeros((r1 - r0, threads))  # a thread's four columns, in order
            for q in range(4):
                acc = acc + tile[:, q * threads:(q + 1) * threads]
            lanes = np.zeros((r1 - r0, 32))
            for k in range(threads // 32):
                lanes = lanes + acc[:, 32 * k:32 * (k + 1)]
            rowpart[ct, r0:r1] = _shfl_down_sum(lanes)
    wprof = np.zeros(w)
    for rt in range(n_rt):
        wprof = wprof + colpart[rt]
    hprof = np.zeros(h)
    for ct in range(n_ct):
        hprof = hprof + rowpart[ct]
    ok = ~((f > 250.0) | (f < -250.0))
    lo = min(np.float32(f[ok].min()) if ok.any() else np.float32(3.4e38), f[0, 0])
    hi = max(np.float32(f[ok].max()) if ok.any() else np.float32(-3.4e38), f[0, 0])
    return wprof, hprof, np.float32(lo), np.float32(hi)


def _model_scan(x):
    """The search kernel's inclusive block scan of x [2n] (512 threads)."""
    threads = 512
    m2 = x.shape[0]
    per = -(-m2 // threads)
    own = np.zeros(threads)
    for t in range(threads):
        for v in x[min(t * per, m2):min((t + 1) * per, m2)]:
            own[t] = own[t] + v
    incl = _inclusive_warp_scan(own.reshape(-1, 32))
    excl = np.concatenate([np.zeros((incl.shape[0], 1)), incl[:, :-1]], axis=1)
    totals = np.zeros(32)
    totals[:incl.shape[0]] = incl[:, -1]
    wscan = _inclusive_warp_scan(totals)
    woff = np.concatenate([[0.0], wscan[:-1]])[:incl.shape[0]]
    out = np.empty(m2)
    for t in range(threads):
        run = woff[t // 32] + excl[t // 32, t % 32]
        for i in range(min(t * per, m2), min((t + 1) * per, m2)):
            run = run + x[i]
            out[i] = run
    return out


def _model_search(prof, minsize, coeff, size_in, dx_in):
    """search_axis on one f64 profile: the new (size, dx, vx)."""
    n = prof.shape[0]
    blurred = np.zeros(n)
    for k, c in zip((-2, -1, 0, 1, 2), _coeffs()):
        blurred = blurred + c * np.roll(prof, -k)
    csum = np.concatenate([[0.0], _model_scan(np.concatenate([blurred, blurred]))])
    total = csum[n]
    ms, size2 = max(minsize, 1), n >> 1
    curr = min(max(size_in, ms), size2)
    cand = [curr, curr - 4, curr + 4, curr >> 1, curr << 1]
    valid = [i == 0 or (ms <= c < size2 and c != curr) for i, c in enumerate(cand)]
    safe = [c if v else curr for c, v in zip(cand, valid)]
    fits, at = [], []
    for s in safe:
        wsum = csum[s:s + n] - csum[:n]
        m = (total - wsum) / (float(n) - s) - wsum / s
        m = m * m
        at.append(int(np.argmax(m)))
        fits.append(m.max())
    win = int(np.argmax([f if v else -np.inf for f, v in zip(fits, valid)]))
    start, size = max(at[win] - 1, 0), safe[win]
    h2 = n // 2
    dxnl = (start + size // 2) % n
    rawdiff = dxnl - dx_in
    dx0 = dx_in + n if rawdiff > h2 else dx_in
    if rawdiff < -h2:
        dxnl += n
    c = torch.tensor(coeff, dtype=torch.float64)
    blended = _fused_blend(torch.tensor(float(dxnl), dtype=torch.float64), c,
                           (1.0 - c) * float(dx0))
    dx1 = int(np.rint(float(blended))) % n
    raw = dx1 - dx0
    return size, dx1, (n - raw if raw > h2 else (-n - raw if raw < -h2 else raw))


def model_post_process(frame, screen, ag, sync_x, sync_y, pll, motionblur, spec):
    """The three kernels on one frame [H, W], in numpy: the same contract
    as the plain version, the SNR summed in f64 partials as the apply
    kernel sums it."""
    f = frame.numpy()
    h, w = f.shape
    wprof, hprof, lo, hi = _model_stats(f)
    keep = np.float32(1.0 - NORMALISATION_LOWPASS_COEFF)
    norm_c = np.float32(NORMALISATION_LOWPASS_COEFF)
    mx = np.float32(keep * np.float32(ag[1]) + norm_c * hi)
    mn = np.float32(keep * np.float32(ag[0]) + norm_c * lo)
    span = np.float32(1.0) if mx == mn else np.float32(mx - mn)
    ok = ~((f > 250.0) | (f < -250.0))
    mean = np.float32(np.float32(f.astype(np.float64)[ok].sum()) / np.float32(h * w))
    sx = _model_search(wprof, spec.minsize_x, FRAMERATE_DX_LOWPASS_COEFF_WIDTH,
                       int(sync_x.stripsize), int(sync_x.dx))
    sy = _model_search(hprof, spec.minsize_y, FRAMERATE_DX_LOWPASS_COEFF_HEIGHT,
                       int(sync_y.stripsize), int(sync_y.dx))
    new_pll = framerate_pll(pll, torch.tensor(sx[2], dtype=torch.int32),
                            enabled=spec.pll_enabled, max_delta=spec.max_delta)
    v = f
    if spec.autoshift:
        v = f[(np.arange(h) + sy[1]) % h][:, (np.arange(w) + sx[1]) % w]
    x = (v - mn) / span
    if spec.markers and not spec.autoshift:
        x = np.where((np.arange(w)[None, :] == sx[1]) | (np.arange(h)[:, None] == sy[1]),
                     np.float32(PIXEL_SPECIAL_VALUE_G), x)
    mb = np.float32(motionblur)
    out = screen.numpy() * mb + x * (np.float32(1.0) - mb)
    d = (v - mean).astype(np.float32)
    s2, s1 = np.float32((d * d).astype(np.float64).sum()), np.float32(d.astype(np.float64).sum())
    n = np.float32(h * w)
    var = np.float32((s2 - s1 * s1 / n) / np.float32(h * w - 1))
    snr = np.float32(mean / np.sqrt(max(var, np.float32(1e-30))))
    i32 = lambda t: torch.tensor(t, dtype=torch.int32)  # noqa: E731
    res = torch.from_numpy(out.astype(np.float32))
    return (res, res, (torch.tensor(mn), torch.tensor(mx), torch.tensor(snr)),
            SweetspotState(*map(i32, sx)), SweetspotState(*map(i32, sy)), new_pll)


@pytest.mark.parametrize("flags", ["default", "autoshift", "markers"])
@pytest.mark.parametrize("w", [849, 3397, 13588])
def test_kernels_arithmetic_model_against_plain(w, flags):
    """The kernels' decomposition (tiled f64 sums finished in fixed order,
    the block scan, first-wins argmaxes, the blend as one fused
    multiply-add, the SNR's f64 partials) against the plain version over
    K = 4 chained slots: frames, min, max and every integer carry exactly,
    the SNR within 1e-5 of its size (the plain version sums in f32). 13,588
    pixels a line: superresolution of a 64 MS/s source (256 MS/s)."""
    h = 628
    spec = spec_for(h, w, flags)
    frames = emanation_frames((h, w), SLOTS, seed=w)
    mb = torch.tensor(0.25)
    want = run_slots(plain, spec, frames, (), 11, mb)
    got = run_slots(model_post_process, spec, frames, (), 11, mb)
    for k, (g, e) in enumerate(zip(got, want)):
        snr_g, snr_e = g.pop(4), e.pop(4)
        assert abs(float(snr_g) - float(snr_e)) <= 1e-5 * abs(float(snr_e)), (k, snr_g, snr_e)
        for i, (a, b) in enumerate(zip(g, e)):
            assert torch.equal(a.to(b.dtype), b), (k, i, a, b)


def test_tiling_covers_every_frame():
    """The stats tiles and apply blocks cover each frame, at most MAX_ROWS
    rows a tile, at the benchmark's widths, a superresolution pipeline's
    (628 x 13588 at 256 MS/s) and at small and tall ones."""
    for h, w in [(628, 849), (628, 3397), (628, 13588), (100, 200), (1, 1), (1125, 2200),
                 (5, 4097)]:
        rows, n_rt, n_ct, n_ap = pp.tiling(h, w)
        assert 1 <= rows <= pp.MAX_ROWS and n_rt * rows >= h > (n_rt - 1) * rows
        assert n_ct * pp.COL_TILE >= w > (n_ct - 1) * pp.COL_TILE
        assert n_ap * pp.APPLY_TILE >= h * w > (n_ap - 1) * pp.APPLY_TILE
    assert pp.tiling(628, 849)[:3] == (20, 32, 1)


# ---- which post-process the step runs ------------------------------------------

CFG = PipelineConfig(samplerate=1e6, height=100, refreshrate=50.0, block_samples=8192)


@pytest.mark.parametrize("params,config,want", [
    (Params(), CFG, "kernels"),
    (Params(autoshift=True), CFG, "kernels"),
    (Params(debug_markers=True), CFG, "kernels"),
    (Params(framerate_pll=False), CFG, "kernels"),
    (Params(fast_sync=True), CFG, "plain"),
    (Params(), dataclasses.replace(CFG, high_precision_sync=False), "plain"),
    (Params(autogain_after_proc=True), CFG, "orders"),
    (Params(lowpass_before_sync=True), CFG, "orders"),
], ids=["default", "autoshift", "markers", "pll_off", "fast_sync", "f32_sums", "autogain_after",
        "lowpass_first"])
def test_step_picks_the_kernels_for_the_default_order_with_f64_profiles(monkeypatch, params,
                                                                         config, want):
    """pipeline._post_process: the default order with f64 profiles is what
    the kernels cover (whatever autoshift, markers and the PLL), fast_sync
    and f32 sums are not, the other orders run their own chain. On a CPU
    frame the default order always runs the plain version; the card takes
    the kernels where they cover (chip_smoke.py counts them there)."""
    seen = []

    def record(name, fn):
        def wrapped(*a, **k):
            seen.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tpipe, "post_process_cuda", record("kernels", pp.post_process_cuda))
    monkeypatch.setattr(tpipe, "_post_process_default_order", record("plain", plain))
    h, w = config.height, config.width
    st = init_state(config, device="cpu")
    f = torch.rand((h, w), generator=torch.Generator().manual_seed(3))
    tpipe._post_process(config, params, f, st.screenbuffer, (st.ag_min, st.ag_max, st.ag_snr),
                        st.sync_x, st.sync_y, st.pll, torch.tensor(0.0))
    assert seen == ([] if want == "orders" else ["plain"])
    spec = tpipe._post_spec(config, params)
    assert pp.covers(spec) == (want != "plain")  # the orders collapse to f64 profiles too


def test_kernels_refuse_what_they_do_not_cover():
    """The CUDA entry raises on a collapse it does not take before looking
    for a card, and on a frame that is not on a card."""
    spec = spec_for(100, 200, "default")
    meta = torch.empty((100, 200), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="f64 profiles"):
        pp.post_process_cuda(meta, meta, None, None, None, None, 0.0,
                             spec._replace(precise=False, widen=False))
    cpu = torch.zeros((100, 200))
    with pytest.raises(ValueError, match="CUDA tensors"):
        pp.post_process_cuda(cpu, cpu, None, None, None, None, 0.0, spec)


def test_no_host_reads_in_the_post_process_or_the_step():
    """The plain version on a stack of 8 and the device step at default
    Params read nothing to the host (tests/torch_host_guard.py), as a CUDA graph
    and an IF node's body need on the card."""
    spec = spec_for(60, 849, "autoshift")
    frames = emanation_frames((8, 60, 849), 2, seed=5)
    ag, sx, sy, pll = carries((8,), 3)
    screen = torch.zeros((8, 60, 849))
    with no_host_reads():
        for f in frames:
            _, screen, ag, sx, sy, pll = plain(f, screen, ag, sx, sy, pll,
                                               torch.full((8,), 0.5), spec)
    step = make_step(CFG, Params(), device="cpu")
    state = init_state(CFG, device="cpu")
    raw = torch.from_numpy(np.random.default_rng(1).integers(0, 256, 2 * CFG.block_samples,
                                                             dtype=np.uint8))
    with no_host_reads():
        for _ in range(3):
            state, out = step(state, raw, StepControls())
    assert int(state.frame_count) > 0
    assert pp.post_process_cuda.launches == 0  # the CPU launches no kernel
