"""The port's copies of the host-side modules — estimate/ (scales, vesa,
peaks, autores, meters, plotrender), snapshot and prefs — against the JAX
package's originals: seeded inputs through both, outputs equal
(array_equal for images and tables, == for scalars and tuples). None of
these modules touches a device."""

import importlib
import os

import numpy as np
import pytest

SEEDS = [0, 1, 2]


def both(name):
    return (importlib.import_module(f"tempestsdr_tpu.{name}"),
            importlib.import_module(f"tempestsdr_tpu_torch.{name}"))


def _ac_window(rng, n, peak):
    """An autocorrelation-like window: positive, decaying, one clear peak."""
    w = (rng.random(n) * 0.1 + np.exp(-np.arange(n) / n)).astype(np.float32)
    w[peak] += 2.0
    return w


@pytest.mark.parametrize("seed", SEEDS)
def test_scales_copy_is_equal(seed):
    """ZoomableXScale driven through the same zoom/pan sequence."""
    j, t = both("estimate.scales")
    rng = np.random.default_rng(seed)
    ops = [(rng.integers(0, 640), float(rng.choice([0.5, 0.8, 1.25, 2.0])),
            int(rng.integers(-200, 200))) for _ in range(12)]
    trace = {}
    for mod in (j, t):
        s = mod.ZoomableXScale(0.0, 5000.0)
        s.set_max_pixels(640)
        got = []
        for px, coeff, pan in ops:
            s.zoom_around(int(px), coeff)
            s.move_offset_with_pixels(pan)
            got.append((s.pixels_to_value_absolute(17), s.pixels_to_value_relative(17),
                        s.value_to_pixel_absolute(1234.5), s.value_to_pixel_relative(99.0),
                        s.offset_px))
        s.move_offset_with_value(250.0)
        s.fix_offset()
        got.append((s.offset_px, s.pixels_to_value_absolute(0)))
        s.set_min_max_value(10.0, 900.0)
        s.reset()
        got.append((s.offset_px, s.pixels_to_value_absolute(639)))
        trace[mod] = got
    assert trace[j] == trace[t]
    assert j._java_int(-3.7) == t._java_int(-3.7) == -3


@pytest.mark.parametrize("seed", SEEDS)
def test_vesa_copy_is_equal(seed):
    j, t = both("estimate.vesa")
    assert [tuple(m) for m in j.VIDEO_MODES] == [tuple(m) for m in t.VIDEO_MODES]
    rng = np.random.default_rng(seed)
    for _ in range(200):
        fps, h = float(rng.uniform(20, 90)), int(rng.integers(300, 2500))
        w = int(rng.choice([m.width for m in j.VIDEO_MODES])) if rng.random() < 0.3 else None
        a, b = j.find_closest_mode(fps, h, w), t.find_closest_mode(fps, h, w)
        assert (a is None) == (b is None) and (a is None or tuple(a) == tuple(b))
    exact = j.VIDEO_MODES[seed]
    assert tuple(t.find_closest_mode(exact.refreshrate, exact.height)) == tuple(
        j.find_closest_mode(exact.refreshrate, exact.height))


@pytest.mark.parametrize("seed", SEEDS)
def test_peaks_copy_is_equal(seed):
    j, t = both("estimate.peaks")
    rng = np.random.default_rng(seed)
    data = _ac_window(rng, 4000, 1777)
    for _ in range(50):
        idx, area = int(rng.integers(0, 4000)), int(rng.integers(0, 300))
        assert j.get_best_id_around(data, idx, area) == t.get_best_id_around(data, idx, area)
        assert j.best_peak_around(data, idx, area) == t.best_peak_around(data, idx, area)
        off, around = int(rng.integers(0, 30000)), int(rng.integers(1, 40000))
        assert j.select_fps(data, off, 8e6, around, area) == t.select_fps(
            data, off, 8e6, around, area)
        assert j.select_height(data, off, 133333.3, around, area) == t.select_height(
            data, off, 133333.3, around, area)
    assert t.select_fps(data, 100, 8e6, 1800, 200) is not None
    for lag in (1, 33333, 133333):
        assert j.fps_from_lag(lag, 8e6) == t.fps_from_lag(lag, 8e6)
        assert j.lag_from_fps(8e6 / lag, 8e6) == t.lag_from_fps(8e6 / lag, 8e6)
        assert j.height_from_lags(lag, 212) == t.height_from_lags(lag, 212)


@pytest.mark.parametrize("seed", SEEDS)
def test_autores_copy_is_equal(seed):
    """estimate_from_plots on seeded windows (with the mirror-alias tie of a
    circular autocorrelation), and AutoResolution fed the same rounds."""
    j, t = both("estimate.autores")
    jev, tev = both("events")
    rng = np.random.default_rng(seed)
    sr = 8e6
    fft = 1 << 18  # ac_fft_size_for(8e6) or not: the tie branch needs only a mirror in range
    frame_off, line_off = 100_000, 150
    frame_peak = int(rng.integers(20_000, 40_000))
    fp = _ac_window(rng, 70_000, frame_peak)
    mirror = fft - (frame_off + frame_peak) - frame_off
    if 0 <= mirror < len(fp):
        fp[mirror] = fp[frame_peak]  # an exact tie with the mirror alias
    lp = _ac_window(rng, 400, int(rng.integers(20, 380)))
    a = j.estimate_from_plots(fp, lp, frame_off, line_off, sr)
    b = t.estimate_from_plots(fp, lp, frame_off, line_off, sr)
    assert tuple(a)[:4] == tuple(b)[:4]
    assert (a.mode is None) == (b.mode is None) and (a.mode is None or tuple(a.mode) == tuple(b.mode))
    got = {}
    for mod, ev in ((j, jev), (t, tev)):
        tracker = mod.AutoResolution(sr)
        outs = []
        for rnd in range(5):
            jitter = 1 if rnd == 1 and seed else 0  # an inconsistent round restarts the count
            f = np.roll(fp, jitter)
            outs.append(tracker.feed(ev.PlotEvent(ev.PLOT_ID.FRAME, frame_off, f, sr)))
            outs.append(tracker.feed(ev.PlotEvent(ev.PLOT_ID.LINE, line_off, lp, sr)))
        tracker.reset()
        outs.append(tracker.feed(ev.PlotEvent(ev.PLOT_ID.FRAME, frame_off, fp, sr)))
        got[mod] = [None if o is None else tuple(o)[:4] for o in outs]
    assert got[j] == got[t] and any(o is not None for o in got[t])


@pytest.mark.parametrize("seed", SEEDS)
def test_meters_copy_is_equal(seed):
    j, t = both("estimate.meters")
    rng = np.random.default_rng(seed)
    for _ in range(6):
        lo = float(rng.uniform(1e-4, 0.1))
        hi = lo + float(rng.uniform(-0.01, 2.0))
        np.testing.assert_array_equal(j.render_autogain_meter(lo, hi), t.render_autogain_meter(lo, hi))
        snr = float(10 ** rng.uniform(-3, 3))
        np.testing.assert_array_equal(j.render_snr_meter(snr), t.render_snr_meter(snr))
        assert j.val_to_db(snr) == t.val_to_db(snr)
        assert j.db_to_px(j.val_to_db(snr), 240) == t.db_to_px(t.val_to_db(snr), 240)
        assert j.px_to_val(37, 240) == t.px_to_val(37, 240)
    assert t.render_autogain_meter(0.01, 1.0).std() > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_plotrender_copy_is_equal(seed, tmp_path):
    """render_plot (plain and through a zoomed scale), the decimators and
    save_plot: the same images, info and files."""
    j, t = both("estimate.plotrender")
    js, ts = both("estimate.scales")
    rng = np.random.default_rng(seed)
    data = _ac_window(rng, 5000 + 37 * seed, 1234)
    for kind in ("frame", "line"):
        (ia, infa), (ib, infb) = (m.render_plot(data, offset=777, samplerate=8e6, kind=kind)
                                  for m in (j, t))
        np.testing.assert_array_equal(ia, ib)
        assert infa == infb and ib.dtype == np.uint8 and ib.shape == (240, 640)
    outs = []
    for mod, smod in ((j, js), (t, ts)):
        scale = smod.ZoomableXScale(0.0, float(len(data)))
        scale.set_max_pixels(640)
        scale.zoom_around(300, 0.5)
        scale.move_offset_with_pixels(40)
        img, info = mod.render_plot(data, offset=10, samplerate=2e6, kind="line",
                                    frame_lag=33333, scale=scale)
        dec = mod.decimate_max(data, 320)
        decz = mod.decimate_max_zoomed(data, 320, scale)
        path = str(tmp_path / f"{mod.__name__}.pgm")
        mod.save_plot(img, path)
        outs.append((img, info, dec, decz, open(path, "rb").read()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1] and outs[0][4] == outs[1][4]
    for a, b in zip(outs[0][2] + outs[0][3], outs[1][2] + outs[1][3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j.db_to_px(np.array([-30.0, -3.0]), -60.0, 0.0, 240),
                                  t.db_to_px(np.array([-30.0, -3.0]), -60.0, 0.0, 240))


@pytest.mark.parametrize("fmt", ["pgm", "npy"])
@pytest.mark.parametrize("invert", [False, True], ids=["plain", "invert"])
def test_snapshot_copy_writes_the_same_bytes(tmp_path, fmt, invert):
    """save_frame on one seeded frame with a marker pixel: the same bytes
    from both copies; frame_to_u8 / frame_to_rgb equal."""
    j, t = both("snapshot")
    from tempestsdr_tpu_torch.config import PIXEL_SPECIAL_VALUE_G

    rng = np.random.default_rng(5)
    frame = rng.random((40, 30)).astype(np.float32) * 1.2 - 0.1
    frame[3, 3] = PIXEL_SPECIAL_VALUE_G
    paths = [str(tmp_path / f"{name}.{fmt}") for name in "jt"]
    for mod, path in zip((j, t), paths):
        mod.save_frame(frame, path, invert=invert)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    assert os.path.getsize(paths[1]) > frame.size
    np.testing.assert_array_equal(j.frame_to_u8(frame, invert), t.frame_to_u8(frame, invert))
    rgb = t.frame_to_rgb(frame, invert)
    np.testing.assert_array_equal(j.frame_to_rgb(frame, invert), rgb)
    assert tuple(rgb[3, 3]) == (0, 255, 0)


def test_prefs_copy_shares_file_format_and_default_path(tmp_path, monkeypatch):
    """The two Preferences stores read each other's files, write the same
    bytes, and resolve the same default path and $TSDR_PREFS_PATH: a user's
    saved preferences serve both packages."""
    j, t = both("prefs")
    monkeypatch.delenv("TSDR_PREFS_PATH", raising=False)
    assert j.default_prefs_path() == t.default_prefs_path()
    assert t.default_prefs_path().endswith(os.path.join("tempestsdr_tpu", "prefs.json"))
    monkeypatch.setenv("TSDR_PREFS_PATH", str(tmp_path / "env.json"))
    assert j.default_prefs_path() == t.default_prefs_path() == str(tmp_path / "env.json")
    values = {"height": 314, "rate": 75.0, "source": "rawfile", "autoshift": True, "freq": None}
    paths = [str(tmp_path / "j.json"), str(tmp_path / "t.json")]
    for mod, path in zip((j, t), paths):
        p = mod.Preferences(path)
        assert p.get("height", 628) == 628
        p.update(values)
        p.put("gain", 0.5)
        p.save()
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    q = t.Preferences(paths[0])  # the port reads the JAX package's file
    assert {k: q.get(k) for k in q.keys()} == {**values, "gain": 0.5}
    assert j.Preferences(paths[1]).get("rate") == 75.0
    with open(paths[1], "w") as f:
        f.write("{nope")
    assert t.Preferences(paths[1]).get("height", 1) == 1  # corrupt store behaves as empty


def test_estimate_package_exports_match():
    j, t = both("estimate")
    names = lambda m: {n for n in dir(m) if not n.startswith("_")}  # noqa: E731
    assert names(j) == names(t)
