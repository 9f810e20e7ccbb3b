"""The per-layer metrics' arithmetic on a made-up profiler trace."""

import os
import types

import pytest

from portbench import manifest, peaks, tracing
from portbench.reference.geometry import Geometry

BENCH = os.path.join(manifest.ROOT, "portbench")
READERS = {f[:-3]: manifest.load_reader(BENCH, f[:-3])
           for f in os.listdir(os.path.join(BENCH, "metrics")) if f.endswith(".py")}
K1 = "void strided_resample_kernel<false>(float const*, float*)"


def _trace():
    """A 1000 us stretch: K1 twice (10 us each), another kernel 100 us, a
    DtoH copy 200 us that overlaps it by 50 us, an HtoD copy 40 us; the host
    in a frame callback during the one long idle gap."""
    ev = [dict(ph="X", cat="user_annotation", name="portbench/traced", ts=0, dur=1000),
          dict(ph="X", cat="kernel", name=K1, ts=10, dur=10),
          dict(ph="X", cat="kernel", name=K1, ts=30, dur=10),
          dict(ph="X", cat="kernel", name="other", ts=100, dur=100),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH (Device -> Pageable)", ts=150,
               dur=200),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD (Pageable -> Device)", ts=400,
               dur=40),
          dict(ph="X", cat="user_annotation", name="portbench/on_frame", ts=500, dur=400),
          dict(ph="X", cat="cpu_op", name="aten::copy_", ts=360, dur=30)]
    return tracing.Trace(ev)


def _run(**kw):
    g = Geometry(64e6, 628, 60.0, 786432)
    base = dict(trace=_trace(), geometry=g, geometries=[g], blocks_traced=2, channels=1)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_busy_and_idle():
    t = _trace()
    assert t.window_s == pytest.approx(1e-3)
    # busy: 10 + 10 + [100, 350) + [400, 440) = 310 us
    assert t.busy_s == pytest.approx(310e-6)
    assert READERS["device_idle_pct.premade"].read(_run()) == pytest.approx(69.0)
    gaps = dict(t.idle_gaps())
    assert gaps["portbench/on_frame"] == pytest.approx(560e-6)
    assert gaps["session: aten::copy_"] == pytest.approx(50e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)
    assert t.top_device_ops()[0] == ["Memcpy DtoH (Device -> Pageable)", pytest.approx(200e-6)]


def test_bytes_and_time_per_block():
    assert READERS["dtoh_ms_per_block.premade"].read(_run()) == pytest.approx(0.1)
    assert READERS["kernel_ms_per_block.premade"].read(_run()) == pytest.approx(0.06)


def test_k1_roofline():
    g = Geometry(64e6, 628, 60.0, 786432)
    nbytes = 4 * (786432 + g.taps) + 4 * 786432 * g.pixels_per_sample
    want = 100 * nbytes / peaks.HBM_BYTES_PER_S / 10e-6
    assert READERS["k1_roofline_pct"].read(_run()) == pytest.approx(want)
    assert 9.4e6 < nbytes < 9.5e6  # the envelope and tail in, ~1.57 M pixels out


def test_k1_roofline_averages_the_channels_geometries():
    """Channels of their own modes: a launch's bytes are the channels' mean."""
    gs = [Geometry(16e6, h, r, 786432) for h, r in ((628, 60.0), (806, 60.0), (1066, 75.0))]
    nbytes = sum(4 * (786432 + g.taps) + 4 * 786432 * g.pixels_per_sample for g in gs) / 3
    want = 100 * nbytes / peaks.HBM_BYTES_PER_S / 10e-6
    assert READERS["k1_roofline_pct"].read(_run(geometry=gs[0], geometries=gs)) == \
        pytest.approx(want)


def test_silence_where_nothing_is_read():
    empty = _run(trace=None)
    assert all(r.read(empty) is None for r in READERS.values())


def test_every_per_layer_metric_has_its_reader():
    assert {m["name"] for m in manifest.load()["per_layer"]} <= set(READERS)
