"""The benchmark's stream: exactly periodic, so a loop of it is the
generator's straight continuation across the seam."""

import json
import os

import numpy as np
import pytest

from portbench.gen import emanation as em
from portbench.tests import tiny


def _config(name):
    with open(os.path.join(tiny.BENCH, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,period", [("vesa800x600-64msps", 3_200_000),
                                         ("vesa800x600-8x16msps", 800_000)])
def test_the_loop_continues_the_generator_across_the_seam(name, period):
    cfg = _config(name)
    assert em.period_samples(cfg["samplerate"], cfg["refreshrate"], cfg["period_frames"]) == period
    n = cfg["block_samples"]
    for c in (0, cfg["channels"] - 1):
        npix = cfg["raster"]["lines"] * cfg["raster"]["total_width"][c]
        # the raster position, computed straight on over two periods
        straight = em.raster_positions(cfg["samplerate"], cfg["refreshrate"], npix, 2 * period)
        assert np.array_equal(straight[period:], straight[:period])
        pos = np.arange(2 * period, dtype=np.int64)
        exact = (pos * npix * cfg["refreshrate"]) // cfg["samplerate"] % npix
        assert np.array_equal(straight, exact)
    one = em.channel_period(cfg, 0, seed=2**31 + 5)
    assert one.shape == (2 * period,) and one.dtype == np.uint8
    loop = em.looped(one, n)
    k = period // n  # the block that crosses the seam
    blk = em.block_at(loop, period, n, k)
    at = k * n
    want = np.concatenate([one[2 * at:], one[: 2 * (at + n - period)]])
    assert np.array_equal(blk, want)
    assert np.array_equal(em.block_at(loop, period, n, k + period), blk)  # a whole period on


def test_the_seed_sets_the_data_and_nothing_else():
    cfg = tiny.tiny_config()
    a, b = em.channel_period(cfg, 0, 1), em.channel_period(cfg, 0, 2)
    assert a.shape == b.shape and not np.array_equal(a, b)
    assert np.array_equal(a, em.channel_period(cfg, 0, 1))
    assert not np.array_equal(a, em.channel_period(cfg, 1, 1) if cfg["channels"] > 1 else b)

