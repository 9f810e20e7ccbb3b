"""Display modes channel by channel, and a configuration's own reference
and session maker, found by name. The accepted configurations read what
they read before these existed: the same streams, geometry and check
numbers, pinned below from the harness as it was."""

import hashlib
import json
import os

import numpy as np
import pytest

from portbench import control, harness, manifest, modes, run
from portbench.gen import emanation as em
from portbench.reference import check
from portbench.reference.geometry import Geometry
from portbench.tests import tiny

ACCEPTED = ("vesa800x600-64msps", "vesa800x600-8x16msps")

# sha256 of every channel's period, channel by channel, at seeds 7 and 2**31 + 5
STREAMS = {
    ("vesa800x600-64msps", 7):
        "5b556b73b3df774aebc9c6d93eb5e90a9d3ad17a1df70a5bc0dcb0342cd18b76",
    ("vesa800x600-64msps", 2**31 + 5):
        "fe3bdae1a2cc8a19e84f8c9cb370d9f35e0203ec3fe209dc29bdd8b242c207d6",
    ("vesa800x600-8x16msps", 7):
        "c4fc2ae7d3863e9a5f5a17fd4de751ea8fff0c9c43e0b75e7e77b2ae72606439",
    ("vesa800x600-8x16msps", 2**31 + 5):
        "613c8fc906f506dd385265aadf455078543ca49732265e051c0a8983e82037f0",
}
GEOMETRIES = {
    "vesa800x600-64msps": dict(
        samplerate=64000000.0, height=628, refreshrate=60.0, n=786432, width=3397,
        fp=2133316, samples_per_pixel=0.5000040625330081, inv0_fix=549760280690, mp=1604310,
        taps=2, k_frames=1, ac_round=3607272, ac_fft=2097152, frame_window=[735632, 428004],
        line_window=[490, 1482], block2=2133333, framebuf_len=3737626,
        pixels_per_sample=1.99998375),
    "vesa800x600-8x16msps": dict(
        samplerate=16000000.0, height=628, refreshrate=60.0, n=786432, width=849, fp=533172,
        samples_per_pixel=0.5001512957669695, inv0_fix=549922165343, mp=1603837, taps=2,
        k_frames=4, ac_round=901818, ac_fft=524288, frame_window=[183908, 107001],
        line_window=[122, 371], block2=533333, framebuf_len=2665860,
        pixels_per_sample=1.999395),
}
# control.control_numbers(tiny.tiny_config(channels), 7, "cpu")
CONTROL = {
    1: dict(frame_err=0.0775154451196105, plot_err=6.479307202585426e-05,
            state_err=0.007162279419590453, long_state_err=0.006378979712323322, mismatches=0,
            frames=8, plots=2, stretches=3, blocks=18, from_start=40, long_mismatches=0),
    3: dict(frame_err=0.0775154451196105, plot_err=6.479307202585426e-05,
            state_err=0.007162279419590453, long_state_err=0.006614049269654054, mismatches=0,
            frames=24, plots=6, stretches=9, blocks=54, from_start=40, long_mismatches=0),
}


def _config(name):
    with open(os.path.join(tiny.BENCH, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,seed", sorted(STREAMS), ids=lambda v: str(v))
def test_the_accepted_streams_are_unchanged(name, seed):
    cfg = _config(name)
    h = hashlib.sha256()
    for c in range(cfg["channels"]):
        h.update(em.channel_period(cfg, c, seed).tobytes())
    assert h.hexdigest() == STREAMS[(name, seed)]


@pytest.mark.parametrize("name", ACCEPTED)
def test_the_accepted_geometries_are_unchanged(name):
    cfg = _config(name)
    assert json.loads(json.dumps(vars(Geometry.of(cfg)))) == GEOMETRIES[name]
    assert {Geometry.of(cfg, c).key for c in range(cfg["channels"])} == {Geometry.of(cfg).key}
    assert len(set(modes.receiver_modes(cfg))) == 1


@pytest.mark.parametrize("channels", [1, 3])
def test_the_tiny_check_numbers_are_unchanged(channels):
    got = control.control_numbers(tiny.tiny_config(channels), 7, "cpu")
    want = CONTROL[channels]
    assert got == {k: pytest.approx(v, rel=1e-9) if isinstance(v, float) else v
                   for k, v in want.items()}


def test_a_channel_reads_its_own_entry_or_the_one_value():
    cfg = tiny.mixed_config()
    got = [modes.channel_mode(cfg, c) for c in range(3)]
    assert [(m["height"], m["refreshrate"], m["lines"]) for m in got] == \
        [(100, 60, 100), (120, 60, 120), (100, 75, 100)]
    assert [m["active"] for m in got] == [(160, 80), (130, 100), (128, 80)]
    one = tiny.tiny_config(3)
    assert {modes.channel_mode(one, c)["active"] for c in range(3)} == {(160, 80)}
    assert modes.receiver_modes(one) == [(100, 60)] * 3
    cfg["refreshrate"] = [60, 75]
    with pytest.raises(ValueError, match="refreshrate has 2 entries for 3 channels"):
        modes.channel_mode(cfg, 0)
    with pytest.raises(IndexError):
        modes.channel_mode(one, 3)


def test_each_channel_streams_at_its_own_mode():
    cfg = tiny.mixed_config()
    geoms = [Geometry.of(cfg, c) for c in range(3)]
    assert [(g.height, g.refreshrate, g.width) for g in geoms] == \
        [(100, 60.0, 333), (120, 60.0, 277), (100, 75.0, 266)]
    assert [em.channel_period_samples(cfg, c) for c in range(3)] == [50_000, 50_000, 40_000]
    n = cfg["block_samples"]
    for c in range(3):
        period = em.channel_period_samples(cfg, c)
        one = em.channel_period(cfg, c, seed=2**31 + 9)
        assert one.shape == (2 * period,)
        mode = modes.channel_mode(cfg, c)
        npix = mode["lines"] * mode["total_width"]
        straight = em.raster_positions(cfg["samplerate"], mode["refreshrate"], npix, 2 * period)
        assert np.array_equal(straight[period:], straight[:period])
        loop = em.looped(one, n)
        k = period // n  # the block that crosses the seam
        at = k * n
        want = np.concatenate([one[2 * at:], one[: 2 * (at + n - period)]])
        assert np.array_equal(em.block_at(loop, period, n, k), want)


def _mixed_cell(tmp_path, files=("sessions/reference_rx.py", "reference/probe.py")):
    """The mixed configuration as new files alone: its JSON, a session maker
    that steps the plain reference, a reference that notes what it is made
    for; nothing that was there changes."""
    root = tiny.copy_of_benchmark(str(tmp_path))
    before = tiny.files_of(root)
    cfg = dict(tiny.mixed_config(), session="reference_rx", reference="probe")
    m = tiny.with_cell(root, cfg, files)
    after = tiny.files_of(root)
    assert {p: after[p] for p in before} == before
    cell = manifest.Cell(root, m, "tiny-mixed-premade")
    cell.reference.MADE.clear()
    return cell


def _checked(cell, seed=23, seconds=1.5):
    res = harness.run_cell(cell, seed, seconds, False, "cpu")
    assert res["error"] is None, res["error"]
    numbers = harness.check_run(res, cell.config, "cpu")
    return res, numbers, run.result_line(cell, res, {"platform": "cpu"}, numbers)


def test_a_mixed_mode_cell_is_files_alone_and_checks_each_channel_at_its_mode(tmp_path):
    cell = _mixed_cell(tmp_path)
    res, numbers, line = _checked(cell)
    assert line["correct"], line["checks"]
    assert [g.key for g in res["geometries"]] == [Geometry.of(cell.config, c).key
                                                  for c in range(3)]
    assert res["geometry"] is res["geometries"][0]
    assert numbers["stretches"] >= 3 and numbers["frames"] > 0 and numbers["plots"] > 0
    assert numbers["from_start"] == min(40, res["blocks"]) > 6
    # one reference for each distinct geometry, made by the check
    assert sorted(cell.reference.MADE) == sorted({g.key for g in res["geometries"]})


@pytest.mark.parametrize("fold", [{1: 0}, {2: 0}], ids=["height", "refreshrate"])
def test_a_channel_folded_at_a_neighbours_mode_is_not_correct(tmp_path, fold):
    cell = _mixed_cell(tmp_path)
    cell.session.FOLD_AT = fold
    _, numbers, line = _checked(cell)
    assert not line["correct"], numbers
    assert numbers["mismatches"] > 0


def test_the_default_session_refuses_mixed_modes_before_the_window(tmp_path):
    cfg = dict(tiny.mixed_config(), reference="probe")
    root = tiny.copy_of_benchmark(str(tmp_path))
    cell = manifest.Cell(root, tiny.with_cell(root, cfg, ["reference/probe.py"]),
                         "tiny-mixed-premade")
    with pytest.raises(ValueError, match="mixed modes"):
        harness.run_cell(cell, 3, 1.0, False, "cpu")


def test_a_configuration_is_checked_with_the_reference_it_names(tmp_path):
    """The program, sound, against a reference whose frames are 0.01
    brighter."""
    root = tiny.copy_of_benchmark(str(tmp_path))
    cfg = dict(tiny.tiny_config(), name="tiny-shifted", reference="shifted")
    cell = manifest.Cell(root, tiny.with_cell(root, cfg, ["reference/shifted.py"]),
                         "tiny-shifted-premade")
    _, numbers, line = _checked(cell)
    assert not line["correct"]
    assert numbers["frame_err"] == pytest.approx(0.01, abs=1e-4)
    assert numbers["state_err"] <= cfg["limits"]["state_err"]


def test_the_control_runs_each_channel_at_its_mode_with_the_named_reference(tmp_path):
    cell = _mixed_cell(tmp_path)
    numbers = control.control_numbers(cell.config, 7, "cpu", reference=cell.reference)
    ok, rows = check.verdict(numbers, cell.config["limits"])
    assert not ok, rows
    assert numbers["frame_err"] > 10 * cell.config["limits"]["frame_err"]
    assert numbers["stretches"] == 3 * 3 and numbers["from_start"] == 40
    # a low-precision reference and the check's for each of the three modes
    keys = [Geometry.of(cell.config, c).key for c in range(3)]
    assert sorted(cell.reference.MADE) == sorted(keys * 2)


@pytest.mark.parametrize("key,name,error", [
    ("reference", "no_such_reference", FileNotFoundError),
    ("session", "no_such_session", FileNotFoundError),
    ("reference", "../reference/step", ValueError),
    ("reference", "uses_the_port", ImportError),
])
def test_a_name_that_does_not_resolve_fails_before_the_window(tmp_path, key, name, error):
    root = tiny.copy_of_benchmark(str(tmp_path))
    cfg = dict(tiny.tiny_config(), name="tiny-named", **{key: name})
    m = tiny.with_cell(root, cfg, ["reference/uses_the_port.py"])
    with pytest.raises(error):
        manifest.Cell(root, m, "tiny-named-premade")


def test_a_reference_that_does_not_model_the_params_fails_before_the_window(tmp_path):
    root = tiny.copy_of_benchmark(str(tmp_path))
    cfg = dict(tiny.tiny_config(), name="tiny-fir", params={"fir_lowpass_taps": 31})
    with pytest.raises(NotImplementedError):
        manifest.Cell(root, tiny.with_cell(root, cfg), "tiny-fir-premade")
