"""The program-span readers' arithmetic (portbench/program_spans.py and the
six host_*_ms_per_block.premade readers) on a made-up profiler trace: self
time, nesting, the benchmark's own spans inside the program's, and spans
that cross the stretch's edges."""

import os
import types

import pytest

from portbench import manifest, program_spans, tracing

BENCH = os.path.join(manifest.ROOT, "portbench")
READS = {"host_source_ms_per_block.premade": "tsdr/source",
         "host_upload_ms_per_block.premade": "tsdr/upload",
         "host_replay_ms_per_block.premade": "tsdr/replay",
         "host_fetch_ms_per_block.premade": "tsdr/fetch",
         "host_download_ms_per_block.premade": "tsdr/download",
         "host_fanout_ms_per_block.premade": "tsdr/fanout"}
READERS = {name: manifest.load_reader(BENCH, name) for name in READS}


def _x(name, ts, dur, cat="user_annotation"):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)


def _events(dispatch=True):
    """A 1000 us stretch of two blocks. Block 1's source call starts before
    the stretch; block 2's dispatch ends after it. Block 1's upload holds a
    nested upload, its fan-out a callback (with the benchmark's on_frame in
    it) and a plot download; the device is busy but for [405, 600]."""
    ev = [_x("portbench/traced", 0, 1000),
          _x("tsdr/source", -50, 80), _x("portbench/source", -20, 30),
          _x("tsdr/upload", 50, 50), _x("tsdr/upload", 60, 20),
          _x("tsdr/replay", 100, 30),
          _x("tsdr/fetch", 140, 160), _x("aten::copy_", 150, 140, "cpu_op"),
          _x("tsdr/download", 310, 90),
          _x("tsdr/fanout", 410, 180), _x("tsdr/callback", 450, 50),
          _x("portbench/on_frame", 455, 40), _x("tsdr/download", 520, 40),
          _x("tsdr/source", 610, 40),
          _x("tsdr/upload", 670, 30), _x("tsdr/replay", 700, 20), _x("tsdr/fetch", 730, 260),
          _x("tsdr/fanout", 995, 85),
          _x("kernel", 0, 405, "kernel"), _x("kernel", 600, 400, "kernel")]
    if dispatch:
        ev += [_x("tsdr/dispatch", 40, 560), _x("tsdr/dispatch", 660, 440)]
    return ev


def _run(trace, blocks=2):
    return types.SimpleNamespace(trace=trace, blocks_traced=blocks, geometry=None, channels=1)


# self time (us) of each span in _events()' stretch
SELF_US = {"tsdr/source": 30 + 40,  # clipped at t0; portbench/source is no child
           "tsdr/upload": 30 + 20 + 30,  # the nested upload counts once, as its own
           "tsdr/replay": 30 + 20,
           "tsdr/fetch": 160 + 260,  # a host op inside is no child
           "tsdr/download": 90 + 40,
           "tsdr/fanout": (180 - 50 - 40) + 5,  # clipped at t1
           "tsdr/callback": 50,  # with the benchmark's on_frame
           "tsdr/dispatch": (560 - 50 - 30 - 160 - 90 - 180) + (340 - 30 - 20 - 260 - 5)}


def test_self_time_clipped_to_the_stretch():
    by = program_spans.self_us(tracing.Trace(_events()))
    assert by == pytest.approx(SELF_US)
    # the spans tile the stretch but for the gaps between the loop's spans
    assert sum(by.values()) == pytest.approx(1000 - 3 * 10)


@pytest.mark.parametrize("name", READS)
def test_each_reader_is_its_spans_self_ms_per_block(name):
    got = READERS[name].read(_run(tracing.Trace(_events())))
    assert got == pytest.approx(SELF_US[READS[name]] / 1e3 / 2)


@pytest.mark.parametrize("name", READS)
def test_silent_without_the_programs_dispatch_spans(name):
    assert READERS[name].read(_run(tracing.Trace(_events(dispatch=False)))) is None
    assert READERS[name].read(_run(None)) is None
    assert READERS[name].read(_run(tracing.Trace(_events()), blocks=0)) is None


def test_idle_gaps_name_the_programs_innermost_span():
    gaps = dict(tracing.Trace(_events()).idle_gaps())
    assert gaps == pytest.approx({"session: tsdr/fanout": 195e-6})


def test_the_new_metrics_are_entries_of_both_cells():
    entries = {m["name"]: m for m in manifest.load()["per_layer"]}
    for name in READS:
        m = entries[name]
        assert (m["source"], m["unit"], m["moves"]) == ("program_span", "ms", "ingest_msps")
        assert m["workloads"] == ["wide64-premade", "multi8x16-premade"]
