"""BENCHMARK.json against the rules it is held to, and every file it names
found by name, a new configuration, mix and metric included."""

import json
import os
import re
import types

import pytest

from portbench import harness, manifest, run
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
M = manifest.load()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"]
    assert M["paths"] == ["portbench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_legal_and_unique(kind):
    names = [e["name"] for e in M[kind]]
    assert len(set(names)) == len(names)
    for name in names:
        assert NAME.match(name), name


def test_configs():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/configs/")
        with open(os.path.join(manifest.ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "width")) for k in c["reduced"])


def test_workloads():
    configs = {c["name"] for c in M["configs"]}
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert [w["name"] for w in M["workloads"]] == ["wide64-premade", "multi8x16-premade"]


def test_metrics():
    e2e = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in M["workloads"]}
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e and UNIT.match(m["unit"])
        assert _line(m["layer"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:  # every cell reports setup_s, another end-to-end metric, a layer's
        mine = [m for m in M["end_to_end"] if cell in m.get("workloads", [cell])]
        assert len(mine) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in M["per_layer"])
    for m in M["per_layer"]:  # each metric's cells report the metric it moves
        moved = next(e for e in M["end_to_end"] if e["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = manifest.Cell(manifest.ROOT, M, cell)
    assert c.config["name"] == c.entry["config"]
    assert callable(c.driver.drive)
    assert set(c.readers) == {m["name"] for m in c.per_layer}
    assert all(callable(r.read) for r in c.readers.values())


def test_a_new_config_mix_driver_and_metric_are_files_alone(tmp_path):
    """A later change adds a configuration, a mix with a driver of its own,
    an end-to-end metric that driver reports and a per-layer metric by new
    files and new entries; the harness finds them and runs the cell (on the
    CPU here) with no other edit."""
    root = tiny.copy_of_benchmark(str(tmp_path))
    before = {p: open(os.path.join(dp, p), "rb").read() for dp, _, fs in os.walk(root)
              for p in fs if p.endswith((".py", ".json")) and p != "BENCHMARK.json"}
    m = tiny.with_dummy(root)
    cell = manifest.Cell(root, m, "dummy-cell")
    assert cell.config["name"] == "dummy-1msps" and cell.traffic["why"] == "a dummy mix"
    assert cell.traffic["driver"] == "dummy_driver"
    assert cell.readers["dummy_blocks"].read(types.SimpleNamespace(blocks_traced=3)) == 3.0
    for p, body in before.items():  # nothing that was there changed
        found = [os.path.join(dp, p) for dp, _, fs in os.walk(root) if p in fs]
        assert any(open(f, "rb").read() == body for f in found)
    res = harness.run_cell(cell, 99, 1.0, False, "cpu")
    assert res["error"] is None and res["blocks"] > 0 and "ingest_msps" in res["metrics"]
    line = run.result_line(cell, res, {}, harness.check_run(res, cell.config, "cpu"))
    assert line["metrics"]["dummy_blocks_s"]["unit"] == "blocks/s" and line["correct"]


def test_run_seconds_fit_the_check_with_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (M["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200
