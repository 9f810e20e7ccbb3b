"""BENCHMARK.json and the files it names, found by name:

  a configuration   portbench/configs/<config>.json   (the entry's `file`)
  a traffic mix     portbench/traffic/<traffic>.json, whose `driver` names
                    portbench/traffic/<driver>.py, a module with
                    drive(ctx) -> dict (see harness.py)
  a per-layer metric portbench/metrics/<metric name>.py, a module with
                    read(run) -> float | None

A cell is a configuration, a mix and a chip count; nothing else in the
harness names a cell, a configuration, a mix or a metric. A later change
adds one by adding its file and its entry."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell:
    def __init__(self, root: str, manifest: dict, name: str):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        with open(os.path.join(root, self.config_entry["file"])) as f:
            self.config = json.load(f)
        bench = os.path.join(root, "portbench")
        with open(os.path.join(bench, "traffic", self.entry["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        self.end_to_end = [m for m in manifest["end_to_end"] if _in_cell(m, name)]
        self.per_layer = [m for m in manifest["per_layer"] if _in_cell(m, name)]
        self.readers = {m["name"]: load_reader(bench, m["name"]) for m in self.per_layer}
        self.driver = load_driver(bench, self.traffic["driver"])


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _load(bench_dir: str, folder: str, name: str, entry: str):
    """portbench/<folder>/<name>.py as a module with a callable `entry`,
    loaded from its path (a metric's name may hold dots)."""
    path = os.path.join(bench_dir, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, entry, None)):
        raise TypeError(f"{path} has no {entry}()")
    return mod


def load_reader(bench_dir: str, name: str):
    return _load(bench_dir, "metrics", name, "read")


def load_driver(bench_dir: str, name: str):
    return _load(bench_dir, "traffic", name, "drive")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)
