"""BENCHMARK.json and the files it names, found by name:

  a configuration   portbench/configs/<config>.json   (the entry's `file`)
  a traffic mix     portbench/traffic/<traffic>.json, whose `driver` names
                    portbench/traffic/<driver>.py, a module with
                    drive(ctx) -> dict (see harness.py)
  a per-layer metric portbench/metrics/<metric name>.py, a module with
                    read(run) -> float | None
  a reference       portbench/reference/<reference>.py, the configuration's
                    `reference` (step.py where it names none): Reference,
                    LEAVES, ARRAYS, INTEGERS as step.py has them
  a session maker   portbench/sessions/<session>.py, the configuration's
                    `session` (default.py where it names none): a module
                    with make(ctx, sources, timed) -> the receiver and
                    channel_leaves(session, c) -> channel c's state leaves

A cell is a configuration, a mix and a chip count; nothing else in the
harness names a cell, a configuration, a mix, a reference, a session maker
or a metric. A later change adds one by adding its file and its entry. A
name that finds no file fails here, before a run's set-up."""

from __future__ import annotations

import ast
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names no benchmark process may load (compared whole: the
# port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "tempestsdr_tpu")
PORT = "tempestsdr_tpu_torch"


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
        self.session, self.reference = load_receiver(bench, self.config)


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _path(bench_dir: str, folder: str, name: str) -> str:
    path = os.path.join(bench_dir, folder, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {os.path.relpath(path, os.path.dirname(bench_dir))} "
                                f"for the name {name!r}")
    return path


def _load(bench_dir: str, folder: str, name: str, *entries: str, package: bool = False):
    """portbench/<folder>/<name>.py as a module with a callable for each of
    `entries`, loaded from its path (a metric's name may hold dots); with
    `package`, as portbench.<folder>.<name>, so that it may import its
    neighbours relatively (not entered in sys.modules)."""
    path = _path(bench_dir, folder, name)
    mod_name = f"portbench.{folder}.{name}" if package else \
        f"portbench_{folder}_{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for entry in entries:
        if not callable(getattr(mod, entry, None)):
            raise TypeError(f"{path} has no {entry}()")
    return mod


def load_reader(bench_dir: str, name: str):
    return _load(bench_dir, "metrics", name, "read")


def load_driver(bench_dir: str, name: str):
    return _load(bench_dir, "traffic", name, "drive")


def imported(path: str) -> set:
    """Top-level names of the absolute imports in a Python file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def load_reference(bench_dir: str, name: str):
    """reference/<name>.py: step.py's interface, importing nothing of the
    port or of JAX."""
    if not name.isidentifier():
        raise ValueError(f"a reference is named as a Python module, not {name!r}")
    found = imported(_path(bench_dir, "reference", name)) & {PORT, *FORBIDDEN}
    if found:
        raise ImportError(f"reference {name!r} imports {sorted(found)}")
    mod = _load(bench_dir, "reference", name, "Reference", package=True)
    for attr in ("LEAVES", "ARRAYS", "INTEGERS"):
        if not isinstance(getattr(mod, attr, None), tuple):
            raise TypeError(f"reference {name!r} has no {attr} tuple")
    return mod


def load_session(bench_dir: str, name: str):
    return _load(bench_dir, "sessions", name, "make", "channel_leaves")


def load_receiver(bench_dir: str, cfg: dict):
    """(session maker, reference module) of a configuration; the reference
    is asked for every channel's geometry under the configuration's
    `params`, so one it does not model fails here too."""
    from .reference.geometry import Geometry

    session = load_session(bench_dir, cfg.get("session", "default"))
    reference = load_reference(bench_dir, cfg.get("reference", "step"))
    for c in range(cfg["channels"]):
        reference.Reference(Geometry.of(cfg, c), "cpu", params=cfg["params"])
    return session, reference


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)
