"""A configuration small enough for the CPU, for the benchmark's tests: the
64 MS/s configuration's keys at 1 MS/s, 100 lines, 8192-sample blocks."""

import copy
import json
import os
import shutil

from portbench import manifest

BENCH = os.path.join(manifest.ROOT, "portbench")


def tiny_config(channels: int = 1) -> dict:
    with open(os.path.join(BENCH, "configs", "vesa800x600-64msps.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", samplerate=1000000, height=100, block_samples=8192, channels=channels,
               raster=dict(lines=100, total_width=[200 + 8 * c for c in range(channels)],
                           active=[160, 80]),
               check=dict(stretches=2, blocks=6, from_start=40), warm_blocks=6)
    return cfg


def traffic(name: str) -> dict:
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        return json.load(f)


class Cell:
    """What the harness reads of a cell, without BENCHMARK.json."""

    def __init__(self, cfg: dict, traffic_: dict):
        self.config, self.traffic = cfg, traffic_
        self.end_to_end = [dict(name="setup_s", unit="s"), dict(name="ingest_msps", unit="MS/s")]
        self.per_layer = []
        self.driver = manifest.load_driver(BENCH, traffic_["driver"])


DUMMY_DRIVER = '''"""A driver of its own: the premade loop, reporting blocks a second too."""

import os

from portbench import manifest

PREMADE = manifest.load_driver(os.path.dirname(os.path.dirname(__file__)), "premade")


def drive(ctx):
    out = PREMADE.drive(ctx)
    out["metrics"]["dummy_blocks_s"] = ctx.window.blocks / (out["t_end"] - ctx.window.t0)
    return out
'''


def copy_of_benchmark(dst: str) -> str:
    """BENCHMARK.json and portbench/ copied under dst (the root of a checkout
    that holds the benchmark and nothing else); returns dst."""
    shutil.copytree(BENCH, os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), dst)
    return dst


def with_dummy(root: str) -> dict:
    """Adds a configuration, a traffic mix with a driver of its own, an
    end-to-end and a per-layer metric and a cell that uses them to the
    benchmark under root, by new files and new entries only; returns the new
    manifest."""
    cfg = tiny_config()
    cfg["name"] = "dummy-1msps"
    with open(os.path.join(root, "portbench", "configs", "dummy-1msps.json"), "w") as f:
        json.dump(cfg, f)
    t = traffic("premade")
    t.update(why="a dummy mix", driver="dummy_driver")
    with open(os.path.join(root, "portbench", "traffic", "dummy-mix.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(root, "portbench", "traffic", "dummy_driver.py"), "w") as f:
        f.write(DUMMY_DRIVER)
    with open(os.path.join(root, "portbench", "metrics", "dummy_blocks.py"), "w") as f:
        f.write("def read(run):\n    return float(run.blocks_traced)\n")
    m = manifest.load(root)
    m = copy.deepcopy(m)
    m["configs"].append(dict(name="dummy-1msps", source="https://example.org/dummy",
                             file="portbench/configs/dummy-1msps.json", reduced=[],
                             why="a dummy"))
    m["workloads"].append(dict(name="dummy-cell", config="dummy-1msps", traffic="dummy-mix",
                               chips=1, why="a dummy"))
    m["per_layer"].append(dict(name="dummy_blocks", unit="blocks", better="higher",
                               source="host_clock", layer="session", moves="ingest_msps",
                               workloads=["dummy-cell"]))
    m["end_to_end"][1]["workloads"].append("dummy-cell")
    m["end_to_end"].append(dict(name="dummy_blocks_s", unit="blocks/s", better="higher",
                                bound=0.25, source="host_clock", workloads=["dummy-cell"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    return m
