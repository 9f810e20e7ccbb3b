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


def mixed_config() -> dict:
    """Three channels of their own modes, two heights and two refresh rates:
    100 lines at 60 Hz, 120 at 60 Hz, 100 at 75 Hz, each emitter's raster
    as many lines with an active area of its own."""
    cfg = tiny_config(3)
    cfg.update(name="tiny-mixed", height=[100, 120, 100], refreshrate=[60, 60, 75],
               raster=dict(lines=[100, 120, 100], total_width=[200, 166, 160],
                           active=[[160, 80], [130, 100], [128, 80]]))
    return cfg


def traffic(name: str) -> dict:
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        return json.load(f)


class Cell:
    """What the harness reads of a cell, without BENCHMARK.json."""

    def __init__(self, cfg: dict, traffic_: dict, bench: str = BENCH):
        self.config, self.traffic = cfg, traffic_
        self.end_to_end = [dict(name="setup_s", unit="s"), dict(name="ingest_msps", unit="MS/s")]
        self.per_layer = []
        self.driver = manifest.load_driver(bench, traffic_["driver"])
        self.session, self.reference = manifest.load_receiver(bench, cfg)


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


FILES = os.path.join(BENCH, "tests", "files")


def with_cell(root: str, cfg: dict, files=()) -> dict:
    """Adds the configuration `cfg`, the modules `files` (paths under
    tests/files/, copied to the same path under portbench/) and a cell
    `<name>-premade` to the benchmark under root, by new files and new
    entries only; returns the new manifest."""
    for rel in files:
        shutil.copy(os.path.join(FILES, rel), os.path.join(root, "portbench", rel))
    with open(os.path.join(root, "portbench", "configs", cfg["name"] + ".json"), "w") as f:
        json.dump(cfg, f)
    m = copy.deepcopy(manifest.load(root))
    m["configs"].append(dict(name=cfg["name"], source="https://example.org/" + cfg["name"],
                             file=f"portbench/configs/{cfg['name']}.json", reduced=[],
                             why="a test"))
    m["workloads"].append(dict(name=cfg["name"] + "-premade", config=cfg["name"],
                               traffic="premade", chips=1, why="a test"))
    m["end_to_end"][1]["workloads"].append(cfg["name"] + "-premade")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    return m


def files_of(root: str) -> dict:
    """Every .py and .json file under root but BENCHMARK.json, by path."""
    return {os.path.join(dp, p): open(os.path.join(dp, p), "rb").read()
            for dp, _, fs in os.walk(root) for p in fs
            if p.endswith((".py", ".json")) and p != "BENCHMARK.json"}
