"""Run one cell of the benchmark once, on the card this process finds:

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. Set-up, then the measured window of S seconds,
then the check against the plain reference; prints each compared number
beside its limit as the last lines of standard error, and one JSON object as
the last line of standard output:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"], "checks"}

With --trace 0 the metrics are the cell's end-to-end metrics; with --trace 1
its per-layer metrics, from a stretch of the window under torch.profiler.
Exits with another code than 0, printing no result, without a CUDA card (or
fewer than the cell asks for), without the program beside it, or when JAX or
the JAX package was loaded: looked for once the window has closed, and
again after the check and the metric readers, just before the result."""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def result_line(cell, res: dict, device: dict, numbers: dict, trace=None) -> dict:
    """The result line: correct, attempted, failed, metrics, device, [breakdown,]
    checks (the compared numbers beside their limits, last)."""
    from portbench.reference import check as ck

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in res["metrics"].items() if k in units}
    ok, rows = ck.verdict(numbers, cell.config["limits"])
    ok = ok and res["error"] is None and numbers["frames"] > 0
    line = dict(correct=bool(ok), attempted=res["attempted"], failed=res["failed"],
                metrics=metrics, device=device)
    if trace is not None:
        line["breakdown"] = dict(device_ops=trace.top_device_ops(), idle_gaps=trace.idle_gaps())
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return line


def refused(found: list) -> bool:
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
    return bool(found)


def emit(line: dict) -> int:
    """Prints the result line, unless the process has loaded JAX or the JAX
    package by now (the check and the readers ran after the first look)."""
    from portbench import harness

    if refused(harness.forbidden_modules()):
        return 3
    print(json.dumps(line))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np

    from portbench import harness, manifest

    cell = manifest.Cell(ROOT, manifest.load(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    seed = args.seed % (1 << 63)
    res = harness.run_cell(cell, seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    if refused(harness.forbidden_modules()):
        return 3
    if res["error"] is not None:
        print(res["error"], file=sys.stderr)
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=cell.chips,
                  memory_peak_bytes=res["mem_peak"])
    trace = None
    if args.trace:
        w = res["window"]
        trace = w.prof.read()
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        run = types.SimpleNamespace(trace=trace, geometry=res["geometry"],
                                    geometries=res["geometries"],
                                    blocks_traced=(w.traced_to or 0) - (w.traced_from or 0),
                                    channels=res["n_channels"], config=cell.config,
                                    traffic=cell.traffic)
        res["metrics"] = {}
        for name, reader in cell.readers.items():
            value = reader.read(run)
            if value is not None:
                res["metrics"][name] = value
    t_check = time.monotonic()
    numbers = harness.check_run(res, cell.config, "cuda")
    print(f"portbench: set-up {res['setup_s']:.3f} s, window {res['window_s']:.3f} s, "
          f"{res['blocks']} blocks, check {time.monotonic() - t_check:.3f} s", file=sys.stderr)
    line = result_line(cell, res, device, numbers, trace)
    per_s = np.bincount((np.asarray(res["window"].asked) - res["window"].t0).astype(int))
    print(f"portbench: blocks asked for in each second of the window {per_s.tolist()}",
          file=sys.stderr)
    compared = {k: numbers[k] for k in ("frames", "plots", "stretches", "blocks", "from_start",
                                        "long_mismatches")}
    print(f"portbench: compared {json.dumps(compared)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return emit(line)


if __name__ == "__main__":
    sys.exit(main())
