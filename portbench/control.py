"""The check's control: the plain reference put in the receiver's place with
its pixel path in bfloat16, the step below the float32 the configurations
state, checked by the same comparison as a run. It has to come out as not
correct; the upper readings of the limits are its numbers.

    python3 portbench/control.py --workload CELL --seeds 1,2,3 [--device cuda]

For each seed it makes the cell's stream, runs the low-precision reference
(the configuration's own reference module, each channel at its own mode)
over the first blocks of every channel as a run's window would (the start
stretch from the initial state, further stretches at fixed blocks from the
control's own state, snapshots before and after each, and its state after
the first `from_start` blocks), compares with the
float64 reference and prints one JSON line of numbers and the verdict
against the configuration's limits. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(cfg: dict, seed: int, device: str, starts=None, reference=None) -> dict:
    """reference: the configuration's reference module (loaded by its name
    where None)."""
    from portbench import manifest
    from portbench.gen import emanation as em
    from portbench.reference import check as ck
    from portbench.reference.geometry import Geometry

    if reference is None:
        reference = manifest.load_reference(manifest.HERE, cfg.get("reference", "step"))
    n, n_ch, m = cfg["block_samples"], cfg["channels"], cfg["check"]["blocks"]
    from_start = cfg["check"]["from_start"]
    geometries = [Geometry.of(cfg, c) for c in range(n_ch)]
    periods = [em.channel_period_samples(cfg, c) for c in range(n_ch)]
    loops = [em.looped(em.channel_period(cfg, c, seed), n) for c in range(n_ch)]
    starts = starts or [0] + [m * (3 * j + 2) for j in range(cfg["check"]["stretches"])]
    lows = {g.key: reference.Reference(g, device, "bfloat16", cfg["params"]) for g in geometries}
    frames, plots, stretches = {}, {}, []
    for c in range(n_ch):
        low, period = lows[geometries[c].key], periods[c]
        st = low.init_state()
        k = 0
        mine = []
        for s0 in starts + [from_start]:
            while k < s0:  # the control's own blocks between stretches
                st, _, _ = low.step(st, em.block_at(loops[c], period, n, k), cfg["raw_format"])
                k += 1
            if s0 == from_start:
                break
            before = None if s0 == 0 else low.to_leaves(st)
            for k in range(s0, s0 + m):
                st, fr, pl = low.step(st, em.block_at(loops[c], period, n, k), cfg["raw_format"])
                frames[(k, c)] = [f.cpu().numpy() for f in fr]
                if pl is not None:
                    plots[(k, c)] = tuple(p.cpu().numpy() for p in pl)
            k = s0 + m
            mine.append(ck.Stretch(c, s0, m, before, low.to_leaves(st)))
        if k != from_start:
            raise ValueError("the control's stretches run past check.from_start")
        mine[0].anchor = (from_start, low.to_leaves(st))
        stretches += mine

    def raw_for(channel, k):
        return em.block_at(loops[channel], periods[channel], n, k), 0

    return ck.check(geometries, stretches, raw_for, frames, plots, cfg["raw_format"],
                    device=device, params=cfg["params"], reference=reference)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import manifest
    from portbench.reference import check as ck

    cell = manifest.Cell(ROOT, manifest.load(ROOT), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control_numbers(cell.config, seed, args.device, reference=cell.reference)
        ok, _ = ck.verdict(numbers, cell.config["limits"])
        print(json.dumps(dict(workload=args.workload, seed=seed, correct=ok, **numbers)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
