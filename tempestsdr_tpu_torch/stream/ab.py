"""Per-block time of the single-channel path in this tree against other
trees of the port, in turns, on one NVIDIA card. Run from the repository's
root:

    python3 -m tempestsdr_tpu_torch.stream.ab --tree LABEL=DIR [--tree ...]
        [--rounds N] [--blocks N] [--rate SR --height H --block N] [--device cpu]

Each DIR holds a tree of the repository (e.g. an earlier commit unpacked with
`git archive`); the repository itself is the tree "this". Every round starts
one process per tree in the order given, then "this" twice, then the given
trees backwards (parent, change, change, parent for one --tree). Each process
imports tempestsdr_tpu_torch from its tree alone (its kernels are built into
that tree), makes `blocks` uint8 blocks of the synthetic emanation at the
geometry given (by default chip_smoke.py's 64 MS/s one: 64e6, 628 lines,
60 Hz, block 786432), runs a warm-up session, then with Params() times,
three times each:

- Session.run over the blocks (host clock, ending in torch.cuda.synchronize());
- the bare step over the same blocks already on the card.

Prints one JSON line per process and a summary line (per tree: the median
over its processes of each process's best run, ms a block), and writes them
to chiprun_out/session_ab.json. Needs one card, unless --device cpu (for a
small geometry only).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def child(tree: str, args) -> None:
    """Runs in a process of its own: times `tree`'s port and prints one JSON
    line."""
    sys.path[:] = [tree] + [p for p in sys.path[1:] if os.path.abspath(p or ".") != REPO]
    import numpy as np
    import torch

    import tempestsdr_tpu_torch as port
    from tempestsdr_tpu_torch.config import PipelineConfig
    from tempestsdr_tpu_torch.params import Params
    from tempestsdr_tpu_torch.sources.base import Source, SourceBlock
    from tempestsdr_tpu_torch.sources.synthetic import render_test_pattern, synth_iq
    from tempestsdr_tpu_torch.stream.pipeline import StepControls, make_step
    from tempestsdr_tpu_torch.stream.session import Session, SessionCallbacks
    from tempestsdr_tpu_torch.stream.state import init_state

    assert os.path.dirname(os.path.abspath(port.__file__)) == os.path.join(
        os.path.abspath(tree), "tempestsdr_tpu_torch"), port.__file__
    n_blocks = args.blocks
    cfg = PipelineConfig(samplerate=args.rate, height=args.height, refreshrate=60.0,
                         block_samples=args.block)
    raster = render_test_pattern(cfg.height, cfg.width // 2)
    pixclock = raster.shape[0] * raster.shape[1] * cfg.refreshrate
    blocks = [np.clip(synth_iq(raster, samplerate=cfg.samplerate, pixelclock=pixclock,
                               n_samples=cfg.block_samples, start_sample=b * cfg.block_samples,
                               noise=0.02, seed=b) * 80.0 + 128.0, 0, 255).astype(np.uint8)
              for b in range(n_blocks)]

    class Replay(Source):
        def init(self, params):
            pass

        def name(self):
            return "replay u8"

        def samplerate(self):
            return cfg.samplerate

        def stream(self, block_samples):
            for blk in blocks:
                yield SourceBlock(blk, 0)

        def stop(self):
            pass

    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    Session(cfg, Params(), Replay(), device=dev).run(max_blocks=n_blocks)  # warm-up
    session_ms, frames = [], []
    for _ in range(3):
        frames.clear()
        sess = Session(cfg, Params(), Replay(), SessionCallbacks(on_frame=frames.append),
                       device=dev)
        sync()
        t0 = time.perf_counter()
        sess.run(max_blocks=n_blocks)
        sync()
        session_ms.append((time.perf_counter() - t0) / n_blocks * 1e3)
    assert frames and all(np.isfinite(f).all() for f in frames)
    step = make_step(cfg, Params(), device=dev)
    on_card = [torch.from_numpy(b).to(dev) for b in blocks]
    step_ms = []
    for _ in range(3):
        state = init_state(cfg, device=dev)
        sync()
        t0 = time.perf_counter()
        for raw in on_card:
            state, out = step(state, raw, StepControls())
        sync()
        step_ms.append((time.perf_counter() - t0) / n_blocks * 1e3)
    print(json.dumps(dict(session_ms_per_block=session_ms, step_ms_per_block=step_ms,
                          frames=len(frames), blocks=n_blocks)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--rate", type=float, default=64e6)
    ap.add_argument("--height", type=int, default=628)
    ap.add_argument("--block", type=int, default=786432)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args)
    trees = [tuple(t.split("=", 1)) for t in args.tree]
    order = trees + [("this", REPO)] * 2 + trees[::-1]
    smi = "cpu"
    if args.device != "cpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    geometry = ["--blocks", str(args.blocks), "--rate", str(args.rate), "--height",
                str(args.height), "--block", str(args.block), "--device", args.device]
    rows = []
    for rnd in range(args.rounds):
        for label, tree in order:
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", os.path.abspath(tree),
                 *geometry],
                capture_output=True, text=True, timeout=600, cwd=tree,
                env=dict(os.environ, PYTHONPATH=os.path.abspath(tree)))
            assert run.returncode == 0, f"{label}: {run.stderr[-3000:]}"
            row = dict(round=rnd, tree=label, **json.loads(run.stdout.strip().splitlines()[-1]))
            print(json.dumps(row), flush=True)
            rows.append(row)
    summary = {}
    for label in dict(order):
        mine = [r for r in rows if r["tree"] == label]
        summary[label] = {k: statistics.median(min(r[k]) for r in mine)
                          for k in ("session_ms_per_block", "step_ms_per_block")}
    print("summary " + json.dumps(summary))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "session_ab.json"), "w") as f:
        json.dump(dict(card=smi, rows=rows, summary=summary), f, indent=1)


if __name__ == "__main__":
    main()
