"""Per-block time of the streaming paths in this tree against other trees of
the port, in turns, on one NVIDIA card. Run from the repository's root:

    python3 -m tempestsdr_tpu_torch.stream.ab --tree LABEL=DIR [--tree ...]
        [--rounds N] [--blocks N] [--batches 1,4,8] [--channels C]
        [--live] [--rate SR --height H --block N]
        [--device cpu]

Each DIR holds a tree of the repository (e.g. an earlier commit unpacked with
`git archive`); the repository itself is the tree "this". Every round starts
one process per tree in the order given, then "this" twice, then the given
trees backwards (parent, change, change, parent for one --tree). Each process
imports tempestsdr_tpu_torch from its tree alone (its kernels are built into
that tree), makes `blocks` uint8 blocks of the synthetic emanation at the
geometry given (by default chip_smoke.py's 64 MS/s one: 64e6, 628 lines,
60 Hz, block 786432), and with Params():

- per batch size in --batches: a warm-up Session(batch_blocks=K), then
  Session.run over the blocks three times (host clock, ending in
  torch.cuda.synchronize()), then once under torch.profiler (the device
  ms a block, the sum of the device events' time, and the part of it that
  copies between the host and the card; the device operations a block; the
  profiler's own cost makes its wall time no measure);
- the bare eager step over the same blocks already on the card, three
  times;
- with --channels C > 0, MultiSession at config 5's geometry (16 MS/s, 628
  lines, 60 Hz, block 786432) over C uint8 sources of their own line
  widths, `blocks` blocks each: a warm-up run, three timed runs (ms a block
  and aggregate MS/s), one under the profiler.

With --live, each process measures the live path instead, over the
repo's replay plugin (native/replay_plugin.c, built from this tree, a
fixture to the reference's binary plugin ABI) replaying one uint8 capture
of the emanation that the parent writes, through `cplugin` and Session
at batch 1: a drop-free run (block=1) whose frames' digest must be equal
in every tree; three runs with the plugin unthrottled (pace=0, block=0:
ms a block, the host ms a block spent in the source's stream, the share
of samples dropped).

Prints one JSON line per process and a summary line (per tree: the median
over its processes of each process's best run, the one of least ms or
most MS/s, or of its one profiled value), and writes them to
chiprun_out/session_ab.json. Needs one card, unless --device cpu (for a
small geometry only, and no --channels).
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG5 = dict(samplerate=16e6, height=628, refreshrate=60.0, block_samples=786432)


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
    from tempestsdr_tpu_torch.stream.multisession import MultiSession
    from tempestsdr_tpu_torch.stream.pipeline import StepControls, make_step
    from tempestsdr_tpu_torch.stream.session import Session, SessionCallbacks
    from tempestsdr_tpu_torch.stream.state import init_state

    assert os.path.dirname(os.path.abspath(port.__file__)) == os.path.join(
        os.path.abspath(tree), "tempestsdr_tpu_torch"), port.__file__
    n_blocks = args.blocks

    def make_blocks(cfg, twidth):
        raster = render_test_pattern(cfg.height, twidth)
        pixclock = raster.shape[0] * raster.shape[1] * cfg.refreshrate
        return [np.clip(synth_iq(raster, samplerate=cfg.samplerate, pixelclock=pixclock,
                                 n_samples=cfg.block_samples, start_sample=b * cfg.block_samples,
                                 noise=0.02, seed=b) * 80.0 + 128.0, 0, 255).astype(np.uint8)
                for b in range(n_blocks)]

    class Replay(Source):
        def __init__(self, rate, blocks):
            self.rate, self.blocks = rate, blocks

        def init(self, params):
            pass

        def name(self):
            return "replay u8"

        def samplerate(self):
            return self.rate

        def stream(self, block_samples):
            for blk in self.blocks:
                yield SourceBlock(blk, 0)

        def stop(self):
            pass

    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def timed(run):
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        return (time.perf_counter() - t0) / n_blocks * 1e3

    def profiled(run):
        """(device ms, of which host transfers, device operations) a block
        of one run under the profiler."""
        from torch.profiler import ProfilerActivity, profile

        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)  # the trace keeps only device events inside its window
            run()
            sync()
            time.sleep(0.05)
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        transfer = [e for e in events if e.key.startswith(("Memcpy HtoD", "Memcpy DtoH"))]
        return (sum(e.self_device_time_total for e in events) / 1e3 / n_blocks,
                sum(e.self_device_time_total for e in transfer) / 1e3 / n_blocks,
                sum(e.count for e in events) / n_blocks)

    cfg = PipelineConfig(samplerate=args.rate, height=args.height, refreshrate=60.0,
                         block_samples=args.block)
    if args.plugin:
        print(json.dumps(dict(blocks=n_blocks, **live_child(cfg, args, dev, sync))))
        return
    blocks = make_blocks(cfg, cfg.width // 2)
    row = dict(blocks=n_blocks)
    for k in args.batches:
        frames = []

        def session_run():
            frames.clear()
            Session(cfg, Params(), Replay(cfg.samplerate, blocks),
                    SessionCallbacks(on_frame=frames.append), batch_blocks=k, device=dev).run()

        session_run()  # warm-up: the runner's capture
        row[f"session_ms_per_block_b{k}"] = [timed(session_run) for _ in range(3)]
        assert frames and all(np.isfinite(f).all() for f in frames)
        if dev.type == "cuda":
            (row[f"device_ms_per_block_b{k}"], row[f"transfer_ms_per_block_b{k}"],
             row[f"device_ops_per_block_b{k}"]) = profiled(session_run)
    step = make_step(cfg, Params(), device=dev)
    on_card = [torch.from_numpy(b).to(dev) for b in blocks]

    def step_run():
        state = init_state(cfg, device=dev)
        for raw in on_card:
            state, _ = step(state, raw, StepControls())

    row["step_ms_per_block"] = [timed(step_run) for _ in range(3)]
    if args.channels:
        c5 = PipelineConfig(**CONFIG5)
        srcs = [Replay(c5.samplerate, make_blocks(c5, c5.width // 2 + 8 * c))
                for c in range(args.channels)]
        def multi_run():
            MultiSession(c5, Params(), srcs, on_frame=lambda c, f: None, device=dev).run()

        multi_run()
        ms = [timed(multi_run) for _ in range(3)]
        row["multisession_ms_per_block"] = ms
        row["multisession_aggregate_msps"] = [
            args.channels * c5.block_samples / m / 1e3 for m in ms]
        (row["multisession_device_ms_per_block"], row["multisession_transfer_ms_per_block"],
         row["multisession_device_ops_per_block"]) = profiled(multi_run)
    print(json.dumps(row))


def live_child(cfg, args, dev, sync) -> dict:
    """The live measurements of one process (see --live)."""
    import numpy as np

    from tempestsdr_tpu_torch.params import Params
    from tempestsdr_tpu_torch.sources.base import Source, load_source
    from tempestsdr_tpu_torch.stream.session import Session, SessionCallbacks, warm_compile_step

    class Timed(Source):
        """A source, with the host seconds spent in its stream counted (not
        sources.tee.TeeSource: a tree older than the tee, as a parent under
        test may be, has none)."""

        def __init__(self, src):
            self.src, self.wait = src, 0.0

        def init(self, params):
            pass

        def name(self):
            return self.src.name()

        def samplerate(self):
            return self.src.samplerate()

        def stream(self, block_samples):
            it = iter(self.src.stream(block_samples))
            while True:
                t0 = time.perf_counter()
                blk = next(it, None)
                self.wait += time.perf_counter() - t0
                if blk is None:
                    return
                yield blk

        def stop(self):
            self.src.stop()

    def run(loader, n):
        src = Timed(load_source("cplugin", f"{args.plugin} {loader} -- {args.capture} "
                                           f"{int(cfg.samplerate)} uint8"))
        frames = []
        sess = Session(cfg, Params(), src, SessionCallbacks(on_frame=frames.append), device=dev)
        sync()
        t0 = time.perf_counter()
        sess.run(max_blocks=n)
        sync()
        wall = time.perf_counter() - t0
        dropped = sess.samples_dropped_total
        return (frames, wall / n * 1e3, src.wait / n * 1e3,
                dropped / (n * cfg.block_samples + dropped))

    warm_compile_step(cfg, Params(), raw_dtype=np.float32, device=dev)
    frames, *_ = run("block=1", args.blocks)
    assert frames and all(np.isfinite(f).all() for f in frames)
    row = dict(frames=len(frames),
               frames_sha256=hashlib.sha256(b"".join(f.tobytes() for f in frames)).hexdigest())
    over = [run("", args.blocks)[1:] for _ in range(3)]
    row.update(overload_ms_per_block=[o[0] for o in over],
               overload_source_ms_per_block=[o[1] for o in over],
               overload_drop_share=[o[2] for o in over])
    return row


def write_live_capture(rate, height, block, n_blocks, path) -> str:
    """This tree's replay plugin, built; and a uint8 capture of the
    emanation, n_blocks blocks and a tail, written to path."""
    sys.path.insert(0, REPO)
    import numpy as np

    from tempestsdr_tpu_torch import native
    from tempestsdr_tpu_torch.config import PipelineConfig
    from tempestsdr_tpu_torch.sources.synthetic import render_test_pattern, synth_iq

    cfg = PipelineConfig(samplerate=rate, height=height, refreshrate=60.0, block_samples=block)
    raster = render_test_pattern(cfg.height, cfg.width // 2)
    synth_iq(raster * 0.6, samplerate=cfg.samplerate, pixelclock=raster.size * cfg.refreshrate,
             n_samples=n_blocks * block + 1000, dc=0.3, noise=0.02,
             dtype=np.uint8).tofile(path)
    return native.build_replay_plugin()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--batches", default="1", help="batch sizes, e.g. 1,4,8")
    ap.add_argument("--channels", type=int, default=0)
    ap.add_argument("--rate", type=float, default=64e6)
    ap.add_argument("--height", type=int, default=628)
    ap.add_argument("--block", type=int, default=786432)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--live", action="store_true", help="the live path (see above)")
    ap.add_argument("--child", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--plugin", help=argparse.SUPPRESS)
    ap.add_argument("--capture", help=argparse.SUPPRESS)
    args = ap.parse_args()
    args.batches = [int(k) for k in args.batches.split(",")]
    if args.child:
        return child(args.child, args)
    tmp = tempfile.TemporaryDirectory()
    if args.live:
        args.capture = os.path.join(tmp.name, "live.u8")
        args.plugin = write_live_capture(args.rate, args.height, args.block, args.blocks,
                                         args.capture)
    trees = [tuple(t.split("=", 1)) for t in args.tree]
    order = trees + [("this", REPO)] * 2 + trees[::-1]
    smi = "cpu"
    if args.device != "cpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    opts = ["--blocks", str(args.blocks), "--batches", ",".join(map(str, args.batches)),
            "--channels", str(args.channels), "--rate", str(args.rate), "--height",
            str(args.height), "--block", str(args.block), "--device", args.device]
    if args.live:
        opts += ["--plugin", args.plugin, "--capture", args.capture]
    rows = []
    for rnd in range(args.rounds):
        for label, tree in order:
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", os.path.abspath(tree),
                 *opts],
                capture_output=True, text=True, timeout=900, cwd=tree,
                env=dict(os.environ, PYTHONPATH=os.path.abspath(tree)))
            assert run.returncode == 0, f"{label}: {run.stderr[-3000:]}"
            row = dict(round=rnd, tree=label, **json.loads(run.stdout.strip().splitlines()[-1]))
            print(json.dumps(row), flush=True)
            rows.append(row)
    summary = {}
    for label in dict(order):
        mine = [r for r in rows if r["tree"] == label]
        best = lambda k, v: (max if k.endswith("msps") else min)(v)  # noqa: E731
        summary[label] = {
            k: statistics.median(best(k, r[k]) if isinstance(r[k], list) else r[k] for r in mine)
            for k in mine[0] if k not in ("round", "tree", "blocks", "frames_sha256")}
    if args.live:
        digests = {r["frames_sha256"] for r in rows}
        summary["frames_equal_in_every_tree"] = len(digests) == 1
        assert len(digests) == 1, "the drop-free runs' frames differ between trees"
    tmp.cleanup()
    print("summary " + json.dumps(summary))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "session_ab.json"), "w") as f:
        json.dump(dict(card=smi, rows=rows, summary=summary), f, indent=1)


if __name__ == "__main__":
    main()
