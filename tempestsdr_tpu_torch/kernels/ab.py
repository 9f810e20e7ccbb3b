"""A/B of other sources of the resample kernels K1 and K3 against the
committed ones, on one NVIDIA card. Run from the repository's root:

    python3 -m tempestsdr_tpu_torch.kernels.ab [--earlier DIR] [--variant LABEL=DIR ...]
                                               [--only k1|k3] [--reps N]

Builds csrc/strided_resample.cu (K1) and csrc/chunked_resample.cu (K3) as
committed, and the files of the same names found in each DIR: --earlier
holds the first design (one 256-thread block a chunk with checked 4-byte
staging, one tile a block; K3's C entry took no group arguments) and is the
baseline when given; each --variant holds an edited copy with the committed C
interface (a file missing there is skipped; headers come from DIR first,
then csrc). For each geometry of chip_smoke.py it

1. compares every build's pixels and carries bit for bit with the first
   build over rates 1 and 1.001^+-1, phases zero, negative, in the tail, near
   the block's end and past it (n_out == 0), and an envelope that starts
   4 bytes past a 16-byte boundary;
2. times every build with chip_smoke.time_launches, L2 flushed and warm (the
   envelope just written by a torch.cat), and as one of eight launches in a
   row (chip_smoke.each_of), in turns: the whole list forwards, then
   backwards, keeping the smaller time of the two turns.

Prints one JSON line per kernel and geometry and writes them to
chiprun_out/kernel_ab.json. Needs nvcc and one card.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from . import build
from .chunked_resample import group_tiles, window_len
from .strided_resample import k1_margin

SOURCE = {"k1": "strided_resample", "k3": "chunked_resample"}
P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
HEAD = [P, LL, P, P, LL, P, P, P, LL, I]  # x .. taps, common to every entry


def compile_all(jobs, lib_dir):
    """jobs: {lib path: (source path, include dir)}; one nvcc each, all at once."""
    os.makedirs(lib_dir, exist_ok=True)
    procs = {lib: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", inc, "-I", build.CSRC, "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for lib, (src, inc) in jobs.items()}
    for lib, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib}:\n{log}")
        print(os.path.basename(lib), " ".join(
            ln.split("Used ")[1] for ln in log.splitlines() if "Used " in ln))


def make_launchers(kind, earlier, variants, dev):
    """{label: fn(cfg, x, phase, inv) -> (pixels, n_out, new_phase)}, the
    baseline first."""
    name = SOURCE[kind]
    dirs = ({"earlier": earlier} if earlier else {}) | {"committed": build.CSRC} | variants
    dirs = {label: d for label, d in dirs.items()
            if os.path.exists(os.path.join(d, name + ".cu"))}
    lib_dir = os.path.join(build.BUILD, "ab")
    paths = {label: os.path.join(lib_dir, f"lib{kind}-{label}.so") for label in dirs}
    compile_all({paths[label]: (os.path.join(d, name + ".cu"), d) for label, d in dirs.items()},
                lib_dir)

    def launcher(label):
        fn = getattr(ctypes.CDLL(paths[label]), "tsdr_" + name)
        first_design = label == "earlier"
        extra = [I, I] if kind == "k1" else [I] if first_design else [I, I, I]
        fn.restype, fn.argtypes = I, [*HEAD, *extra, P]

        def launch(cfg, x, phase, inv):
            n, mp, taps = cfg.block_samples, cfg.max_block_pixels, cfg.resample_taps
            out = torch.empty((mp,), dtype=torch.float32, device=dev)
            n_out = torch.empty((), dtype=torch.int32, device=dev)
            new_phase = torch.empty((), dtype=torch.int64, device=dev)
            if kind == "k1":
                tail = k1_margin(cfg.samples_per_pixel)
            else:
                tiles = group_tiles(cfg.samples_per_pixel, taps)
                tail = () if first_design else (
                    tiles, window_len(cfg.samples_per_pixel, taps, tiles))
                tail = (window_len(cfg.samples_per_pixel, taps), *tail)
            err = fn(x.data_ptr(), x.shape[0], phase.data_ptr(), inv.data_ptr(), n,
                     out.data_ptr(), n_out.data_ptr(), new_phase.data_ptr(), mp, taps, *tail,
                     torch.cuda.current_stream(dev).cuda_stream)
            assert err == 0, (label, err)
            return out, n_out, new_phase

        return launch

    return {label: launcher(label) for label in dirs}


def compare(cfg, launchers, dev, rate_inv):
    """Every build against the first, bit for bit; returns the case count."""
    rng = np.random.default_rng(11)
    n, taps = cfg.block_samples, cfg.resample_taps
    x_pad = torch.cat([torch.zeros(1, device=dev),
                       torch.from_numpy(rng.random(n + taps, dtype=np.float32) * 1.5).to(dev)])
    views = {"aligned": x_pad[1:].clone(), "4 bytes past": x_pad[1:]}
    assert views["aligned"].data_ptr() % 16 == 0 and views["4 bytes past"].data_ptr() % 16 == 4
    phases = {"zero": 0, "negative": -123456789, "in the tail": -(1 << 40) - 12345,
              "near the end": (n - 3) << 40, "past the block": (n + 5) << 40}
    labels = list(launchers)
    cases = 0
    for scale in (1.0, 1.001, 1 / 1.001):
        inv = rate_inv(cfg, scale)
        for pname, ph in phases.items():
            phase = torch.tensor(ph, dtype=torch.int64, device=dev)
            for vname, x in views.items():
                want = launchers[labels[0]](cfg, x, phase, inv)
                torch.cuda.synchronize()
                for label in labels[1:]:
                    got = launchers[label](cfg, x, phase, inv)
                    torch.cuda.synchronize()
                    for g, w, what in zip(got, want, ("pixels", "n_out", "new_phase")):
                        assert torch.equal(g, w), (label, scale, pname, vname, what,
                                                   (g != w).sum().item())
                if pname == "past the block":
                    assert int(want[1]) == 0 and not want[0].any()
                cases += 1
    return cases


def time_all(cfg, launchers, reps, dev, smoke):
    rng = np.random.default_rng(12)
    n, taps = cfg.block_samples, cfg.resample_taps
    inv = smoke.rate_inv(cfg, 1.0)
    phase = torch.zeros((), dtype=torch.int64, device=dev)
    tail = torch.zeros(taps, device=dev)
    body = torch.from_numpy(rng.random(n, dtype=np.float32) * 1.5).to(dev)
    x = torch.cat([tail, body])
    fresh = lambda: torch.cat([tail, body])  # noqa: E731
    times = {label: {"ms": [], "ms_warm": [], "ms_each_of_8": []} for label in launchers}
    labels = list(launchers)
    for turn in (labels, labels[::-1]):
        for label in turn:
            fn = launchers[label]
            times[label]["ms"].append(smoke.time_launches(lambda: fn(cfg, x, phase, inv), reps))
            times[label]["ms_warm"].append(smoke.time_launches(
                lambda xw: fn(cfg, xw, phase, inv), reps, warm_input=fresh))
            times[label]["ms_each_of_8"].append(
                smoke.each_of(lambda: fn(cfg, x, phase, inv), reps=reps))
    return {label: {k: min(v) for k, v in t.items()} | {k + "_turns": v for k, v in t.items()}
            for label, t in times.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", help="directory with the first design's .cu sources")
    ap.add_argument("--variant", action="append", default=[], metavar="LABEL=DIR")
    ap.add_argument("--only", choices=("k1", "k3"))
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    import chip_smoke as smoke  # the timing method and geometries of the smoke run's rows

    variants = dict(v.split("=", 1) for v in args.variant)
    smi = smoke.card()
    rows = []
    for kind in ("k1", "k3"):
        if args.only and kind != args.only:
            continue
        launchers = make_launchers(kind, args.earlier, variants, smoke.DEV)
        for gname, cfg in smoke.GEOMETRIES.items():
            row = dict(card=smi, kernel=kind, geometry=gname, baseline=next(iter(launchers)),
                       bit_identical_cases=compare(cfg, launchers, smoke.DEV, smoke.rate_inv),
                       times=time_all(cfg, launchers, args.reps, smoke.DEV, smoke))
            print(json.dumps(row))
            rows.append(row)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_ab.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
