"""A/B of other sources of the port's kernels against the committed ones, on
one NVIDIA card. Run from the repository's root:

    python3 -m tempestsdr_tpu_torch.kernels.ab [--earlier DIR] [--variant LABEL=DIR ...]
                                               [--only KIND[,KIND ...]] [--reps N]

KIND is one of k1 (csrc/strided_resample.cu), k2 and k2p (K2 and K2',
csrc/fused_demod_resample.cu), k3, k4 and gather (csrc/chunked_resample.cu;
gather is K4's window gather). Builds each source as committed and the files
of the same names found in each DIR: --earlier holds an earlier commit's
csrc/ (e.g. unpacked from `git archive`), whose C entries may lack the group
arguments of K3 and K4 (read from the source) and which has no gather
kernel, and is the baseline when given; each --variant holds an edited copy with the committed C
interface (a file missing there is skipped; headers come from DIR first,
then csrc). The gather's baseline is its plain PyTorch version. For each
geometry of chip_smoke.py it

1. compares every build's outputs (pixels and carries; K2 also the envelope;
   the gather its windows and fracs) bit for bit with the first build over
   rates 1 and 1.001^+-1, phases zero, negative, in the tail, near the
   block's end and past it (n_out == 0), and an input that starts 4 bytes
   past a 16-byte boundary (K2: uint8 and int8 raw blocks, each also 4 bytes
   past); K4 takes the windows of the plain gather at its build's row width;
2. times every build with chip_smoke.time_launches, L2 flushed and warm (the
   input just written, as the step leaves it), and as one of eight launches
   in a row (chip_smoke.each_of), in turns: the whole list forwards, then
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
from .chunked_resample import (
    TILE,
    gather_windows_plain,
    group_tiles,
    k4_group_tiles,
    k4_window_len,
    window_len,
)
from .strided_resample import k1_margin

SOURCE = {"k1": "strided_resample", "k2": "fused_demod_resample",
          "k2p": "fused_demod_resample", "k3": "chunked_resample", "k4": "chunked_resample",
          "gather": "chunked_resample"}
RESAMPLE_OUT = ("pixels", "n_out", "new_phase")
OUTPUTS = {kind: RESAMPLE_OUT for kind in SOURCE} | {
    "k2": ("env", *RESAMPLE_OUT), "k2p": ("env", *RESAMPLE_OUT), "gather": ("windows", "fracs")}
P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
HEAD = [P, LL, P, P, LL, P, P, P, LL, I]  # x .. taps, common to K1's and K3's entries


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


def takes_tiles(lib_dir_src, entry):
    """Whether the C entry `entry` of the source at lib_dir_src takes the
    group argument `tiles` (K3's and K4's first designs did not)."""
    with open(lib_dir_src) as f:
        text = f.read()
    args = text[text.index(f'extern "C" int {entry}('):]
    return "int tiles" in args[:args.index(")")]


def build_libs(kinds, earlier, variants):
    """{source name: {label: loaded library}} for the sources the kinds need,
    the baseline first; each library carries `grouped`, whether its K3 and
    K4 entries take the group arguments."""
    dirs = ({"earlier": earlier} if earlier else {}) | {"committed": build.CSRC} | variants
    lib_dir = os.path.join(build.BUILD, "ab")
    jobs, paths = {}, {}
    for name in dict.fromkeys(SOURCE[kind] for kind in kinds):
        for label, d in dirs.items():
            src = os.path.join(d, name + ".cu")
            if os.path.exists(src):
                paths[name, label] = os.path.join(lib_dir, f"lib{name}-{label}.so")
                jobs[paths[name, label]] = (src, d)
    compile_all(jobs, lib_dir)
    libs = {}
    for (name, label), path in paths.items():
        lib = libs.setdefault(name, {})[label] = ctypes.CDLL(path)
        if name == "chunked_resample":
            lib.grouped = {entry: takes_tiles(jobs[path][0], entry)
                           for entry in ("tsdr_chunked_resample", "tsdr_windows_resample")}
    return libs


def _entry(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = I, argtypes
    return fn


def _resample_outputs(cfg, dev):
    return (torch.empty((cfg.max_block_pixels,), dtype=torch.float32, device=dev),
            torch.empty((), dtype=torch.int32, device=dev),
            torch.empty((), dtype=torch.int64, device=dev))


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def make_launcher(kind, label, lib, dev):
    """fn(cfg, data, phase, inv) -> the kind's OUTPUTS, for one build. data
    is the envelope x_ext (k1, k3, gather), (windows, fracs) from
    prepare_k4 (k4) or (raw, tail) (k2, k2p)."""
    if kind == "gather" and lib is None:
        return lambda cfg, x, phase, inv: gather_windows_plain(
            x, phase, inv, max_pix=cfg.max_block_pixels, taps=cfg.resample_taps,
            inv_nominal=cfg.samples_per_pixel)
    if kind in ("k1", "k3"):
        first_design = kind == "k3" and not lib.grouped["tsdr_chunked_resample"]
        extra = [I, I] if kind == "k1" else [I] if first_design else [I, I, I]
        fn = _entry(lib, "tsdr_" + SOURCE[kind], [*HEAD, *extra, P])

        def launch(cfg, x, phase, inv):
            taps, inv0 = cfg.resample_taps, cfg.samples_per_pixel
            outs = _resample_outputs(cfg, dev)
            if kind == "k1":
                tail = k1_margin(inv0)
            else:
                tiles = group_tiles(inv0, taps)
                tail = (window_len(inv0, taps),
                        *(() if first_design else (tiles, window_len(inv0, taps, tiles))))
            err = fn(x.data_ptr(), x.shape[0], *_ptrs(phase, inv), cfg.block_samples,
                     *_ptrs(*outs), cfg.max_block_pixels, taps, *tail, _stream(dev))
            assert err == 0, (kind, label, err)
            return outs
    elif kind == "k4":
        first_design = not lib.grouped["tsdr_windows_resample"]
        fn = _entry(lib, "tsdr_windows_resample",
                    [P, P, P, P, LL, P, P, P, LL, I, *([] if first_design else [I]), P])

        def launch(cfg, data, phase, inv):
            windows, fracs = data
            w_in = windows.shape[1]
            outs = _resample_outputs(cfg, dev)
            err = fn(*_ptrs(windows, fracs, phase, inv), cfg.block_samples, *_ptrs(*outs),
                     cfg.max_block_pixels, w_in, *(() if first_design else (k4_group_tiles(w_in),)),
                     _stream(dev))
            assert err == 0, (kind, label, err)
            return outs
    elif kind == "gather":
        fn = _entry(lib, "tsdr_gather_windows", [P, LL, P, P, P, P, LL, I, I, P])

        def launch(cfg, x, phase, inv):
            n_tiles = -(-cfg.max_block_pixels // TILE)
            w_in = k4_window_len(cfg.samples_per_pixel, cfg.resample_taps)
            windows = torch.empty((n_tiles, w_in), dtype=torch.float32, device=dev)
            fracs = torch.empty((n_tiles,), dtype=torch.float32, device=dev)
            err = fn(x.data_ptr(), x.shape[0], *_ptrs(phase, inv, windows, fracs), n_tiles,
                     cfg.resample_taps, w_in, _stream(dev))
            assert err == 0, (kind, label, err)
            return windows, fracs
    else:  # k2, k2p
        fn = _entry(lib, "tsdr_fused_demod_resample",
                    [P, I, I, P, P, P, LL, P, P, P, P, LL, I, I, I, P])
        pairs = 2 if kind == "k2" else 1

        def launch(cfg, data, phase, inv):
            raw, tail = data
            env = torch.empty((cfg.block_samples,), dtype=torch.float32, device=dev)
            outs = _resample_outputs(cfg, dev)
            err = fn(raw.data_ptr(), int(raw.dtype == torch.int8), pairs,
                     *_ptrs(tail, phase, inv), cfg.block_samples, *_ptrs(env, *outs),
                     cfg.max_block_pixels, cfg.resample_taps, *k1_margin(cfg.samples_per_pixel),
                     _stream(dev))
            assert err == 0, (kind, label, err)
            return (env, *outs)
    return launch


def prepare_k4(lib):
    """K4's input from the envelope: the plain gather's windows and fracs at
    the build's row width (the first design's rows were not padded)."""
    def prepare(cfg, x, phase, inv):
        taps, inv0 = cfg.resample_taps, cfg.samples_per_pixel
        windows, fracs = gather_windows_plain(x, phase, inv, max_pix=cfg.max_block_pixels,
                                              taps=taps, inv_nominal=inv0)
        if not lib.grouped["tsdr_windows_resample"]:
            windows = windows[:, :window_len(inv0, taps)].contiguous()
        return windows, fracs

    return prepare


def make_launchers(kind, libs, dev):
    """({label: launch}, {label: prepare}), the baseline first. prepare turns
    the kind's test input into the launcher's data outside any timing."""
    built = libs[SOURCE[kind]]
    if kind == "gather":
        built = {"torch": None} | {k: v for k, v in built.items() if k != "earlier"}
    launchers = {label: make_launcher(kind, label, lib, dev) for label, lib in built.items()}
    same = lambda cfg, data, phase, inv: data  # noqa: E731
    return launchers, {label: prepare_k4(lib) if kind == "k4" else same
                       for label, lib in built.items()}


def case_inputs(kind, cfg, rng, dev):
    """{name: data}: the kind's input aligned to 16 bytes and as a view that
    starts 4 bytes past a 16-byte boundary."""
    n, taps = cfg.block_samples, cfg.resample_taps
    if kind in ("k2", "k2p"):
        tail = torch.from_numpy(rng.random(taps, dtype=np.float32) * 1.5).to(dev)
        views = {}
        for dtype in (torch.uint8, torch.int8):
            pad = torch.from_numpy(rng.integers(0, 256, size=2 * n + 4, dtype=np.uint8))
            pad = pad.view(dtype).to(dev)
            views[f"{dtype} aligned"] = (pad[4:].clone(), tail)
            views[f"{dtype} 4 bytes past"] = (pad[4:], tail)
        first = lambda data: data[0]  # noqa: E731
    else:
        x_pad = torch.cat([torch.zeros(1, device=dev),
                           torch.from_numpy(rng.random(n + taps, dtype=np.float32) * 1.5).to(dev)])
        views = {"aligned": x_pad[1:].clone(), "4 bytes past": x_pad[1:]}
        first = lambda data: data  # noqa: E731
    for name, data in views.items():
        assert first(data).data_ptr() % 16 == (0 if name.endswith("aligned") else 4)
    return views


def compare(kind, cfg, launchers, prepares, dev, rate_inv):
    """Every build against the first, bit for bit; returns the case count."""
    rng = np.random.default_rng(11)
    n = cfg.block_samples
    views = case_inputs(kind, cfg, rng, dev)
    phases = {"zero": 0, "negative": -123456789, "in the tail": -(1 << 40) - 12345,
              "near the end": (n - 3) << 40, "past the block": (n + 5) << 40}
    names = OUTPUTS[kind]
    labels = list(launchers)
    cases = 0
    for scale in (1.0, 1.001, 1 / 1.001):
        inv = rate_inv(cfg, scale)
        for pname, ph in phases.items():
            phase = torch.tensor(ph, dtype=torch.int64, device=dev)
            for vname, data in views.items():
                outs = {label: launchers[label](cfg, prepares[label](cfg, data, phase, inv),
                                                phase, inv) for label in labels}
                torch.cuda.synchronize()
                want = outs[labels[0]]
                for label in labels[1:]:
                    for g, w, what in zip(outs[label], want, names):
                        assert torch.equal(g, w), (kind, label, scale, pname, vname, what,
                                                   (g != w).sum().item())
                if pname == "past the block" and "n_out" in names:
                    assert int(want[names.index("n_out")]) == 0
                    assert not want[names.index("pixels")].any()
                cases += 1
    return cases


def time_all(kind, cfg, launchers, prepares, reps, dev, smoke):
    """Flushed, warm and one-of-8 times of every build, in turns. The warm
    input is the kind's input just written: the envelope by a torch.cat, the
    raw block by a copy, K4's windows by the gather."""
    rng = np.random.default_rng(12)
    n, taps = cfg.block_samples, cfg.resample_taps
    inv = smoke.rate_inv(cfg, 1.0)
    phase = torch.zeros((), dtype=torch.int64, device=dev)
    tail = torch.zeros(taps, device=dev)
    if kind in ("k2", "k2p"):
        raw = smoke.raw_block(cfg, rng)
        data, fresh = (raw, tail), lambda: (raw.clone(), tail)
    else:
        body = torch.from_numpy(rng.random(n, dtype=np.float32) * 1.5).to(dev)
        data, fresh = torch.cat([tail, body]), lambda: torch.cat([tail, body])
    times = {label: {"ms": [], "ms_warm": [], "ms_each_of_8": []} for label in launchers}
    labels = list(launchers)
    for turn in (labels, labels[::-1]):
        for label in turn:
            fn, prep = launchers[label], prepares[label]
            ready = prep(cfg, data, phase, inv)
            times[label]["ms"].append(
                smoke.time_launches(lambda: fn(cfg, ready, phase, inv), reps))
            times[label]["ms_warm"].append(smoke.time_launches(
                lambda d: fn(cfg, d, phase, inv), reps,
                warm_input=lambda: prep(cfg, fresh(), phase, inv)))
            times[label]["ms_each_of_8"].append(
                smoke.each_of(lambda: fn(cfg, ready, phase, inv), reps=reps))
    return {label: {k: min(v) for k, v in t.items()} | {k + "_turns": v for k, v in t.items()}
            for label, t in times.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", help="directory with an earlier commit's .cu sources")
    ap.add_argument("--variant", action="append", default=[], metavar="LABEL=DIR")
    ap.add_argument("--only", help="comma-separated kinds, of " + ", ".join(SOURCE))
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    import chip_smoke as smoke  # the timing method and geometries of the smoke run's rows

    kinds = args.only.split(",") if args.only else list(SOURCE)
    if set(kinds) - set(SOURCE):
        ap.error(f"--only takes kinds of {', '.join(SOURCE)}")
    smi = smoke.card()
    libs = build_libs(kinds, args.earlier, dict(v.split("=", 1) for v in args.variant))
    rows = []
    for kind in kinds:
        launchers, prepares = make_launchers(kind, libs, smoke.DEV)
        for gname, cfg in smoke.GEOMETRIES.items():
            row = dict(card=smi, kernel=kind, geometry=gname, baseline=next(iter(launchers)),
                       bit_identical_cases=compare(kind, cfg, launchers, prepares, smoke.DEV,
                                                   smoke.rate_inv),
                       times=time_all(kind, cfg, launchers, prepares, args.reps, smoke.DEV,
                                      smoke))
            print(json.dumps(row), flush=True)
            rows.append(row)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_ab.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
