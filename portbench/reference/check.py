"""What decides `correct`: the receiver's frames, plots and state over
sampled stretches of the measured window, and its state after the window's
first `from_start` blocks, against the plain reference.

A stretch is `blocks` consecutive blocks of one channel. The first starts
at the stream's first block and the reference runs it from its own initial
state: that checks the receiver from its start. The reference then runs on
from its own state to block `from_start` and compares the whole state with
the receiver's there: that checks the state the window carries (the
estimator's running averages, the PLL's rate, the autogain's lows and
highs) over thousands of the receiver's own steps. The other stretches
start at blocks drawn from the seed, later than the reference can replay
in the time a run has, so there it starts from the receiver's own state at
the stretch's first block (a device copy the harness took before the
receiver stepped that block) and checks every block of the stretch: the
frames each block emits and their count, each estimation round's two
plots, and at the stretch's end the whole state against the receiver's
state there, integers exact.

The numbers, each with its limit from the configuration file:
  frame_err       max |receiver - reference| over every compared frame's pixels
  plot_err        max |receiver - reference| / max |reference| over each plot
  state_err       the same relative gap over every float leaf of the state at
                  a stretch's end (the fold and the ring up to their fill)
  long_state_err  the same gap at block `from_start`, both sides from their
                  own initial state
  mismatches      integer leaves that differ at a stretch's end or at block
                  `from_start`, blocks whose frame or plot count differs, and
                  frames of another shape than the reference's (limit 0)

Each channel is checked at its own geometry, with one Reference for each
distinct geometry, made from the reference module the configuration
names (`step.py` where it names none): any module with step.py's
`Reference`, `LEAVES`, `ARRAYS` and `INTEGERS`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NAMES = ("frame_err", "plot_err", "state_err", "long_state_err", "mismatches")


def _rel(p, r) -> float:
    p = torch.as_tensor(p).to(torch.float64).reshape(-1)
    r = torch.as_tensor(r).to(torch.float64).reshape(-1).to(p.device)
    if p.shape != r.shape:
        return math.inf
    scale = max(r.abs().max().item() if r.numel() else 0.0, 1e-30)
    return (p - r).abs().max().item() / scale if r.numel() else 0.0


def state_gaps(ref_st: dict, prog: dict, reference) -> tuple[float, int]:
    """(largest relative gap over the float leaves, integer leaves that
    differ) between the reference's state and the receiver's, both as
    Reference state dicts of the `reference` module."""
    worst, wrong = 0.0, 0
    for name in reference.LEAVES:
        r, p = ref_st[name], prog[name]
        if name in reference.INTEGERS:
            wrong += int(r != p)
            continue
        if name == "framebuf":
            r, p = r[:ref_st["fill"]], p[:ref_st["fill"]]
        elif name == "ac_buf":
            r, p = r[:ref_st["ac_fill"]], p[:ref_st["ac_fill"]]
        if name in reference.ARRAYS:
            worst = max(worst, _rel(p, r))
        else:
            worst = max(worst, abs(float(p) - float(r)) / max(abs(float(r)), 1e-30))
    return worst, wrong


class Stretch:
    """One checked stretch: channel, first block, length, and the receiver's
    state leaves before its first block (None: the initial state) and after
    its last; for the stretch from the initial state, `anchor` may be
    (k, the receiver's state leaves after its first k blocks)."""

    def __init__(self, channel: int, start: int, blocks: int, before=None, after=None,
                 anchor=None):
        self.channel, self.start, self.blocks = channel, start, blocks
        self.before, self.after, self.anchor = before, after, anchor


def check(geometries, stretches, raw_for, frames: dict, plots: dict, raw_format: str,
          device="cpu", params: dict | None = None, *, reference) -> dict:
    """Run the reference over every stretch and return the numbers.

    geometries: channel c's Geometry at [c];
    raw_for(channel, k) -> (raw block as numpy, dropped samples before it);
    frames[(k, channel)] -> the receiver's frames of block k, in order;
    plots[(k, channel)] -> its (frame window, line window) plot of block k;
    reference: the module of the plain receiver."""
    refs = {}

    def reference_for(channel):
        g = geometries[channel]
        if g.key not in refs:
            refs[g.key] = reference.Reference(g, device, params=params)
        return refs[g.key]

    out = dict(frame_err=0.0, plot_err=0.0, state_err=0.0, long_state_err=0.0, mismatches=0,
               frames=0, plots=0, stretches=0, blocks=0, from_start=0, long_mismatches=0)
    for s in stretches:
        ref = reference_for(s.channel)
        st = ref.init_state() if s.before is None else ref.from_leaves(s.before)
        for k in range(s.start, s.start + s.blocks):
            raw, dropped = raw_for(s.channel, k)
            st, ref_frames, ref_plots = ref.step(st, raw, raw_format, dropped)
            got = frames.get((k, s.channel), [])
            out["mismatches"] += int(len(got) != len(ref_frames))
            for p, r in zip(got, ref_frames):
                p = torch.from_numpy(np.asarray(p))
                if p.shape != r.shape:  # folded at another mode
                    out["mismatches"] += 1
                    continue
                gap = (p.to(r.device, torch.float64) - r).abs()
                out["frame_err"] = max(out["frame_err"], gap.max().item())
                out["frames"] += 1
            got_plot = plots.get((k, s.channel))
            out["mismatches"] += int((got_plot is None) != (ref_plots is None))
            if got_plot is not None and ref_plots is not None:
                for p, r in zip(got_plot, ref_plots):
                    out["plot_err"] = max(out["plot_err"], _rel(np.asarray(p), r.cpu()))
                out["plots"] += 1
            out["blocks"] += 1
        if s.after is not None:
            worst, wrong = state_gaps(st, ref.from_leaves(s.after), reference)
            out["state_err"] = max(out["state_err"], worst)
            out["mismatches"] += wrong
        out["stretches"] += 1
        if s.before is None:
            if s.anchor is None:  # the run took no state to compare: not correct
                out["mismatches"] += 1
                continue
            k_end, leaves = s.anchor
            for k in range(s.start + s.blocks, k_end):
                raw, dropped = raw_for(s.channel, k)
                st, _, _ = ref.step(st, raw, raw_format, dropped)
            worst, wrong = state_gaps(st, ref.from_leaves(leaves), reference)
            out["long_state_err"] = max(out["long_state_err"], worst)
            out["mismatches"] += wrong
            out["long_mismatches"] += wrong
            out["from_start"] = max(out["from_start"], k_end)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(every number within its limit, [(name, value, limit)])."""
    rows = [(name, numbers[name], limits[name]) for name in NAMES]
    ok = all(v <= lim and not math.isnan(v) for _, v, lim in rows)
    return ok, rows
