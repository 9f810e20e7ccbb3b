"""A receiver for the benchmark's tests: the float64 plain reference,
stepped channel by channel, each at its own mode, in the session's place.
FOLD_AT maps a channel to the channel whose mode it is folded at instead
(a planted fault; empty: none)."""

import types

import numpy as np

from portbench.reference.geometry import Geometry
from portbench.reference.step import Reference

FOLD_AT = {}


class Receiver:
    def __init__(self, ctx, sources, timed: bool):
        self.cfg, self.n, self.sources = ctx.cfg, ctx.n, sources
        self.rec = ctx.recorder if timed else None
        self.refs = [Reference(Geometry.of(ctx.cfg, FOLD_AT.get(c, c)),
                               params=ctx.cfg["params"]) for c in range(ctx.n_ch)]
        self.state = [r.init_state() for r in self.refs]

    def run(self, max_blocks=None):
        streams = [s.stream(self.n) for s in self.sources]
        k = 0
        while max_blocks is None or k < max_blocks:
            first = next(streams[0], None)  # channel 0's source ends the run
            if first is None:
                return
            blocks = [first] + [next(s) for s in streams[1:]]
            for c, blk in enumerate(blocks):
                st, frames, plots = self.refs[c].step(self.state[c], blk.samples,
                                                      self.cfg["raw_format"], blk.dropped)
                if self.rec is not None:
                    for f in frames:
                        self.rec.frame(c, f.numpy().astype(np.float32))
                    for p in plots or ():
                        self.rec.plot(c, types.SimpleNamespace(values=p.numpy()))
            k += 1


def make(ctx, sources, timed):
    return Receiver(ctx, sources, timed)


def channel_leaves(session, c):
    return session.refs[c].to_leaves(session.state[c])
