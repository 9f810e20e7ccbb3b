"""The `premade` driver: a closed loop from memory, as the reference's
RawFile plugin replays a recording under PERFORMANCE_BENCHMARK. The
benchmark's own source holds one period of every channel's raw IQ (and one
block more) and yields each block as a view at (k * block) mod period; the
next block is asked for only when the receiver is done with the last, so
the source layer costs nothing. Each channel loops its own period (its
mode's); the configuration's session module builds the receiver.

Set-up runs the receiver over the stream's first `warm_blocks` blocks (the
runner's capture, the cuFFT plan, every path of the traffic), then makes
the timed receiver. End-to-end metrics: `setup_s`, and `ingest_msps`, every
sample every channel stepped in the window over the window's wall time,
ending in a device sync. A step that raises fails a block and ends the
run."""

import traceback

from portbench import tracing
from portbench.gen import emanation as em


def source_class():
    from tempestsdr_tpu_torch.sources.base import Source, SourceBlock

    class Premade(Source):
        """A loop of one period, one block a view; the window (channel 0's
        source) decides when it ends."""

        def __init__(self, looped, period: int, rate: float, window=None):
            self.looped, self.period, self.rate, self.window = looped, period, rate, window

        def init(self, params):
            pass

        def name(self):
            return "portbench premade"

        def samplerate(self):
            return self.rate

        def block_dtype(self):
            return self.looped.dtype

        def stream(self, block_samples):
            w = self.window
            k = 0
            while w is None or w.before_block(k):
                with tracing.span("portbench/source", w is not None and w.profiling):
                    blk = SourceBlock(em.block_at(self.looped, self.period, block_samples, k), 0)
                yield blk
                k += 1

        def stop(self):
            pass

    return Premade


def drive(ctx) -> dict:
    Premade = source_class()
    n, w, periods = ctx.n, ctx.window, ctx.channel_periods
    rates = [pc.samplerate for pc in ctx.channel_pcs]
    ctx.make_session([Premade(lp, periods[c], rates[c]) for c, lp in enumerate(ctx.loops)],
                     False).run(max_blocks=ctx.cfg["warm_blocks"])
    ctx.sync()
    sess = ctx.make_session([Premade(lp, periods[c], rates[c], w if c == 0 else None)
                             for c, lp in enumerate(ctx.loops)], True)
    ctx.timed = sess
    setup_s = ctx.clock() - ctx.t_process
    error = None
    try:
        sess.run()
    except Exception:  # a block whose step raised: the run fails
        error = traceback.format_exc()
    ctx.sync()
    t_end = ctx.clock()
    return dict(setup_s=setup_s, t_end=t_end, error=error, attempted=w.blocks,
                failed=int(error is not None),
                metrics=dict(setup_s=setup_s,
                             ingest_msps=w.blocks * n * ctx.n_ch / (t_end - w.t0) / 1e6),
                raw_for=lambda c, k: (em.block_at(ctx.loops[c], periods[c], n, k), 0))
