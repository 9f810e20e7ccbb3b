"""host_fanout_ms_per_block.premade (ms, layer: session). Self time of the
program's tsdr/fanout spans per block of the traced stretch: the session's own
per-block bookkeeping and event fan-out; the caller's callbacks
(tsdr/callback) and downloads (tsdr/download) inside it are children, left
out."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_block(run, "tsdr/fanout")
