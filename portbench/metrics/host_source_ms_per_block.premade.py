"""host_source_ms_per_block.premade (ms, layer: sources). Self time of the
program's tsdr/source spans per block of the traced stretch: each next() on
a source's stream (here the benchmark's own source and window, portbench/
source inside it) with the block's np.asarray and reshape and the controls
applied as it arrives; every channel's block."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_block(run, "tsdr/source")
