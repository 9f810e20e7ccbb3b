"""host_download_ms_per_block.premade (ms, layer: session). Self time of
the program's tsdr/download spans per block of the traced stretch: each
frame or plot download to the host: a copy into pinned memory of torch's
caching host allocator, reused from block to block, and one wait for the
stream."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_block(run, "tsdr/download")
