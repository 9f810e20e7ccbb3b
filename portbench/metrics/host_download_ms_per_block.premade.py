"""host_download_ms_per_block.premade (ms, layer: session). Self time of
the program's tsdr/download spans per block of the traced stretch: each
frame or plot download to the host, into fresh pageable memory."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_block(run, "tsdr/download")
