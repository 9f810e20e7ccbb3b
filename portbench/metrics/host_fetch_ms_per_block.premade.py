"""host_fetch_ms_per_block.premade (ms, layer: session). Self time of the
program's tsdr/fetch spans per block of the traced stretch: the one packed
fetch a runner call, in which the host waits for the device's step to end."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_block(run, "tsdr/fetch")
