"""host_upload_ms_per_block.premade (ms, layer: step). Self time of the
program's tsdr/upload spans per block of the traced stretch: the batch
stacked, made a tensor, the state copied in and the copies into the graph's
static inputs queued (on the card the host side of those copies)."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_block(run, "tsdr/upload")
