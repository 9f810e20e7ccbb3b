"""host_replay_ms_per_block.premade (ms, layer: step). Self time of the
program's tsdr/replay spans per block of the traced stretch: the host's
graph.replay() (cudaGraphLaunch), which returns before the device is done."""

from portbench import program_spans


def read(run):
    return program_spans.ms_per_block(run, "tsdr/replay")
