"""dtoh_ms_per_block.premade (ms, layer: session). Device time of the
device-to-host copies (the packed fetch and the frame and plot downloads)
per block of the traced stretch; a block is one step of every channel."""


def read(run):
    if run.trace is None or not run.blocks_traced:
        return None
    us, count = run.trace.device_us(("gpu_memcpy",), "DtoH")
    return us / 1e3 / run.blocks_traced if count else None
