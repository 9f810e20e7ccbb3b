"""kernel_ms_per_block.premade (ms, layer: step). Device time of every
kernel (copies and memsets left out) per block of the traced stretch: the
step's graph replay, K1 and every op of ops/, for every channel."""


def read(run):
    if run.trace is None or not run.blocks_traced:
        return None
    us, count = run.trace.device_us(("kernel",))
    return us / 1e3 / run.blocks_traced if count else None
