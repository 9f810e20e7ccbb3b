"""k1_roofline_pct (%, layer: kernels). K1's share of its roofline: the
least time its bytes take at the card's memory rate over its mean device
time, by kernel name in the traced stretch. Bytes a launch: the block's
envelope and tail read once, 4 * (n + taps), and the pixels this block
yields written once, 4 * n * pixelrate / samplerate (the mean of n_out, not
the buffer's max_block_pixels), averaged over the channels at their own
geometries (each channel launches K1 alike). K1 runs outside any IF node,
where the profiler's names hold. K1 is about 0.01 ms of a 2-5 ms block, so
this share can move ingest_msps by about half a percent at most."""

import math

from portbench.peaks import HBM_BYTES_PER_S

KERNEL = "strided_resample_kernel<false>"


def read(run):
    if run.trace is None:
        return None
    us, launches = run.trace.device_us(("kernel",), KERNEL)
    if not launches:
        return None
    nbytes = math.fsum(4 * (g.n + g.taps) + 4 * g.n * g.pixels_per_sample
                       for g in run.geometries) / len(run.geometries)
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / (us * 1e-6 / launches)
