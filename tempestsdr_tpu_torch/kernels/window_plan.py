"""The window staging arithmetic of K1 and K3 in plain Python: the host
statement of the rules in csrc/staged_window.cuh. The kernels compute the
same numbers on the card; here slot_floats sizes shared memory in K3's
wrapper, and the CPU tests hold the rules to what the kernels need of them
(every staged window covers its taps, fits shared memory, and the
division-free pixel count equals the carries' n_out).
"""

from __future__ import annotations

SMEM_PER_BLOCK = 232448  # bytes of shared memory a thread block can use on Hopper


def slot_floats(length: int) -> int:
    """Floats of the shared-memory buffer for a window of `length` samples."""
    return (length + 6) & ~3


def aligned_window(w0: int, length: int, misalign: int = 0):
    """(a, off, n): the samples [a, a + n) staged for the window
    [w0, w0 + length) of an envelope whose first sample lies `misalign`
    floats (0..3) past a 16-byte boundary; x[w0] lands at slot[off]. The
    staged range starts and ends on 16-byte boundaries of the address."""
    off = (w0 + misalign) & 3
    return w0 - off, off, 4 * ((off + length + 3) >> 2)


def valid_pixels(p0: int, total: int, num: int, inv: int) -> int:
    """How many of the `total` pixels from p0 are below
    n_out = max(num // inv, 0), dividing only where n_out falls inside."""
    if (p0 + 1) * inv > num:
        return 0
    if (p0 + total) * inv <= num:
        return total
    return num // inv - p0
