"""The window arithmetic of K1, K2, K3 and K4 in plain Python: the host
statement of the rules in csrc/staged_window.cuh and of K2's window and
ownership. The kernels compute the same numbers on the card; here
slot_floats sizes shared memory in K3's and K4's wrappers, and the CPU tests
hold the rules to what the kernels need of them (every window covers its
taps and fits shared memory, the division-free pixel count equals the
carries' n_out, and K2's tiles write every envelope sample exactly once).
"""

from __future__ import annotations

from ..config import FRAC_BITS

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


def k2_window(c: int, phase: int, inv: int, margin: int, taps_eff: int, tile: int):
    """(e0, w_len, par) of K2's tile c: its window holds the x_ext samples of
    envelope indices [e0, e0 + w_len), e0 even (two IQ pairs stay 4-byte
    aligned), and K1's window starts `par` samples into it."""
    start = (phase + c * 2 * tile * inv) >> FRAC_BITS
    par = (start - margin) & 1
    return start - margin - par, tile + taps_eff + 1, par


def k2_tiles(n: int, max_pix: int, tile: int) -> int:
    """K2's thread blocks: enough tiles for every pixel (2 * tile each) and
    for every envelope sample (tile each; tile c owns the samples
    [c * tile, c * tile + tile) below n and writes each exactly once)."""
    return max(-(-max_pix // (2 * tile)), -(-n // tile))


def k2_smem_bytes(taps_eff: int, tile: int) -> int:
    """Shared memory of a K2 thread block: the decoded float window."""
    return (tile + taps_eff + 1) * 4
