"""Kernels K3 and K4: the chunked box resampler for any rate as CUDA
kernels for Hopper (csrc/chunked_resample.cu), replacing the TPU kernels
tempestsdr_tpu/pallas/resample_kernel.py `_kernel` (box_resample_pallas)
and `_kernel_w` (box_resample_pallas_windows).

Same contract as ops.resample.box_resample_block_chunked, their plain
version: (x_ext f32[taps + n], phase_fix i64, inv_fix i64) -> (pixels
f32[max_pix], n_out i32, new_phase i64), within 3e-4 of it (their windows
and f32 ramps are the TPU kernels', not the chunked form's). Each launch
also computes the exact int64 carries.

K3 builds each 256-pixel tile's window in the kernel from device scalars.
What bounds it on the card is memory, but at a block's size (5-10 MB) a
launch is far from a stream at the memory rate (PERF.md): what a design
decides is how many thread blocks start and what each goes through. The
design: one thread block of 256 threads per group of group_tiles()
consecutive tiles, all blocks resident in one wave at the 64 and 8 MS/s
geometries; the group's one contiguous window staged into shared memory
once with 16-byte asynchronous copies, pixels stored 16 bytes at a time,
and no thread waiting on the carries' 64-bit division
(kernels/window_plan.py states the staging arithmetic). x_ext may start at
any 4-byte boundary, and windows that leave x_ext take checked loads in the
kernel.
K4 is handed the windows, as XLA gathered them for the TPU kernel, and does
the weights and the reduction. gather_windows makes them: on CUDA tensors
one launch of gather_windows_kernel (each thread forms its row's exact int64
base and clipped start and moves 16 bytes; no padded copy of x_ext, no index
matrix), on CPU tensors its plain version gather_windows_plain. K4's rows
are k4_window_len samples, window_len padded to a multiple of 4 so that
every row starts on a 16-byte boundary (the padding columns hold the
envelope's next samples or 0 and get weight 0); K4 then follows K3's plan:
one thread block per group of k4_group_tiles rows (8, also the TPU kernel's
own grouping), the group's rows staged into shared memory as one stretch,
four pixels per thread and 16-byte store, no wait on the division.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..config import FRAC_BITS
from ..ops.resample import box_resample_block_chunked
from .window_plan import SMEM_PER_BLOCK, slot_floats

TILE = 256  # pixels per tile, the unit of the kernels' f32 ramp (not a thread
# block's work: that is a group of tiles); equals kTileP
GROUP_TILES = 8  # K3's and K4's tiles per group where shared memory allows
_INV_SCALE = 2.0 ** (-FRAC_BITS)

_LIB = None


def window_len(inv_nominal: float, taps: int, tiles: int = 1) -> int:
    """Window samples of `tiles` consecutive tiles (w_in for one), for up to
    2 % more samples per pixel than nominal (the PLL headroom is 0.2 %)."""
    return int(math.ceil(tiles * TILE * inv_nominal * 1.02)) + taps + 2


def k4_window_len(inv_nominal: float, taps: int) -> int:
    """Samples of one row of K4's windows: window_len padded up to a multiple
    of 4, so that every row starts on a 16-byte boundary."""
    return -(-window_len(inv_nominal, taps) // 4) * 4


def _fit_group(name: str, group_bytes) -> int:
    """GROUP_TILES, halved until group_bytes(tiles) is at most half of a
    thread block's shared memory (so that two blocks fit an SM), down to one
    tile. Raises when even one tile does not fit."""
    tiles = GROUP_TILES
    while tiles > 1 and group_bytes(tiles) > SMEM_PER_BLOCK // 2:
        tiles //= 2
    if group_bytes(tiles) > SMEM_PER_BLOCK:
        raise ValueError(f"{name}'s window of {group_bytes(1) // 4} samples exceeds shared memory")
    return tiles


def group_tiles(inv_nominal: float, taps: int) -> int:
    """K3's tiles per group."""
    return _fit_group("K3", lambda tiles: window_bytes(inv_nominal, taps, tiles))


def window_bytes(inv_nominal: float, taps: int, tiles: int) -> int:
    """Shared memory of a K3 thread block: the staged window of a group."""
    return slot_floats(window_len(inv_nominal, taps, tiles)) * 4


def k4_group_tiles(w_in: int) -> int:
    """K4's rows per group, for rows of w_in samples."""
    return _fit_group("K4", lambda tiles: k4_window_bytes(w_in, tiles))


def k4_window_bytes(w_in: int, tiles: int) -> int:
    """Shared memory of a K4 thread block: the staged rows of a group."""
    return slot_floats(tiles * w_in) * 4


def _lib():
    global _LIB
    if _LIB is None:
        from .build import load

        lib = load("chunked_resample")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.tsdr_chunked_resample.restype = i
        lib.tsdr_chunked_resample.argtypes = [p, ll, p, p, ll, p, p, p, ll, i, i, i, i, p]
        lib.tsdr_windows_resample.restype = i
        lib.tsdr_windows_resample.argtypes = [p, p, p, p, ll, p, p, p, ll, i, i, p]
        lib.tsdr_gather_windows.restype = i
        lib.tsdr_gather_windows.argtypes = [p, ll, p, p, p, p, ll, i, i, p]
        lib.tsdr_chunked_tile.restype = i
        if lib.tsdr_chunked_tile() != TILE:
            raise RuntimeError("chunked_resample.cu tile differs from TILE")
        _LIB = lib
    return _LIB


def _check(name, x_ext, phase_fix, inv_fix, n_samples, max_pix, taps):
    if x_ext.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {x_ext.device}")
    if x_ext.dtype != torch.float32 or x_ext.dim() != 1 or not x_ext.is_contiguous():
        raise ValueError("x_ext must be a contiguous 1-D float32 tensor")
    if x_ext.shape[0] != taps + n_samples:
        raise ValueError(f"x_ext has {x_ext.shape[0]} samples, expected {taps + n_samples}")
    for what, t in (("phase_fix", phase_fix), ("inv_fix", inv_fix)):
        if t.dtype != torch.int64 or t.dim() != 0 or t.device != x_ext.device:
            raise ValueError(f"{what} must be a 0-d int64 tensor on {x_ext.device}")
    if max_pix <= 0:
        raise ValueError("max_pix must be positive")


def _outputs(max_pix, dev):
    return (torch.empty((max_pix,), dtype=torch.float32, device=dev),
            torch.empty((), dtype=torch.int32, device=dev),
            torch.empty((), dtype=torch.int64, device=dev))


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def box_resample_pallas_cuda(x_ext, phase_fix, inv_fix, *, n_samples: int, max_pix: int,
                             taps: int, inv_nominal: float):
    """K3 on CUDA tensors; the plain chunked form on CPU tensors."""
    if x_ext.device.type == "cpu":
        return box_resample_block_chunked(x_ext, phase_fix, inv_fix, n_samples=n_samples,
                                          max_pix=max_pix, taps=taps, inv_nominal=inv_nominal)
    _check("K3", x_ext, phase_fix, inv_fix, n_samples, max_pix, taps)
    tiles = group_tiles(inv_nominal, taps)
    phase_fix, inv_fix = phase_fix.contiguous(), inv_fix.contiguous()
    dev = x_ext.device
    out, n_out, new_phase = _outputs(max_pix, dev)
    _raise_on(_lib().tsdr_chunked_resample(
        x_ext.data_ptr(), x_ext.shape[0], phase_fix.data_ptr(), inv_fix.data_ptr(), n_samples,
        out.data_ptr(), n_out.data_ptr(), new_phase.data_ptr(), max_pix, taps,
        window_len(inv_nominal, taps), tiles, window_len(inv_nominal, taps, tiles),
        torch.cuda.current_stream(dev).cuda_stream), "K3")
    box_resample_pallas_cuda.launches += 1
    return out, n_out, new_phase


def gather_windows_plain(x_ext, phase_fix, inv_fix, *, max_pix: int, taps: int,
                         inv_nominal: float):
    """K4's inputs in plain PyTorch, as the TPU wrapper gathers them
    (resample_kernel.py:78-91): (windows f32[n_tiles, w_in], fracs
    f32[n_tiles]), with each tile's window start clipped into the
    zero-padded envelope and the clip folded into its frac."""
    dev = x_ext.device
    n_tiles = -(-max_pix // TILE)
    w_in = k4_window_len(inv_nominal, taps)
    x_pad = torch.cat([x_ext, torch.zeros((w_in,), dtype=x_ext.dtype, device=dev)])
    t = torch.arange(n_tiles, dtype=torch.int64, device=dev)
    base = phase_fix + (t * TILE) * inv_fix
    start = base >> FRAC_BITS
    frac = (base - (start << FRAC_BITS)).to(torch.float32) * _INV_SCALE
    idx0 = torch.clamp(start + taps, 0, x_pad.shape[0] - w_in)
    frac = frac + (start + taps - idx0).to(torch.float32)
    windows = x_pad[idx0[:, None] + torch.arange(w_in, device=dev)[None, :]]
    return windows, frac


def gather_windows(x_ext, phase_fix, inv_fix, *, max_pix: int, taps: int, inv_nominal: float):
    """K4's inputs (windows, fracs): one launch of the gather kernel on CUDA
    tensors, exactly gather_windows_plain's; that plain version on CPU
    tensors."""
    if x_ext.device.type == "cpu":
        return gather_windows_plain(x_ext, phase_fix, inv_fix, max_pix=max_pix, taps=taps,
                                    inv_nominal=inv_nominal)
    _check("the window gather", x_ext, phase_fix, inv_fix, x_ext.shape[0] - taps, max_pix, taps)
    phase_fix, inv_fix = phase_fix.contiguous(), inv_fix.contiguous()
    dev = x_ext.device
    n_tiles = -(-max_pix // TILE)
    w_in = k4_window_len(inv_nominal, taps)
    windows = torch.empty((n_tiles, w_in), dtype=torch.float32, device=dev)
    fracs = torch.empty((n_tiles,), dtype=torch.float32, device=dev)
    _raise_on(_lib().tsdr_gather_windows(
        x_ext.data_ptr(), x_ext.shape[0], phase_fix.data_ptr(), inv_fix.data_ptr(),
        windows.data_ptr(), fracs.data_ptr(), n_tiles, taps, w_in,
        torch.cuda.current_stream(dev).cuda_stream), "the window gather")
    gather_windows.launches += 1
    return windows, fracs


def windows_resample_launch(windows, fracs, phase_fix, inv_fix, *, n_samples: int,
                            max_pix: int):
    """The K4 launch alone, on windows from gather_windows."""
    dev = windows.device
    if dev.type != "cuda" or fracs.device != dev:
        raise ValueError(f"K4 runs on CUDA tensors, got {dev}")
    n_tiles, w_in = windows.shape
    if n_tiles != -(-max_pix // TILE) or tuple(fracs.shape) != (n_tiles,):
        raise ValueError("windows/fracs do not match max_pix")
    if not (windows.is_contiguous() and fracs.is_contiguous()
            and windows.dtype == fracs.dtype == torch.float32):
        raise ValueError("windows and fracs must be contiguous float32")
    tiles = k4_group_tiles(w_in)
    phase_fix, inv_fix = phase_fix.contiguous(), inv_fix.contiguous()
    out, n_out, new_phase = _outputs(max_pix, dev)
    _raise_on(_lib().tsdr_windows_resample(
        windows.data_ptr(), fracs.data_ptr(), phase_fix.data_ptr(), inv_fix.data_ptr(),
        n_samples, out.data_ptr(), n_out.data_ptr(), new_phase.data_ptr(), max_pix, w_in,
        tiles, torch.cuda.current_stream(dev).cuda_stream), "K4")
    box_resample_pallas_windows_cuda.launches += 1
    return out, n_out, new_phase


def box_resample_pallas_windows_cuda(x_ext, phase_fix, inv_fix, *, n_samples: int,
                                     max_pix: int, taps: int, inv_nominal: float):
    """The window gather, then K4, on CUDA tensors (two launches); the plain
    chunked form on CPU tensors."""
    if x_ext.device.type == "cpu":
        return box_resample_block_chunked(x_ext, phase_fix, inv_fix, n_samples=n_samples,
                                          max_pix=max_pix, taps=taps, inv_nominal=inv_nominal)
    _check("K4", x_ext, phase_fix, inv_fix, n_samples, max_pix, taps)
    windows, fracs = gather_windows(x_ext, phase_fix, inv_fix, max_pix=max_pix, taps=taps,
                                    inv_nominal=inv_nominal)
    return windows_resample_launch(windows, fracs, phase_fix, inv_fix, n_samples=n_samples,
                                   max_pix=max_pix)


box_resample_pallas_cuda.launches = 0
box_resample_pallas_windows_cuda.launches = 0
gather_windows.launches = 0
