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
K4 is handed the windows: the wrapper gathers them with one torch index, as
XLA gathered them for the TPU kernel, and the kernel does the weights and
the reduction. The TPU's grouping of 8 tiles per program and its 8-aligned
window width were TPU layout constraints and are gone.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..config import FRAC_BITS
from ..ops.resample import box_resample_block_chunked

TILE = 256  # pixels per thread block; must equal kTileP in the .cu source
_INV_SCALE = 2.0 ** (-FRAC_BITS)

_LIB = None


def window_len(inv_nominal: float, taps: int) -> int:
    """w_in: window samples per tile, for up to 2 % more samples per pixel
    than nominal (the PLL headroom is 0.2 %)."""
    return int(math.ceil(TILE * inv_nominal * 1.02)) + taps + 2


def _lib():
    global _LIB
    if _LIB is None:
        from .build import load

        lib = load("chunked_resample")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.tsdr_chunked_resample.restype = i
        lib.tsdr_chunked_resample.argtypes = [p, ll, p, p, ll, p, p, p, ll, i, i, p]
        lib.tsdr_windows_resample.restype = i
        lib.tsdr_windows_resample.argtypes = [p, p, p, p, ll, p, p, p, ll, i, p]
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
    w_in = window_len(inv_nominal, taps)
    if w_in * 4 > 232448:  # a thread block's shared memory on Hopper
        raise ValueError(f"K3's window of {w_in} samples exceeds shared memory")
    phase_fix, inv_fix = phase_fix.contiguous(), inv_fix.contiguous()
    dev = x_ext.device
    out, n_out, new_phase = _outputs(max_pix, dev)
    _raise_on(_lib().tsdr_chunked_resample(
        x_ext.data_ptr(), x_ext.shape[0], phase_fix.data_ptr(), inv_fix.data_ptr(), n_samples,
        out.data_ptr(), n_out.data_ptr(), new_phase.data_ptr(), max_pix, taps, w_in,
        torch.cuda.current_stream(dev).cuda_stream), "K3")
    box_resample_pallas_cuda.launches += 1
    return out, n_out, new_phase


def gather_windows(x_ext, phase_fix, inv_fix, *, max_pix: int, taps: int, inv_nominal: float):
    """K4's inputs, as the TPU wrapper gathers them (resample_kernel.py:78-91):
    (windows f32[n_tiles, w_in], fracs f32[n_tiles]), with each tile's window
    start clipped into the zero-padded envelope and the clip folded into its
    frac."""
    dev = x_ext.device
    n_tiles = -(-max_pix // TILE)
    w_in = window_len(inv_nominal, taps)
    x_pad = torch.cat([x_ext, torch.zeros((w_in,), dtype=x_ext.dtype, device=dev)])
    t = torch.arange(n_tiles, dtype=torch.int64, device=dev)
    base = phase_fix + (t * TILE) * inv_fix
    start = base >> FRAC_BITS
    frac = (base - (start << FRAC_BITS)).to(torch.float32) * _INV_SCALE
    idx0 = torch.clamp(start + taps, 0, x_pad.shape[0] - w_in)
    frac = frac + (start + taps - idx0).to(torch.float32)
    windows = x_pad[idx0[:, None] + torch.arange(w_in, device=dev)[None, :]]
    return windows, frac


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
    phase_fix, inv_fix = phase_fix.contiguous(), inv_fix.contiguous()
    out, n_out, new_phase = _outputs(max_pix, dev)
    _raise_on(_lib().tsdr_windows_resample(
        windows.data_ptr(), fracs.data_ptr(), phase_fix.data_ptr(), inv_fix.data_ptr(),
        n_samples, out.data_ptr(), n_out.data_ptr(), new_phase.data_ptr(), max_pix, w_in,
        torch.cuda.current_stream(dev).cuda_stream), "K4")
    box_resample_pallas_windows_cuda.launches += 1
    return out, n_out, new_phase


def box_resample_pallas_windows_cuda(x_ext, phase_fix, inv_fix, *, n_samples: int,
                                     max_pix: int, taps: int, inv_nominal: float):
    """K4 (after the torch window gather) on CUDA tensors; the plain chunked
    form on CPU tensors."""
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
