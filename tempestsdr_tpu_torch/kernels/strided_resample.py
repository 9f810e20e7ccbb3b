"""Kernel K1: the m == 2 strided box resampler as a CUDA kernel for Hopper
(csrc/strided_resample.cu), replacing the TPU kernel
tempestsdr_tpu/pallas/strided_kernel.py `_kernel` (box_resample_strided_pallas).

Same contract as ops.resample.box_resample_strided, its plain version:
(x_ext f32[taps + n], phase_fix i64, inv_fix i64) -> (pixels f32[max_pix],
n_out i32, new_phase i64). The kernel computes the exact int64 carries (as
resample_counts does) and the chunk bases itself, from device scalars: one
launch per block, no host round trip.

What bounds it on the card is memory, but at a block's size (5-10 MB) a
launch is far from a stream at the memory rate: on an NVIDIA H100 80GB HBM3
at 700.00 W half of its ~10 us is the launch itself, and a plain copy of
the same bytes takes as long as the kernel (PERF.md). The design: one
thread block of 128 threads per 1024-sample chunk, all blocks resident in
one wave at the 64 and 8 MS/s geometries; the chunk's window staged into
shared memory once with 16-byte asynchronous copies, pixels stored 16 bytes
at a time, and no thread waiting on the carries' 64-bit division
(kernels/window_plan.py states the staging arithmetic). x_ext may start at
any 4-byte boundary: the staged range is rounded to 16-byte boundaries of
the address, and windows that leave x_ext take checked loads in the kernel.

The tap loop covers the whole PLL headroom (config.PLL_HEADROOM_FRAC, which
framerate_pll and the refresh nudge clamp to), so the kernel serves every
block the step can produce and has no fallback branch.

box_resample_range_strided_cuda is K1's second entry, for the time-sharded
step: the same kernel over one shard's pixel range (its plain version is
ops.resample.box_resample_range_strided), with the shard's shifted phase
and a device count of valid pixels, and no carries.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..config import PLL_HEADROOM_FRAC
from ..ops.resample import (
    box_resample_range_strided,
    box_resample_strided,
    plan_strided,
    shard_phase,
)

TILE = 1024  # samples per chunk, the unit of the kernel's f32 ramp (margin and
# taps_eff follow from it); equals kTile in the .cu source


def k1_margin(inv_nominal: float, tile: int = TILE):
    """(margin, taps_eff) of K1's tap loop: the drift of the pixel ramp
    against the sample grid over one tile, at the worst rate the PLL
    headroom allows, plus one sample of slack."""
    pll = PLL_HEADROOM_FRAC / (1.0 - PLL_HEADROOM_FRAC)
    drift = abs(2.0 * inv_nominal - 1.0) + 2.0 * inv_nominal * pll
    margin = int(math.ceil(tile * drift)) + 1
    return margin, 2 * margin + 4


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .build import load

        lib = load("strided_resample")
        lib.tsdr_strided_resample.restype = ctypes.c_int
        lib.tsdr_strided_resample.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.tsdr_strided_resample_range.restype = ctypes.c_int
        lib.tsdr_strided_resample_range.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.tsdr_noop.restype = ctypes.c_int
        lib.tsdr_noop.argtypes = [ctypes.c_void_p]
        lib.tsdr_copy_floor.restype = ctypes.c_int
        lib.tsdr_copy_floor.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                        ctypes.c_longlong, ctypes.c_void_p]
        lib.tsdr_strided_resample_tile.restype = ctypes.c_int
        if lib.tsdr_strided_resample_tile() != TILE:
            raise RuntimeError("strided_resample.cu tile differs from TILE")
        _LIB = lib
    return _LIB


def box_resample_strided_cuda(x_ext, phase_fix, inv_fix, *, n_samples: int, max_pix: int,
                              taps: int, inv_nominal: float):
    """K1 on CUDA tensors; the plain version on CPU tensors."""
    if x_ext.device.type == "cpu":
        return box_resample_strided(x_ext, phase_fix, inv_fix, n_samples=n_samples,
                                    max_pix=max_pix, taps=taps, inv_nominal=inv_nominal)
    _check_m2(x_ext, inv_nominal, taps, dict(phase_fix=phase_fix, inv_fix=inv_fix))
    if x_ext.shape[0] != taps + n_samples:
        raise ValueError(f"x_ext has {x_ext.shape[0]} samples, expected {taps + n_samples}")
    if max_pix <= 0:
        raise ValueError("max_pix must be positive")
    margin, taps_eff = k1_margin(inv_nominal)
    phase_fix = phase_fix.contiguous()
    inv_fix = inv_fix.contiguous()
    dev = x_ext.device
    out = torch.empty((max_pix,), dtype=torch.float32, device=dev)
    n_out = torch.empty((), dtype=torch.int32, device=dev)
    new_phase = torch.empty((), dtype=torch.int64, device=dev)
    err = _lib().tsdr_strided_resample(
        x_ext.data_ptr(), x_ext.shape[0], phase_fix.data_ptr(), inv_fix.data_ptr(),
        n_samples, out.data_ptr(), n_out.data_ptr(), new_phase.data_ptr(), max_pix,
        taps, margin, taps_eff, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError_t {err}")
    box_resample_strided_cuda.launches += 1
    return out, n_out, new_phase


box_resample_strided_cuda.launches = 0


def _check_m2(x, inv_nominal: float, taps: int, scalars) -> None:
    """What both K1 entries take: the m == 2 geometry, a contiguous 1-D
    float32 input, and 0-d int64 scalars on its device."""
    if x.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {x.device}")
    plan = plan_strided(inv_nominal, taps)
    if plan is None or plan[0] != 2:
        raise ValueError("K1 requires the m == 2 geometry")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("the input must be a contiguous 1-D float32 tensor")
    for name, t in scalars.items():
        if t.dtype != torch.int64 or t.dim() != 0 or t.device != x.device:
            raise ValueError(f"{name} must be a 0-d int64 tensor on {x.device}")


def box_resample_range_strided_cuda(x_local, phase_fix, inv_fix, p_start, p_end, seg_offset, *,
                                    max_pix: int, taps: int, inv_nominal: float):
    """K1's range entry on CUDA tensors (one launch, no host round trip);
    the plain box_resample_range_strided on CPU tensors. Same contract:
    x_local f32[taps + S + taps], phase_fix/inv_fix/p_start/p_end 0-d int64,
    seg_offset the segment's first global sample (an int or a 0-d int64);
    returns pixels f32[max_pix], zero past p_end - p_start."""
    if x_local.device.type == "cpu":
        return box_resample_range_strided(x_local, phase_fix, inv_fix, p_start, p_end,
                                          seg_offset, max_pix=max_pix, taps=taps,
                                          inv_nominal=inv_nominal)
    _check_m2(x_local, inv_nominal, taps, dict(phase_fix=phase_fix, inv_fix=inv_fix,
                                                p_start=p_start, p_end=p_end))
    if x_local.shape[0] <= 2 * taps:
        raise ValueError(f"x_local has {x_local.shape[0]} samples, no segment between its halos")
    if max_pix <= 0:
        raise ValueError("max_pix must be positive")
    out = range_launch(x_local, shard_phase(phase_fix, inv_fix, p_start, seg_offset), inv_fix,
                       torch.clamp(p_end - p_start, min=0), max_pix=max_pix, taps=taps,
                       inv_nominal=inv_nominal)
    box_resample_range_strided_cuda.launches += 1
    return out


def range_launch(x_local, eff_phase, inv_fix, n_valid, *, max_pix: int, taps: int,
                 inv_nominal: float):
    """The range entry's one launch, from the shard's window-start phase and
    its count of valid pixels (0-d int64 CUDA tensors): what
    box_resample_range_strided_cuda runs after computing those two. Inputs
    as that wrapper checks them; counts nothing."""
    margin, taps_eff = k1_margin(inv_nominal)
    eff_phase, inv_fix, n_valid = (t.contiguous() for t in (eff_phase, inv_fix, n_valid))
    out = torch.empty((max_pix,), dtype=torch.float32, device=x_local.device)
    err = _lib().tsdr_strided_resample_range(
        x_local.data_ptr(), x_local.shape[0], eff_phase.data_ptr(), inv_fix.data_ptr(),
        n_valid.data_ptr(), out.data_ptr(), max_pix, taps, margin, taps_eff,
        torch.cuda.current_stream(x_local.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"K1 range launch failed: cudaError_t {err}")
    return out


box_resample_range_strided_cuda.launches = 0


def launch_noop(device) -> None:
    """An empty kernel on the current stream: the launch floor of the
    kernels' timings."""
    err = _lib().tsdr_noop(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty launch failed: cudaError_t {err}")


def launch_copy_floor(src, dst) -> None:
    """A float4 copy kernel that reads src once and writes dst once (whole
    16-byte pieces): the time a stream of a kernel's bytes takes on the card
    with no arithmetic. A yardstick for measurements; the port's paths do not
    call it."""
    for t in (src, dst):
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the copy floor takes contiguous float32 CUDA tensors")
    err = _lib().tsdr_copy_floor(src.data_ptr(), src.numel(), dst.data_ptr(), dst.numel(),
                                 torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"copy launch failed: cudaError_t {err}")
