"""Kernels K2 and K2': byte decode + AM demod + the m == 2 strided box
resample in one launch (csrc/fused_demod_resample.cu), replacing the TPU
kernels tempestsdr_tpu/pallas/fused_kernel.py `_kernel_u32`
(fused_demod_resample) and bench/fused_u16_probe.py `_kernel`
(fused_demod_resample_u16).

Contract of both, and of their plain version fused_demod_resample:
(raw u8/i8[2n] interleaved IQ, tail f32[taps], phase_fix i64, inv_fix i64)
-> (env f32[n], pixels f32[max_pix], n_out i32, new_phase i64), a drop-in
for am_demod(normalize_iq(raw)) followed by box_resample_strided on
concat(tail, env). The envelope is bit-exact against the plain version; the
pixels are K1's (within 2e-5 of the plain strided form, as K1 is).

The kernel stands on its copy floor (a float4 copy of its 11.1 MB at
64 MS/s takes what it takes, PERF.md). The design: one thread block of 256
threads per 1024-sample tile, all resident in one wave at the 64 and 8 MS/s
geometries; the tile decodes its window from device memory into shared
memory and, separately, the envelope samples it owns (tile c owns
[1024c, 1024c + 1024): each is written once, kernels/window_plan.py), whose
stores go out before the barrier the window waits at; envelope and pixels
stored 16 bytes at a time, and no thread waiting on the carries' 64-bit
division. Staging the raw pairs with asynchronous copies, copying owned
samples from the decoded window and 128-thread blocks each measured slower.
raw may start at any 4-byte boundary.

K2 decodes two IQ pairs per 4-byte load, K2' one pair per 2-byte load: the
same function, kept as the card's A/B of the TPU's two window layouts (on
this design the two take the same time). Like K1, the kernel covers the whole PLL
headroom (k1_margin) and needs no fallback branch.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.demod import am_demod, normalize_iq
from ..ops.resample import box_resample_strided, plan_strided
from .strided_resample import k1_margin

TILE = 1024  # samples per thread block; must equal kTile in the .cu source

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .build import load

        lib = load("fused_demod_resample")
        lib.tsdr_fused_demod_resample.restype = ctypes.c_int
        lib.tsdr_fused_demod_resample.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.tsdr_fused_tile.restype = ctypes.c_int
        if lib.tsdr_fused_tile() != TILE:
            raise RuntimeError("fused_demod_resample.cu tile differs from TILE")
        _LIB = lib
    return _LIB


def fused_demod_resample(raw, tail, phase_fix, inv_fix, *, n_samples: int, max_pix: int,
                         taps: int, inv_nominal: float):
    """The plain version of K2 and K2': the unfused chain."""
    env = am_demod(normalize_iq(raw))
    pixels, n_out, new_phase = box_resample_strided(
        torch.cat([tail, env]), phase_fix, inv_fix, n_samples=n_samples, max_pix=max_pix,
        taps=taps, inv_nominal=inv_nominal)
    return env, pixels, n_out, new_phase


def _launch(wrapper, pairs: int, raw, tail, phase_fix, inv_fix, *, n_samples, max_pix, taps,
            inv_nominal):
    if raw.device.type == "cpu":
        return fused_demod_resample(raw, tail, phase_fix, inv_fix, n_samples=n_samples,
                                    max_pix=max_pix, taps=taps, inv_nominal=inv_nominal)
    name = wrapper.__name__
    if raw.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {raw.device}")
    plan = plan_strided(inv_nominal, taps)
    if plan is None or plan[0] != 2:
        raise ValueError(f"{name} requires the m == 2 geometry")
    if raw.dtype not in (torch.uint8, torch.int8) or raw.dim() != 1 or not raw.is_contiguous():
        raise ValueError("raw must be a contiguous 1-D uint8 or int8 tensor")
    if raw.shape[0] != 2 * n_samples or n_samples % 2:
        raise ValueError(f"raw has {raw.shape[0]} bytes, expected 2 * {n_samples} (even)")
    if raw.data_ptr() % 4:
        raise ValueError("raw must be 4-byte aligned")
    if tail.dtype != torch.float32 or tuple(tail.shape) != (taps,) or tail.device != raw.device:
        raise ValueError(f"tail must be float32[{taps}] on {raw.device}")
    for what, t in (("phase_fix", phase_fix), ("inv_fix", inv_fix)):
        if t.dtype != torch.int64 or t.dim() != 0 or t.device != raw.device:
            raise ValueError(f"{what} must be a 0-d int64 tensor on {raw.device}")
    if max_pix <= 0:
        raise ValueError("max_pix must be positive")
    margin, taps_eff = k1_margin(inv_nominal, TILE)
    tail, phase_fix, inv_fix = tail.contiguous(), phase_fix.contiguous(), inv_fix.contiguous()
    dev = raw.device
    env = torch.empty((n_samples,), dtype=torch.float32, device=dev)
    out = torch.empty((max_pix,), dtype=torch.float32, device=dev)
    n_out = torch.empty((), dtype=torch.int32, device=dev)
    new_phase = torch.empty((), dtype=torch.int64, device=dev)
    err = _lib().tsdr_fused_demod_resample(
        raw.data_ptr(), int(raw.dtype == torch.int8), pairs, tail.data_ptr(),
        phase_fix.data_ptr(), inv_fix.data_ptr(), n_samples, env.data_ptr(), out.data_ptr(),
        n_out.data_ptr(), new_phase.data_ptr(), max_pix, taps, margin, taps_eff,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    wrapper.launches += 1
    return env, out, n_out, new_phase


def fused_demod_resample_cuda(raw, tail, phase_fix, inv_fix, *, n_samples: int, max_pix: int,
                              taps: int, inv_nominal: float):
    """K2 (two IQ pairs per 4-byte load) on CUDA tensors; the plain version
    on CPU tensors."""
    return _launch(fused_demod_resample_cuda, 2, raw, tail, phase_fix, inv_fix,
                   n_samples=n_samples, max_pix=max_pix, taps=taps, inv_nominal=inv_nominal)


def fused_demod_resample_u16_cuda(raw, tail, phase_fix, inv_fix, *, n_samples: int,
                                  max_pix: int, taps: int, inv_nominal: float):
    """K2' (one IQ pair per 2-byte load) on CUDA tensors; the plain version
    on CPU tensors."""
    return _launch(fused_demod_resample_u16_cuda, 1, raw, tail, phase_fix, inv_fix,
                   n_samples=n_samples, max_pix=max_pix, taps=taps, inv_nominal=inv_nominal)


fused_demod_resample_cuda.launches = 0
fused_demod_resample_u16_cuda.launches = 0
