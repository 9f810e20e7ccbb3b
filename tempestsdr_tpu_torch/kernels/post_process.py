"""One frame's post-process in the default order (dsp.c:192-226, both order
flags 0) as three CUDA launches for Hopper (csrc/post_process.cu).

post_process_cuda(frame, screen, ag, sync_x, sync_y, pll, motionblur, spec)
has the contract of stream/pipeline.py _post_process_default_order, the
plain chain of ops/frame.py and ops/sync.py it replaces on the card: a
frame [..., H, W] with carries of [...] leaves, the leading dimensions a
stack of independent frames (one channel, the unrolled channels' rows, the
gated [C, H, W] form, the time-sharded back half all take the same entry).
H and W come from the frame's shape and the search's least strip sizes from
`spec`, never from a config. It launches the three kernels on the current
stream, reading nothing to the host (so a CUDA graph and an IF node's body
capture them), or raises. It covers f64 profiles (covers(spec));
pipeline._post_process gives it the default order's CUDA frames that it
covers and everything else to the chain.

The kernels equal the plain chain bit for bit in the frames given the same
min and max, which they compute exactly; the integer carries agree but where
a sum taken in the kernels' fixed f64 order rounds another way than torch's
and that decides a near-tie of the search; the SNR is summed in another
order (csrc/post_process.cu). TPU counterpart: none, XLA fuses this chain.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import NORMALISATION_LOWPASS_COEFF, PIXEL_SPECIAL_VALUE_G
from ..ops.gaussian import _coeffs
from ..ops.sync import (
    FRAMERATE_DX_LOWPASS_COEFF_HEIGHT,
    FRAMERATE_DX_LOWPASS_COEFF_WIDTH,
    PLLState,
    SweetspotState,
)

# the kernels' tiling, as csrc/post_process.cu states it (checked at load)
COL_TILE, MAX_ROWS, APPLY_TILE = 1024, 20, 2048
TARGET_ROW_TILES = 32  # row tiles a frame the stats pass aims at


class PostSpec(NamedTuple):
    """What the step's config and Params fix of a frame's post-process: the
    sync search's least strip sizes, the PLL and its headroom (Hz),
    autoshift, markers, and the collapse (precise: f64 sums; widen: f64
    profiles; both unless Params.fast_sync, precise also needs
    config.high_precision_sync)."""

    minsize_x: int
    minsize_y: int
    pll_enabled: bool
    max_delta: float
    autoshift: bool
    markers: bool
    precise: bool = True
    widen: bool = True


def covers(spec: PostSpec) -> bool:
    """Whether the kernels take this post-process: f64 profiles."""
    return spec.precise and spec.widen


# ---- the kernels ------------------------------------------------------------

_POINTERS = (
    "frame", "screen", "motionblur", "ag_min", "ag_max", "sx_size", "sx_dx", "sy_size", "sy_dx",
    "pll_avg", "pll_delta",
    "out", "out2", "ag_min_out", "ag_max_out", "ag_snr_out", "sx_size_out", "sx_dx_out",
    "sx_vx_out", "sy_size_out", "sy_dx_out", "sy_vx_out", "pll_avg_out", "pll_locked_out",
    "pll_delta_out",
    "colpart", "rowpart", "tile_min", "tile_max", "tile_sum", "sq_part", "apply_par", "done",
    "search",
)
_INTS = ("h", "w", "rows_per_tile", "n_rtiles", "n_ctiles", "apply_blocks", "minsize_x",
         "minsize_y", "pll_enabled", "mode")


class _Args(ctypes.Structure):
    """csrc/post_process.cu's Args, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [(n, ctypes.c_longlong) for n in ("batch", "frame_stride", "mb_stride")]
                + [("blur", ctypes.c_double * 5), ("coeff_x", ctypes.c_double),
                   ("coeff_y", ctypes.c_double)]
                + [(n, ctypes.c_int) for n in _INTS]
                + [(n, ctypes.c_float) for n in ("ag_keep", "ag_norm", "max_delta", "marker")])


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .build import load

        lib = load("post_process")
        lib.tsdr_post_process.restype = ctypes.c_int
        lib.tsdr_post_process.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.tsdr_post_process_tiles.restype = None
        lib.tsdr_post_process_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)]
        tiles = (ctypes.c_int * 3)()
        lib.tsdr_post_process_tiles(tiles)
        if tuple(tiles) != (COL_TILE, MAX_ROWS, APPLY_TILE):
            raise RuntimeError(f"post_process.cu tiles {tuple(tiles)} differ from the wrapper's")
        _LIB = lib
    return _LIB


def tiling(h: int, w: int):
    """(rows_per_tile, row tiles, column tiles, apply blocks) of a frame."""
    rows = min(MAX_ROWS, -(-h // TARGET_ROW_TILES))
    return rows, -(-h // rows), -(-w // COL_TILE), -(-(h * w) // APPLY_TILE)


def _leaf(x, dtype, n: int, dev, what: str):
    """A carry leaf as n contiguous values on dev (a view where it can be)."""
    if not isinstance(x, torch.Tensor) or x.dtype != dtype or x.device != dev or x.numel() != n:
        raise ValueError(f"{what} must be a {dtype} tensor of {n} values on {dev}")
    return x.reshape(n).contiguous()


def post_process_cuda(frame, screen, ag, sync_x, sync_y, pll, motionblur, spec: PostSpec):
    """The three kernels on CUDA tensors (see the module docstring): the
    plain chain's contract, but the result is a copy of the new screen of
    its own (the emitted frame), not the screen itself."""
    if not covers(spec):
        raise ValueError("the post-process kernels take f64 profiles: fast_sync and "
                         "high_precision_sync=False run the plain chain")
    if frame.device.type != "cuda":
        raise ValueError(f"the post-process kernels run on CUDA tensors, got {frame.device}")
    if frame.dtype != torch.float32 or frame.dim() < 2:
        raise ValueError("the frame must be a float32 tensor [..., H, W]")
    dev = frame.device
    h, w = frame.shape[-2:]
    lead = tuple(frame.shape[:-2])
    n = math.prod(lead)
    if screen.shape != frame.shape or screen.dtype != torch.float32 or screen.device != dev:
        raise ValueError("the screen must be a float32 tensor of the frame's shape")
    fb = frame.reshape(n, h, w)
    if fb.stride(-1) != 1 or fb.stride(-2) != w:
        fb = fb.contiguous()
    scr = screen.contiguous()
    mb = torch.as_tensor(motionblur, dtype=torch.float32, device=dev)
    if mb.numel() not in (1, n):
        raise ValueError(f"motionblur has {mb.numel()} values for {n} frames")
    mb = mb.reshape(-1).contiguous()
    ins = [_leaf(x, dt, n, dev, name) for x, dt, name in (
        (ag[0], torch.float32, "ag_min"), (ag[1], torch.float32, "ag_max"),
        (sync_x.stripsize, torch.int32, "sync_x.stripsize"), (sync_x.dx, torch.int32, "sync_x.dx"),
        (sync_y.stripsize, torch.int32, "sync_y.stripsize"), (sync_y.dx, torch.int32, "sync_y.dx"),
        (pll.avg_speed, torch.float64, "pll.avg_speed"),
        (pll.refresh_delta, torch.float32, "pll.refresh_delta"))]

    def empty(dtype, shape=lead):
        return torch.empty(shape, dtype=dtype, device=dev)

    out, out2 = empty(torch.float32, lead + (h, w)), empty(torch.float32, lead + (h, w))
    ag_out = [empty(torch.float32) for _ in range(3)]
    sx_out = [empty(torch.int32) for _ in range(3)]
    sy_out = [empty(torch.int32) for _ in range(3)]
    pll_out = [empty(torch.float64), empty(torch.bool), empty(torch.float32)]
    rows, n_rt, n_ct, n_ap = tiling(h, w)
    tiles = n_rt * n_ct
    f64 = empty(torch.float64, (n * (n_rt * w + n_ct * h + tiles + 2 * n_ap),))
    search = empty(torch.float64, (n * (3 * (w + h) + 2),))
    f32 = empty(torch.float32, (n * (2 * tiles + 4),))
    done = empty(torch.int32, (n,))
    at64 = np.cumsum([0, n * n_rt * w, n * n_ct * h, n * tiles]) * 8 + f64.data_ptr()
    at32 = np.cumsum([0, n * tiles, n * tiles]) * 4 + f32.data_ptr()
    ptrs = [fb, scr, mb, *ins[:6], ins[6], ins[7], out, out2, *ag_out, *sx_out, *sy_out, *pll_out]
    ptrs = [x.data_ptr() for x in ptrs] + [int(at64[0]), int(at64[1]), int(at32[0]), int(at32[1]),
                                           int(at64[2]), int(at64[3]), int(at32[2]),
                                           done.data_ptr(), search.data_ptr()]
    args = _Args(*ptrs, n, fb.stride(0), 0 if mb.numel() == 1 else 1,
                 (ctypes.c_double * 5)(*_coeffs()), FRAMERATE_DX_LOWPASS_COEFF_WIDTH,
                 FRAMERATE_DX_LOWPASS_COEFF_HEIGHT,
                 h, w, rows, n_rt, n_ct, n_ap, max(int(spec.minsize_x), 1),
                 max(int(spec.minsize_y), 1), int(spec.pll_enabled),
                 1 if spec.autoshift else (2 if spec.markers else 0),
                 float(np.float32(1.0 - NORMALISATION_LOWPASS_COEFF)),
                 float(np.float32(NORMALISATION_LOWPASS_COEFF)), float(np.float32(spec.max_delta)),
                 PIXEL_SPECIAL_VALUE_G)
    err = _lib().tsdr_post_process(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"post-process launch failed: cudaError_t {err}")
    post_process_cuda.launches += 3
    return (out2, out, tuple(ag_out), SweetspotState(*sx_out), SweetspotState(*sy_out),
            PLLState(*pll_out))


post_process_cuda.launches = 0
