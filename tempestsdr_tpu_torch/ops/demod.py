"""AM envelope demodulation and on-device IQ normalization.

am_demod mirrors TempestSDR/src/TSDRLibrary.c:244-262 (|I + jQ| per sample);
normalize_iq mirrors the RawFile plugin's per-format scaling
(TSDRPlugin_RawFile/src/TSDRPlugin_RawFile.c:241-261), run on the device so
the host->device copy carries the narrow raw dtype.

The JAX package pairs I^2 and Q^2 with a 0/1 matmul, a device for the TPU's
lane layout; on the GPU the envelope is the plain elementwise
sqrt(i*i + q*q), which rounds identically (one rounding for each square,
one for the sum, a correctly rounded sqrt). torch's vectorized f32 sqrt
on the CPU is not correctly rounded (about 1 value in 200 is off by one
ulp), so on the CPU the root is taken in f64 and rounded back to f32,
which is exact; CUDA's f32 sqrt is correctly rounded as it is.
"""

from __future__ import annotations

import torch

_SCALES = {
    torch.int8: (0.0, 128.0),
    torch.uint8: (128.0, 128.0),
    torch.int16: (0.0, 32767.0),
    torch.uint16: (32767.0, 32767.0),
}


def normalize_iq(raw: torch.Tensor) -> torch.Tensor:
    """Raw recorded samples -> float32 in [-1, 1]: int8 /128, uint8
    (x-128)/128, int16 /32767, uint16 (x-32767)/32767, float32 passthrough."""
    if raw.dtype == torch.float32:
        return raw
    if raw.dtype not in _SCALES:
        raise TypeError(f"unsupported IQ sample dtype {raw.dtype}")
    off, scale = _SCALES[raw.dtype]
    x = raw.to(torch.float32)
    if off:
        x = x - off
    return x / scale


def _sqrt(power: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt on either device (see the module note)."""
    if power.device.type == "cpu":
        return torch.sqrt(power.to(torch.float64)).to(torch.float32)
    return torch.sqrt(power)


def am_demod(iq: torch.Tensor) -> torch.Tensor:
    """Envelope of interleaved IQ: float32[..., 2n] (or complex64[..., n])
    -> float32[..., n]."""
    if iq.is_complex():
        return iq.abs().to(torch.float32)
    i = iq[..., 0::2]
    q = iq[..., 1::2]
    return _sqrt(i * i + q * q)


def demod_raw_interleaved(raw: torch.Tensor) -> torch.Tensor:
    """Normalize + demod of 1-D interleaved IQ from the integer (I, Q) pair:
    sqrt(I^2 + Q^2) * scale, the byte-pair decode kernel K2 reproduces bit
    for bit. For int8/uint8 this equals am_demod(normalize_iq(raw)) exactly
    (I^2 + Q^2 is an exact integer and 1/128 a power of two); int16 rounds
    as the JAX package's form does. Other dtypes take the generic pair."""
    if raw.dim() == 1 and raw.dtype in (torch.uint8, torch.int8, torch.int16):
        pair = raw.view(-1, 2).to(torch.float32)
        if raw.dtype == torch.uint8:
            pair = pair - 128.0
        scale = 1.0 / 32767.0 if raw.dtype == torch.int16 else 1.0 / 128.0
        a, b = pair[:, 0], pair[:, 1]
        return _sqrt(a * a + b * b) * torch.full((), scale, dtype=torch.float32, device=raw.device)
    return am_demod(normalize_iq(raw))
