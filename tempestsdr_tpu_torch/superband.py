"""Superbandwidth — frequency-hopping spectrum stitching ("superresolution").

Functional re-design of TempestSDR/src/superbandwidth.c (C10): simulate a
receiver with HOPS x the hardware bandwidth by retuning +-samplerate around
the center, recording SUPER_SAMPLES_TO_RECORD frames per hop, aligning each
hop to hop 0 by cross-correlating the derivative of their envelopes, then
concatenating the hop spectra and inverse-transforming the HOPS-wide
spectrum into a time stream at HOPS x the native rate (superbandwidth.c:
121-152). The stitched stream re-enters the normal pipeline as if captured
by a HOPS-x-rate device (TSDRLibrary.c:271-278).

The hop control state machine is host-side (it drives retunes with settle
pauses — superbandwidth.c:179-254); the alignment/stitch math runs on the
given device with torch.fft on complex64.
Tuning sequence reproduces the reference: hop i>=1 is recorded after
`shiftfreq((i - HOPS/2) * samplerate)` (:241), i.e. offsets [0, -sr, 0, +sr]
for 4 hops — experimental quality, as the dissertation notes
(acs-dissertation.tex:945).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .config import floor_pow2
from .device import resolve_device

SUPER_HOPS_TO_MAKE = 4  # superbandwidth.c:22
SUPER_SAMPLES_TO_RECORD = 10  # frames per hop (:31)
SUPER_SECS_TO_PAUSE = 0.5  # retune settle (:33)


def _abs_diff(iq: torch.Tensor) -> torch.Tensor:
    """Derivative of the envelope along the last axis (complex_to_abs_diff,
    superbandwidth.c:67-81), including the reference's quirk that the first
    'previous' value is the squared magnitude."""
    mag = iq.abs()
    prev = torch.cat([mag[..., :1] ** 2, mag[..., :-1]], dim=-1)
    return (mag - prev).to(torch.float32)


def _xcorr(ref_iq: torch.Tensor, other_iq: torch.Tensor) -> torch.Tensor:
    """|cross-correlation| of the envelope derivatives of ref [n] and other
    [..., n] over the full circular lag range. The reference bin product is
    conj(A)*B (fft.c:80-89): the peak lands at the shift applied to `other`."""
    a = torch.fft.fft(_abs_diff(ref_iq).to(torch.complex64))
    b = torch.fft.fft(_abs_diff(other_iq).to(torch.complex64), dim=-1)
    return torch.fft.ifft(torch.conj(a) * b, dim=-1).abs()


def best_alignment(ref_iq, other_iq, device="cuda") -> torch.Tensor:
    """Lag (complex samples, int32) aligning `other` to `ref` by
    cross-correlating envelope derivatives (superb_bestfit,
    superbandwidth.c:83-119). The reference scans the FULL lag range [0, n)
    (its loop over `samples` complex outputs, :104-117) with a
    strictly-greater update — i.e. first-wins argmax, which torch.argmax is.
    roll(other, -lag) aligns it to ref (superb_ondataready's three-memcpy
    left rotation, :135-138). `other` may carry leading axes: one lag each."""
    dev = resolve_device(device)
    ref = torch.as_tensor(ref_iq).to(dev)
    other = torch.as_tensor(other_iq).to(dev)
    return torch.argmax(_xcorr(ref, other), dim=-1).to(torch.int32)


def _stitch(hops: torch.Tensor) -> torch.Tensor:
    """complex64 [HOPS, n] on any device -> the stitched complex64 [HOPS*n]."""
    nhops, n = hops.shape
    ref = hops[0]
    lag = torch.argmax(_xcorr(ref, hops[1:]), dim=-1)
    # each hop rotated left by its own lag: one gather (torch.roll takes no
    # per-row shift)
    idx = (torch.arange(n, device=hops.device)[None, :] + lag[:, None]) % n
    aligned = torch.cat([ref[None], torch.gather(hops[1:], 1, idx)], dim=0)
    spectra = torch.fft.fft(aligned, dim=1) / n  # reference forward scaling 1/N
    wide = spectra.reshape(nhops * n)
    return torch.fft.ifft(wide) * (nhops * n)  # reference inverse: unnormalized


def stitch_hops(hops, device="cuda") -> np.ndarray:
    """hops: complex[HOPS, n] (n a power of two), hop 0 the reference.
    Returns complex64[HOPS*n] — the stitched stream at HOPS x rate
    (superb_ondataready, superbandwidth.c:121-152)."""
    dev = resolve_device(device)
    hops = torch.from_numpy(np.ascontiguousarray(hops, dtype=np.complex64)).to(dev)
    return _stitch(hops).cpu().numpy()


class SuperBandwidth:
    """Host-side hop state machine.

    feed(iq, dropped) consumes native-rate complex blocks and occasionally
    returns a stitched HOPS-x-rate block. `retune(offset_hz)` is called
    between hops (shiftfreq equivalent); pass the source's relative tuner.
    The stitch runs on `device`.
    """

    def __init__(self, samplerate: float, refreshrate: float,
                 retune: Optional[Callable[[float], None]] = None,
                 hops: int = SUPER_HOPS_TO_MAKE, device="cuda"):
        self.device = resolve_device(device)
        self.samplerate = samplerate
        self.hops = hops
        self.retune = retune or (lambda off: None)
        samples_in_frame = int(samplerate / refreshrate)
        self.samples_to_gather = SUPER_SAMPLES_TO_RECORD * samples_in_frame
        self.n = floor_pow2(self.samples_to_gather)
        self.samples_to_pause = int(SUPER_SECS_TO_PAUSE * samplerate)
        self._bufs = np.zeros((hops, self.samples_to_gather), np.complex64)
        self._hop = 0
        self._gathered = 0
        self._pausing = 0
        self._state = "gather"

    @property
    def output_samplerate(self) -> float:
        return self.hops * self.samplerate

    def reset(self) -> None:
        self._hop = 0
        self._gathered = 0
        self._state = "gather"
        self.retune(0.0)

    def feed(self, iq: np.ndarray, dropped: int = 0) -> Optional[np.ndarray]:
        """iq: complex64[k] at native rate. Returns stitched complex64
        [hops * pow2(gather)] when a full hop cycle completes, else None."""
        if self._state == "pause":
            self._pausing += len(iq)
            if self._pausing > self.samples_to_pause:
                self._pausing = 0
                self._state = "gather"
            return None
        if dropped:
            self._gathered = 0  # only contiguous data per hop (:221)
            return None
        take = min(len(iq), self.samples_to_gather - self._gathered)
        self._bufs[self._hop, self._gathered : self._gathered + take] = iq[:take]
        self._gathered += take
        if self._gathered < self.samples_to_gather:
            return None
        self._gathered = 0
        self._hop += 1
        if self._hop < self.hops:
            self.retune((self._hop - self.hops // 2) * self.samplerate)
            self._state = "pause"
            return None
        # cycle complete
        self._hop = 0
        self.retune(0.0)
        return stitch_hops(self._bufs[:, : self.n], self.device)
