"""The plain reference receiver: one block of raw IQ in, the frames it
completes and the estimator's plots out, for one channel, written from the
reference TempestSDR's DSP (TSDRLibrary.c:244-368, dsp.c:22-307,
frameratedetector.c:44-230, syncdetector.c) as straight-line PyTorch, with
host `if`s for its branches.

It imports nothing of the receiver under test and shares no code with it.
Its pixel path is float64: the envelope, a box resampler written as the
difference of a running integral (not the receiver's windowed sums), the
fold, the autogain, the estimator's FFT in complex128. Its integers (the
resampler's fixed-point phase, the drop compensation, the sync positions)
and the float32 rate the PLL sets are exact, so that every count matches.

`precision` lowers the pixel path for the control: "bfloat16" rounds every
stage's float output (envelope, pixels, autocorrelation input, normalized
frame) to bfloat16, the step below the float32 the configuration states.

State: a dict keyed by LEAVES, the receiver's state in its leaf order;
`from_leaves` takes a snapshot of the receiver's (its tensors, in that
order) for a check that follows the receiver from its own state.
"""

from __future__ import annotations

import numpy as np
import torch

from . import sync
from .geometry import FRAC_BITS, NORMALISATION_LOWPASS_COEFF, PLL_HEADROOM_FRAC, Geometry

LEAVES = ("phase_fix", "tail", "fir_tail", "skip_pixels", "fill", "framebuf", "screenbuffer",
          "ag_min", "ag_max", "ag_snr", "sx_stripsize", "sx_dx", "sx_vx", "sy_stripsize",
          "sy_dx", "sy_vx", "pll_avg_speed", "pll_locked", "pll_refresh_delta", "runs",
          "frame_count", "ac_buf", "ac_fill", "ac_avg_frame", "ac_avg_line", "ac_calls",
          "ac_last_full")
INTEGERS = ("phase_fix", "skip_pixels", "fill", "sx_stripsize", "sx_dx", "sx_vx",
            "sy_stripsize", "sy_dx", "sy_vx", "pll_locked", "runs", "frame_count", "ac_fill",
            "ac_calls")
ARRAYS = ("tail", "fir_tail", "framebuf", "screenbuffer", "ac_buf", "ac_avg_frame",
          "ac_avg_line", "ac_last_full")
SPECIAL = 250.0  # dsp.c:57: beyond this a pixel is a debug marker
RAW_SCALE = {"uint8": (128.0, 128.0), "int8": (0.0, 128.0), "int16": (0.0, 32767.0),
             "uint16": (32767.0, 32767.0)}
_MASK = (1 << FRAC_BITS) - 1
F64 = torch.float64


class Reference:
    """params: the configuration's `Params` fields. The reference models the
    default post-process order with no FIR, no nearest-neighbour, autoshift
    or markers and the float64 sync search; `resampler` picks only how the
    receiver computes the same box integral, and `framerate_pll` may be off."""

    MODELLED = {"resampler", "framerate_pll"}

    def __init__(self, geometry: Geometry, device="cpu", precision: str = "float64",
                 params: dict | None = None):
        if precision not in ("float64", "bfloat16"):
            raise ValueError(precision)
        params = params or {}
        unmodelled = sorted(set(params) - self.MODELLED)
        if unmodelled:
            raise NotImplementedError(f"the reference does not model {unmodelled}")
        self.g, self.device, self.precision = geometry, torch.device(device), precision
        self.framerate_pll = bool(params.get("framerate_pll", True))

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A stage's float output in the pixel path's precision."""
        if self.precision == "bfloat16":
            return x.to(torch.bfloat16).to(F64)
        return x

    # ---- state

    def init_state(self) -> dict:
        g, dev = self.g, self.device
        z = lambda *shape: torch.zeros(shape, dtype=F64, device=dev)  # noqa: E731
        st = {k: 0 for k in INTEGERS}
        st["pll_locked"] = False
        st.update(tail=z(g.taps), fir_tail=z(1), framebuf=z(g.framebuf_len),
                  screenbuffer=z(g.height, g.width), ag_min=0.0, ag_max=0.0, ag_snr=1.0,
                  pll_avg_speed=0.0, pll_refresh_delta=np.float32(0.0),
                  ac_buf=z(g.ac_round + g.n), ac_avg_frame=z(g.frame_window[1]),
                  ac_avg_line=z(g.line_window[1]), ac_last_full=z(g.ac_fft // 2))
        return st

    def from_leaves(self, leaves) -> dict:
        """The receiver's state (its leaves in LEAVES order, any device)."""
        if len(leaves) != len(LEAVES):
            raise ValueError(f"{len(leaves)} leaves, the receiver's state has {len(LEAVES)}")
        st = {}
        for name, x in zip(LEAVES, leaves):
            if name in ARRAYS:
                st[name] = x.detach().to(self.device, F64).clone()
            elif name == "pll_refresh_delta":
                st[name] = np.float32(x.item())
            elif name == "pll_locked":
                st[name] = bool(x.item())
            elif name in INTEGERS:
                st[name] = int(x.item())
            else:
                st[name] = float(x.item())
        return st

    def to_leaves(self, st: dict) -> list:
        """A state as the receiver's leaves (tensors in LEAVES order)."""
        dev = self.device
        out = []
        for name in LEAVES:
            v = st[name]
            if name in ARRAYS:
                out.append(v.to(torch.float32))
            elif name == "pll_locked":
                out.append(torch.tensor(v, dtype=torch.bool, device=dev))
            elif name in INTEGERS:
                out.append(torch.tensor(v, dtype=torch.int64, device=dev))
            else:
                out.append(torch.tensor(float(v), dtype=torch.float64, device=dev))
        return out

    # ---- one block

    def step(self, st: dict, raw: np.ndarray, raw_format: str, dropped: int = 0):
        """(state', frames [list of float64 [H, W]], plots (frame window,
        line window) or None). st is updated in place and returned."""
        g, dev = self.g, self.device
        n, fp, mp, taps = g.n, g.fp, g.mp, g.taps
        size_fix = n << FRAC_BITS

        # drop compensation folded into the phase (dsp.c:313-368)
        phase = st["phase_fix"]
        skip_before = max(phase, 0) >> FRAC_BITS
        new_skip = (skip_before - dropped) % g.block2 if dropped > 0 else skip_before
        phase += (new_skip - skip_before) << FRAC_BITS
        drop_all = phase >= size_fix

        # the PLL-modulated samples-per-pixel, float32 as the rate is set
        delta = np.float32(st["pll_refresh_delta"])
        corr = np.float32(delta / np.float32(np.float32(g.refreshrate) + delta))
        inv_fix = g.inv0_fix - int(np.round(np.float32(np.float32(g.inv0_fix) * corr)))

        # normalize + AM demod (TSDRLibrary.c:244-262)
        x = torch.from_numpy(np.ascontiguousarray(raw)).to(dev)
        if raw_format == "float32":
            iq = x.to(F64)
        else:
            off, scale = RAW_SCALE[raw_format]
            iq = (x.to(F64) - off) / scale
        iq = self.q(iq)
        env = self.q(torch.sqrt(iq[0::2] ** 2 + iq[1::2] ** 2))

        # box resample (dsp.c:256-307): pixel p integrates the envelope over
        # [a_p, a_p + inv), a_p = phase + p * inv, times 1 / inv
        x_ext = torch.cat([st["tail"], env])
        n_out = max((size_fix - phase) // inv_fix, 0)
        phase2 = phase + n_out * inv_fix - size_fix
        pixels = torch.zeros(mp, dtype=F64, device=dev)
        if n_out:
            p = torch.arange(n_out, dtype=torch.int64, device=dev)
            a = phase + p * inv_fix
            csum = torch.cat([torch.zeros(1, dtype=F64, device=dev), torch.cumsum(x_ext, 0)])
            xz = torch.cat([x_ext, torch.zeros(1, dtype=F64, device=dev)])

            def integral(u):  # the envelope's integral up to fixed-point position u
                i = (u >> FRAC_BITS) + taps
                frac = (u & _MASK).to(F64) * 2.0 ** -FRAC_BITS
                return csum[i] + frac * xz[i]

            pixels[:n_out] = self.q((integral(a + inv_fix) - integral(a))
                                    * (2.0 ** FRAC_BITS / inv_fix))
        st["tail"] = x_ext[-taps:].clone()
        st["phase_fix"] = phase2

        # the autocorrelation ring (frameratedetector.c:215-230)
        purge = dropped != 0
        fed = not drop_all and not purge
        fill0 = 0 if purge else st["ac_fill"]
        if fed:
            st["ac_buf"][fill0:fill0 + n] = env
        ac_fill = fill0 + n if fed else fill0
        round_done = ac_fill >= g.ac_round
        st["ac_fill"] = ac_fill - g.ac_round if round_done else ac_fill

        # manual sync shift as a pixel skip (no shift is ever asked for here,
        # so only the carried skip applies)
        pend = st["skip_pixels"] % fp
        k = min(pend, n_out)
        if k > 0:
            pixels = torch.cat([pixels[k:], torch.zeros(k, dtype=F64, device=dev)])
        n_valid = n_out - k
        st["skip_pixels"] = pend - k

        # the fold: all max_pix pixels written at fill (zeros past n_valid)
        fb = st["framebuf"]
        fill = st["fill"]
        fb[fill:fill + mp] = pixels
        fill2 = fill + n_valid

        plots = None
        if round_done:
            r = torch.fft.ifft(torch.fft.fft(self.q(st["ac_buf"][:g.ac_fft]).to(
                torch.complex128)).abs().to(torch.complex128)).abs()
            calls = st["ac_calls"] + 1
            fo, fl = g.frame_window
            lo, ll = g.line_window
            st["ac_avg_frame"] = (st["ac_avg_frame"] * (calls - 1) + r[fo:fo + fl]) / calls
            st["ac_avg_line"] = (st["ac_avg_line"] * (calls - 1) + r[lo:lo + ll]) / calls
            st["ac_calls"] = calls
            st["ac_last_full"] = r[:g.ac_fft // 2].clone()
            left = st["ac_buf"].shape[0] - g.ac_round
            st["ac_buf"][:left] = st["ac_buf"][g.ac_round:].clone()
            plots = (st["ac_avg_frame"].clone(), st["ac_avg_line"].clone())

        frames = []
        for slot in range(g.k_frames):
            if fill2 >= (slot + 1) * fp:
                window = fb[slot * fp:(slot + 1) * fp].reshape(g.height, g.width)
                frames.append(self._post_process(st, window))
        emitted = len(frames)
        keep = mp if g.k_frames == 1 else fp
        fb[:keep] = fb[emitted * fp:emitted * fp + keep].clone()
        st["fill"] = fill2 - emitted * fp
        st["runs"] += emitted
        st["frame_count"] += emitted
        return st, frames, plots

    def _post_process(self, st: dict, f: torch.Tensor) -> torch.Tensor:
        """dsp_post_process in its default order (dsp.c:134-239): autogain
        (dsp.c:41-94) and the sync search on the raw frame, then the
        normalisation, and the motion-blur IIR at a coefficient of 0."""
        g = self.g
        special = f.abs() > SPECIAL
        big = torch.full((), 3.4e38, dtype=F64, device=f.device)
        cur_min = min(torch.where(special, big, f).amin().item(), f[0, 0].item())
        cur_max = max(torch.where(special, -big, f).amax().item(), f[0, 0].item())
        c = NORMALISATION_LOWPASS_COEFF
        mx = (1.0 - c) * st["ag_max"] + c * cur_max
        mn = (1.0 - c) * st["ag_min"] + c * cur_min
        npx = f.numel()
        mean = torch.where(special, 0.0, f).sum().item() / npx
        d = f - mean
        var = ((d * d).sum().item() - d.sum().item() ** 2 / npx) / (npx - 1)
        st["ag_min"], st["ag_max"] = mn, mx
        st["ag_snr"] = mean / np.sqrt(max(var, 1e-30))

        wprof, hprof = f.sum(dim=0), f.sum(dim=1)
        minx = int(g.width * np.float32(0.05))
        miny = int(g.height * np.float32(0.01))
        sx = sync.sweet_spot((st["sx_stripsize"], st["sx_dx"], st["sx_vx"]), wprof, minx,
                             sync.LOWPASS_WIDTH)
        sy = sync.sweet_spot((st["sy_stripsize"], st["sy_dx"], st["sy_vx"]), hprof, miny,
                             sync.LOWPASS_HEIGHT)
        st["sx_stripsize"], st["sx_dx"], st["sx_vx"] = sx
        st["sy_stripsize"], st["sy_dx"], st["sy_vx"] = sy
        avg, locked, delta = sync.pll(
            (st["pll_avg_speed"], st["pll_locked"], st["pll_refresh_delta"]), sx[2],
            self.framerate_pll, PLL_HEADROOM_FRAC * g.refreshrate)
        st["pll_avg_speed"], st["pll_locked"], st["pll_refresh_delta"] = avg, locked, delta

        span = 1.0 if mx == mn else mx - mn
        norm = self.q((f - mn) / span)
        st["screenbuffer"] = norm.clone()
        return norm
