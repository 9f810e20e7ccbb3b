"""Public API — mirrors the reference C API surface
(TempestSDR/src/include/TSDRLibrary.h:62-76, 16 functions + 3 callbacks) as
one class. Everything DSP-related delegates to the streaming session;
geometry changes rebuild the (cached) step, which is this package's
equivalent of the reference's buffer re-allocation on resolution change
(dsp.c:152-173). Every session runs on the `device` the TSDR was given
("cuda" by default; without a card it raises unless the caller asks for
"cpu").
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .config import PipelineConfig
from .errors import TSDRError, TSDRStatus
from .events import PlotEvent, ValueEvent
from .params import DIRECTION, PARAM, Params
from .sources.base import Source, load_source
from .stream.session import Session, SessionCallbacks


class TSDR:
    """Reference-API parity (tsdr_* functions -> methods):

    tsdr_init              -> TSDR(...)
    tsdr_loadplugin        -> load_source(name, params)
    tsdr_unloadplugin      -> unload_source()
    tsdr_setresolution     -> set_resolution(height, refreshrate)
    tsdr_setbasefreq       -> set_base_freq(freq)
    tsdr_setgain           -> set_gain(gain)
    tsdr_readasync         -> start(...) / run()   (+ start_async)
    tsdr_stop              -> stop()
    tsdr_isrunning         -> is_running
    tsdr_sync              -> sync(pixels, direction)
    tsdr_motionblur        -> set_motionblur(coeff)
    tsdr_setparameter_int  -> set_param(param, value)
    tsdr_setparameter_double -> set_parameter_double(param, value)
    tsdr_getlasterrortext  -> last_error
    tsdr_free              -> close()

    (tsdr_getctx, the JNI context accessor, has no Python equivalent — the
    `session` property plays that role.)
    """

    def __init__(
        self,
        on_value: Optional[Callable[[ValueEvent], None]] = None,
        on_plot: Optional[Callable[[PlotEvent], None]] = None,
        block_samples: int = 1 << 16,
        batch_blocks: int | str = 1,
        device="cuda",
    ):
        self._device = device
        self._callbacks = SessionCallbacks(on_value=on_value, on_plot=on_plot)
        self._batch_blocks = batch_blocks
        self._params = Params()
        self._source: Optional[Source] = None
        self._session: Optional[Session] = None
        self._height = 600
        self._refreshrate = 60.0
        self._block_samples = block_samples
        self._last_error = ""
        self._params_double = [0.0, 0.0]  # params_double[COUNT_PARAM_DOUBLE]

    # ---- source management ----

    def load_source(self, name: str, params: str = "") -> None:
        if self.is_running:
            raise TSDRError(TSDRStatus.ALREADY_RUNNING, "stop before loading a source")
        try:
            self._source = load_source(name, params)
        except TSDRError as e:
            self._last_error = str(e)
            raise

    def unload_source(self) -> None:
        if self.is_running:
            raise TSDRError(TSDRStatus.ALREADY_RUNNING, "stop before unloading")
        if self._source is not None:
            self._source.cleanup()
            self._source = None

    # ---- parameters ----

    def set_resolution(self, height: int, refreshrate: float) -> None:
        """Geometry is a rebuild boundary here (static shapes): changing it
        while streaming requires stop()/start() — the headless equivalent of
        the reference's live setResolution, whose C side also reallocates and
        purges everything (dsp.c:152-173, TSDRLibrary.c:379-383)."""
        if height <= 0 or refreshrate <= 0:
            raise TSDRError(TSDRStatus.WRONG_VIDEOPARAMS, "invalid height/refreshrate")
        if self.is_running:
            raise TSDRError(TSDRStatus.ALREADY_RUNNING,
                            "stop before changing resolution")
        self._height = int(height)
        self._refreshrate = float(refreshrate)

    def set_base_freq(self, freq: float) -> None:
        if self._session is not None:
            self._session.set_basefreq(freq)
        elif self._source is not None:
            self._source.set_basefreq(freq)

    def set_gain(self, gain: float) -> None:
        if self._source is not None:
            self._source.set_gain(gain)

    def set_motionblur(self, coeff: float) -> None:
        if not 0.0 <= coeff <= 1.0:
            raise TSDRError(TSDRStatus.WRONG_VIDEOPARAMS, "motionblur outside [0,1]")
        self._motionblur = coeff
        if self._session is not None:
            self._session.set_motionblur(coeff)

    def sync(self, pixels: int, direction: int = DIRECTION.CUSTOM) -> None:
        if self._session is None:
            raise TSDRError(TSDRStatus.NOT_RUNNING, "no active session")
        self._session.sync_shift(pixels, direction)

    def nudge_framerate(self, delta_hz: float) -> float:
        """Manual framerate nudge (the GUI framerate hold-buttons /
        unshifted left-right keys, Main.java:960-965,1012-1020). Live while
        streaming — rides the carried PLL refresh delta (no rebuild);
        between sessions it adjusts the nominal rate for the next start.
        Returns the refresh rate now in effect."""
        if self._session is not None and self.is_running:
            return self._session.nudge_refreshrate(delta_hz)
        self._refreshrate = max(1e-3, self._refreshrate + float(delta_hz))
        return self._refreshrate

    def set_param(self, param: int, value: int) -> None:
        """tsdr_setparameter_int: one-shot params act immediately; flag
        params apply live — a running session swaps its step at the
        next block, preserving carried
        state like the reference's in-place params_int writes
        (TSDRLibrary.c:604-611)."""
        p = PARAM(param)
        if p == PARAM.AUTOCORR_PLOTS_RESET:
            if self._session is not None:
                self._session.reset_autocorr()
            return
        if p == PARAM.AUTOCORR_DUMP:
            if self._session is not None:
                self._session.dump_autocorr()
            return
        new = self._params.with_int_param(p, value)
        if new == self._params:
            return
        if new.superresolution != self._params.superresolution and self.is_running:
            # superresolution changes the pipeline sample rate (hops x):
            # a config boundary, not a live flag
            raise TSDRError(TSDRStatus.ALREADY_RUNNING,
                            "stop before toggling superresolution")
        self._params = new
        if self._session is not None:
            self._session.set_params(new)

    def set_extra_params(self, **kw) -> None:
        """Set the extra flags that have no reference PARAM id
        (fast_sync, resampler, fir_lowpass_taps, debug_markers). Same live
        semantics as set_param: a running session swaps its step at
        the next block, preserving carried state."""
        new = self._params.replace(**kw)
        if new == self._params:
            return
        self._params = new
        if self._session is not None:
            self._session.set_params(new)

    def set_parameter_double(self, param: int, value: float) -> None:
        """tsdr_setparameter_double (TSDRLibrary.c:613-620): the reference
        validates the id against COUNT_PARAM_DOUBLE (= 2) and then only
        prints the value — no double parameter is ever consumed by the DSP.
        Mirror that surface: accept ids 0-1 (stored for symmetry), raise
        INVALID_PARAMETER otherwise."""
        if not 0 <= int(param) < 2:
            raise TSDRError(
                TSDRStatus.INVALID_PARAMETER,
                "Invalid double floating point parameter id",
            )
        self._params_double[int(param)] = float(value)

    # ---- streaming ----

    def _make_config(self, height: int | None = None,
                     refreshrate: float | None = None) -> PipelineConfig:
        if self._source is None:
            raise TSDRError(TSDRStatus.ERR_PLUGIN, "no source loaded")
        rate = self._source.samplerate()
        if self._params.superresolution:
            from .superband import SUPER_HOPS_TO_MAKE

            # the stitched stream re-enters the pipeline at HOPS x the
            # native rate (superbandwidth.c:151 set_internal_samplerate)
            rate *= SUPER_HOPS_TO_MAKE
        return PipelineConfig(
            samplerate=rate,
            height=self._height if height is None else int(height),
            refreshrate=(self._refreshrate if refreshrate is None
                         else float(refreshrate)),
            block_samples=self._block_samples,
        )

    def warm_resolution(self, height: int, refreshrate: float,
                        background: bool = False):
        """Build and warm the step for (height, refreshrate) so a later
        set_resolution + start switches modes with only the stream gap, not
        a first block's kernel build, FFT plan and allocations — the
        headless counterpart of the reference's live tsdr_setresolution
        (TSDRLibrary.c:552-566). Safe to call while streaming (the warm
        blocks run on a state of their own). background=True runs the warm
        start on a daemon thread and returns it (join to wait)."""
        from .stream.session import warm_compile_step

        cfg = self._make_config(height=height, refreshrate=refreshrate)
        # superresolution sessions dispatch host-stitched float32 blocks
        # regardless of the source's raw dtype (Session._superres_blocks)
        dtype = (np.float32 if self._params.superresolution
                 else self._source.block_dtype())
        if background:
            import threading

            t = threading.Thread(
                target=warm_compile_step, args=(cfg, self._params),
                kwargs=dict(batch_blocks=self._batch_blocks, raw_dtype=dtype,
                            device=self._device),
                daemon=True,
            )
            t.start()
            return t
        warm_compile_step(cfg, self._params,
                          batch_blocks=self._batch_blocks, raw_dtype=dtype,
                          device=self._device)
        return None

    def _rebuild_session(self) -> None:
        self._session = Session(self._make_config(), self._params, self._source,
                                self._callbacks, batch_blocks=self._batch_blocks,
                                device=self._device)
        self._session.set_motionblur(getattr(self, "_motionblur", 0.0))

    def start(
        self,
        on_frame: Callable[[np.ndarray], None],
        max_blocks: Optional[int] = None,
        max_frames: Optional[int] = None,
        background: bool = False,
    ):
        """tsdr_readasync: stream until stopped (or limits hit)."""
        if self.is_running:
            raise TSDRError(TSDRStatus.ALREADY_RUNNING, "already streaming")
        self._callbacks.on_frame = on_frame
        self._rebuild_session()
        if background:
            self._session.start_async(max_blocks=max_blocks, max_frames=max_frames)
            return None
        return self._session.run(max_blocks=max_blocks, max_frames=max_frames)

    def stop(self) -> None:
        if self._session is not None:
            self._session.stop()

    @property
    def is_running(self) -> bool:
        return self._session is not None and self._session.is_running

    @property
    def last_error(self) -> str:
        return self._last_error

    @property
    def session(self) -> Optional[Session]:
        return self._session

    def close(self) -> None:
        self.stop()
        self.unload_source()
