"""Plain PyTorch DSP ops: the counterparts of tempestsdr_tpu.ops."""

from .demod import am_demod, normalize_iq  # noqa: F401
from .gaussian import gaussian_blur_circular  # noqa: F401
from .autocorr import autocorrelation_magnitude, accumulate_running_mean  # noqa: F401
from .resample import box_resample_strided, plan_strided, resample_counts  # noqa: F401
from .frame import collapse_v_h, autogain_run, time_lowpass  # noqa: F401
from .sync import find_best_fit, find_the_sweet_spot, framerate_pll, SweetspotState, PLLState  # noqa: F401
