"""Plain PyTorch DSP ops: the counterparts of tempestsdr_tpu.ops."""

from .demod import am_demod, demod_raw_interleaved, normalize_iq  # noqa: F401
from .gaussian import gaussian_blur_circular  # noqa: F401
from .autocorr import autocorrelation_magnitude, accumulate_running_mean  # noqa: F401
from .fir import design_lowpass_fir, fir_apply_block  # noqa: F401
from .resample import (  # noqa: F401
    box_resample_block,
    box_resample_block_chunked,
    box_resample_gather_i32,
    box_resample_range,
    box_resample_range_strided,
    box_resample_strided,
    nn_resample_range,
    nn_resample_block,
    plan_strided,
    resample_counts,
)
from .frame import collapse_v_h, autogain_run, time_lowpass  # noqa: F401
from .sync import (  # noqa: F401
    find_best_fit, find_the_sweet_spot, find_the_sweet_spot_pair, framerate_pll, SweetspotState,
    PLLState)
