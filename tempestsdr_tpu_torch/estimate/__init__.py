"""Automatic display-mode estimation.

The reference splits this between the C autocorrelation thread
(frameratedetector.c — produces the two lag plots, already implemented in the
streaming pipeline) and the Java GUI (peak picking, fps/height transformers,
3-round convergence, VESA snapping — Main.java:1232-1371, VideoMode.java).
Here the whole estimation loop is host-side Python over the pipeline's plot
outputs.
"""

from .vesa import VideoMode, VIDEO_MODES, find_closest_mode  # noqa: F401
from .autores import AutoResolution, Estimate, estimate_from_plots  # noqa: F401
from .peaks import (  # noqa: F401
    best_peak_around,
    fps_from_lag,
    get_best_id_around,
    height_from_lags,
    lag_from_fps,
    select_fps,
    select_height,
)
from .plotrender import (  # noqa: F401
    decimate_max,
    decimate_max_zoomed,
    render_plot,
    save_plot,
)
from .scales import ZoomableXScale  # noqa: F401
from .meters import render_autogain_meter, render_snr_meter  # noqa: F401
