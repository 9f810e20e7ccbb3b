"""Live flips through the API against the JAX package's on the CPU: what a
user toggles (the GUI's buttons, the TUI's keys) through TSDR.set_param and
set_extra_params, in order and back, twice, record for record (frames
within tests/test_torch_session.py's FRAME_ATOL, value and plot events as
there), with the runners the port makes counted."""

import numpy as np

from tempestsdr_tpu.params import Params as JParams

from tempestsdr_tpu_torch.params import PARAM, Params
from tempestsdr_tpu_torch.stream import session as tsession

from test_torch_session import (
    BLOCK,
    LINES,
    REFRESH,
    SPEC,
    _compare_records,
    _jax_warm,
)
from test_torch_device_step import one_torch_thread  # noqa: F401 (autouse)


# what a user toggles, in order, through the API (the GUI's buttons, the
# TUI's keys); then each back, in reverse
FLIP_CYCLE = ((PARAM.AUTOSHIFT, 1), (PARAM.LOW_PASS_BEFORE_SYNC, 1),
              (PARAM.AUTOGAIN_AFTER_PROCESSING, 1), (PARAM.FRAMERATE_PLL, 0),
              (PARAM.AUTOCORR_PLOTS_OFF, 1), ("fast_sync", True),
              (PARAM.NEAREST_NEIGHBOUR_RESAMPLING, 1))
FLIP_EVERY = 2  # frames between two flips


def _flip(rx, key, value):
    """One toggle through the API: a reference PARAM id by set_param, an
    extra flag by set_extra_params."""
    if isinstance(key, str):
        rx.set_extra_params(**{key: value})
    else:
        rx.set_param(int(key), value)


def test_tsdr_set_param_cycle_matches_jax(monkeypatch):
    """FLIP_CYCLE and back, twice, through TSDR.set_param and
    set_extra_params from on_frame every FLIP_EVERY frames (each flip lands
    on the next block), motion blur 0.5, against the JAX TSDR record for
    record: frames, values and plots (the first frame after each
    lowpass_before_sync flip shows the zeroed screen buffer in both); the
    frame counter counts on across every flip; the first cycle makes one
    runner per Params it visits, the second none."""
    from tempestsdr_tpu import api as japi
    from tempestsdr_tpu_torch import api as tapi
    from tempestsdr_tpu_torch.stream import graph as tgraph

    back = [(k, (not v) if isinstance(k, str) else 1 - v) for k, v in reversed(FLIP_CYCLE)]
    cycle = list(FLIP_CYCLE) + back
    schedule = cycle * 2
    n_frames = FLIP_EVERY * (len(schedule) + 1)
    visited, p = {Params()}, Params()
    for key, value in cycle:
        p = p.replace(**{key: value}) if isinstance(key, str) else p.with_int_param(key, value)
        visited.add(p)
    assert len(visited) == len(FLIP_CYCLE) + 1
    for p in visited:  # the JAX Session compiles a flip's step unless warmed
        _jax_warm(JParams(**vars(p)), 1)
    monkeypatch.setattr(tsession, "_WARM_STEPS", {})
    made, real_init = [], tgraph.BlockRunner.__init__

    def counted_init(self, config, params, *a, **k):
        made.append(params)
        real_init(self, config, params, *a, **k)

    monkeypatch.setattr(tgraph.BlockRunner, "__init__", counted_init)
    recs, rxs, made_by_cycle = {}, {}, []
    for which, mod, kw in (("j", japi, {}), ("t", tapi, dict(device="cpu"))):
        rec = dict(frames=[], values=[], plots=[])
        rx = mod.TSDR(on_value=rec["values"].append, on_plot=rec["plots"].append,
                      block_samples=BLOCK, **kw)
        rx.load_source("synthetic", SPEC)
        rx.set_resolution(LINES, REFRESH)
        rx.set_motionblur(0.5)

        def on_frame(f, rx=rx, rec=rec, which=which):
            rec["frames"].append(f)
            i, due = divmod(len(rec["frames"]), FLIP_EVERY)
            if due == 0 and 1 <= i <= len(schedule):
                if which == "t" and i == len(cycle) + 1:
                    made_by_cycle.append(list(made))
                _flip(rx, *schedule[i - 1])

        assert rx.start(on_frame=on_frame, max_frames=n_frames) == n_frames
        recs[which], rxs[which] = rec, rx
    _compare_records(recs["j"], recs["t"])
    assert [int(np.asarray(rx.session.state.frame_count)) for rx in rxs.values()] == [n_frames] * 2
    assert rxs["t"].session.params == Params() == Params(**vars(rxs["j"].session.params))
    assert sorted(map(repr, made_by_cycle[0])) == sorted(map(repr, visited))
    assert made == made_by_cycle[0]  # the second cycle made no runner
