"""The port's host spans (tempestsdr_tpu_torch/utils/profiling.py span) on
the CPU: under profile_trace, a Session at batch 1 and at batch 2 and a
two-channel MultiSession tile their loops with tsdr/source and tsdr/dispatch
spans, each dispatch holding one upload, one replay, one fetch and one
fan-out, its downloads and a callback span around each of the caller's
callbacks; the profiler changes no frame, plot, value or state bit; with no
profiler a span is one shared no-op; a profiler records the spans of its own
thread only."""

import glob
import json
import os
import threading

import numpy as np
import pytest
import torch

from tempestsdr_tpu_torch.config import PipelineConfig
from tempestsdr_tpu_torch.params import Params
from tempestsdr_tpu_torch.sources.synthetic import SyntheticSource
from tempestsdr_tpu_torch.stream.multisession import MultiSession
from tempestsdr_tpu_torch.stream.session import Session, SessionCallbacks
from tempestsdr_tpu_torch.stream.state import state_leaves
from tempestsdr_tpu_torch.utils.profiling import profile_trace, span

from test_torch_device_step import one_torch_thread  # noqa: F401 (autouse)

LINES, TWIDTH, REFRESH, SR, BLOCK = 100, 200, 50.0, 1e6, 8192
BLOCKS = 12  # blocks of each channel: a few frames and one estimator round
# case: (channels, batch_blocks)
CASES = {"session-batch1": (1, 1), "session-batch2": (1, 2), "multisession-2": (2, 1)}
INSIDE_DISPATCH = ("tsdr/upload", "tsdr/replay", "tsdr/fetch", "tsdr/fanout")


class Counted(SyntheticSource):
    """The synthetic source, counting the blocks its stream yields."""

    def __init__(self, twidth: int):
        super().__init__()
        self.init(f"{LINES} {twidth} {REFRESH} {SR} 0.01")
        self.calls = 0

    def stream(self, block_samples):
        for blk in super().stream(block_samples):
            self.calls += 1
            yield blk


def _marked(name: str, record: list):
    """A callback that records its argument inside a span of its own
    (test/<name>), as the benchmark marks its callbacks."""

    def callback(*args):
        with torch.profiler.record_function(f"test/{name}"):
            record.append(args)

    return callback


def _run(case: str, logdir=None) -> dict:
    """One run of the case, under profile_trace into logdir when given: the
    callbacks' records, the final state, the source calls and the spans."""
    channels, batch = CASES[case]
    cfg = PipelineConfig(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=BLOCK)
    sources = [Counted(TWIDTH + 8 * c) for c in range(channels)]
    rec = dict(frames=[], plots=[], values=[])
    if channels == 1:
        sess = Session(cfg, Params(), sources[0], SessionCallbacks(
            on_frame=_marked("frames", rec["frames"]), on_plot=_marked("plots", rec["plots"]),
            on_value=_marked("values", rec["values"])), batch_blocks=batch, device="cpu")
    else:
        sess = MultiSession(cfg, Params(), sources, on_frame=_marked("frames", rec["frames"]),
                            on_plot=_marked("plots", rec["plots"]), device="cpu")
    if logdir is None:
        sess.run(max_blocks=BLOCKS)
        spans = None
    else:
        with profile_trace(str(logdir)):
            sess.run(max_blocks=BLOCKS)
        (path,) = glob.glob(os.path.join(str(logdir), "*.json"))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                        for e in events if e.get("ph") == "X"
                        and e.get("name", "").startswith(("tsdr/", "test/"))),
                       key=lambda s: (s[1], -s[2]))
    return dict(rec=rec, state=state_leaves(sess.state), calls=sum(s.calls for s in sources),
                spans=spans, dispatches=BLOCKS // batch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's traced and untraced run, made once for the module."""
    done = {}

    def get(case: str, traced: bool = True) -> dict:
        if (case, traced) not in done:
            done[case, traced] = _run(case, tmp_path_factory.mktemp(case) if traced else None)
        return done[case, traced]

    return get


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("case", CASES)
def test_each_runner_call_is_one_dispatch_of_upload_replay_fetch_fanout(runs, case):
    spans = runs(case)["spans"]
    dispatches = _named(spans, "tsdr/dispatch")
    assert len(dispatches) == runs(case)["dispatches"]
    for d in dispatches:
        held = [s[0] for s in spans if s is not d and _inside(s, d)]
        for name in INSIDE_DISPATCH:
            assert held.count(name) == 1, (name, held)
    for name in INSIDE_DISPATCH + ("tsdr/download",):
        assert all(sum(_inside(s, d) for d in dispatches) == 1 for s in _named(spans, name))


@pytest.mark.parametrize("case", CASES)
def test_one_source_span_per_source_call(runs, case):
    got = runs(case)
    channels, _ = CASES[case]
    assert got["calls"] == BLOCKS * channels == len(_named(got["spans"], "tsdr/source"))


@pytest.mark.parametrize("case", CASES)
def test_sources_and_dispatches_tile_the_loop_without_overlap(runs, case):
    """The loop's top-level spans follow one another; every callback lies in
    a fan-out, every fan-out after its dispatch's fetch."""
    spans = runs(case)["spans"]
    top = sorted(_named(spans, "tsdr/source") + _named(spans, "tsdr/dispatch"),
                 key=lambda s: s[1])
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))
    fanouts = _named(spans, "tsdr/fanout")
    assert all(any(_inside(c, f) for f in fanouts) for c in _named(spans, "tsdr/callback"))
    for d in _named(spans, "tsdr/dispatch"):
        (fetch,) = [s for s in _named(spans, "tsdr/fetch") if _inside(s, d)]
        (fanout,) = [s for s in fanouts if _inside(s, d)]
        (upload,) = [s for s in _named(spans, "tsdr/upload") if _inside(s, d)]
        (replay,) = [s for s in _named(spans, "tsdr/replay") if _inside(s, d)]
        assert upload[2] <= replay[1] and replay[2] <= fetch[1] and fetch[2] <= fanout[1]


@pytest.mark.parametrize("case", CASES)
def test_a_callback_span_per_callback_and_a_download_before_each_frame(runs, case):
    got = runs(case)
    spans, rec = got["spans"], got["rec"]
    callbacks = _named(spans, "tsdr/callback")
    marks = [s for s in spans if s[0].startswith("test/")]
    assert rec["frames"] and rec["plots"]
    assert len(marks) == len(callbacks) == sum(len(v) for v in rec.values())
    assert all(any(_inside(m, c) for c in callbacks) for m in marks)
    for m in _named(spans, "test/frames"):
        (d,) = [d for d in _named(spans, "tsdr/dispatch") if _inside(m, d)]
        assert any(_inside(s, d) and s[2] <= m[1] for s in _named(spans, "tsdr/download"))


@pytest.mark.parametrize("case", CASES)
def test_the_profiler_changes_no_output(runs, case):
    traced, plain = runs(case), runs(case, traced=False)
    for key in ("frames", "plots", "values"):
        assert len(traced["rec"][key]) == len(plain["rec"][key])
    for a, b in zip(traced["rec"]["frames"], plain["rec"]["frames"]):
        assert a[:-1] == b[:-1] and np.array_equal(a[-1], b[-1])
    for a, b in zip(traced["rec"]["plots"], plain["rec"]["plots"]):
        assert a[:-1] == b[:-1] and (a[-1].plot_id, a[-1].offset) == (b[-1].plot_id, b[-1].offset)
        assert np.array_equal(a[-1].values, b[-1].values)
    assert [v[0] for v in traced["rec"]["values"]] == [v[0] for v in plain["rec"]["values"]]
    assert all(torch.equal(a, b) for a, b in zip(traced["state"], plain["state"]))


def test_without_a_profiler_a_span_is_one_shared_noop(tmp_path):
    assert not torch.autograd._profiler_enabled()
    noop = span("tsdr/a")
    assert span("tsdr/b") is noop
    with noop, span("tsdr/c"):  # reentrant
        pass
    with profile_trace(str(tmp_path)):
        assert isinstance(span("tsdr/a"), torch.profiler.record_function)


def test_a_profiler_records_the_spans_of_its_own_thread_only(tmp_path):
    """A span opened on another thread than the profiler's is the no-op and
    leaves nothing in the trace (so a start_async loop's spans are not
    recorded by a profiler its caller started)."""
    noop = span("tsdr/outside")
    got = []

    def worker():
        s = span("tsdr/worker")
        got.append(s is noop)
        with s:
            pass

    with profile_trace(str(tmp_path)):
        with span("tsdr/caller"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and got == [True]
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "tsdr/caller" in names and "tsdr/worker" not in names
