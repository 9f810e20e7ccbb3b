"""The port's MultiSession (tempestsdr_tpu_torch.stream.MultiSession)
against the JAX package's on the CPU, with the scenarios of
tests/test_stream.py:428-474, its host fetches counted, and the port's
multi-target example run end to end."""

import os

import numpy as np
import pytest
import torch

from tempestsdr_tpu.config import PipelineConfig as JConfig
from tempestsdr_tpu.errors import TSDRError as JError, TSDRStatus as JStatus
from tempestsdr_tpu.params import Params as JParams
from tempestsdr_tpu.sources.synthetic import SyntheticSource as JSynthetic
from tempestsdr_tpu.stream.multisession import MultiSession as JMultiSession

from tempestsdr_tpu_torch.config import PipelineConfig
from tempestsdr_tpu_torch.errors import TSDRError, TSDRStatus
from tempestsdr_tpu_torch.params import Params
from tempestsdr_tpu_torch.sources.base import Source, SourceBlock
from tempestsdr_tpu_torch.sources.synthetic import SyntheticSource, render_test_pattern, synth_iq
from tempestsdr_tpu_torch.stream import MultiSession

from test_examples import EX, run_example
from test_torch_device_step import one_torch_thread  # noqa: F401 (autouse)

SR, LINES, TWIDTH, REFRESH = 1e6, 100, 200, 50.0
C = 3
FRAME_ATOL, FRAME_RTOL = 1e-5, 1e-6  # tests/test_torch_stream.py:45-47
AC_RTOL = 1e-5


def _sources(cls, samplerates=None):
    out = []
    for c in range(C):
        s = cls()
        # different line width per channel -> visibly different frame content
        s.init(f"{LINES} {TWIDTH + 8 * c} {REFRESH} {(samplerates or [SR] * C)[c]} 0.01")
        out.append(s)
    return out


def _run(cls_ms, cls_cfg, cls_params, cls_src, block=8192, **kw):
    cfg = cls_cfg(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=block)
    got = {c: [] for c in range(C)}
    plots = []
    ms = cls_ms(cfg, cls_params(framerate_pll=False), _sources(cls_src),
                on_frame=lambda c, f: got[c].append(f),
                on_plot=lambda c, ev: plots.append((c, ev)), **kw)
    total = ms.run(max_frames=4 * C + 2)
    return ms, cfg, total, got, plots


@pytest.mark.parametrize("block", [8192, 49152])
def test_multisession_matches_jax(block):
    """Three sources of different content through both MultiSessions: the
    same frames per channel in the same order (K == 1 and K == 3), the same
    plot events, totals and drop counts; each channel carries its own raster
    (tests/test_stream.py:428-460)."""
    jms, _, jtotal, jgot, jplots = _run(JMultiSession, JConfig, JParams, JSynthetic, block)
    tms, cfg, total, got, plots = _run(MultiSession, PipelineConfig, Params, SyntheticSource, block,
                                       device="cpu")
    assert total == jtotal >= 4 * C and tms.frames_total == jms.frames_total
    assert tms.samples_dropped_total == jms.samples_dropped_total == [0] * C
    for c in range(C):
        assert len(got[c]) == len(jgot[c]) >= 3
        for a, b in zip(got[c], jgot[c]):
            np.testing.assert_allclose(a, b, rtol=FRAME_RTOL, atol=FRAME_ATOL)
    assert [(c, ev.plot_id, ev.offset) for c, ev in plots] == [
        (c, ev.plot_id, ev.offset) for c, ev in jplots]
    assert plots, "no estimation rounds fired"
    for (_, a), (_, b) in zip(plots, jplots):
        np.testing.assert_allclose(a.values, b.values, rtol=0,
                                   atol=AC_RTOL * np.abs(b.values).max())
    a, b = got[0][-1], got[1][-1]
    assert a.shape == b.shape == (LINES, cfg.width) and np.abs(a - b).max() > 0.05
    for c in range(C):
        assert np.corrcoef(got[c][-1].ravel(), got[c][-2].ravel())[0, 1] > 0.9


def test_multisession_rejects_mismatched_samplerate():
    """WRONG_VIDEOPARAMS from both packages for a source at another rate."""
    for ms, cfg_cls, params, src_cls, err, status, kw in (
            (JMultiSession, JConfig, JParams, JSynthetic, JError, JStatus, {}),
            (MultiSession, PipelineConfig, Params, SyntheticSource, TSDRError, TSDRStatus,
             {"device": "cpu"})):
        cfg = cfg_cls(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=8192,
                      autocorr=False)
        with pytest.raises(err) as ei:
            ms(cfg, params(framerate_pll=False), _sources(src_cls, [SR, 2 * SR, SR]), **kw)
        assert ei.value.status == status.WRONG_VIDEOPARAMS
        with pytest.raises(err) as ei:
            ms(cfg, params(), [], **kw)
        assert ei.value.status == status.ERR_PLUGIN


class _Droppy(Source):
    """A synthetic channel that reports `drop` samples lost before block 3."""

    def __init__(self, twidth, drop):
        self.raster = render_test_pattern(LINES, twidth)
        self.twidth, self.drop, self.working = twidth, drop, True

    def init(self, params):
        pass

    def name(self):
        return "droppy"

    def samplerate(self):
        return SR

    def stream(self, block_samples):
        pos, b = 0, 0
        while self.working:
            dropped = self.drop if b == 3 else 0
            pos += dropped
            yield SourceBlock(synth_iq(self.raster, samplerate=SR,
                                       pixelclock=LINES * self.twidth * REFRESH,
                                       n_samples=block_samples, start_sample=pos, noise=0.01,
                                       dtype=np.uint8), dropped)
            pos += block_samples
            b += 1

    def stop(self):
        self.working = False


@pytest.mark.parametrize("with_plots", [True, False], ids=["on_plot", "no-on_plot"])
def test_multisession_fetches_and_drops(monkeypatch, with_plots):
    """Per block one packed fetch (one .tolist() of the runner's [C, PACKED
    + K] values) and no other host read; on a block where a channel
    completed a frame, one copy of the valid frames to the host; on a block
    where a round completed, one of those channels' plots, only with
    on_plot set. download_stats counts those copies. Drops stay per
    channel."""
    from tempestsdr_tpu_torch.stream import session as session_mod
    from tempestsdr_tpu_torch.stream.graph import PACKED, ChannelRunner

    cfg = PipelineConfig(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=8192)
    got = {c: 0 for c in range(C)}
    n_plots = []
    ms = MultiSession(cfg, Params(), [_Droppy(TWIDTH + 8 * c, 5000 * (c == 1)) for c in range(C)],
                      on_frame=lambda c, f: got.__setitem__(c, got[c] + 1),
                      on_plot=(lambda c, ev: n_plots.append(c)) if with_plots else None,
                      device="cpu")
    calls = []
    for name in ("tolist", "item", "cpu", "__bool__", "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    marks, packs = [], []
    real_run = ChannelRunner.run

    def spy(self, *a, **k):
        marks.append(len(calls))
        out = real_run(self, *a, **k)
        packs.append(out[2].clone())
        return out

    monkeypatch.setattr(ChannelRunner, "run", spy)
    real_to_host = session_mod._to_host
    monkeypatch.setattr(session_mod, "_to_host",
                        lambda *a: (calls.append("to_host"), real_to_host(*a))[1])
    total = ms.run(max_blocks=20)
    marks.append(len(calls))
    monkeypatch.undo()
    assert ms.samples_dropped_total == [0, 5000, 0]
    assert sum(got.values()) == total == sum(ms.frames_total) and min(got.values()) >= 3
    assert set(n_plots) == (set(range(C)) if with_plots else set())
    assert len(packs) == 20
    emitting = rounds = 0
    for b, packed in enumerate(packs):
        block_calls = calls[marks[b]:marks[b + 1]]
        emit = bool(packed[:, len(PACKED):].any())
        done = bool(packed[:, PACKED.index("ac_plot_valid")].any())
        assert block_calls == ["tolist"] + ["to_host"] * (emit + (done and with_plots)), \
            (b, block_calls)
        emitting += emit
        rounds += done
    assert emitting >= 5 and rounds >= 1
    assert ms.download_stats.downloads == emitting + rounds * with_plots
    assert ms.download_stats.fresh_pinned == 0



def test_multisession_kept_frames_and_plots_stay_the_callers():
    """A caller that keeps every channel's frames and plots over the run
    still holds the bytes it cloned inside the callbacks when the run ends
    (tests/test_torch_session.py's case for Session); download_stats counts
    their bytes, with no pinned block on the CPU."""
    cfg = PipelineConfig(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=8192)
    kept, clones = [], []

    def keep(values):
        kept.append(values)
        clones.append(np.array(values, copy=True))

    ms = MultiSession(cfg, Params(), _sources(SyntheticSource),
                      on_frame=lambda c, f: keep(f), on_plot=lambda c, ev: keep(ev.values),
                      device="cpu")
    ms.run(max_blocks=16)
    frames = [k for k in kept if k.ndim == 2]
    assert len(frames) >= 4 * C and len(kept) > len(frames)
    for i, (a, b) in enumerate(zip(kept, clones)):
        assert a.tobytes() == b.tobytes(), i
    stats = ms.download_stats
    assert stats.downloads >= 2 and stats.bytes == sum(k.nbytes for k in kept)
    assert stats.fresh_pinned == 0 and stats.pinned_hit_share == 1.0

def test_multisession_async_start_stop():
    cfg = PipelineConfig(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=8192,
                         autocorr=False)
    frames = []
    ms = MultiSession(cfg, Params(framerate_pll=False), _sources(SyntheticSource),
                      on_frame=lambda c, f: frames.append(c), device="cpu")
    ms.start_async()
    import time

    deadline = time.time() + 60
    while len(frames) < 2 * C and time.time() < deadline:
        time.sleep(0.01)
    ms.stop()
    assert not ms.is_running and len(frames) >= 2 * C


def test_multisession_async_frames_equal_the_foreground_run(monkeypatch):
    """start_async streams, per channel, the frames of a foreground run over
    the same sources bit for bit. is_running holds from the call on, also
    while the worker thread is slow to start; the caller polls it until the
    run ends, then stop() joins the thread."""
    import time

    cfg = PipelineConfig(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=8192)

    def frames_of(start):
        got = {c: [] for c in range(C)}
        ms = MultiSession(cfg, Params(framerate_pll=False), _sources(SyntheticSource),
                          on_frame=lambda c, f: got[c].append(f), device="cpu")
        start(ms)
        return ms, got

    _, want = frames_of(lambda ms: ms.run(max_blocks=10))
    real_run = MultiSession.run

    def slow_start(self, **kw):
        time.sleep(0.2)
        return real_run(self, **kw)

    monkeypatch.setattr(MultiSession, "run", slow_start)
    ms, got = frames_of(lambda ms: ms.start_async(max_blocks=10))
    assert ms.is_running
    with pytest.raises(TSDRError):
        ms.start_async()
    deadline = time.time() + 60
    while ms.is_running and time.time() < deadline:
        time.sleep(0.005)
    thread = ms._thread
    ms.stop()
    assert not ms.is_running and ms._thread is None and not thread.is_alive()
    assert [len(got[c]) for c in range(C)] == [len(want[c]) for c in range(C)]
    assert min(len(want[c]) for c in range(C)) >= 3
    for c in range(C):
        assert all(np.array_equal(a, b) for a, b in zip(got[c], want[c])), c


def test_example_torch_multi_target(tmp_path):
    out = run_example([os.path.join(EX, "torch_multi_target.py"), "3", "--device", "cpu"],
                      tmp_path)
    assert "3 targets on cpu, frames per channel: [4, 4, 4]" in out, out
    assert "target 2:" in out, out
