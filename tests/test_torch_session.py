"""The port's Session in full (tempestsdr_tpu_torch.stream.session) against
the JAX package's on the CPU, event for event: batching, live params, the
framerate nudge, the autocorrelation dump, async start/stop and the warm
start. Frames within FRAME_RTOL/FRAME_ATOL (the step's parity tolerance,
tests/test_torch_stream.py), value-event ids equal and their arguments
within rtol 1e-5, plot ids and offsets equal and plot values within AC_RTOL
of the peak."""

import functools
import threading
import time

import numpy as np
import pytest
import torch

from tempestsdr_tpu.config import PLL_HEADROOM_FRAC, PipelineConfig as JConfig
from tempestsdr_tpu.errors import TSDRError as JError, TSDRStatus as JStatus
from tempestsdr_tpu.params import Params as JParams
from tempestsdr_tpu.sources.synthetic import render_test_pattern, synth_iq
from tempestsdr_tpu.sources.synthetic import SyntheticSource as JSynthetic
from tempestsdr_tpu.stream import session as jsession
from tempestsdr_tpu.utils import profiling as jprofiling

from tempestsdr_tpu_torch.config import PIXEL_SPECIAL_VALUE_G, PipelineConfig
from tempestsdr_tpu_torch.errors import TSDRError, TSDRStatus
from tempestsdr_tpu_torch.params import Params
from tempestsdr_tpu_torch.sources.synthetic import SyntheticSource
from tempestsdr_tpu_torch.stream import session as tsession
from tempestsdr_tpu_torch.utils import profiling as tprofiling

from test_torch_device_step import one_torch_thread  # noqa: F401 (autouse)

LINES, TWIDTH, REFRESH, SR, BLOCK = 100, 200, 50.0, 1e6, 8192
FRAME_ATOL, FRAME_RTOL = 1e-5, 1e-6  # tests/test_torch_stream.py
AC_RTOL = 1e-5
SPEC = f"{LINES} {TWIDTH} {REFRESH} {SR} 0.01"
CPU = torch.device("cpu")


class FiniteDroppy:
    """A deterministic float32 stream of `n_blocks` blocks that skips
    `drop_n` samples before block `drop_block` and reports them (the
    hardware-drop semantics of tests/test_stream.py's DroppySynth). Serves
    both packages' sessions: they read .samples and .dropped only."""

    def __init__(self, n_blocks=None, drop_block=5, drop_n=12345):
        self.raster = render_test_pattern(LINES, TWIDTH)
        self.n_blocks, self.drop_block, self.drop_n = n_blocks, drop_block, drop_n
        self.pos = self.block = 0

    def samplerate(self):
        return SR

    def set_basefreq(self, freq):
        self.freq = freq

    def set_gain(self, gain):
        self.gain = gain

    def stream(self, block_samples):
        from tempestsdr_tpu_torch.sources.base import SourceBlock

        while self.n_blocks is None or self.block < self.n_blocks:
            dropped = 0
            if self.block == self.drop_block:
                self.pos += self.drop_n
                dropped = self.drop_n
            blk = synth_iq(self.raster, samplerate=SR, pixelclock=LINES * TWIDTH * 50.03,
                           n_samples=block_samples, start_sample=self.pos, noise=0.01,
                           seed=self.block)
            self.pos += block_samples
            self.block += 1
            yield SourceBlock(blk, dropped)

    def stop(self):
        pass


def _synthetic(which):
    src = JSynthetic() if which == "j" else SyntheticSource()
    src.init(SPEC)
    return src


@functools.lru_cache(maxsize=None)
def _jax_warm(params: JParams, batch: int, autocorr: bool = True):
    """Compile the JAX step once per (params, batch): every JAX session of
    this file with that key reuses it through the package's warm cache."""
    cfg = JConfig(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=BLOCK,
                  autocorr=autocorr)
    jsession.warm_compile_step(cfg, params, batch_blocks=batch, raw_dtype=np.float32)


def _session(which, source, batch=1, autocorr=True, **params):
    """A recording session of the JAX package ("j") or the port ("t")."""
    rec = dict(frames=[], values=[], plots=[])
    kw = dict(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=BLOCK,
              autocorr=autocorr)
    if which == "j":
        _jax_warm(JParams(**params), batch, autocorr)
        cbs = jsession.SessionCallbacks(on_frame=rec["frames"].append,
                                        on_value=rec["values"].append,
                                        on_plot=rec["plots"].append)
        sess = jsession.Session(JConfig(**kw), JParams(**params), source, cbs,
                                batch_blocks=batch)
    else:
        cbs = tsession.SessionCallbacks(on_frame=rec["frames"].append,
                                        on_value=rec["values"].append,
                                        on_plot=rec["plots"].append)
        sess = tsession.Session(PipelineConfig(**kw), Params(**params), source, cbs,
                                batch_blocks=batch, device="cpu")
    return sess, rec


def _compare_records(rj, rt, frame_atol=FRAME_ATOL):
    assert len(rt["frames"]) == len(rj["frames"]) > 0
    for i, (a, b) in enumerate(zip(rt["frames"], rj["frames"])):
        np.testing.assert_allclose(a, b, rtol=FRAME_RTOL, atol=frame_atol, err_msg=f"frame {i}")
    assert [v.value_id for v in rt["values"]] == [v.value_id for v in rj["values"]]
    for a, b in zip(rt["values"], rj["values"]):
        np.testing.assert_allclose([a.arg0, a.arg1], [b.arg0, b.arg1], rtol=1e-5)
    assert [(p.plot_id, p.offset) for p in rt["plots"]] == [
        (p.plot_id, p.offset) for p in rj["plots"]]
    for a, b in zip(rt["plots"], rj["plots"]):
        np.testing.assert_allclose(a.values, b.values, rtol=0,
                                   atol=AC_RTOL * np.abs(b.values).max())


def test_batched_session_matches_unbatched_and_jax():
    """batch 1 against batch 4 against the JAX batch 4 on a stream of 30
    blocks (no multiple of 4: the last two are never dispatched at batch 4)
    with a sync shift pending at the start (slot 0 only) and a drop at
    block 5 (the middle of a batch, compensated at its own slot)."""
    runs = {}
    for name, which, batch in (("t1", "t", 1), ("t4", "t", 4), ("j4", "j", 4)):
        sess, rec = _session(which, FiniteDroppy(n_blocks=30), batch=batch)
        sess.sync_shift(37)
        sess.run()
        assert sess.samples_dropped_total == 12345
        runs[name] = (sess, rec)
    _compare_records(runs["j4"][1], runs["t4"][1])
    assert runs["t4"][0].meter.total_samples == 28 * BLOCK
    assert runs["t1"][0].meter.total_samples == 30 * BLOCK
    # the same steps in the same order: batch 4's events are batch 1's, exactly
    f1, f4 = runs["t1"][1]["frames"], runs["t4"][1]["frames"]
    assert len(f1) >= len(f4) >= 4
    for a, b in zip(f1, f4):
        np.testing.assert_array_equal(a, b)
    p1, p4 = runs["t1"][1]["plots"], runs["t4"][1]["plots"]
    assert len(p4) >= 2
    for a, b in zip(p1, p4):
        assert (a.plot_id, a.offset) == (b.plot_id, b.offset)
        np.testing.assert_array_equal(a.values, b.values)


def test_batched_limits_are_tested_after_a_dispatch():
    """run(max_blocks=10) at batch 4 runs 12 blocks, in both packages."""
    for which in ("t", "j"):
        sess, rec = _session(which, _synthetic(which), batch=4, autocorr=False,
                             framerate_pll=False)
        sess.run(max_blocks=10)
        assert sess.meter.total_samples == 12 * BLOCK, which


def test_batched_controls_from_callbacks_match_jax():
    """Controls set from on_frame at batch 4 — a sync shift, motion blur, an
    autocorrelation reset — act from the next batch on, as in the JAX
    session: the same events."""
    recs = {}
    for which in ("j", "t"):
        sess, rec = _session(which, _synthetic(which), batch=4)
        n = {"frames": 0}

        def on_frame(f, sess=sess, rec=rec, n=n):
            rec["frames"].append(f)
            n["frames"] += 1
            if n["frames"] == 3:
                sess.sync_shift(1234)
                sess.set_motionblur(0.4)
            if n["frames"] == 5:
                sess.reset_autocorr()

        sess.callbacks.on_frame = on_frame
        sess.run(max_blocks=40)
        recs[which] = rec
    ids = [v.value_id.name for v in recs["t"]["values"]]
    assert "AUTOCORRECT_RESET" in ids and "AUTOCORRECT_FRAMES_COUNT" in ids
    _compare_records(recs["j"], recs["t"])


@pytest.mark.parametrize("flip", [
    dict(debug_markers=True),
    dict(lowpass_before_sync=True),
    dict(fir_lowpass_taps=31),
    dict(autoshift=True),
    dict(autogain_after_proc=True),
    dict(fast_sync=True),
    dict(autocorr_plots_off=True),
    dict(nearest_neighbour=True),
], ids=lambda d: ",".join(d))
def test_set_params_live_matches_jax(flip):
    """set_params flipped from on_frame after frame 6: the step is rebuilt at
    the next block; the state is kept when its shapes allow (the frame
    counter keeps counting; the screen buffer is zeroed on a
    lowpass_before_sync flip) and fresh otherwise (fir_lowpass_taps 0 -> 31
    changes the FIR carry's shape), in both packages alike."""
    recs, sessions = {}, {}
    for which, cls in (("j", JParams), ("t", Params)):
        sess, rec = _session(which, _synthetic(which), autocorr=False, framerate_pll=False)
        if which == "j":
            _jax_warm(JParams(framerate_pll=False, **flip), 1, False)

        def on_frame(f, sess=sess, rec=rec, cls=cls):
            rec["frames"].append(f)
            if len(rec["frames"]) == 6:
                sess.set_params(cls(framerate_pll=False, **flip))

        sess.callbacks.on_frame = on_frame
        assert sess.run(max_frames=12) == 12
        recs[which], sessions[which] = rec, sess
    _compare_records(recs["j"], recs["t"])
    counts = {w: int(np.asarray(s.state.frame_count)) for w, s in sessions.items()}
    assert counts["t"] == counts["j"]
    if "fir_lowpass_taps" in flip:
        assert counts["t"] < 12 and sessions["t"].state.fir_tail.shape == (30,)
    else:
        assert counts["t"] == 12
    if "debug_markers" in flip:
        frames = recs["t"]["frames"]
        assert not (frames[4] == PIXEL_SPECIAL_VALUE_G).any()
        assert (frames[-1] == PIXEL_SPECIAL_VALUE_G).any()
    assert sessions["t"].params == Params(framerate_pll=False, **flip)


def test_nudge_refreshrate_live_and_clamped():
    """The nudge lands in the carried PLL refresh_delta at the next block
    and saturates at the static headroom; the values it returns and
    current_refreshrate equal the JAX session's to 1e-6
    (tests/test_tui.py:248)."""
    lim = REFRESH * PLL_HEADROOM_FRAC
    got = {}
    for which in ("j", "t"):
        sess, rec = _session(which, _synthetic(which), autocorr=False, framerate_pll=False)
        seen, ret = [], []

        def on_frame(f, sess=sess, seen=seen, ret=ret):
            seen.append(sess.current_refreshrate())
            if len(seen) == 1:
                ret.append(sess.nudge_refreshrate(0.5 * lim))
            elif len(seen) == 2:
                ret.append(sess.nudge_refreshrate(10 * lim))  # saturates
            elif len(seen) == 3:
                ret.append(sess.nudge_refreshrate(-0.25 * lim))

        sess.callbacks.on_frame = on_frame
        sess.run(max_frames=5)
        got[which] = (seen, ret, sess.current_refreshrate())
    seen, ret, final = got["t"]
    assert ret == pytest.approx([REFRESH + 0.5 * lim, REFRESH + lim, REFRESH + 0.75 * lim])
    assert seen[0] == pytest.approx(REFRESH) and seen[2] == pytest.approx(REFRESH + lim)
    np.testing.assert_allclose(seen, got["j"][0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ret, got["j"][1], rtol=0, atol=1e-6)
    assert final == pytest.approx(got["j"][2], abs=1e-6)


def _read_dump(path):
    lines = open(path).read().splitlines()
    assert lines[0] == "ms, dB"
    rows = np.array([[float(x) for x in line.split(",")] for line in lines[1:]])
    return rows[:, 0], rows[:, 1]


def test_dump_autocorr_both_forms_match_jax(tmp_path):
    """dump_autocorr, raw half-range and windows form: False before the
    first round; then the same row count and the same times as the JAX
    session's file, and dB within 5e-4 dB wherever the JAX value is within
    60 dB of its peak (below that the two FFTs' rounding shows)."""
    dumps = {}
    for which in ("j", "t"):
        sess, rec = _session(which, _synthetic(which), framerate_pll=False)
        assert not sess.dump_autocorr(str(tmp_path / f"early_{which}.csv"))
        assert not sess.dump_autocorr(str(tmp_path / f"early_{which}.csv"), windows=True)
        sess.run(max_blocks=16)
        raw, win = str(tmp_path / f"{which}.csv"), str(tmp_path / f"{which}_w.csv")
        assert sess.dump_autocorr(raw) and sess.dump_autocorr(win, windows=True)
        dumps[which] = (_read_dump(raw), _read_dump(win), sess, rec)
        assert [v.value_id.name for v in rec["values"]].count("AUTOCORRECT_DUMPED") == 2
    cfg = dumps["t"][2].config
    for form in (0, 1):
        (tt, tdb), (jt, jdb) = dumps["t"][form], dumps["j"][form]
        assert len(tt) == len(jt)
        np.testing.assert_array_equal(tt, jt)
        near = jdb > jdb.max() - 60.0
        assert near.sum() > len(jdb) // 2
        np.testing.assert_allclose(tdb[near], jdb[near], rtol=0, atol=5e-4)
    assert len(dumps["t"][0][0]) == cfg.ac_fft_size // 2
    assert dumps["t"][0][0][0] == 0.0 and dumps["t"][1][0][0] > 0.0


def test_set_basefreq_retunes_and_resets_autocorr():
    """set_basefreq reaches the source and queues an autocorrelation reset
    (the next block emits AUTOCORRECT_RESET); set_gain reaches the source."""
    for which in ("t", "j"):
        src = FiniteDroppy(n_blocks=3, drop_block=-1)
        sess, rec = _session(which, src, framerate_pll=False)
        sess.set_basefreq(433e6)
        sess.set_gain(0.7)
        assert (src.freq, src.gain) == (433e6, 0.7)
        sess.run()
        assert [v.value_id.name for v in rec["values"]][0] == "AUTOCORRECT_RESET", which


def test_start_async_stop_and_already_running():
    """start_async marks the session running before its thread starts, a
    second start raises ALREADY_RUNNING, stop joins the loop; an off-thread
    current_refreshrate answers while streaming. Both packages alike."""
    for which, err, status in (("t", TSDRError, TSDRStatus.ALREADY_RUNNING),
                               ("j", JError, JStatus.ALREADY_RUNNING)):
        sess, rec = _session(which, _synthetic(which), autocorr=False, framerate_pll=False)
        stopped = []
        sess.callbacks.on_stopped = lambda stopped=stopped: stopped.append(True)
        sess.start_async()
        assert sess.is_running
        with pytest.raises(err) as ei:
            sess.start_async()
        assert ei.value.status == status
        deadline = time.time() + 60
        while len(rec["frames"]) < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert sess.current_refreshrate() == pytest.approx(REFRESH)
        sess.stop()
        assert not sess.is_running and stopped == [True] and len(rec["frames"]) >= 3
        n = len(rec["frames"])
        time.sleep(0.05)
        assert len(rec["frames"]) == n  # the loop has ended


def test_warm_compile_step_is_reused_by_session():
    """warm_compile_step caches the BlockRunner under (config, params,
    batch, device); a later Session with that key reuses the object, as the JAX
    Session reuses its warmed functions (tests/test_stream.py:376), and
    streams the frames of a session that was not warmed."""
    cfg = PipelineConfig(samplerate=SR, height=LINES + 2, refreshrate=REFRESH,
                         block_samples=BLOCK)
    params = Params(framerate_pll=False)
    key = (cfg, params, 2, CPU)
    assert key not in tsession._WARM_STEPS
    cold_frames = []
    tsession.Session(cfg, params, _synthetic("t"),
                     tsession.SessionCallbacks(on_frame=cold_frames.append), batch_blocks=2,
                     device="cpu").run(max_frames=3)
    tsession.warm_compile_step(cfg, params, batch_blocks=2, raw_dtype=np.float32, device="cpu")
    warmed = tsession._WARM_STEPS[key]
    frames = []
    sess = tsession.Session(cfg, params, _synthetic("t"),
                            tsession.SessionCallbacks(on_frame=frames.append), batch_blocks=2,
                            device="cpu")
    assert sess._runner is warmed
    assert sess.run(max_frames=3) >= 3
    for a, b in zip(frames, cold_frames):
        np.testing.assert_array_equal(a, b)
    # another batch size or device string is another key
    assert tsession.Session(cfg, params, _synthetic("t"), device="cpu")._runner is not warmed
    # the JAX package's contract, on its own cache
    jcfg = JConfig(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=BLOCK,
                   autocorr=False)
    _jax_warm(JParams(framerate_pll=False), 1, False)
    jsess = jsession.Session(jcfg, JParams(framerate_pll=False), _synthetic("j"))
    assert jsess._step is jsession._WARM_STEPS[(jcfg, JParams(framerate_pll=False), 1)][0]


def test_warm_compile_step_on_a_thread_while_streaming():
    """The warm start of the very key a session streams with, from a second
    thread: the runner the session holds is warm already and is left
    alone, and the session's frames stay those of an undisturbed run."""
    cfg = PipelineConfig(samplerate=SR, height=LINES + 4, refreshrate=REFRESH,
                         block_samples=BLOCK)
    params = Params()

    def run(disturb):
        frames = []
        sess = tsession.Session(cfg, params, _synthetic("t"),
                                tsession.SessionCallbacks(on_frame=frames.append), device="cpu")
        threads = []

        def on_frame(f):
            frames.append(f)
            if disturb and len(frames) in (1, 3):
                t = threading.Thread(target=tsession.warm_compile_step, args=(cfg, params),
                                     kwargs=dict(raw_dtype=np.float32, device="cpu"))
                t.start()
                threads.append(t)

        sess.callbacks.on_frame = on_frame
        sess.run(max_frames=8)
        for t in threads:
            t.join(timeout=60)
        return frames, sess

    tsession.warm_compile_step(cfg, params, raw_dtype=np.float32, device="cpu")
    quiet, _ = run(False)
    loud, sess = run(True)
    assert sess._runner is tsession._WARM_STEPS[(cfg, params, 1, CPU)]
    assert len(quiet) == len(loud) == 8
    for a, b in zip(quiet, loud):
        np.testing.assert_array_equal(a, b)


def test_resolve_batch_blocks_and_auto_sizing():
    """auto_batch_blocks is the JAX package's arithmetic
    (tests/test_stream.py:582: 27, 1, 3); resolve_batch_blocks passes ints
    and resolves "auto" to at least 1 from the measured floor; a Session
    built with "auto" streams."""
    cfg = PipelineConfig(samplerate=8e6, height=628, refreshrate=60.0, block_samples=65536)
    jcfg = JConfig(samplerate=8e6, height=628, refreshrate=60.0, block_samples=65536)
    for latency, floor, want in ((0.25, 0.025, 27), (0.25, 1e-4, 1), (0.05, 0.025, 3)):
        got = tprofiling.auto_batch_blocks(cfg, latency_s=latency, floor_s=floor)
        assert got == want == jprofiling.auto_batch_blocks(jcfg, latency_s=latency, floor_s=floor)
    assert tsession.resolve_batch_blocks(cfg, 17, device="cpu") == 17
    assert tsession.resolve_batch_blocks(cfg, 0, device="cpu") == 1
    auto = tsession.resolve_batch_blocks(cfg, "auto", device="cpu")
    assert isinstance(auto, int) and 1 <= auto <= 256
    sess, rec = _session("t", _synthetic("t"), batch="auto", autocorr=False,
                         framerate_pll=False)
    assert isinstance(sess.batch_blocks, int) and sess.batch_blocks >= 1
    sess.run(max_blocks=8 * sess.batch_blocks)
    assert rec["frames"] and rec["frames"][-1].shape == (LINES, sess.config.width)


def test_dispatch_floor_meter_and_trace(tmp_path):
    """measure_dispatch_floor(device="cpu") is a positive time, cached per device;
    IngestMeter counts like the JAX package's; profile_trace writes a Chrome
    trace of the enclosed run."""
    floor = tprofiling.measure_dispatch_floor(device="cpu")
    assert 0 < floor < 1.0 and tprofiling.measure_dispatch_floor(device="cpu") == floor
    meters = (tprofiling.IngestMeter(), jprofiling.IngestMeter())
    for m in meters:
        for _ in range(3):
            m.update(1000, 2)
        assert m.samples_per_sec > 0 and "frames" in repr(m)
    assert (meters[0].total_samples, meters[0].total_frames) == (
        meters[1].total_samples, meters[1].total_frames) == (3000, 6)
    sess, rec = _session("t", _synthetic("t"), autocorr=False, framerate_pll=False)
    with tprofiling.profile_trace(str(tmp_path / "trace")):
        sess.run(max_blocks=3)
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].stat().st_size > 1000


@pytest.mark.parametrize("batch", [1, 4])
def test_kept_frames_and_plots_stay_the_callers(monkeypatch, batch):
    """A caller that keeps every frame and plot it is handed still holds,
    after the run, the bytes it cloned inside the callback: the rows are
    host memory of their own, never a view of the step's outputs, which the
    next block rewrites. download_stats counts each copy to the host and its
    bytes, with no pinned block on the CPU."""
    kept, clones = [], []

    def keep(values):
        kept.append(values)
        clones.append(np.array(values, copy=True))

    cbs = tsession.SessionCallbacks(on_frame=keep, on_plot=lambda ev: keep(ev.values))
    sess = tsession.Session(PipelineConfig(samplerate=SR, height=LINES, refreshrate=REFRESH,
                                           block_samples=BLOCK),
                            Params(), FiniteDroppy(n_blocks=24), cbs, batch_blocks=batch,
                            device="cpu")
    copies = []
    real_to_host = tsession._to_host
    monkeypatch.setattr(tsession, "_to_host",
                        lambda *a: (copies.append(1), real_to_host(*a))[1])
    sess.run()
    frames = [k for k in kept if k.ndim == 2]
    assert len(frames) >= 4 and len(kept) - len(frames) >= 4  # two plots a round
    for i, (a, b) in enumerate(zip(kept, clones)):
        assert a.tobytes() == b.tobytes(), i
    stats = sess.download_stats
    assert stats.downloads == len(copies) >= 2
    assert stats.bytes == sum(k.nbytes for k in kept)
    assert stats.fresh_pinned == 0 and stats.pinned_hit_share == 1.0


@pytest.mark.parametrize("rows", [[1, 2, 3], [4, 0, 2], [], "plots"],
                         ids=["consecutive", "gathered", "empty", "plot-rows"])
def test_download_rows_are_the_stacks_and_its_own(rows):
    """_download's rows equal stack[rows] bit for bit, in its dtype, and a
    later write to the stack leaves them as they were."""
    gen = torch.Generator().manual_seed(5)
    if rows == "plots":  # the plots' stack: [blocks, frame window + line window]
        stack, rows = torch.randn(4, 37, generator=gen, dtype=torch.float32), [0, 3]
    else:
        stack = torch.randn(6, 5, 7, generator=gen, dtype=torch.float32)
    want = stack[rows].numpy().copy()
    got = tsession._download(stack, rows)
    assert len(got) == len(rows)
    assert all(g.dtype == want.dtype and g.tobytes() == w.tobytes() for g, w in zip(got, want))
    stack.add_(1.0)
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))
