"""The live path on the CPU: the repo's replay plugin (a fixture to the
reference's binary plugin ABI, tempestsdr_tpu_torch/native/replay_plugin.c)
through both packages' CPluginSource, and recorded live blocks that carry
drops through both packages' Session and MultiSession.

Small sizes: 2 MS/s, 100-line rasters 160-176 wide, 8192-sample blocks.
Integers exact; frames within FRAME_ATOL/FRAME_RTOL (the steps' parity
tolerance, tests/test_torch_session.py), or 2e-5 where a plugin's frames
meet rawfile's (tests/test_cplugin.py:192-193); the port against itself bit
for bit."""

import os
import shutil
import subprocess
import time

import jax
import numpy as np
import pytest
import torch

import tempestsdr_tpu.native as jnative
import tempestsdr_tpu.sources as jsources
from tempestsdr_tpu import errors as jerrors
from tempestsdr_tpu.config import PipelineConfig as JConfig
from tempestsdr_tpu.params import Params as JParams
from tempestsdr_tpu.stream import session as jsession
from tempestsdr_tpu.stream.multisession import MultiSession as JMultiSession

import tempestsdr_tpu_torch.native as tnative
import tempestsdr_tpu_torch.sources as tsources
from tempestsdr_tpu_torch import errors as terrors
from tempestsdr_tpu_torch.config import PipelineConfig
from tempestsdr_tpu_torch.ops.demod import normalize_iq
from tempestsdr_tpu_torch.params import Params
from tempestsdr_tpu_torch.sources.base import SourceBlock
from tempestsdr_tpu_torch.sources.synthetic import render_test_pattern, synth_iq
from tempestsdr_tpu_torch.sources.tee import RecordedSource, TeeSource, gaps_in
from tempestsdr_tpu_torch.stream import MultiSession
from tempestsdr_tpu_torch.stream import session as tsession
from tempestsdr_tpu_torch.stream.state import state_leaves

from test_torch_device_step import one_torch_thread  # noqa: F401 (autouse)

SR, LINES, TWIDTH, REFRESH, BLOCK = 2e6, 100, 160, 50.0, 8192
CHUNK = 8192  # floats a push: 4096 IQ samples, two pushes a block
PUSH = CHUNK // 2
FRAME_ATOL, FRAME_RTOL = 1e-5, 1e-6  # tests/test_torch_session.py
PLUGIN_ATOL = 2e-5  # tests/test_cplugin.py:192-193
CAPTURE_SAMPLES = 40 * BLOCK + 1000  # no whole number of pushes: a gap is never a whole loop

PKGS = {"jax": (jsources, jerrors, jnative), "torch": (tsources, terrors, tnative)}
both = pytest.mark.parametrize("pkg", list(PKGS))
pytestmark = pytest.mark.skipif(shutil.which("gcc") is None, reason="gcc unavailable")


def _sources(pkg):
    return PKGS[pkg][0]


@pytest.fixture(scope="module")
def plugin_so():
    return tnative.build_replay_plugin()


def _emanation(twidth=TWIDTH, n=CAPTURE_SAMPLES):
    return synth_iq(render_test_pattern(LINES, twidth), samplerate=SR,
                    pixelclock=LINES * twidth * REFRESH, n_samples=n, start_sample=0,
                    noise=0.05, dtype=np.uint8)


def _values(raw):
    """What the plugin delivers for raw file values: normalize_iq's float32."""
    return normalize_iq(torch.from_numpy(np.ascontiguousarray(raw))).numpy()


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    iq = _emanation()
    path = tmp_path_factory.mktemp("live") / "cap.u8"
    iq.tofile(path)
    return str(path), _values(iq)


def _take(src, block_samples, n, pause=0.0):
    """n blocks of src.stream, then stop."""
    got = []
    for blk in src.stream(block_samples):
        got.append(blk)
        if len(got) == n:
            break
        time.sleep(pause)
    src.stop()
    return got


def _stats(src):
    return tnative.replay_plugin_stats(src._dll)


# ---- the replay plugin through both packages' CPluginSource ---------------

@both
def test_replay_identity_and_rate(pkg, plugin_so, capture):
    src = _sources(pkg).CPluginSource()
    src.init(f"{plugin_so} -- {capture[0]} 8000000 uint8")
    assert "replay" in src.name().lower() and src.block_dtype() == np.float32
    assert src.samplerate() == 8e6 and src.set_samplerate(2e6) == 8e6
    assert _stats(src)["setsamplerate_calls"] == 1
    src.cleanup()


@pytest.mark.parametrize("fmt", ["uint8", "int8", "int16", "float32"])
@both
def test_replay_delivers_normalize_iq(pkg, fmt, plugin_so, tmp_path):
    """Every format converted exactly as normalize_iq converts it on the
    card, looping at the end of a file that holds 3.5 pushes."""
    rng = np.random.default_rng(3)
    n = 7 * PUSH  # values: 3.5 pushes of IQ
    raw = {"uint8": lambda: rng.integers(0, 256, n, dtype=np.uint8),
           "int8": lambda: rng.integers(-128, 128, n, dtype=np.int8),
           "int16": lambda: rng.integers(-32768, 32768, n, dtype=np.int16),
           "float32": lambda: rng.standard_normal(n).astype(np.float32)}[fmt]()
    path = tmp_path / f"cap.{fmt}"
    raw.tofile(path)
    src = _sources(pkg).load_source("cplugin",
                                    f"{plugin_so} block=1 -- {path} 2000000 {fmt} chunk={CHUNK}")
    got = _take(src, PUSH, 6)
    assert [b.dropped for b in got] == [0] * 6
    want = np.concatenate([_values(raw)] * 2)[:6 * CHUNK]
    np.testing.assert_array_equal(np.concatenate([b.samples for b in got]), want)


@pytest.mark.parametrize("block, inject, want", [
    (PUSH, "2:1000,5:4096", [(2, 0, 1000), (5, 0, 4096)]),  # a push a block
    (BLOCK, "3:777", [(1, PUSH, 777)]),  # the gap inside block 1, after its first push
])
@both
def test_replay_injected_gap_reported_once(pkg, block, inject, want, plugin_so, capture):
    """A gap the plugin reports with the push after it rides exactly the
    first block holding data after it, once, and the data skips it there."""
    path, values = capture
    src = _sources(pkg).load_source(
        "cplugin", f"{plugin_so} block=1 -- {path} 2000000 uint8 chunk={CHUNK} inject={inject}")
    got = _take(src, block, 8)
    assert gaps_in(got, values, PUSH) == want
    assert [b for b, blk in enumerate(got) if blk.dropped] == [g[0] for g in want]


@both
def test_replay_overflow_drops_whole_pushes(pkg, plugin_so, capture):
    """block=0 and an unthrottled plugin ahead of a slow consumer: the full
    ring drops whole pushes, each counted once on the first block of data
    after it, and every delivered sample is the capture's."""
    path, values = capture
    src = _sources(pkg).load_source("cplugin",
                                    f"{plugin_so} -- {path} 2000000 uint8 chunk={CHUNK}")
    got = _take(src, 1 << 18, 8, pause=0.02)  # 2 MB blocks: a ring of four
    drops = [b.dropped for b in got]
    assert sum(drops) > 0 and all(d % PUSH == 0 for d in drops), drops
    gaps = gaps_in(got, values, PUSH)
    assert gaps and all(off % PUSH == 0 for _, off, _ in gaps)
    st = _stats(src)
    assert st["active"] == 0
    assert st["samples_pushed"] >= len(got) * (1 << 18) + sum(drops)


@both
def test_replay_controls_reach_the_plugin(pkg, plugin_so, capture):
    src = _sources(pkg).CPluginSource()
    src.init(f"{plugin_so} -- {capture[0]} 2000000 uint8")
    src.set_basefreq(100e6)
    assert _stats(src)["basefreq"] == 100e6
    src.set_freq_offset(1.5e6)  # shiftfreq: center + offset, center kept
    assert _stats(src)["basefreq"] == 101.5e6
    src.set_gain(0.25)
    assert _stats(src)["gain"] == 0.25
    assert src.set_samplerate(8e6) == 2e6 and _stats(src)["setsamplerate_calls"] == 1
    src.cleanup()


@both
def test_replay_stop_returns_readasync(pkg, plugin_so, capture):
    """stop() ends a paced readasync within a push, and its thread joins."""
    src = _sources(pkg).load_source(
        "cplugin", f"{plugin_so} -- {capture[0]} 2000000 uint8 chunk={CHUNK} pace=1")
    it = iter(src.stream(PUSH))
    for _ in range(3):
        next(it)
    reader = src._reader
    t0 = time.perf_counter()
    src.stop()
    assert time.perf_counter() - t0 < 1.0 and not reader.is_alive()
    st = _stats(src)
    assert st["active"] == 0 and st["readasync_calls"] == 1


@both
def test_replay_push_times_give_its_rate(pkg, plugin_so, capture):
    """The fixture's own clock at its first and last push (first_push_s,
    last_push_s: 0 before any) gives the rate it pushed at, which a paced
    plugin never exceeds (each push waits for its deadline)."""
    src = _sources(pkg).load_source(
        "cplugin", f"{plugin_so} -- {capture[0]} 2000000 uint8 chunk={CHUNK} pace=2")
    assert _stats(src)["first_push_s"] == 0 == _stats(src)["last_push_s"]
    _take(src, BLOCK, 6)
    st = _stats(src)
    span = st["last_push_s"] - st["first_push_s"]
    assert st["pushes"] >= 12 and span > 0, st
    rate = st["samples_pushed"] * (st["pushes"] - 1) / st["pushes"] / span
    assert rate <= 1.02 * 2 * 2e6, rate


@both
def test_replay_missing_symbol_is_incompatible(pkg, plugin_so, tmp_path):
    """The replay plugin built without tsdrplugin_setgain: INCOMPATIBLE_PLUGIN,
    naming the symbol."""
    so = tmp_path / "no_setgain.so"
    subprocess.run(["gcc", "-O2", "-fPIC", "-shared", "-Dtsdrplugin_setgain=other_setgain",
                    os.path.join(os.path.dirname(tnative.__file__), "replay_plugin.c"),
                    "-o", str(so)], check=True, capture_output=True)
    errors = PKGS[pkg][1]
    with pytest.raises(errors.TSDRError) as ei:
        _sources(pkg).CPluginSource().init(str(so))
    assert ei.value.status == errors.TSDRStatus.INCOMPATIBLE_PLUGIN
    assert "tsdrplugin_setgain" in str(ei.value)


@pytest.mark.parametrize("params, text", [
    ("{cap} 2000000 notaformat", "unknown format 'notaformat'"),
    ("{cap} 2000000 uint8 chunk=3", "bad option 'chunk=3'"),
    ("{cap} 2000000 uint8 inject=0:5", "bad option 'inject=0:5'"),
    ("{cap} 2000000 uint8 speed=2", "unknown option 'speed=2'"),
    ("/nonexistent/cap.u8 2000000 uint8", "cannot open /nonexistent/cap.u8"),
    ("{cap}", "params should be"),
])
@both
def test_replay_bad_parameters(pkg, params, text, plugin_so, capture):
    """A parameter the plugin refuses: its init fails, and its own
    getlasterrortext message surfaces."""
    errors = PKGS[pkg][1]
    with pytest.raises(errors.TSDRError) as ei:
        _sources(pkg).CPluginSource().init(f"{plugin_so} -- {params.format(cap=capture[0])}")
    assert ei.value.status == errors.TSDRStatus.PLUGIN_PARAMETERS_WRONG
    assert "plugin rc=" in str(ei.value) and text in str(ei.value)


def _session(pkg, cfg_kw, params_kw, source, batch=1, on_frame=None):
    frames = []
    on_frame = on_frame or frames.append
    if pkg == "jax":
        sess = jsession.Session(JConfig(**cfg_kw), JParams(**params_kw), source,
                                jsession.SessionCallbacks(on_frame=on_frame), batch_blocks=batch)
    else:
        sess = tsession.Session(PipelineConfig(**cfg_kw), Params(**params_kw), source,
                                tsession.SessionCallbacks(on_frame=on_frame), batch_blocks=batch,
                                device="cpu")
    return sess, frames


@both
def test_replay_frames_equal_rawfile(pkg, plugin_so, capture):
    """The plugin's float32 (normalized in C) and rawfile's uint8
    (normalized by the step) give the same frames."""
    path = capture[0]
    cfg = dict(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=BLOCK,
               autocorr=False)
    runs = []
    for name, spec in (("rawfile", f"{path} 2000000 uint8"),
                       ("cplugin", f"{plugin_so} block=1 -- {path} 2000000 uint8")):
        src = _sources(pkg).load_source(name, spec)
        sess, frames = _session(pkg, cfg, dict(framerate_pll=False), src)
        sess.run(max_frames=4)
        src.cleanup()
        runs.append(frames)
    assert len(runs[0]) == len(runs[1]) == 4
    for a, b in zip(*runs):
        np.testing.assert_allclose(a, b, rtol=0, atol=PLUGIN_ATOL)


# ---- recorded live blocks through both packages' sessions -----------------

RECORDED_BLOCKS = 24
# after pushes 8, 11 and 14 (two a block): the gaps ride blocks 4, 5 and 7,
# slots 0, 1 and 3 of the second batch of 4 (block 5's after its first push)
RECORDED_INJECT = "8:1000,11:30000,14:77777"


@pytest.fixture(scope="module")
def recording(plugin_so, capture):
    tee = TeeSource(tsources.load_source(
        "cplugin",
        f"{plugin_so} block=1 -- {capture[0]} 2000000 uint8 chunk={CHUNK} "
        f"inject={RECORDED_INJECT}"))
    _take(tee, BLOCK, RECORDED_BLOCKS)
    assert gaps_in(tee.blocks, capture[1], PUSH) == [(4, 0, 1000), (5, PUSH, 30000),
                                                       (7, 0, 77777)]
    return tee.blocks


def _int_leaves(leaves):
    return [np.asarray(x) for x in leaves if not np.issubdtype(np.asarray(x).dtype, np.inexact)]


def test_session_over_recorded_drops_matches_jax(recording):
    """The same recorded blocks, drops at slots 0, 1 and 3 of a batch of 4,
    through the JAX Session and the port's at batch 4: frames within
    FRAME_ATOL, every integer state leaf equal, the drops counted alike."""
    cfg = dict(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=BLOCK)
    runs = {}
    for pkg in PKGS:
        sess, frames = _session(pkg, cfg, {}, RecordedSource(recording, SR), batch=4)
        sess.run()
        leaves = jax.tree.leaves(sess.state) if pkg == "jax" else state_leaves(sess.state)
        runs[pkg] = frames, _int_leaves(leaves), sess.samples_dropped_total
    (jf, jints, jd), (tf, tints, td) = runs["jax"], runs["torch"]
    assert jd == td == 1000 + 30000 + 77777
    assert len(tf) == len(jf) >= 3
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a, b, rtol=FRAME_RTOL, atol=FRAME_ATOL)
    assert len(tints) == len(jints)
    for i, (a, b) in enumerate(zip(tints, jints)):
        np.testing.assert_array_equal(a, b, err_msg=f"integer leaf {i}")


def test_port_session_batch_1_and_4_equal_over_a_recording(recording):
    """The port's Session at batch 1 and at batch 4 over one recording with
    drops: frames and every state leaf equal bit for bit."""
    cfg = dict(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=BLOCK)
    runs = []
    for batch in (1, 4):
        sess, frames = _session("torch", cfg, {}, RecordedSource(recording, SR), batch=batch)
        sess.run()
        runs.append((frames, state_leaves(sess.state), sess.samples_dropped_total))
    (f1, s1, d1), (f4, s4, d4) = runs
    assert d1 == d4 == 108777 and len(f1) == len(f4) >= 3
    assert all(np.array_equal(a, b) for a, b in zip(f1, f4))
    assert all(torch.equal(a, b) for a, b in zip(s1, s4))


def test_multisession_cplugin_channels_match_jax(plugin_so, tmp_path):
    """Three replay plugins (copies of the .so: a plugin's state lives in
    its library), each its own capture and gaps, through the JAX
    MultiSession and the port's: frames per channel within FRAME_ATOL, the
    drops counted per channel."""
    injects = ("3:5000", "6:12345", "1:100,9:40000")
    specs = []
    for c, inject in enumerate(injects):
        cap = tmp_path / f"cap{c}.u8"
        _emanation(TWIDTH + 8 * c, 32 * BLOCK + 1000).tofile(cap)
        specs.append((cap, inject))
    cfg = dict(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=BLOCK)
    got = {}
    for pkg in PKGS:
        srcs = []
        for c, (cap, inject) in enumerate(specs):
            so = tmp_path / f"replay_{pkg}_{c}.so"
            shutil.copy(plugin_so, so)
            srcs.append(_sources(pkg).load_source(
                "cplugin", f"{so} block=1 -- {cap} 2000000 uint8 chunk={CHUNK} inject={inject}"))
        frames = {c: [] for c in range(len(srcs))}
        on_frame = lambda c, f: frames[c].append(np.array(f))  # noqa: E731
        if pkg == "jax":
            ms = JMultiSession(JConfig(**cfg), JParams(), srcs, on_frame=on_frame)
        else:
            ms = MultiSession(PipelineConfig(**cfg), Params(), srcs, on_frame=on_frame,
                              device="cpu")
        ms.run(max_blocks=28)
        for s in srcs:
            s.cleanup()
        got[pkg] = frames, list(ms.samples_dropped_total)
    (jf, jd), (tf, td) = got["jax"], got["torch"]
    assert jd == td == [5000, 12345, 40100]
    for c in range(len(injects)):
        assert len(tf[c]) == len(jf[c]) >= 2, c
        for a, b in zip(tf[c], jf[c]):
            np.testing.assert_allclose(a, b, rtol=FRAME_RTOL, atol=FRAME_ATOL)


# ---- the tee: a live run recorded and replayed -----------------------------

@pytest.mark.parametrize("live", ["cplugin", "simlive"])
def test_tee_replay_equals_the_live_run(live, plugin_so, capture):
    """A live source unthrottled ahead of a slow consumer (real ring
    overflows) through the port's Session, recorded by a TeeSource; the
    recording played back through a fresh Session gives the same frames,
    drops and state bit for bit."""
    block = 1 << 16  # the cplugin ring (8 MB at least) holds 16: drops from the 17th
    if live == "cplugin":
        src = tsources.load_source("cplugin", f"{plugin_so} -- {capture[0]} 2000000 uint8 "
                                              f"chunk={CHUNK}")
    else:
        src = tsources.load_source("simlive", f"{LINES} {TWIDTH} {REFRESH} {SR} 0.02 ring=2")
    cfg = dict(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=block)
    tee = TeeSource(src)
    live_frames = []

    def slow(frame):  # a consumer slower than the source
        live_frames.append(frame)
        time.sleep(0.02)

    sess, _ = _session("torch", cfg, {}, tee, on_frame=slow)
    sess.run(max_blocks=24)
    assert len(tee.blocks) == 24 and sess.samples_dropped_total == tee.samples_dropped > 0
    if live == "cplugin":
        gaps_in(tee.blocks, capture[1], PUSH)
    again, frames = _session("torch", cfg, {}, RecordedSource(tee.blocks, SR))
    again.run()
    assert again.samples_dropped_total == sess.samples_dropped_total
    assert len(frames) == len(live_frames) > 0
    assert all(np.array_equal(a, b) for a, b in zip(frames, live_frames))
    assert all(torch.equal(a, b) for a, b in zip(state_leaves(again.state),
                                                 state_leaves(sess.state)))


def test_gaps_in_refuses_a_misplaced_drop(capture):
    """gaps_in, the check the chip run holds every live recording to: a drop
    reported one block late, a drop that is not in the data, or data that
    does not start at a push are refused."""
    values = capture[1].reshape(-1, 2)

    def blk(start, n=BLOCK, dropped=0):
        idx = np.arange(start, start + n) % len(values)
        return SourceBlock(values[idx].reshape(-1), dropped)

    good = [blk(0), blk(BLOCK + 3 * PUSH, dropped=3 * PUSH), blk(2 * BLOCK + 3 * PUSH)]
    assert gaps_in(good, capture[1], PUSH) == [(1, 0, 3 * PUSH)]
    late = [blk(0), blk(BLOCK + 3 * PUSH), blk(2 * BLOCK + 3 * PUSH, dropped=3 * PUSH)]
    missing = [blk(0), blk(BLOCK, dropped=PUSH)]
    mid_push = [blk(0), blk(BLOCK + 5)]
    for bad in (late, missing, mid_push):
        with pytest.raises(ValueError):
            gaps_in(bad, capture[1], PUSH)
