"""The port's sources and native I/O runtime (tempestsdr_tpu_torch.sources,
tempestsdr_tpu_torch.native) against the JAX package's: every scenario of
tests/test_sources.py and tests/test_cplugin.py runs through both packages
(each with its own Session; the port's on the CPU), and where the data is
deterministic the two packages' blocks are compared with each other. The
rtl_tcp cases talk to an in-process loopback server only."""

import os
import shlex
import shutil
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from types import ModuleType

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import tempestsdr_tpu as jpkg
import tempestsdr_tpu.native as jnative
import tempestsdr_tpu.sources as jsources
from tempestsdr_tpu import errors as jerrors
from tempestsdr_tpu.stream import pipeline as jpipeline
from tempestsdr_tpu.stream import session as jsession

import tempestsdr_tpu_torch as tpkg
import tempestsdr_tpu_torch.native as tnative
import tempestsdr_tpu_torch.sources as tsources
from tempestsdr_tpu_torch import errors as terrors
from tempestsdr_tpu_torch.stream import pipeline as tpipeline
from tempestsdr_tpu_torch.stream import session as tsession
from tempestsdr_tpu_torch.sources import rtltcp as trtltcp
from tempestsdr_tpu_torch.sources import subproc as tsubproc

import test_cplugin
from test_sources import FakeRtlTcpServer

LINES, TWIDTH, REFRESH, SR = 100, 200, 50.0, 1e6


@dataclass
class Pkg:
    name: str
    pkg: ModuleType
    sources: ModuleType
    native: ModuleType
    errors: ModuleType
    pipeline: ModuleType
    session: ModuleType

    def submodule(self, name):
        import importlib

        return importlib.import_module(f"{self.pkg.__name__}.sources.{name}")

    def config(self, **kw):
        return self.pkg.PipelineConfig(**kw)

    def session_of(self, cfg, params, src, on_frame):
        extra = {} if self.name == "jax" else {"device": "cpu"}
        return self.session.Session(cfg, params, src,
                                    self.session.SessionCallbacks(on_frame=on_frame), **extra)

    def step_block(self, sess, samples, dropped):
        """One block through a session's step by hand: (frame_valid, frame)."""
        if self.name == "jax":
            ctrl = self.pipeline.StepControls(jnp.int64(dropped), jnp.int32(0),
                                              jnp.float32(0.0))
            sess.state, out = sess._step(sess.state, jnp.asarray(samples), ctrl)
        else:
            ctrl = self.pipeline.StepControls(dropped, 0, 0.0)
            sess.state, out = sess._runner.step(sess.state, torch.from_numpy(samples), ctrl)
        return bool(out.frame_valid), np.asarray(out.frame)


PKGS = {
    "jax": Pkg("jax", jpkg, jsources, jnative, jerrors, jpipeline, jsession),
    "torch": Pkg("torch", tpkg, tsources, tnative, terrors, tpipeline, tsession),
}
both = pytest.mark.parametrize("p", list(PKGS.values()), ids=list(PKGS))


def _native_or_skip(p):
    if not p.native.available():
        pytest.skip("native IO runtime unavailable")


@pytest.fixture(scope="module")
def iq_file(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("iq") / "capture.bin"
    data = rng.integers(0, 256, size=100_000, dtype=np.uint8)
    path.write_bytes(data.tobytes())
    return str(path), data


def _collect(src, block_samples, n_blocks):
    out = []
    for blk in src.stream(block_samples):
        out.append(blk)
        if len(out) >= n_blocks:
            src.stop()
            break
    return out


def test_native_library_builds_into_the_package_build_dir():
    """The port's native runtime builds from its own io_runtime.cpp into
    tempestsdr_tpu_torch/build/, named by a hash of the source; the source is
    the JAX package's, copied."""
    assert tnative.available()
    path = tnative.lib_path()
    pkg_dir = os.path.dirname(tpkg.__file__)
    assert os.path.dirname(path) == os.path.join(pkg_dir, "build") and os.path.exists(path)
    assert os.path.basename(path).startswith("libtsdr_io-")
    code = [[line for line in open(os.path.join(os.path.dirname(m.__file__), "native",
                                                "io_runtime.cpp")) if not line.startswith("//")]
            for m in (tpkg, jpkg)]
    assert code[0] == code[1] and len(code[0]) > 100


def test_load_source_knows_the_reference_names():
    for name in ("rawfile", "synthetic", "simlive", "rtltcp", "exec", "cplugin"):
        assert name in tsources.base._REGISTRY and name in jsources.base._REGISTRY
    assert {n: c.__name__ for n, c in tsources.base._REGISTRY.items()} == {
        n: c.__name__ for n, c in jsources.base._REGISTRY.items()}
    for name in ("SimulatedLiveSource", "RtlTcpSource", "ExternalProcessSource",
                 "CPluginSource", "RawFileSource"):
        assert hasattr(tsources, name) and hasattr(jsources, name)


@pytest.mark.parametrize("native", [False, True])
@both
def test_rawfile_replays_bytes_in_order(p, iq_file, native):
    path, data = iq_file
    if native:
        _native_or_skip(p)
    src = p.sources.RawFileSource(loop=True, native=native)
    src.init(f"{path} 1000000 uint8")
    assert src.samplerate() == 1e6
    blocks = _collect(src, 4096, 13)
    got = np.concatenate([b.samples for b in blocks])
    np.testing.assert_array_equal(got, np.tile(data, 2)[: got.size])
    assert all(b.dropped == 0 for b in blocks) and got.dtype == np.uint8


@pytest.mark.parametrize("native", [None, False, True])
def test_rawfile_native_argument_parity(iq_file, native):
    """RawFileSource(native=None/False/True): both packages accept the
    argument and yield the same blocks."""
    path, _ = iq_file
    got = []
    for p in PKGS.values():
        src = p.sources.RawFileSource(native=native)
        src.init(f"{path} 1000000 uint8")
        got.append([b.samples for b in _collect(src, 3000, 20)])
    assert all(np.array_equal(a, b) for a, b in zip(*got))


@both
def test_rawfile_formats(p, tmp_path):
    for fmt, dtype in [("float", np.float32), ("int8", np.int8), ("int16", np.int16),
                       ("uint16", np.uint16)]:
        path = tmp_path / f"f.{fmt}"
        arr = (np.arange(64) % 17).astype(dtype)
        path.write_bytes(arr.tobytes())
        src = p.sources.RawFileSource(loop=True, native=False)
        src.init(f"{path} 8000 {fmt}")
        blk = next(iter(src.stream(16)))
        assert blk.samples.dtype == dtype
        np.testing.assert_array_equal(blk.samples, arr[:32])
        src.stop()


@both
def test_synthetic_bad_params(p):
    for bad in ("not numbers at all", "600 111", "0 111 60 2e6", ""):
        src = p.sources.SyntheticSource()
        with pytest.raises(p.errors.TSDRError) as ei:
            src.init(bad)
        assert ei.value.status == p.errors.TSDRStatus.PLUGIN_PARAMETERS_WRONG


@both
def test_rawfile_bad_params(p):
    for bad in ("onlyname", "name 1000 complex128", "name -5 uint8"):
        with pytest.raises(p.errors.TSDRError):
            p.sources.RawFileSource().init(bad)


@both
def test_rawfile_option_tokens(p, tmp_path):
    path = tmp_path / "c.bin"
    path.write_bytes(np.arange(4096, dtype=np.uint8).tobytes())
    src = p.sources.RawFileSource(native=False)
    src.init(f"{path} 1000000 uint8 stretch=2 noloop")
    assert src._throttle and src._stretch == 2.0 and not src._loop
    assert len(list(src.stream(512))) == 4  # noloop: exactly one pass
    with pytest.raises(p.errors.TSDRError):
        p.sources.RawFileSource().init(f"{path} 1000000 uint8 bogus")


@both
def test_rawfile_quoted_filename(p, tmp_path):
    path = tmp_path / "my capture.bin"
    path.write_bytes(np.zeros(1024, np.uint8).tobytes())
    src = p.sources.RawFileSource(native=False)
    src.init(f'"{path}" 1000 uint8')
    assert next(iter(src.stream(128))).samples.size == 256
    src.stop()


@both
def test_registry_loads_by_name(p, iq_file):
    path, _ = iq_file
    src = p.sources.load_source("rawfile", f"{path} 2000000 uint8")
    assert "RawFile" in src.name()
    src.cleanup()


@pytest.mark.parametrize("native", [False, True])
@both
def test_wav_autodetection(p, tmp_path, native):
    if native:
        _native_or_skip(p)
    rng = np.random.default_rng(3)
    data = rng.integers(-32768, 32767, size=2000, dtype=np.int16)
    sr = 2_048_000
    hdr = (b"RIFF" + (36 + data.nbytes).to_bytes(4, "little") + b"WAVE"
           + b"fmt " + (16).to_bytes(4, "little") + (1).to_bytes(2, "little")
           + (2).to_bytes(2, "little") + sr.to_bytes(4, "little")
           + (sr * 4).to_bytes(4, "little") + (4).to_bytes(2, "little")
           + (16).to_bytes(2, "little")
           + b"data" + data.nbytes.to_bytes(4, "little"))
    path = tmp_path / "cap.wav"
    path.write_bytes(hdr + data.tobytes())
    src = p.sources.RawFileSource(loop=True, native=native)
    src.init(str(path))
    assert src.samplerate() == sr
    blk = next(iter(src.stream(500)))
    assert blk.samples.dtype == np.int16
    np.testing.assert_array_equal(blk.samples, data[:1000])
    src.stop()


@both
def test_native_ring_drop_accounting(p):
    _native_or_skip(p)
    ring = p.native.Ring(1024)
    assert ring.write(b"a" * 512) and ring.write(b"b" * 512)
    assert not ring.write(b"c" * 128)  # overflow -> dropped whole
    assert ring.take_dropped() == 0  # the gap sits after the 1024 buffered bytes
    buf = bytearray(600)
    assert ring.read_into(memoryview(buf)) == 600 and bytes(buf[:512]) == b"a" * 512
    assert ring.take_dropped() == 0
    assert ring.read_into(memoryview(bytearray(424))) == 424
    assert ring.take_dropped() == 0  # nothing past the gap read yet
    assert ring.write(b"d" * 64)
    assert ring.read_into(memoryview(bytearray(64))) == 64
    assert ring.take_dropped() == 128 and ring.take_dropped() == 0
    ring.close()


@both
def test_native_file_pump_paces_and_loops(p, iq_file):
    """FilePump into a Ring: the file's bytes in order, looped at EOF."""
    _native_or_skip(p)
    path, data = iq_file
    ring = p.native.Ring(1 << 16)
    pump = p.native.FilePump(path, 4096, ring, loop=True)
    try:
        buf = bytearray(150_000)
        for got in range(0, len(buf), 5000):  # reads of less than the ring holds
            assert ring.read_into(memoryview(buf)[got:got + 5000]) == 5000
    finally:
        pump.stop()
    np.testing.assert_array_equal(np.frombuffer(bytes(buf), np.uint8), np.tile(data, 2)[:150_000])


def _u8_capture(n_frames, sr=SR, twidth=TWIDTH):
    raster = jsources.render_test_pattern(LINES, twidth)
    return jsources.synth_iq(raster, samplerate=sr, pixelclock=LINES * twidth * REFRESH,
                             n_samples=int(n_frames * sr / REFRESH), noise=0.01, dtype=np.uint8)


@both
def test_rtltcp_source_end_to_end(p):
    """rtl_tcp against the loopback server: header, rate/freq/gain commands,
    u8 blocks through a Session to frames, a live retune mid-stream."""
    _native_or_skip(p)
    rt = p.submodule("rtltcp")
    server = FakeRtlTcpServer(_u8_capture(4).tobytes())
    try:
        src = p.sources.load_source(
            "rtltcp", f"127.0.0.1 {server.port} {SR:.0f} freq=433000000 gain=0.5")
        assert src.block_dtype() == np.uint8
        cfg = p.config(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=8192,
                       autocorr=False)
        frames = []
        sess = p.session_of(cfg, p.pkg.Params(framerate_pll=False), src, None)

        def on_frame(f):
            frames.append(f)
            if len(frames) == 3:
                sess.set_basefreq(433_250_000)

        sess.callbacks.on_frame = on_frame
        assert sess.run(max_frames=8) == 8
        assert frames[0].shape == (LINES, cfg.width)
        cc = np.corrcoef(frames[-1].ravel(), frames[-2].ravel())[0, 1]
        assert cc > 0.8, cc
        assert (src.tuner_type, src.tuner_gain_count) == (5, 29)
    finally:
        server.stop()
    cmds = {}
    for c, v in server.commands:
        cmds.setdefault(c, []).append(v)
    assert cmds[rt.CMD_SET_SAMPLE_RATE] == [int(SR)]
    assert cmds[rt.CMD_SET_FREQ][0] == 433_000_000 and 433_250_000 in cmds[rt.CMD_SET_FREQ]
    assert cmds[rt.CMD_SET_GAIN_MODE] == [1] and cmds[rt.CMD_SET_GAIN] == [248]


def test_rtltcp_wire_constants_match():
    import tempestsdr_tpu.sources.rtltcp as jrt

    names = [n for n in dir(jrt) if n.startswith("CMD_")]
    assert names and all(getattr(trtltcp, n) == getattr(jrt, n) for n in names)


@both
def test_rtltcp_bad_params_and_no_server(p):
    with pytest.raises(p.errors.TSDRError):
        p.sources.load_source("rtltcp", "localhost")
    with pytest.raises(p.errors.TSDRError):
        p.sources.load_source("rtltcp", "localhost notaport 1e6")
    src = p.sources.load_source("rtltcp", "127.0.0.1 1 1000000")  # port 1: refused
    with pytest.raises(p.errors.TSDRError):
        next(iter(src.stream(4096)))


@both
def test_rtltcp_freq_offset_absolute_from_center(p):
    _native_or_skip(p)
    rt = p.submodule("rtltcp")
    server = FakeRtlTcpServer(bytes(range(256)) * 1024)
    try:
        src = p.sources.load_source("rtltcp", f"127.0.0.1 {server.port} 1000000 freq=433000000")
        it = src.stream(4096)
        next(it)
        src.set_freq_offset(1_000_000)
        src.set_freq_offset(1_000_000)  # same hop twice -> same tune
        src.set_freq_offset(0)
        deadline = time.time() + 5
        while (sum(1 for c, _ in server.commands if c == rt.CMD_SET_FREQ) < 4
               and time.time() < deadline):
            time.sleep(0.05)
        src.stop()
    finally:
        server.stop()
    freqs = [v for c, v in server.commands if c == rt.CMD_SET_FREQ]
    assert freqs == [433_000_000, 434_000_000, 434_000_000, 433_000_000]
    assert src._freq == 433_000_000


@both
def test_simulated_live_source_seam_end_to_end(p):
    """simlive through a Session, then a stalled consumer: the 2-chunk ring
    overflows, drops are whole chunks reported as samples_dropped, and the
    whole-frame compensation keeps the raster aligned."""
    _native_or_skip(p)
    cfg = p.config(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=8192,
                   autocorr=False)
    params = p.pkg.Params(framerate_pll=False)
    frames = []
    src = p.sources.load_source("simlive", f"{LINES} {TWIDTH} {REFRESH} {SR} 0.0 pace=0 ring=2")
    assert p.session_of(cfg, params, src, frames.append).run(max_frames=8) == 8
    baseline = frames[-1]
    src2 = p.sources.load_source("simlive", f"{LINES} {TWIDTH} {REFRESH} {SR} 0.0 pace=1 ring=2")
    sess2 = p.session_of(cfg, params, src2, None)
    dropped_total, got = 0, []
    for i, blk in enumerate(src2.stream(cfg.block_samples)):
        if i == 4:
            time.sleep(0.8)  # consumer stall: far past the ring's capacity in time
        dropped_total += blk.dropped
        valid, frame = p.step_block(sess2, blk.samples, blk.dropped)
        if valid:
            got.append(frame)
        if len(got) >= 14:
            break
    src2.stop()
    assert dropped_total > 0 and dropped_total % max(int(0.06 * SR), 1024) == 0
    cc = np.corrcoef(got[-1].ravel(), baseline.ravel())[0, 1]
    assert cc > 0.9, f"raster lost alignment across live overload: corr {cc}"


@both
def test_session_tracks_dropped_total(p):
    base = p.sources.base

    class Droppy(base.Source):
        def init(self, params):
            self.raster = p.sources.render_test_pattern(LINES, TWIDTH)
            self.pos = self.block = 0

        def name(self):
            return "droppy"

        def samplerate(self):
            return SR

        def stream(self, block_samples):
            while True:
                dropped = 7777 if self.block == 3 else 0
                self.pos += dropped
                blk = p.sources.synth_iq(self.raster, samplerate=SR,
                                         pixelclock=LINES * TWIDTH * REFRESH,
                                         n_samples=block_samples, start_sample=self.pos, noise=0.0)
                self.pos += block_samples
                self.block += 1
                yield base.SourceBlock(blk, dropped)

        def stop(self):
            pass

    src = Droppy()
    src.init("")
    cfg = p.config(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=8192,
                   autocorr=False)
    sess = p.session_of(cfg, p.pkg.Params(framerate_pll=False), src, None)
    sess.run(max_blocks=6)
    assert sess.samples_dropped_total == 7777


# ---- the external-process source (tests/test_sources.py:431-706) ----------

def _exec_params(rate, fmt, *opts, cmd):
    return " ".join([str(rate), fmt, *opts, "--", " ".join(shlex.quote(c) for c in cmd)])


def _py(code):
    return [sys.executable, "-u", "-c", code]


FREQ_ECHO = _py(
    "import sys\n"
    "w = sys.stdout.buffer\n"
    "w.write(b'\\x01' * 65536); w.flush()\n"
    "for line in sys.stdin:\n"
    "    t = line.split()\n"
    "    if t and t[0] == 'FREQ':\n"
    "        w.write(bytes([int(t[1]) % 256]) * 65536); w.flush()\n")
ARGV_ECHO = _py("import sys, time\n"
                "sys.stdout.buffer.write(bytes([int(sys.argv[1]) % 256]) * 65536)\n"
                "sys.stdout.buffer.flush()\n"
                "time.sleep(600)\n") + ["{freq}"]


@both
def test_exec_source_streams_child_stdout_in_order(p):
    _native_or_skip(p)
    src = p.sources.load_source("exec", _exec_params(
        1_000_000, "u8", cmd=_py("import sys; sys.stdout.buffer.write(bytes(range(256)) * 256)")))
    assert src.block_dtype() == np.uint8
    blocks = _collect(src, 8192, 4)
    got = np.concatenate([b.samples for b in blocks])
    assert np.array_equal(got, np.tile(np.arange(256, dtype=np.uint8), 256)[: got.size])
    assert all(b.dropped == 0 for b in blocks)


@both
def test_exec_source_stdin_control(p):
    _native_or_skip(p)
    src = p.sources.load_source("exec", _exec_params(1_000_000, "u8", "control=stdin",
                                                     cmd=FREQ_ECHO))
    it = src.stream(32768)  # block = 65536 bytes
    assert (next(it).samples == 1).all()
    src.set_basefreq(7)
    assert (next(it).samples == 7).all()
    src.stop()


@both
def test_exec_source_restart_control(p):
    _native_or_skip(p)
    code = ("import sys, time\n"
            "sys.stdout.buffer.write(bytes([int(sys.argv[1]) % 256]) * 65536)\n"
            "sys.stdout.buffer.flush()\n"
            "time.sleep(600)\n")
    src = p.sources.load_source("exec", _exec_params(
        1_000_000, "u8", "control=restart", "freq=3", cmd=_py(code) + ["{freq}"]))
    it = src.stream(32768)
    assert (next(it).samples == 3).all()
    src.set_basefreq(9)
    assert (next(it).samples == 9).all()
    src.stop()


@both
def test_exec_source_crash_isolation(p):
    _native_or_skip(p)
    child = _py("import sys\n"
                "sys.stdout.buffer.write(b'\\x05' * 16384); sys.stdout.buffer.flush()\n"
                "sys.stderr.write('simulated hardware fault'); sys.exit(3)\n")
    src = p.sources.load_source("exec", _exec_params(1_000_000, "u8", cmd=child))
    blocks = list(src.stream(8192))  # 16384 bytes = exactly 1 block
    assert len(blocks) == 1 and (blocks[0].samples == 5).all()
    assert "rc=3" in src.last_error() and "simulated hardware fault" in src.last_error()


@both
def test_exec_i24_conversion(p):
    sub = p.submodule("subproc")
    raw = bytes([0x01, 0x00, 0x00, 0xFF, 0xFF, 0xFF, 0x00, 0x00, 0x80, 0xFF, 0xFF, 0x7F])
    expect = np.array([1, -1, -(1 << 23), (1 << 23) - 1], np.float32) / np.float32(1 << 23)
    assert np.array_equal(sub._i24le_to_f32(raw), expect)
    assert np.array_equal(tsubproc._i24le_to_f32(raw), sub._i24le_to_f32(raw))
    _native_or_skip(p)
    n = 4096
    child = _py(f"import sys\nsys.stdout.buffer.write(bytes([0x00, 0x00, 0x80]) * (2 * {n}))\n")
    src = p.sources.load_source("exec", _exec_params(1_000_000, "i24", cmd=child))
    assert src.block_dtype() == np.float32
    blk = next(iter(src.stream(n)))
    assert blk.samples.dtype == np.float32 and (blk.samples == -1.0).all()
    src.stop()


@both
def test_exec_source_session_end_to_end(p, tmp_path):
    _native_or_skip(p)
    path = tmp_path / "capture.bin"
    path.write_bytes(_u8_capture(3).tobytes())
    child = _py(f"import sys\nsys.stdout.buffer.write(open({str(path)!r}, 'rb').read())\n")
    src = p.sources.load_source("exec", _exec_params(int(SR), "u8", cmd=child))
    cfg = p.config(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=8192,
                   autocorr=False)
    frames = []
    assert p.session_of(cfg, p.pkg.Params(framerate_pll=False), src,
                        frames.append).run(max_frames=2) == 2
    assert frames[0].shape == (LINES, cfg.width)


@both
def test_exec_bad_params(p):
    for bad in ("1000000 u8", "1000000 pcm -- cat", "1000000 u8 control=telnet -- cat",
                "notarate u8 -- cat"):
        with pytest.raises(p.errors.TSDRError):
            p.sources.load_source("exec", bad)


@both
def test_exec_freq_offset_absolute_from_center(p):
    _native_or_skip(p)
    src = p.sources.load_source("exec", _exec_params(1_000_000, "u8", "control=stdin",
                                                     cmd=FREQ_ECHO))
    it = src.stream(32768)
    assert (next(it).samples == 1).all()
    src.set_basefreq(100)
    assert (next(it).samples == 100).all()
    for off, want in ((10, 110), (10, 110), (0, 100)):  # absolute, never compounding
        src.set_freq_offset(off)
        assert (next(it).samples == want).all()
    src.stop()


@both
def test_exec_freq_offset_respawn_argv(p):
    _native_or_skip(p)
    src = p.sources.load_source("exec", _exec_params(
        1_000_000, "u8", "control=restart", "freq=50", cmd=ARGV_ECHO))
    it = src.stream(32768)
    assert (next(it).samples == 50).all()
    for off, want in ((25, 75), (25, 75)):
        src.set_freq_offset(off)
        assert (next(it).samples == want).all()
    src.set_basefreq(200)
    assert (next(it).samples == 200).all()
    assert src.last_error() == ""
    src.stop()
    assert src.last_error() == ""


@both
def test_exec_chatty_stderr_drained(p):
    _native_or_skip(p)
    child = _py("import sys\n"
                "for i in range(200):\n"
                "    sys.stderr.write('stat line %d\\n' % i + 'x' * 1000)\n"
                "sys.stderr.flush()\n"
                "sys.stdout.buffer.write(b'\\x02' * 16384); sys.stdout.buffer.flush()\n"
                "sys.stderr.write('final diagnostic')\n"
                "sys.exit(9)\n")
    src = p.sources.load_source("exec", _exec_params(1_000_000, "u8", cmd=child))
    result = {}
    t = threading.Thread(target=lambda: result.setdefault("blocks", list(src.stream(8192))),
                         daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "stream wedged on undrained stderr"
    assert len(result["blocks"]) == 1 and (result["blocks"][0].samples == 2).all()
    assert "rc=9" in src.last_error() and "final diagnostic" in src.last_error()


@both
def test_exec_spawn_failure_resets_state(p):
    _native_or_skip(p)
    src = p.sources.load_source("exec", _exec_params(
        1_000_000, "u8", cmd=["/nonexistent/binary/for/this/test"]))
    for _ in range(2):  # a second attempt fails the same clean way
        with pytest.raises(p.errors.TSDRError):
            next(iter(src.stream(4096)))
        assert src._running is False and src._ring is None


# ---- the reference's binary plugin ABI (tests/test_cplugin.py) -------------
# The plugin cases build the reference's own RawFile plugin and skip where
# tests/test_cplugin.py skips (same condition, its marker).

needs_reference = test_cplugin.pytestmark
needs_gcc = pytest.mark.skipif(shutil.which("gcc") is None, reason="gcc unavailable")
CHUNK_VALUES = test_cplugin.CHUNK_VALUES
CHUNK_SAMPLES = test_cplugin.CHUNK_SAMPLES


@pytest.fixture(scope="module")
def plugin_so(tmp_path_factory):
    return test_cplugin._build_plugin(tmp_path_factory.mktemp("cplugin"), "base")


@pytest.fixture(scope="module")
def capture_u8(tmp_path_factory):
    data = np.random.default_rng(7).integers(0, 256, size=8 * CHUNK_VALUES, dtype=np.uint8)
    path = tmp_path_factory.mktemp("cap") / "cap.u8"
    path.write_bytes(data.tobytes())
    return str(path), data


@needs_reference
@both
def test_cplugin_identity_and_rate(p, plugin_so, capture_u8):
    path, _ = capture_u8
    src = p.sources.CPluginSource()
    src.init(f"{plugin_so} -- {path} 8000000 uint8")
    assert "raw" in src.name().lower() or "file" in src.name().lower()
    assert src.samplerate() == 8e6 and src.set_samplerate(2e6) == 8e6
    src.cleanup()


@needs_reference
@both
def test_cplugin_stream_matches_normalization_oracle(p, plugin_so, capture_u8):
    path, data = capture_u8
    src = p.sources.load_source("cplugin", f"{plugin_so} block=1 -- {path} 8000000 uint8")
    assert src.block_dtype() == np.float32
    got = []
    for blk in src.stream(CHUNK_SAMPLES):
        assert blk.dropped == 0
        got.append(blk.samples)
        if len(got) == 4:
            break
    src.stop()
    expected = (data[: 4 * 2 * CHUNK_SAMPLES].astype(np.float32) - 128.0) / 128.0
    np.testing.assert_allclose(np.concatenate(got), expected, atol=1e-6)


@needs_reference
@both
def test_cplugin_injected_drop_reported_after_gap(p, tmp_path_factory, capture_u8):
    path, data = capture_u8
    so = test_cplugin._build_plugin(tmp_path_factory.mktemp("cplugin_inj"), "inj",
                                    inj_at=2, inj_drop=1000)
    src = p.sources.CPluginSource()
    src.init(f"{so} block=1 -- {path} 8000000 uint8")
    drops, blocks = [], []
    for blk in src.stream(CHUNK_SAMPLES):
        drops.append(blk.dropped)
        blocks.append(blk.samples)
        if len(drops) == 6:
            break
    src.stop()
    assert sum(drops) == 1000 and next(i for i, d in enumerate(drops) if d) == 2
    expected = (data[: 2 * 2 * CHUNK_SAMPLES].astype(np.float32) - 128.0) / 128.0
    np.testing.assert_allclose(np.concatenate(blocks[:2]), expected, atol=1e-6)


@needs_reference
@both
def test_cplugin_frames_match_rawfile_source(p, plugin_so, tmp_path):
    sr, twidth = 2e6, 160
    iq = jsources.synth_iq(jsources.render_test_pattern(LINES, twidth), samplerate=sr,
                           pixelclock=LINES * twidth * REFRESH, n_samples=52 * CHUNK_SAMPLES,
                           start_sample=0, noise=0.05, dtype=np.uint8)
    path = tmp_path / "cap2.u8"
    path.write_bytes(iq.tobytes())
    cfg = p.config(samplerate=sr, height=LINES, refreshrate=REFRESH, block_samples=8192,
                   autocorr=False)

    def frames_via(source):
        frames = []
        p.session_of(cfg, p.pkg.Params(framerate_pll=False), source,
                     frames.append).run(max_frames=4)
        return frames

    ref = frames_via(p.sources.load_source("rawfile", f"{path} 2000000 uint8"))
    plug = p.sources.load_source("cplugin", f"{plugin_so} block=1 -- {path} 2000000 uint8")
    got = frames_via(plug)
    plug.cleanup()
    assert len(ref) == len(got) == 4
    for a, b in zip(ref, got):
        np.testing.assert_allclose(a, b, atol=2e-5)


@needs_reference
@both
def test_cplugin_init_error_text_surfaces(p, plugin_so):
    src = p.sources.CPluginSource()
    with pytest.raises(p.errors.TSDRError) as ei:
        src.init(f"{plugin_so} -- /nonexistent 8000000 notaformat")
    assert ei.value.status == p.errors.TSDRStatus.PLUGIN_PARAMETERS_WRONG
    assert "plugin rc=" in str(ei.value)


@needs_gcc
@both
def test_cplugin_missing_symbols_is_incompatible(p, tmp_path):
    """A .so without the 10-function ABI -> INCOMPATIBLE_PLUGIN (needs gcc,
    not the reference)."""
    c = tmp_path / "noabi.c"
    c.write_text("int not_a_plugin(void) { return 42; }\n")
    so = tmp_path / "noabi.so"
    subprocess.run(["gcc", "-O2", "-fPIC", "-shared", "-o", str(so), str(c)],
                   check=True, capture_output=True)
    with pytest.raises(p.errors.TSDRError) as ei:
        p.sources.CPluginSource().init(str(so))
    assert ei.value.status == p.errors.TSDRStatus.INCOMPATIBLE_PLUGIN


@both
def test_cplugin_bad_loader_params(p):
    with pytest.raises(p.errors.TSDRError) as ei:
        p.sources.CPluginSource().init("")
    assert ei.value.status == p.errors.TSDRStatus.PLUGIN_PARAMETERS_WRONG


# ---- the surface repairs: the same call through both packages -------------

def test_version_matches_the_reference():
    assert tpkg.__version__ == jpkg.__version__ == "0.1.0"


def test_measure_dispatch_floor_takes_repeats_first(monkeypatch):
    """measure_dispatch_floor(5) means five repeats in both packages; the
    port's device is a keyword (default the card)."""
    import inspect

    from tempestsdr_tpu.utils import profiling as jprof
    from tempestsdr_tpu_torch.utils import profiling as tprof

    for mod in (jprof, tprof):
        monkeypatch.setattr(mod, "_FLOOR_CACHE", {})
        assert list(inspect.signature(mod.measure_dispatch_floor).parameters)[0] == "repeats"
    assert 0 < jprof.measure_dispatch_floor(5) < 1.0
    assert 0 < tprof.measure_dispatch_floor(5, device="cpu") < 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tprof.measure_dispatch_floor(5)
