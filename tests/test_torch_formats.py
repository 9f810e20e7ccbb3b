"""The raw IQ formats users feed the receiver, through the port's Session and
the JAX package's, on the CPU: a rawfile capture in int8 (HackRF), int16
(USRP, SDRplay), uint16 and float32, int8 again under resampler="fused"
(the JAX step's fused kernel in Pallas interpret mode, the port's plain
version), and an exec source whose child writes 24-bit samples (the ExtIO
format, widened to float32 on the host). Each package reads the same file
through its own source into its own Session. Frames within FRAME_ATOL,
value events equal, and every integer leaf of the final state (the carries:
phase, fill, skip, frame count, ...) equal.

The capture is the synthetic emanation at an amplitude every format holds
without clipping (synth_iq quantizes it like a recorder)."""

import os
import shlex
import sys

import jax
import numpy as np
import pytest

import tempestsdr_tpu.native as jnative
from tempestsdr_tpu.config import PipelineConfig as JConfig
from tempestsdr_tpu.params import Params as JParams
from tempestsdr_tpu.sources import load_source as j_load_source
from tempestsdr_tpu.stream import session as jsession

import tempestsdr_tpu_torch.native as tnative
from tempestsdr_tpu_torch.config import PipelineConfig
from tempestsdr_tpu_torch.params import Params
from tempestsdr_tpu_torch.sources import load_source, render_test_pattern, synth_iq
from tempestsdr_tpu_torch.stream import session as tsession
from tempestsdr_tpu_torch.stream.state import state_to_numpy

from test_torch_device_step import interpret_pallas, one_torch_thread  # noqa: F401 (fixtures)

SR, LINES, TWIDTH, REFRESH = 1e6, 100, 160, 60.0
BLOCK, N_BLOCKS = 8192, 12  # width 333, one frame a block at most; 4096-aligned for "fused"
FRAME_ATOL = 1e-4  # K1- and K2-class frames against the JAX step (tests/test_stream.py:91)
VALUE_RTOL = 1e-5


def emanation(dtype, n=N_BLOCKS * BLOCK):
    """The capture's samples in `dtype`: the raster at 0.3-0.9 of full
    scale plus noise, inside every format's range."""
    raster = render_test_pattern(LINES, TWIDTH) * 0.6
    return synth_iq(raster, samplerate=SR, pixelclock=LINES * TWIDTH * 50.03, n_samples=n,
                    dc=0.3, noise=0.01, seed=7, dtype=dtype)


def i24_bytes(f32: np.ndarray) -> bytes:
    """float32 in [-1, 1) as 24-bit little-endian signed PCM."""
    v = np.clip(np.round(f32.astype(np.float64) * (1 << 23)), -(1 << 23), (1 << 23) - 1)
    b = v.astype(np.int64).astype("<i4").view(np.uint8).reshape(-1, 4)
    return b[:, :3].tobytes()


def run_both(spec, params):
    """The source `spec` (load_source's name and params) through each
    package's Session for N_BLOCKS blocks: per package its frames, value
    events and final state's leaves."""
    kw = dict(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=BLOCK)
    got = {}
    for which in ("jax", "torch"):
        rec = dict(frames=[], values=[])
        if which == "jax":
            cbs = jsession.SessionCallbacks(on_frame=rec["frames"].append,
                                            on_value=rec["values"].append)
            sess = jsession.Session(JConfig(**kw), JParams(**params), j_load_source(*spec), cbs)
        else:
            cbs = tsession.SessionCallbacks(on_frame=rec["frames"].append,
                                            on_value=rec["values"].append)
            sess = tsession.Session(PipelineConfig(**kw), Params(**params), load_source(*spec),
                                    cbs, device="cpu")
        sess.run(max_blocks=N_BLOCKS)
        rec["state"] = ([np.asarray(x) for x in jax.tree.leaves(sess.state)]
                        if which == "jax" else state_to_numpy(sess.state))
        got[which] = rec
    return got["jax"], got["torch"]


def held(j, t):
    assert len(t["frames"]) == len(j["frames"]) >= 4
    for i, (a, b) in enumerate(zip(t["frames"], j["frames"])):
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=FRAME_ATOL, err_msg=f"frame {i}")
    assert [v.value_id for v in t["values"]] == [v.value_id for v in j["values"]]
    for a, b in zip(t["values"], j["values"]):
        np.testing.assert_allclose([a.arg0, a.arg1], [b.arg0, b.arg1], rtol=VALUE_RTOL)
    assert len(t["state"]) == len(j["state"])
    ints = 0
    for i, (a, b) in enumerate(zip(t["state"], j["state"])):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if a.dtype.kind in "biu":
            assert np.array_equal(a, b), f"state leaf {i}"
            ints += 1
    assert ints >= 5


@pytest.mark.parametrize("fmt,dtype,params", [
    ("int8", np.int8, {}),
    ("int16", np.int16, {}),
    ("uint16", np.uint16, {}),
    ("float", np.float32, {}),
    ("int8", np.int8, dict(resampler="fused")),
], ids=["int8", "int16", "uint16", "float32", "int8-fused"])
def test_rawfile_format_through_the_session(tmp_path, interpret_pallas, fmt, dtype, params):
    path = tmp_path / f"capture.{fmt}"
    emanation(dtype).tofile(path)
    src = load_source("rawfile", f"{path} {SR} {fmt} noloop")
    assert src.block_dtype() == dtype
    held(*run_both(("rawfile", f"{path} {SR} {fmt} noloop"), params))


def test_exec_i24_through_the_session(tmp_path):
    """cat of a 24-bit capture through the exec source: blocks widened to
    float32 on the host, equal to the float32 capture of the same samples
    read by rawfile, and the sessions of both packages agree."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("the native I/O runtime does not build here")
    f32 = emanation(np.float32)
    raw24 = i24_bytes(f32)
    path = tmp_path / "capture.i24"
    path.write_bytes(raw24)
    ring = -(-len(raw24) // (1 << 16)) + 1  # the whole capture: cat outruns the session
    spec = ("exec", f"{SR} i24 ring={ring} -- {shlex.quote(sys.executable)} -c "
            + shlex.quote(f"import sys; sys.stdout.buffer.write(open({str(path)!r}, 'rb').read())"))
    src = load_source(*spec)
    assert src.block_dtype() == np.float32
    blocks = [b for _, b in zip(range(N_BLOCKS), src.stream(BLOCK))]
    src.stop()
    widened = np.concatenate([b.samples for b in blocks])
    v = (np.frombuffer(raw24, np.uint8).reshape(-1, 3).astype(np.int32) * [1, 1 << 8, 1 << 16]).sum(1)
    want = (np.where(v >= 1 << 23, v - (1 << 24), v) / (1 << 23)).astype(np.float32)
    assert np.array_equal(widened, want) and all(b.dropped == 0 for b in blocks)
    assert src.last_error() == ""
    j, t = run_both(spec, {})
    held(j, t)
    f32_path = tmp_path / "capture.f32"
    want.tofile(f32_path)
    _, t_raw = run_both(("rawfile", f"{f32_path} {SR} float noloop"), {})
    assert len(t_raw["frames"]) == len(t["frames"])
    assert all(np.array_equal(a, b) for a, b in zip(t["frames"], t_raw["frames"]))
    assert os.path.getsize(path) == 2 * 3 * N_BLOCKS * BLOCK
