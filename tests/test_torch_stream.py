"""The port's streaming step and Session (tempestsdr_tpu_torch.stream)
against the JAX package's on the CPU, over multi-block uint8 streams from
synth_iq: per block, the integer outputs and carries exactly; frames within
FRAME_ATOL; autocorrelation plots within AC_RTOL of their peak."""

import ast
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tempestsdr_tpu.config import PipelineConfig as JConfig
from tempestsdr_tpu.params import Params as JParams
from tempestsdr_tpu.stream import make_step as j_make_step, init_state as j_init_state
from tempestsdr_tpu.stream.pipeline import StepControls as JControls
from tempestsdr_tpu.stream.session import Session as JSession, SessionCallbacks as JCallbacks
from tempestsdr_tpu.sources.synthetic import (
    SyntheticSource as JSynthetic,
    render_test_pattern,
    synth_iq,
)

from tempestsdr_tpu_torch.config import PipelineConfig
from tempestsdr_tpu_torch.params import DIRECTION, Params
from tempestsdr_tpu_torch.stream import make_step, init_state
from tempestsdr_tpu_torch.stream.pipeline import StepControls
from tempestsdr_tpu_torch.stream.session import Session, SessionCallbacks
from tempestsdr_tpu_torch.stream.state import (
    state_compatible,
    state_from_numpy,
    state_leaves,
    state_to_numpy,
)
from tempestsdr_tpu_torch.sources.rawfile import RawFileSource
from tempestsdr_tpu_torch.sources.synthetic import SyntheticSource

from test_torch_device_step import one_torch_thread  # noqa: F401 (autouse)

LINES, TWIDTH, REFRESH, SR = 100, 200, 50.0, 1e6
# XLA fuses the normalize / motion-blur elementwise pass and may rewrite its
# division and multiply-adds; torch runs them as separate correctly rounded
# ops. Frames in [0, ~1.2] differ by a few f32 ulps (4e-6 seen), markers
# (512) by one.
FRAME_ATOL, FRAME_RTOL = 1e-5, 1e-6
# complex64 FFT: pocketfft and JAX's FFT sum in different orders
AC_RTOL = 1e-5
EXACT = ("n_pixels", "frame_valid", "sync_dx", "sync_dy", "pll_locked", "ac_calls",
         "ac_plot_valid")


def _configs(block, autocorr=True):
    kw = dict(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=block,
              autocorr=autocorr)
    return JConfig(**kw), PipelineConfig(**kw)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _compare_streams(block, n_blocks, params, events=None, refresh_true=50.03,
                     motionblur=0.3, frame_atol=FRAME_ATOL):
    """Drive both steps over the same u8 stream; `events` maps a block index
    to (samples_dropped, syncoffset). Returns the JAX outputs seen."""
    events = events or {}
    jcfg, tcfg = _configs(block)
    jstep = jax.jit(j_make_step(jcfg, JParams(**params)))
    tstep = make_step(tcfg, Params(**params), device="cpu")
    fir = params.get("fir_lowpass_taps", 0)
    js, ts = j_init_state(jcfg, fir), init_state(tcfg, fir, device="cpu")
    raster = render_test_pattern(LINES, TWIDTH)
    seen = dict(frames=0, rounds=0, k=tcfg.frames_per_block, locked=0)
    for b in range(n_blocks):
        raw = synth_iq(raster, samplerate=SR, pixelclock=LINES * TWIDTH * refresh_true,
                       n_samples=block, start_sample=b * block, noise=0.01,
                       dtype=np.uint8)
        dropped, sync = events.get(b, (0, 0))
        js, jo = jstep(js, jnp.asarray(raw),
                       JControls(jnp.int64(dropped), jnp.int32(sync), jnp.float32(motionblur)))
        ts, to = tstep(ts, torch.from_numpy(raw), StepControls(dropped, sync, motionblur))
        for f in EXACT:
            np.testing.assert_array_equal(_np(getattr(to, f)), np.asarray(getattr(jo, f)),
                                          err_msg=f"block {b} {f}")
        for f in ("phase_fix", "fill", "skip_pixels", "ac_fill", "runs", "frame_count"):
            assert int(getattr(ts, f)) == int(getattr(js, f)), (b, f)
        assert [int(v) for v in ts.sync_x] == [int(v) for v in js.sync_x]
        assert [int(v) for v in ts.sync_y] == [int(v) for v in js.sync_y]
        np.testing.assert_array_equal(_np(ts.fir_tail), np.asarray(js.fir_tail))
        np.testing.assert_allclose(_np(to.frame), np.asarray(jo.frame),
                                   rtol=FRAME_RTOL, atol=frame_atol, err_msg=f"block {b}")
        if bool(jo.ac_plot_valid):
            for f in ("ac_frame_plot", "ac_line_plot"):
                want = np.asarray(getattr(jo, f))
                np.testing.assert_allclose(_np(getattr(to, f)), want, rtol=0,
                                           atol=AC_RTOL * np.abs(want).max())
            seen["rounds"] += 1
        seen["frames"] += int(np.sum(np.asarray(jo.frame_valid)))
        seen["locked"] += int(bool(jo.pll_locked))
    return seen


def test_step_k1_pll_drops_sync_blur_autocorr():
    """K == 1 with the PLL tracking a 50.03 Hz source, drops, manual sync
    shifts and motion blur; autocorrelation rounds complete."""
    seen = _compare_streams(8192, 30, {},
                            events={5: (3000, 0), 9: (0, 1234), 14: (100, 77), 20: (0, -500)})
    assert seen["k"] == 1 and seen["frames"] >= 4 and seen["rounds"] >= 1


def test_step_multi_emit_k3():
    """K > 1 (49152-sample blocks span ~2.5 frames -> K == 3) with the PLL
    on and a drop + sync shift mid-stream."""
    seen = _compare_streams(49152, 8, {}, events={2: (5000, 500)})
    assert seen["k"] == 3 and seen["frames"] >= 6 and seen["rounds"] >= 2


@pytest.mark.parametrize("flags", [
    dict(autogain_after_proc=True),
    dict(lowpass_before_sync=True),
    dict(autogain_after_proc=True, lowpass_before_sync=True),
    dict(autoshift=True),
    dict(debug_markers=True),
    dict(fast_sync=True),
    dict(framerate_pll=False, autocorr_plots_off=True),
    dict(resampler="strided"),
], ids=lambda d: ",".join(d))
def test_step_param_flags(flags):
    """Every post-process order and sync flag of this slice."""
    seen = _compare_streams(8192, 14, flags, motionblur=0.5)
    assert seen["frames"] >= 2


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """The JAX step's TPU resample kernels in interpret mode
    (tests/test_pallas.py:14-25)."""
    import jax.experimental.pallas as pl
    import tempestsdr_tpu.pallas.resample_kernel as rk

    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(rk.pl, "pallas_call", interp)


# The JAX step's TPU kernels (interpret mode on the CPU) against the port's
# plain versions. K1/K2's pixels differ from the plain strided form by
# ~1e-6 (their f32 ramps differ), K3/K4's from the chunked form by up to
# 3e-4 (tests/test_pallas.py:99), and autogain scales pixel errors by
# ~1/span: frames within 1e-4 (8.6e-6 seen) and 1e-3 (1.4e-4 seen). Both
# are inside the JAX package's own kernel-vs-XLA step tolerance, 2e-3
# (tests/test_stream.py:91,125).
K1_FRAME_ATOL, K3_FRAME_ATOL = 1e-4, 1e-3


@pytest.mark.parametrize("flags,frame_atol", [
    (dict(resampler="fused"), K1_FRAME_ATOL),
    (dict(resampler="pallas"), K3_FRAME_ATOL),
    (dict(resampler="pallas_windows"), K3_FRAME_ATOL),
    (dict(resampler="pallas_strided"), K1_FRAME_ATOL),
    (dict(resampler="chunked"), FRAME_ATOL),
    (dict(fir_lowpass_taps=15), FRAME_ATOL),
    (dict(nearest_neighbour=True), FRAME_ATOL),
], ids=lambda v: ",".join(f"{k}={x}" for k, x in v.items()) if isinstance(v, dict) else None)
def test_step_resampler_paths(interpret_pallas, flags, frame_atol):
    """Every resampler choice, the FIR and nearest-neighbour: the port's CPU
    step (plain versions) against the JAX step, with a drop and a sync
    shift. Carries and integer outputs exact, frames within frame_atol."""
    seen = _compare_streams(8192, 10, flags, events={4: (3000, 0), 6: (0, 777)},
                            frame_atol=frame_atol)
    assert seen["frames"] >= 2


@pytest.mark.parametrize("flags,exc", [
    (dict(resampler="no_such_resampler"), ValueError),
])
def test_unported_params_raise(flags, exc):
    """An unknown resampler name is a ValueError, as in the JAX package.
    (Every Params flag is ported: superresolution is the session's business,
    tests/test_torch_superband.py, and the step ignores it as the JAX step
    does.)"""
    _, tcfg = _configs(8192)
    with pytest.raises(exc, match="resampler"):
        make_step(tcfg, Params(**flags), device="cpu")
    assert make_step(tcfg, Params(superresolution=True), device="cpu").params.superresolution


def _session_pair(block=8192):
    jcfg, tcfg = _configs(block)
    spec = f"{LINES} {TWIDTH} {REFRESH} {SR} 0.01"
    jsrc, tsrc = JSynthetic(), SyntheticSource()
    jsrc.init(spec)
    tsrc.init(spec)
    rec = {"j": dict(frames=[], values=[], plots=[]), "t": dict(frames=[], values=[], plots=[])}

    def cbs(cls, r):
        return cls(on_frame=r["frames"].append, on_value=r["values"].append,
                   on_plot=r["plots"].append)

    js = JSession(jcfg, JParams(), jsrc, cbs(JCallbacks, rec["j"]))
    ts = Session(tcfg, Params(), tsrc, cbs(SessionCallbacks, rec["t"]), device="cpu")
    return js, ts, rec


def _compare_records(rj, rt):
    assert len(rt["frames"]) == len(rj["frames"]) > 0
    for a, b in zip(rt["frames"], rj["frames"]):
        np.testing.assert_allclose(a, b, rtol=FRAME_RTOL, atol=FRAME_ATOL)
    assert [v.value_id for v in rt["values"]] == [v.value_id for v in rj["values"]]
    for a, b in zip(rt["values"], rj["values"]):
        np.testing.assert_allclose([a.arg0, a.arg1], [b.arg0, b.arg1], rtol=1e-5)
    assert [(p.plot_id, p.offset) for p in rt["plots"]] == [(p.plot_id, p.offset) for p in rj["plots"]]
    for a, b in zip(rt["plots"], rj["plots"]):
        np.testing.assert_allclose(a.values, b.values, rtol=0,
                                   atol=AC_RTOL * np.abs(b.values).max())


def test_session_run_matches_jax_session():
    """Session.run on a SyntheticSource: the same frames, value events (PLL,
    autogain cadence, round counts, reset) and plot events as the JAX
    Session, with a sync shift, motion blur and an autocorrelation reset set
    between runs."""
    js, ts, rec = _session_pair()
    for s in (js, ts):
        assert s.run(max_blocks=12) >= 1
        s.sync_shift(3, DIRECTION.UP)
        s.set_motionblur(0.25)
        s.reset_autocorr()
        s.run(max_blocks=10)
        s.sync_shift(37)
        s.run(max_blocks=4)
    _compare_records(rec["j"], rec["t"])


def test_jax_checkpoint_loads_and_runs_on(tmp_path):
    """A JAX Session.save_state checkpoint loads into the port's Session and
    runs on equal to the JAX session run on from the same point."""
    js, ts, rec = _session_pair()
    js.run(max_blocks=12)
    path = tmp_path / "ckpt.npz"
    js.save_state(path)
    ts.load_state(path)
    ts.source._pos = js.source._pos  # same stream position
    rec["j"] = dict(frames=[], values=[], plots=[])
    js.callbacks.on_frame = rec["j"]["frames"].append
    js.callbacks.on_value = rec["j"]["values"].append
    js.callbacks.on_plot = rec["j"]["plots"].append
    # host-side session bookkeeping is not part of the checkpoint
    js._agruns = ts._agruns = 0
    ts._last_refresh = js._last_refresh
    js.run(max_blocks=12)
    ts.run(max_blocks=12)
    _compare_records(rec["j"], rec["t"])
    # and the port's own checkpoint round-trips in the same format
    ts.save_state(tmp_path / "port")
    with np.load(tmp_path / "port.npz") as z:
        flat = [z[k] for k in z.files]
    assert [(x.shape, x.dtype) for x in flat] == [
        (np.asarray(x).shape, np.asarray(x).dtype) for x in jax.tree.leaves(js.state)]


def test_state_leaves_match_jax():
    """Same leaf order, shapes and dtypes as the JAX StreamState (K == 1 and
    K > 1), and state_from_numpy round-trips the JAX leaves."""
    for block in (8192, 49152):
        jcfg, tcfg = _configs(block)
        jl = jax.tree.leaves(j_init_state(jcfg))
        tl = state_leaves(init_state(tcfg, device="cpu"))
        assert [(np.asarray(x).shape, np.asarray(x).dtype) for x in jl] == [
            (tuple(x.shape), x.numpy().dtype) for x in tl]
        back = state_to_numpy(state_from_numpy([np.asarray(x) for x in jl], device="cpu"))
        assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(back, jl))
    k1 = init_state(_configs(8192)[1], device="cpu")
    k3 = init_state(_configs(49152)[1], device="cpu")
    assert state_compatible(k1, k1) and not state_compatible(k1, k3)


def test_rawfile_replay_in_raw_dtype(tmp_path):
    """The port's RawFile source (numpy only) yields blocks in the file's
    raw dtype and loops at EOF, like the JAX package's."""
    data = np.arange(3 * 2 * 1000, dtype=np.int64).astype(np.uint8)
    path = tmp_path / "cap.u8"
    data.tofile(path)
    src = RawFileSource()
    src.init(f"{path} 2e6 uint8")
    assert src.block_dtype() == np.uint8 and src.samplerate() == 2e6
    it = src.stream(1400)
    blocks = [next(it).samples for _ in range(3)]
    src.stop()
    np.testing.assert_array_equal(np.concatenate(blocks),
                                  np.concatenate([data, data])[:3 * 2800])


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no CUDA device and no explicit device='cpu', entry points raise
    instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs(8192)
    src = SyntheticSource()
    src.init(f"{LINES} {TWIDTH} {REFRESH} {SR}")
    with pytest.raises(RuntimeError, match="CUDA"):
        Session(tcfg, Params(), src)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_step(tcfg, Params())
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(tcfg)
    # the front door: warm start, TSDR and the command line
    from tempestsdr_tpu_torch import TSDR, cli
    from tempestsdr_tpu_torch.stream.session import warm_compile_step
    from tempestsdr_tpu_torch.superband import stitch_hops
    from tempestsdr_tpu_torch.utils.profiling import measure_dispatch_floor

    with pytest.raises(RuntimeError, match="CUDA"):
        warm_compile_step(tcfg, Params())
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_dispatch_floor()
    with pytest.raises(RuntimeError, match="CUDA"):
        stitch_hops(np.zeros((4, 64), np.complex64))
    rx = TSDR(block_samples=8192)
    rx.load_source("synthetic", f"{LINES} {TWIDTH} {REFRESH} {SR}")
    rx.set_resolution(LINES, REFRESH)
    with pytest.raises(RuntimeError, match="CUDA"):
        rx.start(on_frame=lambda f: None, max_frames=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        rx.warm_resolution(LINES, REFRESH)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--source", "synthetic", "--source-params", f"{LINES} {TWIDTH} {REFRESH} {SR}",
                  "--height", str(LINES), "--rate", str(REFRESH), "--block-samples", "8192",
                  "--frames", "1"])


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    root = os.path.join(os.path.dirname(__file__), "..")
    files = [os.path.join(root, "chip_smoke.py")]
    files += [os.path.join(root, "examples", n) for n in os.listdir(os.path.join(root, "examples"))
              if n.startswith("torch_") and n.endswith(".py")]
    for d, _, names in os.walk(os.path.join(root, "tempestsdr_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    walked = {os.path.relpath(p, root).replace(os.sep, "/") for p in files}
    for mod in ("parallel/__init__", "parallel/channels", "native/__init__", "sources/live",
                "sources/rtltcp", "sources/subproc", "sources/cplugin", "stream/multisession"):
        assert f"tempestsdr_tpu_torch/{mod}.py" in walked, mod
    assert "examples/torch_multi_target.py" in walked
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tempestsdr_tpu"), f"{path} imports {mod}"
