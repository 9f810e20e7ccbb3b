"""The port's device step (stream.pipeline.make_step, the single-channel
step with no host read inside a block) on the CPU, and the helpers of
tests/test_torch_graph_runner.py (its block runner, stream.graph.
BlockRunner and make_scan_runner, and the K == 4 scenarios):

- against the JAX package's make_step block for block, at a K == 1 and a
  K == 4 geometry 333 pixels wide, with drops (and the blocks past a drop
  that the phase skips whole), sync shifts mid-stream, autocorrelation
  rounds, autoshift, debug markers, FIR 31, nearest-neighbour and every
  resampler choice (the JAX TPU kernels in Pallas interpret mode, the
  port's kernels as their plain versions): integers and carries exact,
  frames within the path's tolerance;
- against the block runner's eager loop (stream.graph.BlockRunner at one
  block a call), bit for bit;
- K blocks through the runner against the JAX package's scan of the step,
  with drops in varied slots and the sync shift in slot 0;
- with every way a block could read a tensor to the host made to raise:
  the property a CUDA-graph capture of the step needs.

Inputs are uint8 IQ from synth_iq, seeded with numpy."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tempestsdr_tpu.config import PipelineConfig as JConfig
from tempestsdr_tpu.params import Params as JParams
from tempestsdr_tpu.sources.synthetic import render_test_pattern, synth_iq
from tempestsdr_tpu.stream import init_state as j_init_state, make_step as j_make_step
from tempestsdr_tpu.stream.pipeline import StepControls as JControls

from tempestsdr_tpu_torch.config import PipelineConfig
from tempestsdr_tpu_torch.params import Params
from tempestsdr_tpu_torch.stream import StepOutputs, init_state, make_step
from tempestsdr_tpu_torch.stream.graph import BlockRunner
from tempestsdr_tpu_torch.stream.pipeline import StepControls

SR, LINES, REFRESH, TWIDTH = 1e6, 100, 60.0, 160
K1_BLOCK, K4_BLOCK = 8192, 49152  # frames_per_block 1 and 4 at 333 x 100
# Frames against the JAX step, of the frame's peak where it exceeds 1
# (autogain scales a pixel difference by 1/span, and the first frames,
# before its IIR bounds settle, peak near 12). The K1 path (the strided form and K1/K2, the
# FIR, nearest-neighbour): the JAX K1/K2 kernels' f32 ramps differ from the
# plain strided form's by ~1e-6 of a sample, and XLA fuses the normalize
# and motion-blur pass that torch rounds op by op: 2e-5
# (tests/test_pallas.py's kernel tolerance). The K3 path ("pallas",
# "pallas_windows"): the TPU kernels' per-tile ramps against the chunked
# form's per-chunk ones, 3e-4 (tests/test_pallas.py:99). FRAME_RTOL covers
# debug-marker pixels (512) through the motion-blur IIR, one f32 ulp apart.
K1_PATH_ATOL, K3_PATH_ATOL, FRAME_RTOL = 2e-5, 3e-4, 1e-6
AC_RTOL = 1e-5  # complex64 FFTs, pocketfft against JAX's (of the plot's peak)
EXACT = ("n_pixels", "frame_valid", "sync_dx", "sync_dy", "pll_locked", "ac_calls",
         "ac_plot_valid")
CARRIES = ("phase_fix", "fill", "skip_pixels", "ac_fill", "runs", "frame_count")
# a drop of 1000 samples: compensation skips to the next two-frame boundary
# (32333 samples), so the block of the drop and the next two produce no
# pixel (drop_all); sync shifts forward and back
K1_EVENTS = {8: (1000, 0), 5: (0, 1234), 13: (0, -500)}
K4_EVENTS = {2: (5000, 500), 4: (0, -777)}

SCENARIOS = {  # name -> (Params fields, frame tolerance)
    "default": ({}, K1_PATH_ATOL),
    "autoshift": (dict(autoshift=True), K1_PATH_ATOL),
    "debug_markers": (dict(debug_markers=True), K1_PATH_ATOL),
    "fir31": (dict(fir_lowpass_taps=31), K1_PATH_ATOL),
    "nearest_neighbour": (dict(nearest_neighbour=True), K1_PATH_ATOL),
    "strided": (dict(resampler="strided"), K1_PATH_ATOL),
    "chunked": (dict(resampler="chunked"), K1_PATH_ATOL),
    "pallas_strided": (dict(resampler="pallas_strided"), K1_PATH_ATOL),
    "fused": (dict(resampler="fused"), K1_PATH_ATOL),
    "pallas": (dict(resampler="pallas"), K3_PATH_ATOL),
    "pallas_windows": (dict(resampler="pallas_windows"), K3_PATH_ATOL),
    # the post-process orders and sync flags of the reference's PARAM
    # registry (and fast_sync), alone and all at once
    "autogain_after": (dict(autogain_after_proc=True), K1_PATH_ATOL),
    "lowpass_first": (dict(lowpass_before_sync=True), K1_PATH_ATOL),
    "both": (dict(autogain_after_proc=True, lowpass_before_sync=True), K1_PATH_ATOL),
    "fast_sync": (dict(fast_sync=True), K1_PATH_ATOL),
    "pll_off_plots_off": (dict(framerate_pll=False, autocorr_plots_off=True), K1_PATH_ATOL),
    "everything": (dict(resampler="pallas", fir_lowpass_taps=31, lowpass_before_sync=True,
                        autogain_after_proc=True, autoshift=True, fast_sync=True), K3_PATH_ATOL),
}
K4_SCENARIOS = ("default", "autoshift", "fused", "pallas", "both", "everything")
# the motion blur of every block: 0.5 where lowpass comes first, so the IIR
# ahead of the collapse weighs the screen and the frame alike
MOTIONBLUR = {"lowpass_first": 0.5, "both": 0.5, "everything": 0.5}


def motionblur(name):
    return MOTIONBLUR.get(name, 0.3)


def rounds_expected(fields):
    """At least one autocorrelation round, unless the plots are off."""
    return 0 if fields.get("autocorr_plots_off") else 1


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test with one torch thread: these small tensors gain nothing from
    the thread pool, and on a host with more runnable threads than cores
    every parallel op waits for its whole pool (four of these tests: 64 s
    with the default pool against 8 s with one thread, beside 8 busy
    processes on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """The JAX step's TPU kernels in interpret mode (tests/test_pallas.py:14-25)."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _configs(block):
    kw = dict(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=block)
    return JConfig(**kw), PipelineConfig(**kw)


def _blocks(n, block, seed=0):
    """n uint8 blocks of a synthetic emanation at 60.03 Hz (the PLL walks)."""
    raster = render_test_pattern(LINES, TWIDTH)
    return [synth_iq(raster, samplerate=SR, pixelclock=LINES * TWIDTH * 60.03, n_samples=block,
                     start_sample=b * block, noise=0.01, seed=seed + b, dtype=np.uint8)
            for b in range(n)]


def _np(x):
    return x.detach().cpu().numpy()


def _assert_same_outputs(a, b, where):
    """Two port StepOutputs/StreamStates, every leaf bit for bit."""
    for x, y, name in zip(a, b, a._fields):
        if isinstance(x, tuple):
            for u, v in zip(x, y):
                assert torch.equal(u, v), (where, name)
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), (where, name)


def hold_against_jax_and_runner(k, name):
    """Block for block: the device step against the JAX step (integers,
    carries and sync/PLL state exact, frames within the path's tolerance,
    plots within AC_RTOL of their peak) and against the block runner's
    eager loop at one block a call (every output and state leaf bit for
    bit), through drops, drop-skipped blocks, sync shifts, rounds and
    emits. K == 4's scenarios run in tests/test_torch_graph_runner.py (a
    file of its own, so the two share the JAX compiles between two test
    workers)."""
    fields, atol = SCENARIOS[name]
    block, events, n_blocks = (K1_BLOCK, K1_EVENTS, 18) if k == 1 else (K4_BLOCK, K4_EVENTS, 6)
    jcfg, tcfg = _configs(block)
    assert tcfg.frames_per_block == k
    fir = fields.get("fir_lowpass_taps", 0)
    mb = motionblur(name)
    jstep = jax.jit(j_make_step(jcfg, JParams(**fields)))
    dstep = make_step(tcfg, Params(**fields), device="cpu")
    runner = BlockRunner(tcfg, Params(**fields), 1, "cpu")
    js = j_init_state(jcfg, fir)
    ds, rs = init_state(tcfg, fir, device="cpu"), init_state(tcfg, fir, device="cpu")
    seen = dict(frames=0, rounds=0, skipped=0)
    for b, raw in enumerate(_blocks(n_blocks, block)):
        dropped, sync = events.get(b, (0, 0))
        js, jo = jstep(js, jnp.asarray(raw),
                       JControls(jnp.int64(dropped), jnp.int32(sync), jnp.float32(mb)))
        ctl = StepControls(dropped, sync, mb)
        ds, do = dstep(ds, torch.from_numpy(raw), ctl)
        rs, ro, _ = runner.run(rs, torch.from_numpy(raw)[None], [list(ctl)])
        _assert_same_outputs(do, StepOutputs(*(x[0] for x in ro)), b)
        _assert_same_outputs(ds, rs, b)
        for f in EXACT:
            np.testing.assert_array_equal(_np(getattr(do, f)), np.asarray(getattr(jo, f)),
                                          err_msg=f"block {b} {f}")
        for f in CARRIES:
            assert int(getattr(ds, f)) == int(getattr(js, f)), (b, f)
        for f in ("sync_x", "sync_y"):
            assert [int(v) for v in getattr(ds, f)] == [int(v) for v in getattr(js, f)], (b, f)
        np.testing.assert_array_equal(_np(ds.pll.refresh_delta), np.asarray(js.pll.refresh_delta))
        want = np.asarray(jo.frame)
        np.testing.assert_allclose(_np(do.frame), want, rtol=FRAME_RTOL,
                                   atol=atol * max(1.0, float(np.abs(want).max())),
                                   err_msg=f"block {b}")
        if bool(jo.ac_plot_valid):
            for f in ("ac_frame_plot", "ac_line_plot"):
                want = np.asarray(getattr(jo, f))
                np.testing.assert_allclose(_np(getattr(do, f)), want, rtol=0,
                                           atol=AC_RTOL * np.abs(want).max())
            seen["rounds"] += 1
        seen["frames"] += int(np.sum(np.asarray(jo.frame_valid)))
        seen["skipped"] += int(np.asarray(jo.n_pixels) == 0)
    assert seen["frames"] >= (4 if k == 1 else 10) and seen["rounds"] >= rounds_expected(fields)
    if k == 1:
        assert seen["skipped"] == 3  # the drop's block and the two past it


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_device_step_matches_jax_and_the_host_step(interpret_pallas, name):
    """hold_against_jax_and_runner at K == 1, every scenario."""
    hold_against_jax_and_runner(1, name)

