"""The port's channel steps (tempestsdr_tpu_torch.stream.pipeline:
make_channels_step_hybrid, _unrolled, make_channels_step, make_multi_step),
the channel runner (stream.graph.ChannelRunner), make_step(batched=True),
make_scan_runner and parallel.stack_states against the JAX package's on the
CPU, block by block; every channel form run with every host read made to
raise (tests/torch_host_guard.py), and cond_mode="batched" against
"unrolled". At the JAX tests' sizes (SR
1e6, 100 lines, block 8192, C = 3; tests/test_parallel.py:427-432): integer
outputs and carries exactly, frames within FRAME_ATOL/FRAME_RTOL, plots
within AC_RTOL of their peak. Where a JAX step reaches a Pallas kernel it
runs in interpret mode, as tests/test_pallas.py runs it."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tempestsdr_tpu.config import PipelineConfig as JConfig
from tempestsdr_tpu.params import Params as JParams
from tempestsdr_tpu.parallel.channels import stack_states as j_stack_states
from tempestsdr_tpu.sources.synthetic import render_test_pattern, synth_iq
from tempestsdr_tpu.stream import init_state as j_init_state, make_step as j_make_step
from tempestsdr_tpu.stream import pipeline as jpipe
from tempestsdr_tpu.stream.pipeline import StepControls as JControls

from tempestsdr_tpu_torch.config import PipelineConfig
from tempestsdr_tpu_torch.params import Params
from tempestsdr_tpu_torch.parallel import stack_states
from tempestsdr_tpu_torch.stream import init_state, make_step
from tempestsdr_tpu_torch.stream import pipeline as tpipe
from tempestsdr_tpu_torch.stream.pipeline import StepControls
from tempestsdr_tpu_torch.stream.state import state_leaves

from torch_host_guard import CountOps, no_host_reads
from test_torch_device_step import one_torch_thread  # noqa: F401 (autouse)

SR, LINES, TWIDTH, REFRESH = 1e6, 100, 200, 50.0
C = 3
BIG = 49152  # ~2.46 frames of 20000 samples -> K == 3
# as tests/test_torch_stream.py:41-47
FRAME_ATOL, FRAME_RTOL = 1e-5, 1e-6
AC_RTOL = 1e-5
K1_FRAME_ATOL = 1e-4  # K2 (interpret mode) against the plain strided form,
# tests/test_torch_stream.py:157
EXACT = ("n_pixels", "frame_valid", "sync_dx", "sync_dy", "pll_locked", "ac_calls",
         "ac_plot_valid")
CARRIES = ("phase_fix", "fill", "skip_pixels", "ac_fill", "runs", "frame_count")


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """The JAX step's TPU kernels in interpret mode (tests/test_pallas.py:14-25)."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _configs(block=8192, autocorr=True):
    kw = dict(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=block,
              autocorr=autocorr)
    return JConfig(**kw), PipelineConfig(**kw)


@functools.lru_cache(maxsize=None)
def _blocks(n_blocks, block, seed0, dtype=np.uint8):
    """[n_blocks] stacked uint8 blocks [C, 2*block], one raster per channel
    (tests/test_parallel.py:24-35 with each channel's own seed)."""
    per_ch = []
    for c in range(C):
        raster = render_test_pattern(LINES, TWIDTH, seed=seed0 + c)
        per_ch.append([synth_iq(raster, samplerate=SR, pixelclock=LINES * TWIDTH * REFRESH,
                                n_samples=block, start_sample=b * block, noise=0.01,
                                seed=seed0 + c, dtype=dtype) for b in range(n_blocks)])
    return [np.stack([per_ch[c][b] for c in range(C)]) for b in range(n_blocks)]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _drops(b, drop_at, amount=37777):
    return [0, amount if b == drop_at else 0, 0]


def compare(jstep, tstep, jstates, tstates, blocks, drop_at=None, frame_atol=FRAME_ATOL,
            amount=37777, motionblur=0.0):
    """Drive both channel steps over the same blocks (channel 1 drops
    `amount` samples at block drop_at) and hold them to each other per block.
    Returns counts of frames and rounds seen."""
    seen = dict(frames=0, rounds=0)
    for b, raws in enumerate(blocks):
        dropped = _drops(b, drop_at, amount)
        jctrl = JControls(jnp.asarray(dropped, jnp.int64), jnp.zeros((C,), jnp.int32),
                          jnp.full((C,), motionblur, jnp.float32))
        jstates, jo = jstep(jstates, jnp.asarray(raws), jctrl)
        tstates, to = tstep(tstates, torch.from_numpy(raws),
                            StepControls(dropped, [0] * C, [motionblur] * C))
        for f in EXACT:
            np.testing.assert_array_equal(_np(getattr(to, f)), np.asarray(getattr(jo, f)),
                                          err_msg=f"block {b} {f}")
        for f in CARRIES:
            np.testing.assert_array_equal(_np(getattr(tstates, f)), np.asarray(getattr(jstates, f)),
                                          err_msg=f"block {b} {f}")
        for f in ("sync_x", "sync_y"):
            for a, j in zip(getattr(tstates, f), getattr(jstates, f)):
                np.testing.assert_array_equal(_np(a), np.asarray(j), err_msg=f"block {b} {f}")
        np.testing.assert_allclose(_np(to.frame), np.asarray(jo.frame), rtol=FRAME_RTOL,
                                   atol=frame_atol, err_msg=f"block {b}")
        pv = np.asarray(jo.ac_plot_valid)
        for c in np.nonzero(pv)[0]:
            for f in ("ac_frame_plot", "ac_line_plot"):
                want = np.asarray(getattr(jo, f))[c]
                np.testing.assert_allclose(_np(getattr(to, f))[c], want, rtol=0,
                                           atol=AC_RTOL * np.abs(want).max())
        seen["rounds"] += int(pv.sum())
        seen["frames"] += int(np.asarray(jo.frame_valid).sum())
    return seen


@pytest.mark.parametrize("demod_mode", ["per-channel", "stacked"])
@pytest.mark.parametrize("cond_mode", ["batched", "unrolled"])
@pytest.mark.parametrize("with_drop", [False, True])
def test_hybrid_matches_jax(cond_mode, demod_mode, with_drop):
    """The hybrid step in each cond_mode and demod_mode, with and without a
    drop that desynchronises channel 1's ring fill and frame cadence (the
    per-channel ring writes), against the JAX hybrid step
    (tests/test_parallel.py:413-463)."""
    jcfg, tcfg = _configs()
    kw = dict(cond_mode=cond_mode, demod_mode=demod_mode)
    jstep = jax.jit(jpipe.make_channels_step_hybrid(jcfg, JParams(), C, **kw))
    tstep = tpipe.make_channels_step_hybrid(tcfg, Params(), C, device="cpu", **kw)
    seen = compare(jstep, tstep, j_stack_states(jcfg, C), stack_states(tcfg, C, device="cpu"),
                   _blocks(20, 8192, 50), drop_at=5 if with_drop else None, motionblur=0.3)
    assert seen["rounds"] > 0 and seen["frames"] >= 3 * C


def test_hybrid_fused_matches_jax(interpret_pallas):
    """resampler="fused": per-channel demod, K2 per channel (its plain
    version here; the TPU kernel in interpret mode on the JAX side)."""
    jcfg, tcfg = _configs()
    jstep = jax.jit(jpipe.make_channels_step_hybrid(jcfg, JParams(resampler="fused"), C,
                                                 demod_mode="stacked"))
    tstep = tpipe.make_channels_step_hybrid(tcfg, Params(resampler="fused"), C,
                                            demod_mode="stacked", device="cpu")
    assert not tstep.stacked_demod
    seen = compare(jstep, tstep, j_stack_states(jcfg, C), stack_states(tcfg, C, device="cpu"),
                   _blocks(12, 8192, 60), drop_at=4, frame_atol=K1_FRAME_ATOL)
    assert seen["frames"] >= 2 * C


@pytest.mark.parametrize("form", ["unrolled", "gated", "multi"])
@pytest.mark.parametrize("autocorr", [True, False])
def test_channel_forms_match_jax(form, autocorr):
    """make_channels_step_unrolled, make_channels_step (any()-gated in the
    reference) and make_multi_step (vmap(step(batched=True)) there) against
    their JAX counterparts, with a drop desynchronising channel 1
    (tests/test_parallel.py:326-411)."""
    jcfg, tcfg = _configs(autocorr=autocorr)
    jmake = dict(unrolled=lambda: jpipe.make_channels_step_unrolled(jcfg, JParams(), C),
                 gated=lambda: jpipe.make_channels_step(jcfg, JParams(), C),
                 multi=lambda: jpipe.make_multi_step(jcfg, JParams()))[form]
    tmake = dict(unrolled=lambda: tpipe.make_channels_step_unrolled(tcfg, Params(), C, "cpu"),
                 gated=lambda: tpipe.make_channels_step(tcfg, Params(), C, device="cpu"),
                 multi=lambda: tpipe.make_multi_step(tcfg, Params(), device="cpu"))[form]
    seen = compare(jax.jit(jmake()), tmake(), j_stack_states(jcfg, C),
                   stack_states(tcfg, C, device="cpu"), _blocks(16, 8192, 30), drop_at=5)
    assert seen["frames"] >= 2 * C and (seen["rounds"] > 0) == autocorr


def test_gated_step_takes_channel_count_from_raws():
    """make_channels_step(config, params) with n_channels=0, as the JAX
    package's (its vmap reads the count from the inputs)."""
    jcfg, tcfg = _configs(autocorr=False)
    seen = compare(jax.jit(jpipe.make_channels_step(jcfg, JParams())),
                   tpipe.make_channels_step(tcfg, Params(), device="cpu"),
                   j_stack_states(jcfg, C), stack_states(tcfg, C, device="cpu"),
                   _blocks(6, 8192, 30))
    assert seen["frames"] >= C


def test_hybrid_multiframe_matches_jax_and_single_channel():
    """K > 1 (49152-sample blocks, K == 3) through the hybrid step: against
    the JAX hybrid step block by block, and each channel's frame stream equal
    to its own single-channel run (tests/test_multiframe.py:166-194)."""
    jcfg, tcfg = _configs(BIG, autocorr=False)
    assert tcfg.frames_per_block == 3
    params = dict(framerate_pll=False)
    blocks = _blocks(6, BIG, 40)
    jstep = jax.jit(jpipe.make_channels_step_hybrid(jcfg, JParams(**params), C))
    tstep = tpipe.make_channels_step_hybrid(tcfg, Params(**params), C, device="cpu")
    tstates = stack_states(tcfg, C, device="cpu")
    compare(jstep, tstep, j_stack_states(jcfg, C), tstates, blocks)
    # the port's hybrid against the port's single-channel step, frame for frame
    tstep = tpipe.make_channels_step_hybrid(tcfg, Params(**params), C, device="cpu")
    states = stack_states(tcfg, C, device="cpu")
    got = [[] for _ in range(C)]
    for raws in blocks:
        states, out = tstep(states, torch.from_numpy(raws))
        assert out.frame.shape == (C, 3, LINES, tcfg.width) and out.frame_valid.shape == (C, 3)
        for c, k in np.argwhere(out.frame_valid.numpy()):
            got[c].append(out.frame[c, k].numpy())
    one = make_step(tcfg, Params(**params), device="cpu")
    for c in range(C):
        s, single = init_state(tcfg, device="cpu"), []
        for raws in blocks:
            s, o = one(s, torch.from_numpy(raws[c]))
            single += [o.frame[k].numpy() for k in np.nonzero(o.frame_valid.numpy())[0]]
        assert len(single) == len(got[c]) >= len(blocks)
        for a, b in zip(single, got[c]):
            np.testing.assert_array_equal(a, b)
        assert int(states.frame_count[c]) == int(s.frame_count)


def test_multi_step_multiframe_matches_jax():
    """make_multi_step at K == 3 (49152-sample blocks): the bodies once over
    the channel axis at every emit slot, against the JAX vmap(step) block
    by block, a drop on channel 1 desynchronising its frame cadence."""
    jcfg, tcfg = _configs(BIG)
    assert tcfg.frames_per_block == 3
    seen = compare(jax.jit(jpipe.make_multi_step(jcfg, JParams())),
                   tpipe.make_multi_step(tcfg, Params(), device="cpu"), j_stack_states(jcfg, C),
                   stack_states(tcfg, C, device="cpu"), _blocks(6, BIG, 45), drop_at=2)
    assert seen["frames"] >= 6 * C and seen["rounds"] > 0


def test_batched_bodies_equal_unrolled_multiframe():
    """ChannelsStep(cond_mode="batched") at K == 3 (make_multi_step's form)
    equals cond_mode="unrolled" bit for bit in every output and state leaf,
    a drop on channel 1 included."""
    _, tcfg = _configs(BIG)
    assert tcfg.frames_per_block == 3
    steps = [tpipe.ChannelsStep(tcfg, Params(), C, "cpu", cond_mode=m)
             for m in ("batched", "unrolled")]
    states = [stack_states(tcfg, C, device="cpu") for _ in steps]
    frames = rounds = 0
    for b, raws in enumerate(_blocks(6, BIG, 45)):
        outs = []
        for i, step in enumerate(steps):
            states[i], out = step(states[i], torch.from_numpy(raws), _ctl(_drops(b, 2)))
            outs.append(out)
        for name, a, b2 in zip(tpipe.StepOutputs._fields, *outs):
            assert a.dtype == b2.dtype and torch.equal(a, b2), (b, name)
        for a, b2 in zip(state_leaves(states[0]), state_leaves(states[1])):
            assert torch.equal(a, b2), b
        frames += int(outs[0].frame_valid.sum())
        rounds += int(outs[0].ac_plot_valid.sum())
    assert frames >= 6 * C and rounds > 0


@pytest.mark.parametrize("with_drop", [False, True])
def test_stacked_demod_bit_identical(with_drop):
    """demod_mode="stacked" gives, bit for bit, every output and state leaf
    of per-channel demod (tests/test_parallel.py:466-503)."""
    _, tcfg = _configs()
    steps = [tpipe.make_channels_step_hybrid(tcfg, Params(), C, demod_mode=m, device="cpu")
             for m in ("per-channel", "stacked")]
    states = [stack_states(tcfg, C, device="cpu") for _ in steps]
    frames = 0
    for b, raws in enumerate(_blocks(16, 8192, 70)):
        ctrl = StepControls([0, 4444 if (with_drop and b == 4) else 0, 0], 0, 0.0)
        outs = []
        for i, step in enumerate(steps):
            states[i], out = step(states[i], torch.from_numpy(raws), ctrl)
            outs.append(out)
        for a, b2 in zip(*outs):
            assert torch.equal(a, b2)
        frames += int(outs[0].frame_valid.sum())
    assert frames > 0
    for a, b2 in zip(state_leaves(states[0]), state_leaves(states[1])):
        assert torch.equal(a, b2)


def test_batched_step_matches_jax():
    """make_step(batched=True): the JAX batched step's outputs, over one
    channel with a drop and a sync shift. The flag exists for the JAX
    package's vmap and changes nothing in the port: every resampler choice
    picks what the plain step picks (K1 for "auto", K2 for "fused")."""
    jcfg, tcfg = _configs()
    for choice in ("auto", "pallas_strided", "fused", "pallas", "strided"):
        step = make_step(tcfg, Params(resampler=choice), device="cpu", batched=True)
        plain = make_step(tcfg, Params(resampler=choice), device="cpu")
        assert (step.resample, step.fused) == (plain.resample, plain.fused), choice
    step = make_step(tcfg, Params(resampler="fused"), device="cpu", batched=True)
    assert step.fused
    assert make_step(tcfg, Params(), device="cpu", batched=True).resample \
        is tpipe.box_resample_strided_cuda
    jstep = jax.jit(j_make_step(jcfg, JParams(), batched=True))
    tstep = make_step(tcfg, Params(), device="cpu", batched=True)
    js, ts = j_init_state(jcfg), init_state(tcfg, device="cpu")
    for b, raws in enumerate(_blocks(12, 8192, 80)):
        dropped, sync = {3: (3000, 0), 6: (0, 777)}.get(b, (0, 0))
        js, jo = jstep(js, jnp.asarray(raws[0]),
                       JControls(jnp.int64(dropped), jnp.int32(sync), jnp.float32(0.2)))
        ts, to = tstep(ts, torch.from_numpy(raws[0]), StepControls(dropped, sync, 0.2))
        for f in EXACT:
            np.testing.assert_array_equal(_np(getattr(to, f)), np.asarray(getattr(jo, f)))
        for f in CARRIES:
            assert int(getattr(ts, f)) == int(getattr(js, f)), (b, f)
        np.testing.assert_allclose(_np(to.frame), np.asarray(jo.frame), rtol=FRAME_RTOL,
                                   atol=FRAME_ATOL)


@pytest.mark.parametrize("block", [8192, BIG])
def test_scan_runner_matches_jax(block):
    """make_scan_runner: K blocks in one call, outputs stacked over the
    blocks as lax.scan stacks them, the same controls every block."""
    jcfg, tcfg = _configs(block)
    n = 4 if block == BIG else 10
    raws = np.stack([b[0] for b in _blocks(n, block, 90)])
    js, jo = jax.jit(jpipe.make_scan_runner(jcfg, JParams(), n))(
        j_init_state(jcfg), jnp.asarray(raws),
        JControls(jnp.int64(0), jnp.int32(0), jnp.float32(0.1)))
    ts, to = tpipe.make_scan_runner(tcfg, Params(), n, device="cpu")(
        init_state(tcfg, device="cpu"), torch.from_numpy(raws), StepControls(0, 0, 0.1))
    for f in EXACT:
        np.testing.assert_array_equal(_np(getattr(to, f)), np.asarray(getattr(jo, f)), err_msg=f)
    for f in CARRIES:
        assert int(getattr(ts, f)) == int(getattr(js, f)), f
    assert to.frame.shape == jo.frame.shape and int(np.asarray(jo.frame_valid).sum()) >= 2
    np.testing.assert_allclose(_np(to.frame), np.asarray(jo.frame), rtol=FRAME_RTOL,
                               atol=FRAME_ATOL)
    with pytest.raises(ValueError, match="blocks"):
        tpipe.make_scan_runner(tcfg, Params(), n + 1, device="cpu")(
            init_state(tcfg, device="cpu"), torch.from_numpy(raws))


@pytest.mark.parametrize("case", ["gated-multiframe", "batched-multiframe", "cond_mode",
                                  "demod_mode"])
def test_channel_steps_raise_as_jax(case):
    """The ValueErrors of the JAX channel steps (tests/test_multiframe.py:
    197-205 and the argument checks), raised by both packages."""
    make = {
        "gated-multiframe": lambda pipe, cfg, p: pipe.make_channels_step(cfg, p, 2),
        "batched-multiframe": lambda pipe, cfg, p: pipe.make_channels_step_hybrid(
            cfg, p, 2, cond_mode="batched"),
        "cond_mode": lambda pipe, cfg, p: pipe.make_channels_step_hybrid(
            cfg, p, 2, cond_mode="vmapped"),
        "demod_mode": lambda pipe, cfg, p: pipe.make_channels_step_hybrid(
            cfg, p, 2, demod_mode="fused"),
    }[case]
    jcfg, tcfg = _configs(BIG if "multiframe" in case else 8192)
    with pytest.raises(ValueError) as jerr:
        make(jpipe, jcfg, JParams())
    with pytest.raises(ValueError) as terr:
        make(tpipe, tcfg, Params())
    assert str(terr.value) == str(jerr.value)


def test_stack_states_rows_own_their_memory():
    """stack_states: the JAX stacked state's leaf shapes and dtypes, zeros
    like it, and rows that do not share memory (the step writes the fold
    buffer and ring in place through a row)."""
    jcfg, tcfg = _configs()
    tl = state_leaves(stack_states(tcfg, C, fir_ntaps=15, device="cpu"))
    jl = jax.tree.leaves(j_stack_states(jcfg, C, fir_ntaps=15))
    assert [(tuple(x.shape), x.numpy().dtype) for x in tl] == [
        (np.asarray(x).shape, np.asarray(x).dtype) for x in jl]
    assert all(np.array_equal(x.numpy(), np.asarray(y)) for x, y in zip(tl, jl))
    for x in tl:
        assert x.is_contiguous() and 0 not in x.stride()[:1]
        x[0].fill_(7)
        assert not (x[1] == 7).any()


def _ctl(dropped, motionblur=0.3):
    """Per-channel controls as [C] tensors, made before a guarded block (a
    tensor made from host values is a host -> device copy on a card, which
    the guard refuses, as a graph capture does)."""
    return StepControls(torch.tensor(dropped, dtype=torch.int64), torch.zeros(C, dtype=torch.int32),
                        torch.full((C,), motionblur))


def hold_guarded_against_jax(jstep, tstep, blocks, drop_at=5):
    """Every block of the port's channel step run with every host read
    made to raise (tests/torch_host_guard.py), channel 1 dropping samples
    at drop_at; the integer outputs equal the JAX step's, and from the drop
    on every channel's autocorrelation ring equals the JAX ring row by row.
    Returns the frames and rounds seen."""
    jcfg, tcfg = _configs()
    jstates, tstates = j_stack_states(jcfg, C), stack_states(tcfg, C, device="cpu")
    frames = rounds = 0
    for b, raws in enumerate(blocks):
        dropped = _drops(b, drop_at)
        ctl, raw = _ctl(dropped), torch.from_numpy(raws)
        with no_host_reads():
            tstates, out = tstep(tstates, raw, ctl)
        jstates, jo = jstep(jstates, jnp.asarray(raws),
                            JControls(jnp.asarray(dropped, jnp.int64), jnp.zeros((C,), jnp.int32),
                                      jnp.full((C,), 0.3, jnp.float32)))
        for f in EXACT:
            np.testing.assert_array_equal(_np(getattr(out, f)), np.asarray(getattr(jo, f)),
                                          err_msg=f"block {b} {f}")
        if b >= drop_at:
            for c in range(C):
                np.testing.assert_array_equal(_np(tstates.ac_buf[c]), np.asarray(jstates.ac_buf[c]),
                                              err_msg=f"block {b} ring {c}")
        frames += int(out.frame_valid.sum())
        rounds += int(out.ac_plot_valid.sum())
    return frames, rounds


def test_hybrid_fetches_once_per_block(interpret_pallas):
    """The hybrid step reads nothing to the host inside a block (what the
    CUDA-graph capture of MultiSession's block needs), in both cond modes,
    both demod modes and with resampler="fused" (K2 per channel), on blocks
    with frames, rounds and a drop that desynchronises channel 1's ring
    fill (the 2-D ring write at per-channel offsets); the ring after the
    drop equals the JAX ring row by row."""
    jcfg, tcfg = _configs()
    blocks = _blocks(20, 8192, 50)
    for kw, fields in ((dict(cond_mode="unrolled"), {}), (dict(cond_mode="batched"), {}),
                       (dict(demod_mode="stacked"), {}),
                       (dict(cond_mode="batched", demod_mode="stacked"), {}),
                       ({}, dict(resampler="fused"))):
        jstep = jax.jit(jpipe.make_channels_step_hybrid(jcfg, JParams(**fields), C, **kw))
        tstep = tpipe.make_channels_step_hybrid(tcfg, Params(**fields), C, device="cpu", **kw)
        frames, rounds = hold_guarded_against_jax(jstep, tstep, blocks)
        assert frames >= 3 * C and rounds > 0, (kw, fields)


@pytest.mark.parametrize("form", ["unrolled", "gated", "multi"])
def test_channel_forms_fetch_once_per_block(form):
    """The unrolled (the bodies per channel), gated and multi (the bodies
    once over the channel axis) forms read nothing to the host inside a
    block, a drop included, and their rings equal the JAX ones."""
    jcfg, tcfg = _configs()
    step = dict(unrolled=lambda: tpipe.make_channels_step_unrolled(tcfg, Params(), C, "cpu"),
                gated=lambda: tpipe.make_channels_step(tcfg, Params(), C, device="cpu"),
                multi=lambda: tpipe.make_multi_step(tcfg, Params(), device="cpu"))[form]()
    jstep = dict(unrolled=lambda: jpipe.make_channels_step_unrolled(jcfg, JParams(), C),
                 gated=lambda: jpipe.make_channels_step(jcfg, JParams(), C),
                 multi=lambda: jpipe.make_multi_step(jcfg, JParams()))[form]()
    assert step.cond_mode == ("unrolled" if form == "unrolled" else "batched")
    frames, rounds = hold_guarded_against_jax(jax.jit(jstep), step, _blocks(12, 8192, 50))
    assert frames >= 2 * C and rounds > 0


@pytest.mark.parametrize("fields", [{}, dict(autoshift=True),
                                    dict(debug_markers=True, autogain_after_proc=True),
                                    dict(lowpass_before_sync=True, fast_sync=True)],
                         ids=["default", "autoshift", "markers-autogain-after", "lowpass-first"])
def test_batched_bodies_equal_unrolled_with_fewer_operations(fields):
    """cond_mode="batched" runs the round and emit bodies once over the
    channel axis: at one frame per block, every output and state leaf equals
    cond_mode="unrolled"'s bit for bit (a drop on channel 1 included), and
    a block dispatches fewer operations at C = 3."""
    _, tcfg = _configs()
    assert tcfg.frames_per_block == 1
    steps = [tpipe.make_channels_step_hybrid(tcfg, Params(**fields), C, cond_mode=m, device="cpu")
             for m in ("batched", "unrolled")]
    states = [stack_states(tcfg, C, device="cpu") for _ in steps]
    ops = [0, 0]
    frames = rounds = 0
    for b, raws in enumerate(_blocks(14, 8192, 20)):
        outs = []
        for i, step in enumerate(steps):
            with CountOps() as count:
                states[i], out = step(states[i], torch.from_numpy(raws), _ctl(_drops(b, 5)))
            ops[i] += count.n
            outs.append(out)
        for name, a, b2 in zip(tpipe.StepOutputs._fields, *outs):
            assert a.dtype == b2.dtype and torch.equal(a, b2), (b, name)
        for a, b2 in zip(state_leaves(states[0]), state_leaves(states[1])):
            assert torch.equal(a, b2), b
        frames += int(outs[0].frame_valid.sum())
        rounds += int(outs[0].ac_plot_valid.sum())
    assert frames >= 3 * C and rounds > 0
    assert ops[0] < ops[1], ops
    print(f"operations in 14 blocks, batched / unrolled: {ops[0]} / {ops[1]}")


def test_channel_runner_matches_the_jax_multisession_step():
    """The channel runner (MultiSession's: one block of C channels a call, a
    graph replay on the card, the step eagerly here) against the JAX
    MultiSession's jitted hybrid step (donated state) over 14 blocks, a drop
    in channel 1; its packed values are the outputs'."""
    from tempestsdr_tpu_torch.stream.graph import PACKED, ChannelRunner

    jcfg, tcfg = _configs()
    jstep = jax.jit(jpipe.make_channels_step_hybrid(jcfg, JParams(), C), donate_argnums=0)
    runner = ChannelRunner(tcfg, Params(), C, "cpu")
    packs = []

    def tstep(states, raws, ctrl):
        states, out, packed = runner.run(states, raws, np.array(ctrl, np.float64).T)
        rows = packed.tolist()
        for c, row in enumerate(rows):
            vals = dict(zip(PACKED, row))
            assert vals["ac_calls"] == int(out.ac_calls[c])
            assert vals["ac_plot_valid"] == bool(out.ac_plot_valid[c])
            assert vals["refreshrate"] == float(out.refreshrate[c])
            assert row[len(PACKED)] == bool(out.frame_valid[c])
        packs.append(packed.shape)
        return states, out

    seen = compare(jstep, tstep, j_stack_states(jcfg, C), stack_states(tcfg, C, device="cpu"),
                   _blocks(14, 8192, 50), drop_at=5, motionblur=0.3)
    assert seen["frames"] >= 3 * C and seen["rounds"] > 0
    assert set(packs) == {(C, len(PACKED) + 1)}


def test_sync_states_default_to_the_card(monkeypatch):
    """SweetspotState.init and PLLState.init, public through ops, default to
    the card as every entry point does: without CUDA they raise, and with
    device="cpu" they make CPU tensors."""
    from tempestsdr_tpu_torch.ops import PLLState, SweetspotState

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for init in (SweetspotState.init, PLLState.init):
        with pytest.raises(RuntimeError, match="CUDA"):
            init()
        assert {x.device.type for x in init("cpu")} == {"cpu"}


def test_channel_entry_points_default_to_the_card(monkeypatch):
    """With no CUDA device and no device="cpu", the new entry points raise
    instead of carrying on on the CPU."""
    from tempestsdr_tpu_torch.sources.synthetic import SyntheticSource
    from tempestsdr_tpu_torch.stream import MultiSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs()
    src = SyntheticSource()
    src.init(f"{LINES} {TWIDTH} {REFRESH} {SR}")
    for make in (lambda: stack_states(tcfg, C),
                 lambda: tpipe.make_channels_step_hybrid(tcfg, Params(), C),
                 lambda: tpipe.make_channels_step_unrolled(tcfg, Params(), C),
                 lambda: tpipe.make_channels_step(tcfg, Params(), C),
                 lambda: tpipe.make_multi_step(tcfg, Params()),
                 lambda: tpipe.make_scan_runner(tcfg, Params(), 4),
                 lambda: make_step(tcfg, Params(), batched=True),
                 lambda: MultiSession(tcfg, Params(), [src])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
