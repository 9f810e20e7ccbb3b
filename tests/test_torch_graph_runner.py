"""The port's block runner (stream.graph.BlockRunner: K device steps a
call, one CUDA-graph replay on the card, a loop on the CPU), make_scan_runner
and Session's batch path on the CPU, and the device step at K == 4 and with
every host read made to raise; helpers and scenarios in
tests/test_torch_device_step.py."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tempestsdr_tpu.params import Params as JParams
from tempestsdr_tpu.stream import init_state as j_init_state
from tempestsdr_tpu.stream import pipeline as jpipe
from tempestsdr_tpu.stream.pipeline import StepControls as JControls
from tempestsdr_tpu.stream.session import _build_step_fns as j_build_step_fns

from tempestsdr_tpu_torch.params import Params
from tempestsdr_tpu_torch.stream import init_state, make_step
from tempestsdr_tpu_torch.stream import pipeline as tpipe
from tempestsdr_tpu_torch.stream.graph import PACKED, BlockRunner, host_controls
from tempestsdr_tpu_torch.stream.pipeline import StepControls
from tempestsdr_tpu_torch.stream.state import state_leaves

from torch_host_guard import no_host_reads
from test_torch_device_step import (  # noqa: F401 (the fixtures)
    CARRIES,
    EXACT,
    FRAME_RTOL,
    K1_BLOCK,
    K1_PATH_ATOL,
    K4_BLOCK,
    K4_SCENARIOS,
    LINES,
    REFRESH,
    SCENARIOS,
    SR,
    TWIDTH,
    _assert_same_outputs,
    _blocks,
    _configs,
    _np,
    hold_against_jax_and_runner,
    interpret_pallas,
    one_torch_thread,
    rounds_expected,
)


@pytest.mark.parametrize("name", K4_SCENARIOS)
def test_device_step_matches_jax_and_the_host_step_k4(interpret_pallas, name):
    """hold_against_jax_and_runner at K == 4 (the multi-emit slots)."""
    hold_against_jax_and_runner(4, name)


def test_runner_matches_the_jax_scan():
    """BlockRunner (the session's batch path; a loop on the CPU) over two
    batches of 4 blocks against the JAX Session's lax.scan of the step, with
    drops in slots 1 and 3, the sync shift in slot 0: outputs stacked as the
    scan stacks them, integers and carries exact, frames within 2e-5; and
    the packed values are the stacked outputs'. Drops just short of the
    two-frame granularity (33333 samples here) skip a few hundred samples."""
    n = 4
    jcfg, tcfg = _configs(K1_BLOCK)
    _, jscan = j_build_step_fns(jcfg, JParams(), n)
    runner = BlockRunner(tcfg, Params(), n, "cpu")
    js, ts = j_init_state(jcfg), init_state(tcfg, device="cpu")
    batches = (([0, 33000, 0, 32000], 700), ([0, 0, 33100, 0], -55), ([0, 0, 0, 0], 0))
    blocks = np.stack(_blocks(len(batches) * n, K1_BLOCK, seed=40))
    for batch, (dropped, sync) in enumerate(batches):
        raws = blocks[batch * n:(batch + 1) * n]
        js, jo = jscan(js, jnp.asarray(raws), jnp.asarray(dropped, jnp.int64),
                       jnp.asarray([sync, 0, 0, 0], jnp.int32), jnp.float32(0.2))
        ts, to, packed = runner.run(ts, raws, host_controls(dropped, sync, 0.2))
        for f in EXACT:
            np.testing.assert_array_equal(_np(getattr(to, f)), np.asarray(getattr(jo, f)), f)
        for f in CARRIES:
            assert int(getattr(ts, f)) == int(getattr(js, f)), (batch, f)
        np.testing.assert_allclose(_np(to.frame), np.asarray(jo.frame), rtol=FRAME_RTOL,
                                   atol=K1_PATH_ATOL)
        rows = packed.tolist()
        for i, row in enumerate(rows):
            vals = dict(zip(PACKED, row))
            assert vals["ac_calls"] == int(to.ac_calls[i])
            assert vals["ac_plot_valid"] == bool(to.ac_plot_valid[i])
            assert vals["refreshrate"] == float(to.refreshrate[i])
            assert row[len(PACKED)] == bool(to.frame_valid[i])
    assert int(ts.frame_count) >= 2


def test_make_scan_runner_matches_jax_with_a_drop_every_block():
    """make_scan_runner takes one controls for every block, as the JAX
    one does: n = 4 blocks, each with a drop of 500 samples."""
    n = 4
    jcfg, tcfg = _configs(K1_BLOCK)
    raws = np.stack(_blocks(n, K1_BLOCK, seed=60))
    js, jo = jax.jit(jpipe.make_scan_runner(jcfg, JParams(), n))(
        j_init_state(jcfg), jnp.asarray(raws),
        JControls(jnp.int64(500), jnp.int32(0), jnp.float32(0.1)))
    ts, to = tpipe.make_scan_runner(tcfg, Params(), n, device="cpu")(
        init_state(tcfg, device="cpu"), torch.from_numpy(raws), StepControls(500, 0, 0.1))
    for f in EXACT:
        np.testing.assert_array_equal(_np(getattr(to, f)), np.asarray(getattr(jo, f)), f)
    for f in CARRIES:
        assert int(getattr(ts, f)) == int(getattr(js, f)), f
    np.testing.assert_allclose(_np(to.frame), np.asarray(jo.frame), rtol=FRAME_RTOL,
                               atol=K1_PATH_ATOL)


# ---- no host read inside a block ---------------------------------------------

@pytest.mark.parametrize("k,name", [(1, n) for n in SCENARIOS] + [(4, n) for n in K4_SCENARIOS])
def test_device_step_reads_nothing_to_the_host(k, name):
    """One device step per block over blocks with a drop, the blocks it
    skips, a sync shift, an autocorrelation round and emits, then one runner
    batch, each with every host read made to raise; the outputs are those
    of the same blocks stepped unguarded."""
    fields, _ = SCENARIOS[name]
    block = K1_BLOCK if k == 1 else K4_BLOCK
    _, tcfg = _configs(block)
    params = Params(**fields)
    step = make_step(tcfg, params, device="cpu")
    raws = [torch.from_numpy(r) for r in _blocks(9 if k == 1 else 3, block, seed=7)]
    # K == 1: a round at block 6, the drop at 7 (7 to 9 skipped); K == 4: a
    # round at block 1, the drop at 2
    events = {7: (1000, 0), 3: (0, 321)} if k == 1 else {2: (5000, -40)}
    guarded = init_state(tcfg, params.fir_lowpass_taps, device="cpu")
    free = init_state(tcfg, params.fir_lowpass_taps, device="cpu")
    rounds = 0
    for b, raw in enumerate(raws):
        ctl = StepControls(*events.get(b, (0, 0)), 0.4)
        with no_host_reads():
            guarded, out = step(guarded, raw, ctl)
        free, want = step(free, raw, ctl)
        _assert_same_outputs(out, want, b)
        rounds += int(out.ac_plot_valid)
    assert rounds >= rounds_expected(fields)
    runner = BlockRunner(tcfg, params, 2, "cpu")
    controls = torch.tensor([[7.0, 3.0, 0.4], [0.0, 0.0, 0.4]], dtype=torch.float64)
    with no_host_reads():
        guarded, out, packed = runner.run(guarded, torch.stack(raws[:2]), controls)
    assert packed.shape == (2, len(PACKED) + k)
    assert len(state_leaves(guarded)) == len(state_leaves(free))


def test_the_guard_catches_host_reads():
    """The guard above refuses each kind of host read it names, and a
    Python value written into a tensor."""
    t = torch.arange(4)
    for read in (lambda: t[0].item(), lambda: t.tolist(), lambda: bool(t[1]),
                 lambda: int(t[1]), lambda: float(t[1]), lambda: range(t[2]),
                 lambda: t[torch.tensor(1)], lambda: t[t > 1], lambda: t.__setitem__(0, 5)):
        with pytest.raises(AssertionError, match="host read"):
            with no_host_reads():
                read()


@pytest.mark.parametrize("batch", [1, 4])
def test_session_fetches_once_per_batch(monkeypatch, batch):
    """Session(batch_blocks=K) reads the device once a batch for its flags
    and small values (one .tolist() of the packed values), then downloads
    only what completed: the frames with one copy to the host a batch that
    emitted, the plots with one a batch that completed a round, and no
    .cpu(); download_stats counts the copies."""
    from tempestsdr_tpu_torch.sources.synthetic import SyntheticSource
    from tempestsdr_tpu_torch.stream import session as session_mod
    from tempestsdr_tpu_torch.stream.session import Session, SessionCallbacks

    _, tcfg = _configs(K1_BLOCK)
    src = SyntheticSource()
    src.init(f"{LINES} {TWIDTH} {REFRESH} {SR} 0.01")
    frames, plots = [], []
    sess = Session(tcfg, Params(), src, SessionCallbacks(on_frame=frames.append,
                                                         on_plot=plots.append),
                   batch_blocks=batch, device="cpu")
    calls = []
    for name in ("tolist", "cpu"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _n=name, _r=real, **k: (calls.append(_n),
                                                                      _r(self, *a, **k))[1])
    real_to_host = session_mod._to_host
    monkeypatch.setattr(session_mod, "_to_host",
                        lambda *a: (calls.append("to_host"), real_to_host(*a))[1])
    sess.run(max_blocks=16)
    monkeypatch.undo()
    assert calls.count("tolist") == 16 // batch and calls.count("cpu") == 0
    assert 1 <= calls.count("to_host") <= 2 * (16 // batch)
    assert sess.download_stats.downloads == calls.count("to_host")
    assert len(frames) >= 5 and len(plots) >= 2 and int(sess.state.frame_count) == len(frames)
