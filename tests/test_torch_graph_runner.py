"""The port's block runner (stream.graph.BlockRunner: K device steps a
call, one CUDA-graph replay on the card, a loop on the CPU), make_scan_runner
and Session's batch path on the CPU, the device step at K == 4 and with
every host read made to raise, and the runner's upload: its rows staged
through a host buffer (a plain one here, pinned on the card) and
UploadStats; helpers and scenarios in tests/test_torch_device_step.py."""

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
from tempestsdr_tpu_torch.stream.graph import (
    PACKED,
    BlockRunner,
    UploadStats,
    _rows,
    _stage,
    host_controls,
)
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


STAGE_DTYPES = [np.uint8, np.int8, np.int16, np.float32]


def _raw_rows(k, n2, dtype, seed):
    """k rows of n2 raw samples of `dtype` spread over the dtype's range."""
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, size=(k, n2), endpoint=True).astype(dtype)
    return rng.standard_normal((k, n2)).astype(dtype)


@pytest.mark.parametrize("dtype", STAGE_DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("form", ["list", "view", "ndarray", "tensor"])
def test_staged_rows_land_row_for_row(form, dtype):
    """The runner's staging (stream.graph._rows, _stage) with a plain host
    buffer in the pinned one's place: a list of 4 blocks, one block given as
    a view into a longer looped stream (as the benchmark's premade source
    yields them), a [4, 2n] array and a [4, 2n] tensor each land row for row
    in the host buffer and in the destination, in their own dtype, and the
    caller's rows are left as they were."""
    n2 = 96
    want = _raw_rows(1 if form == "view" else 4, n2, dtype, seed=len(form))
    if form == "list":
        raws = list(want.copy())
    elif form == "view":
        looped = np.concatenate([_raw_rows(1, 40, dtype, 9)[0], want[0], want[0][:8]])
        raws = [looped[40:40 + n2]]
        assert raws[0].base is looped
    elif form == "ndarray":
        raws = want.copy()
    else:
        raws = torch.from_numpy(want.copy())
    rows = _rows(raws, len(want), "blocks")
    tdtype = torch.from_numpy(want).dtype
    assert all(row.dtype == tdtype and row.shape == (n2,) for row in rows)
    host = torch.zeros(want.shape, dtype=tdtype)
    dst = torch.zeros(want.shape, dtype=tdtype)
    assert _stage(rows, host, dst) is True
    for got in (host, dst):
        assert got.dtype == tdtype and got.numpy().tobytes() == want.tobytes()
    again = np.stack([np.asarray(r) for r in raws])
    assert again.dtype == want.dtype and again.tobytes() == want.tobytes()


def test_staged_controls_land_as_one_row():
    """The controls go through their own host buffer as one [K, 3] row, as
    the runner stages them, exact in float64."""
    ctl = torch.as_tensor(host_controls([3, 0, 11, 2], 5, 0.25), dtype=torch.float64)
    host, dst = torch.zeros(4, 3, dtype=torch.float64), torch.zeros(4, 3, dtype=torch.float64)
    assert _stage([ctl], [host], [dst]) is True
    assert torch.equal(host, ctl) and torch.equal(dst, ctl)


@pytest.mark.parametrize("case,raws,controls,message", [
    ("one block, no leading axis", np.zeros(64, np.uint8), np.zeros((2, 3)),
     "(64,) blocks, the runner takes [2, 2n]"),
    ("a list of 3 blocks", [np.zeros(64, np.uint8)] * 3, np.zeros((2, 3)),
     "(3, 64) blocks, the runner takes [2, 2n]"),
    ("a list of one block", [np.zeros(64, np.uint8)], np.zeros((2, 3)),
     "(1, 64) blocks, the runner takes [2, 2n]"),
    ("an array of 3 blocks", np.zeros((3, 64), np.int16), np.zeros((2, 3)),
     "(3, 64) blocks, the runner takes [2, 2n]"),
    ("a tensor of one block", torch.zeros(1, 64), np.zeros((2, 3)),
     "(1, 64) blocks, the runner takes [2, 2n]"),
    ("a stack of stacks", np.zeros((2, 4, 16), np.uint8), np.zeros((2, 3)),
     "(2, 4, 16) blocks, the runner takes [2, 2n]"),
    ("controls of one block", np.zeros((2, 64), np.uint8), np.zeros((1, 3)),
     "controls (1, 3), the runner takes [2, 3]"),
    ("controls of 4 numbers", np.zeros((2, 64), np.uint8), np.zeros((2, 4)),
     "controls (2, 4), the runner takes [2, 3]"),
])
def test_runner_refuses_shapes_in_the_same_words(case, raws, controls, message):
    """The runner's shape and controls errors keep their wording (the shape
    of a list named as its stack's) and count no upload."""
    _, tcfg = _configs(K1_BLOCK)
    runner = BlockRunner(tcfg, Params(), 2, device="cpu")
    state = init_state(tcfg, device="cpu")
    with pytest.raises(ValueError) as err:
        runner.run(state, raws, controls)
    assert str(err.value) == message, case
    assert runner.upload_stats == UploadStats()


def test_ragged_blocks_are_refused_as_the_stack_refused_them():
    """A list of blocks of different lengths raises numpy's stack error."""
    _, tcfg = _configs(K1_BLOCK)
    runner = BlockRunner(tcfg, Params(), 2, device="cpu")
    with pytest.raises(ValueError, match="all input arrays must have the same shape"):
        runner.run(init_state(tcfg, device="cpu"),
                   [np.zeros(64, np.uint8), np.zeros(32, np.uint8)], np.zeros((2, 3)))


def test_upload_stats_count_on_the_cpu():
    """UploadStats on the CPU: every call of the runner an upload, its bytes
    those of its raws and controls, none staged (no pinned buffer), no
    wait; Session and MultiSession read their runner's stats."""
    from dataclasses import replace

    from tempestsdr_tpu_torch.sources.synthetic import SyntheticSource
    from tempestsdr_tpu_torch.stream.multisession import MultiSession
    from tempestsdr_tpu_torch.stream.session import Session

    _, tcfg = _configs(K1_BLOCK)
    runner = BlockRunner(tcfg, Params(), 2, device="cpu")
    state = init_state(tcfg, device="cpu")
    blocks = _blocks(4, K1_BLOCK)
    state, _, _ = runner.run(state, blocks[:2], host_controls([0, 0], 0, 0.0))
    state, _, _ = runner.run(state, np.stack(blocks[2:]), host_controls([0, 0], 0, 0.0))
    per_call = 2 * 2 * K1_BLOCK + 2 * 3 * 8
    assert runner.upload_stats == UploadStats(uploads=2, bytes=2 * per_call, staged=0, waits=0)
    assert runner.upload_stats.staged_share == 0.0

    def source():
        src = SyntheticSource()
        src.init(f"{LINES} {TWIDTH} {REFRESH} {SR} 0.01")
        return src

    sess = Session(tcfg, Params(), source(), batch_blocks=2, device="cpu")
    before = replace(sess.upload_stats)
    sess.run(max_blocks=6)
    assert sess.upload_stats is sess._runner.upload_stats
    got = sess.upload_stats
    raw_bytes = 2 * K1_BLOCK * np.dtype(source().block_dtype()).itemsize
    per_call = 2 * raw_bytes + 2 * 3 * 8
    assert (got.uploads - before.uploads, got.bytes - before.bytes) == (3, 3 * per_call)
    assert (got.staged, got.waits) == (before.staged, before.waits) == (0, 0)

    multi = MultiSession(tcfg, Params(), [source(), source(), source()], device="cpu")
    before = replace(multi.upload_stats)
    multi.run(max_blocks=2)
    got = multi.upload_stats
    assert got is multi._runner.upload_stats
    per_call = 3 * raw_bytes + 3 * 3 * 8
    assert (got.uploads - before.uploads, got.bytes - before.bytes) == (2, 2 * per_call)
    assert (got.staged, got.waits) == (0, 0)
