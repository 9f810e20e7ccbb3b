"""The node form of the port's branches, held on the CPU.

In a captured CUDA graph every branch of the step (stream.pipeline._cond:
the FFT round, each emit slot, the sync-skip shift; per channel, or gated
on any() over the channels) is a pair of IF nodes (kernels/graph_cond.py):
only the taken body runs, the untaken side writes into the taken body's
output buffers, and a body's in-place writes (the ring's leftover move, the
shifted pixels) happen only when it is taken. The nodes run only on a
card. Here a strategy (tests/torch_taken_only.py) puts a host `if` in the
branch seam (pipeline._branch) that does what the nodes do: the taken side alone, or,
when the branch is not taken, the untaken side written into output
buffers that the taken body would have allocated, poisoned first (NaN, or
a sentinel for integers and flags) so that any output the untaken side
fails to write shows. To make those buffers it runs the taken body on
copies of the operands, whose in-place writes land in the copies.

That form must equal the select form (every branch both sides, committed
by torch.where; the CPU's and the eager card step's form) bit for bit in
every output and state leaf, and the JAX package within the tolerances of
tests/test_torch_device_step.py and tests/test_torch_channels.py, over
blocks that take both sides of every branch: the single-channel step at a
K == 1 and a K == 3 geometry with drops and sync shifts, ChannelsStep
unrolled and batched (C = 3), and make_scan_runner. Also the pieces the
nodes are built from: the taken body's outputs made its own
(graph_cond._owned), the untaken side's write into them, the masked
in-place write of the select form, the node census's arithmetic on a
stubbed node list, and the refusal of a branch captured outside a
runner."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tempestsdr_tpu.parallel.channels import stack_states as j_stack_states
from tempestsdr_tpu.stream import init_state as j_init_state, make_step as j_make_step
from tempestsdr_tpu.stream import pipeline as jpipe
from tempestsdr_tpu.stream.pipeline import StepControls as JControls
from tempestsdr_tpu.params import Params as JParams

from tempestsdr_tpu_torch.kernels import graph_cond
from tempestsdr_tpu_torch.params import Params
from tempestsdr_tpu_torch.parallel import stack_states
from tempestsdr_tpu_torch.stream import init_state, make_step
from tempestsdr_tpu_torch.stream import pipeline as tpipe
from tempestsdr_tpu_torch.stream.pipeline import StepControls
from tempestsdr_tpu_torch.stream.state import state_leaves

import test_torch_channels as tch
from torch_taken_only import TakenOnly, taken_only
from test_torch_device_step import (  # noqa: F401 (one_torch_thread: autouse)
    AC_RTOL,
    CARRIES,
    EXACT,
    FRAME_RTOL,
    K1_PATH_ATOL,
    SCENARIOS,
    _assert_same_outputs,
    _blocks,
    _configs,
    interpret_pallas,
    motionblur,
    one_torch_thread,
)

BIG = 32768  # ~1.97 frames of 333 x 100 at 1 MS/s -> K == 3
EVENTS = {  # block -> (samples dropped, sync shift)
    8192: {3: (0, 777), 6: (3000, 0), 11: (0, -1234)},
    BIG: {1: (0, 500), 3: (5000, 0), 5: (0, -777)},
}
class Paired:
    """A step run twice on the same inputs, in the select form on states of
    its own and with the taken-only strategy on the states it is given; the
    two must agree bit for bit in every output and state leaf. Returns the
    taken-only form's states and outputs."""

    def __init__(self, make, states):
        self.select, self.taken = make(), make()
        self.states = states
        self.strategy = TakenOnly()
        self.blocks = 0

    def __call__(self, states, raws, controls):
        raws = torch.as_tensor(raws)
        self.states, want = self.select(self.states, raws.clone(), controls)
        with taken_only(self.strategy):
            states, got = self.taken(states, raws, controls)
        _assert_same_outputs(got, want, self.blocks)
        for a, b in zip(state_leaves(states), state_leaves(self.states)):
            assert a.dtype == b.dtype and torch.equal(a, b), self.blocks
        self.blocks += 1
        return states, got


# the post-process orders and sync flags (tests/test_torch_device_step.py's
# scenarios of those names): the taken-only form under each, on the step
# forms that run them
FLAG_SETS = ("autogain_after", "lowpass_first", "both", "fast_sync", "pll_off_plots_off",
             "everything")


def _flag_cases(*lead):
    """The default Params at each lead (ids as before), then each flag set
    at the first."""
    return [pytest.param(*x, "default", id="-".join(map(str, x))) for x in lead] + [
        pytest.param(*lead[0], name, id="-".join(map(str, lead[0] + (name,))))
        for name in FLAG_SETS]


def _branches(names, fields):
    """The branches a run takes both sides of: no round without the plots."""
    return {n for n in names if not (fields.get("autocorr_plots_off") and "round_body" in n)}


def _np(x):
    return x.detach().cpu().numpy()


@pytest.mark.parametrize("block,name", _flag_cases((8192,), (BIG,)) + [
    pytest.param(BIG, name, id=f"{BIG}-{name}") for name in ("both", "everything")])
def test_single_step_taken_only_equals_select_and_jax(interpret_pallas, block, name):
    """The single-channel device step with the taken-only strategy against
    its select form (bit for bit) and the JAX step (integers, carries and
    sync/PLL state exact, frames within the scenario's tolerance of their
    peak, plots within AC_RTOL), over drops and sync shifts: every branch
    takes both sides. Default Params, then each flag set (the post-process
    orders, fast_sync, the PLL and plots off, and all of them at once over
    K3 with FIR 31)."""
    fields, atol = SCENARIOS[name]
    mb = motionblur(name)
    jcfg, tcfg = _configs(block)
    k_frames = tcfg.frames_per_block
    assert k_frames == (1 if block == 8192 else 3)
    fir = fields.get("fir_lowpass_taps", 0)
    jstep = jax.jit(j_make_step(jcfg, JParams(**fields)))
    paired = Paired(lambda: make_step(tcfg, Params(**fields), device="cpu"),
                    init_state(tcfg, fir, device="cpu"))
    js, ts = j_init_state(jcfg, fir), init_state(tcfg, fir, device="cpu")
    frames = rounds = 0
    for b, raw in enumerate(_blocks(16 if block == 8192 else 8, block, seed=3)):
        dropped, sync = EVENTS[block].get(b, (0, 0))
        js, jo = jstep(js, jnp.asarray(raw),
                       JControls(jnp.int64(dropped), jnp.int32(sync), jnp.float32(mb)))
        ts, to = paired(ts, torch.from_numpy(raw), StepControls(dropped, sync, mb))
        for f in EXACT:
            np.testing.assert_array_equal(_np(getattr(to, f)), np.asarray(getattr(jo, f)),
                                          err_msg=f"block {b} {f}")
        for f in CARRIES:
            assert int(getattr(ts, f)) == int(getattr(js, f)), (b, f)
        for f in ("sync_x", "sync_y"):
            assert [int(v) for v in getattr(ts, f)] == [int(v) for v in getattr(js, f)], (b, f)
        want = np.asarray(jo.frame)
        np.testing.assert_allclose(_np(to.frame), want, rtol=FRAME_RTOL,
                                   atol=atol * max(1.0, float(np.abs(want).max())),
                                   err_msg=f"block {b}")
        if bool(jo.ac_plot_valid):
            for f in ("ac_frame_plot", "ac_line_plot"):
                w = np.asarray(getattr(jo, f))
                np.testing.assert_allclose(_np(getattr(to, f)), w, rtol=0,
                                           atol=AC_RTOL * np.abs(w).max())
            rounds += 1
        frames += int(np.sum(np.asarray(jo.frame_valid)))
    assert frames >= 4 and rounds >= (0 if fields.get("autocorr_plots_off") else 1)
    assert paired.strategy.seen == {n: {False, True} for n in _branches(
        ("round_body", "emit_fn", "shift"), fields)}


@pytest.mark.parametrize("cond_mode,block,name",
                         _flag_cases(("unrolled", 8192), ("unrolled", BIG), ("batched", 8192),
                                     ("batched", BIG))
                         + [pytest.param("batched", 8192, name, id=f"batched-8192-{name}")
                            for name in FLAG_SETS])
def test_channel_steps_taken_only_equal_select_and_jax(interpret_pallas, cond_mode, block, name):
    """ChannelsStep (C = 3) with the taken-only strategy against its select
    form, bit for bit, and the JAX step (integers and carries exact, frames
    within tests/test_torch_channels.py's FRAME_ATOL, the K3 path's within
    its own), a drop on channel 1 desynchronising its ring and frame
    cadence: unrolled (per channel, as the JAX hybrid step's real conds) and
    batched (gated on any(), the JAX gated forms: the hybrid step at K == 1,
    make_multi_step at K == 3); default Params, then each flag set at K ==
    1 in both modes."""
    fields, atol = SCENARIOS[name]
    jcfg, tcfg = tch._configs(block)
    C = tch.C
    jp, fir = JParams(**fields), fields.get("fir_lowpass_taps", 0)
    if block == 8192:
        jstep = jpipe.make_channels_step_hybrid(jcfg, jp, C, cond_mode=cond_mode)
    elif cond_mode == "unrolled":
        jstep = jpipe.make_channels_step_hybrid(jcfg, jp, C)
    else:
        jstep = jpipe.make_multi_step(jcfg, jp)
    paired = Paired(lambda: tpipe.ChannelsStep(tcfg, Params(**fields), C, "cpu",
                                               cond_mode=cond_mode),
                    stack_states(tcfg, C, fir, device="cpu"))
    n_blocks = 14 if block == 8192 else 6
    seen = tch.compare(jax.jit(jstep), paired, j_stack_states(jcfg, C, fir),
                       stack_states(tcfg, C, fir, device="cpu"), tch._blocks(n_blocks, block, 45),
                       drop_at=2, motionblur=motionblur(name),
                       frame_atol=tch.FRAME_ATOL if atol == K1_PATH_ATOL else atol)
    assert seen["frames"] >= 2 * C and seen["rounds"] >= (0 if fields.get("autocorr_plots_off")
                                                          else 1)
    names = ("round_body", "emit_fn", "shift") if cond_mode == "unrolled" else (
        "any:round_body", "any:emit_fn", "shift")
    assert {k: v for k, v in paired.strategy.seen.items() if k != "shift"} == {
        n: {False, True} for n in _branches(names, fields) if n != "shift"}
    assert paired.strategy.seen["shift"] == {False}  # no channel shifts its sync


def test_scan_runner_taken_only_equals_select_and_jax():
    """make_scan_runner (K blocks a call) with the taken-only strategy
    against its select form, bit for bit, and the JAX scan."""
    jcfg, tcfg = _configs(BIG)
    n = 5
    raws = np.stack(_blocks(n, BIG, seed=7))
    ctl = StepControls(0, 0, 0.1)
    want_s, want = tpipe.make_scan_runner(tcfg, Params(), n, device="cpu")(
        init_state(tcfg, device="cpu"), torch.from_numpy(raws), ctl)
    strategy = TakenOnly()
    with taken_only(strategy):
        got_s, got = tpipe.make_scan_runner(tcfg, Params(), n, device="cpu")(
            init_state(tcfg, device="cpu"), torch.from_numpy(raws), ctl)
    _assert_same_outputs(got, want, "scan")
    _assert_same_outputs(got_s, want_s, "scan state")
    assert strategy.seen["emit_fn"] == {False, True} and strategy.seen["round_body"] == {
        False, True}
    js, jo = jax.jit(jpipe.make_scan_runner(jcfg, JParams(), n))(
        j_init_state(jcfg), jnp.asarray(raws),
        JControls(jnp.int64(0), jnp.int32(0), jnp.float32(0.1)))
    for f in EXACT:
        np.testing.assert_array_equal(_np(getattr(got, f)), np.asarray(getattr(jo, f)), err_msg=f)
    for f in CARRIES:
        assert int(getattr(got_s, f)) == int(getattr(js, f)), f
    assert int(np.asarray(jo.frame_valid).sum()) >= 2
    np.testing.assert_allclose(_np(got.frame), np.asarray(jo.frame), rtol=FRAME_RTOL,
                               atol=K1_PATH_ATOL * max(1.0, float(np.abs(jo.frame).max())))


def test_owned_outputs_share_no_storage():
    """The taken body's outputs as graph_cond._owned leaves them: an output
    that is an operand, or that shares storage with an earlier output, is
    copied; the untaken side's write then reaches every output and no
    operand (the emit body returns its new screen twice, as carry and
    frame)."""
    x, y = torch.arange(4.0), torch.ones(3)
    screen = x * 2
    out = graph_cond._owned(((screen, y), screen, x[1:]), (x, y))
    (s, y2), frame, tail = out
    assert s is screen and y2 is not y and frame is not screen
    assert tail.data_ptr() != x[1:].data_ptr()
    stores = {t.untyped_storage().data_ptr() for t in graph_cond._leaves(out)}
    assert len(stores) == 4 and not stores & {x.untyped_storage().data_ptr(),
                                               y.untyped_storage().data_ptr()}
    graph_cond._write_into(out, ((x, y), 0.0, x[:3]))
    assert torch.equal(s, x) and torch.equal(frame, torch.zeros(4)) and torch.equal(tail, x[:3])
    assert torch.equal(x, torch.arange(4.0)) and torch.equal(y, torch.ones(3))
    with pytest.raises(TypeError):
        graph_cond._owned((screen, 0.0), ())
    with pytest.raises(ValueError):
        graph_cond._write_into((screen,), (x, y))


@pytest.mark.parametrize("pred", [[True, False, True], [False, False, False]])
def test_select_form_writes_in_place_only_where_taken(pred):
    """The select form's in-place write (_write_taken): a [C] predicate
    writes the taken channels' rows, through a gate on any() too (the masks
    of nested selects combine), and a 0-d one all or nothing; outside a
    select the write is plain."""
    p = torch.tensor(pred)
    buf = torch.zeros(3, 4)

    def body(b):
        tpipe._write_taken(b, torch.ones_like(b))
        return (b.sum(dim=-1),)

    (sums,) = tpipe._cond(p, body, lambda b: (torch.full((3,), -1.0),), (buf,))
    want = torch.tensor(pred, dtype=torch.float32)[:, None].expand(3, 4)
    assert torch.equal(buf, want)
    assert torch.equal(sums, torch.where(p, 4.0 * p, -1.0))
    one = torch.zeros(4)
    tpipe._cond(p.any(), lambda b: (tpipe._write_taken(b, b + 2), ())[1], None, (one,))
    assert torch.equal(one, torch.full((4,), 2.0 if any(pred) else 0.0))
    plain = torch.zeros(2)
    tpipe._write_taken(plain, torch.ones(2))
    assert torch.equal(plain, torch.ones(2))


class _StubDriver:
    """A graph as node lists: graph -> [(node, type)]."""

    def __init__(self, graphs):
        self.graphs = graphs
        self.types = {n: t for nodes in graphs.values() for n, t in nodes}

    def nodes(self, graph):
        return [n for n, _ in self.graphs[graph]]

    def node_type(self, node):
        return self.types[node]


def test_census_counts_parent_if_and_body_nodes():
    """graph_cond.census on a stubbed graph: a parent of 3 kernel nodes, a
    set kernel and 2 IF nodes (type 13), whose bodies hold 4 and 1 nodes,
    one body holding a nested IF node with a body of 2."""
    kernel, cond = 0, graph_cond.CONDITIONAL_NODE
    graphs = {
        "parent": [("k0", kernel), ("k1", kernel), ("k2", kernel), ("set", kernel),
                   ("if0", cond), ("if1", cond)],
        "body0": [("b0", kernel), ("b1", kernel), ("b2", 2), ("nested", cond)],
        "body1": [("c0", 1)],
        "body2": [("d0", kernel), ("d1", kernel)],
    }
    got = graph_cond.census("parent", ["body0", "body1", "body2"], _StubDriver(graphs))
    assert got == dict(parent_nodes=6, if_nodes=2, body_nodes=7, all_nodes=13)
    assert graph_cond.census("parent", [], _StubDriver(graphs))["body_nodes"] == 0


def test_branch_outside_a_runner_capture_raises():
    """The node form is made only inside branch_nodes (the runners'
    capture): a branch reaching graph_cond.if_else outside it raises rather
    than capture both sides; a CPU tensor's branch is never captured."""
    assert not graph_cond.capturing(torch.tensor(True))
    with pytest.raises(RuntimeError, match="branch_nodes"):
        graph_cond.if_else(torch.tensor(True), lambda: (), lambda: (), ())
