"""The sharded receiver of the PyTorch port (tempestsdr_tpu_torch.parallel)
against the JAX package's (tempestsdr_tpu.parallel) on the CPU: every
scenario of tests/test_parallel.py, with its tolerances.

The port runs SPMD over torch.distributed: one module-scoped group of 8
gloo ranks (parallel.launch.RankPool, "spawn" start method, a file://
rendezvous under tmp_path), each a CPU process running the rank functions
below. The JAX side runs on the 8 virtual CPU devices (tests/conftest.py)
in this process, while the ranks work. Every time-sharded case is held
against JAX's time-sharded step at the same T and against the port's
single-channel step; the ranks' outputs must all be equal.

The sharded steps are cut at their collectives into stages, which a card
replays as CUDA graphs (stream.graph.StagedRunner). Here the staged steps
are held bit for bit against a copy of the step as it was before the split
(_unsplit_time_sharded), eagerly and through a StagedRunner whose graphs a
CPU stand-in replays (EmulatedStages), also with the IF nodes' taken-only
form installed in each rank (tests/torch_taken_only.py).

The rank functions are pickled by reference, so the ranks import this
module: JAX is imported only inside the functions this process runs.
"""

import contextlib
import hashlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tempestsdr_tpu_torch.config import FRAC_BITS, PipelineConfig
from tempestsdr_tpu_torch.params import Params
from tempestsdr_tpu_torch.parallel import (
    make_channel_step,
    make_grid_step,
    make_mesh,
    make_time_sharded_step,
    stack_states,
)
from tempestsdr_tpu_torch.parallel.distributed import (
    channel_row_bounds,
    local_channel_slice,
    make_global_mesh,
)
from tempestsdr_tpu_torch.parallel.launch import RankPool
from tempestsdr_tpu_torch.sources.synthetic import render_test_pattern, synth_iq
from tempestsdr_tpu_torch.stream import init_state, make_step
from tempestsdr_tpu_torch.stream.pipeline import StepControls

SR, LINES, TWIDTH, REFRESH = 1e6, 100, 200, 50.0
WORLD = 8
FRAME_TOL = 2e-3  # tests/test_parallel.py:64-66
CH_RTOL, CH_ATOL = 1e-4, 1e-5  # tests/test_parallel.py:228


def gen_blocks(n_blocks, block_samples, noise=0.01, seed=0):
    raster = render_test_pattern(LINES, TWIDTH, seed=seed)
    return [synth_iq(raster, samplerate=SR, pixelclock=LINES * TWIDTH * REFRESH,
                     n_samples=block_samples, start_sample=b * block_samples, noise=noise,
                     seed=seed) for b in range(n_blocks)]


def config(block=8192, autocorr=False):
    return PipelineConfig(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=block,
                          autocorr=autocorr)


# ---- what the ranks run (each returns numpy, or None off the mesh) --------


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _summary(outs, state):
    """Per block (n_pixels, frame_valid, frame when valid), the final
    carries, and a digest of every output and state leaf."""
    from tempestsdr_tpu_torch.stream.state import state_to_numpy

    blocks = [(int(o.n_pixels), bool(o.frame_valid),
               o.frame.numpy().copy() if bool(o.frame_valid) else None) for o in outs]
    leaves = state_to_numpy(state)
    every = [x.numpy() for o in outs for x in o] + leaves
    carries = dict(phase_fix=int(state.phase_fix), fill=int(state.fill),
                   frame_count=int(state.frame_count), ac_calls=int(state.ac_calls),
                   ac_avg_frame=state.ac_avg_frame.numpy().copy(),
                   refresh_delta=float(state.pll.refresh_delta))
    return dict(blocks=blocks, carries=carries, digest=_digest(every))


def rank_time_sharded(cfg, params, T, blocks):
    mesh = make_mesh(1, T, device="cpu")
    if mesh.coords is None:
        return None
    step = make_time_sharded_step(cfg, params, mesh)
    state = init_state(cfg, params.fir_lowpass_taps, device="cpu")
    S, t = cfg.block_samples // T, mesh.time_index
    outs = []
    for blk in blocks:
        state, out = step(state, torch.from_numpy(blk[2 * S * t:2 * S * (t + 1)]), StepControls())
        outs.append(out)
    return _summary(outs, state)


def rank_channel_dp(cfg, params, C, per_ch_blocks):
    mesh = make_mesh(C, 1, device="cpu")
    if mesh.coords is None:
        return None
    n_ch = len(per_ch_blocks)
    step = make_channel_step(cfg, params, mesh, n_ch)
    per = n_ch // C
    mine = range(mesh.ch_index * per, (mesh.ch_index + 1) * per)
    states = stack_states(cfg, per, device="cpu")
    frames = {c: [] for c in mine}
    for b in range(len(per_ch_blocks[0])):
        raws = torch.from_numpy(np.stack([per_ch_blocks[c][b] for c in mine]))
        states, outs = step(states, raws, StepControls())
        fv = outs.frame_valid.reshape(per, -1)
        fr = outs.frame.reshape((per, fv.shape[1]) + tuple(outs.frame.shape[-2:]))
        for i, c in enumerate(mine):
            frames[c] += [fr[i, k].numpy().copy() for k in range(fv.shape[1]) if fv[i, k]]
    return dict(frames=frames, frame_count={c: int(states.frame_count[i])
                                            for i, c in enumerate(mine)})


def rank_grid(cfg, params, C, T, per_ch_blocks):
    mesh = make_mesh(C, T, device="cpu")
    if mesh.coords is None:
        return None
    step = make_grid_step(cfg, params, mesh)
    r, t = mesh.coords
    S = cfg.block_samples // T
    states = stack_states(cfg, 1, device="cpu")
    frames, n_pixels = [], []
    for b in range(len(per_ch_blocks[0])):
        raws = torch.from_numpy(per_ch_blocks[r][b][None, 2 * S * t:2 * S * (t + 1)])
        states, outs = step(states, raws, StepControls())
        n_pixels.append(int(outs.n_pixels[0]))
        frames.append(outs.frame[0].numpy().copy() if bool(outs.frame_valid[0]) else None)
    return dict(channel=r, n_pixels=n_pixels, frames=frames, phase_fix=int(states.phase_fix[0]),
                fill=int(states.fill[0]), digest=_digest([s.numpy() for s in states
                                                          if isinstance(s, torch.Tensor)]))


def _guard_ctl(dropped, n=None):
    """Controls as tensors made before a guarded block: 0-d, or [n] per
    local channel with the drop on channel 0."""
    if n is None:
        return StepControls(torch.tensor(dropped), torch.tensor(0, dtype=torch.int32),
                            torch.tensor(0.3))
    return StepControls(torch.tensor([dropped] + [0] * (n - 1)), torch.zeros(n, dtype=torch.int32),
                        torch.full((n,), 0.3))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def rank_guarded(cfg, params, blocks, per_ch_blocks, drop_at=9):
    """The time-sharded step over all WORLD ranks of one row, then the grid
    step (2 rows of WORLD // 2), each block run twice: once with every host
    read made to raise (tests/torch_host_guard.py; the mesh's collectives
    run inside the guard) and once free, on states of their own. Returns
    whether every output and state leaf agreed, and the frames and rounds
    the guarded runs saw."""
    from torch_host_guard import no_host_reads

    from tempestsdr_tpu_torch.stream.state import state_leaves

    got = dict(same=True, frames=0, rounds=0)
    mesh = make_mesh(1, WORLD, device="cpu")
    step = make_time_sharded_step(cfg, params, mesh)
    S, t = cfg.block_samples // WORLD, mesh.time_index
    guarded, free = (init_state(cfg, device="cpu") for _ in range(2))
    for b, blk in enumerate(blocks):
        raw = torch.from_numpy(blk[2 * S * t:2 * S * (t + 1)])
        ctl = _guard_ctl(1000 if b == drop_at else 0)
        with no_host_reads():
            guarded, out = step(guarded, raw, ctl)
        free, want = step(free, raw, ctl)
        got["same"] &= _same(out, want) and _same(state_leaves(guarded), state_leaves(free))
        got["frames"] += int(out.frame_valid)
        got["rounds"] += int(out.ac_plot_valid)
    mesh = make_mesh(2, WORLD // 2, device="cpu")
    step = make_grid_step(cfg, params, mesh)
    (r, t), S = mesh.coords, cfg.block_samples // (WORLD // 2)
    guarded, free = (stack_states(cfg, 1, device="cpu") for _ in range(2))
    for b, blk in enumerate(per_ch_blocks[r]):
        raws = torch.from_numpy(blk[None, 2 * S * t:2 * S * (t + 1)])
        ctl = _guard_ctl(1000 if b == drop_at else 0, 1)
        with no_host_reads():
            guarded, out = step(guarded, raws, ctl)
        free, want = step(free, raws, ctl)
        got["same"] &= _same(out, want) and _same(state_leaves(guarded), state_leaves(free))
        got["frames"] += int(out.frame_valid.sum())
        got["rounds"] += int(out.ac_plot_valid.sum())
    return got


# ---- the staged step against the step as it was before the split ---------


def _unsplit_time_sharded(step, state, raw_seg, controls):
    """TimeShardedStep.__call__ as it was before it was cut into stages at
    its collectives: one body, the collectives inline (the reference the
    staged forms are held to, bit for bit)."""
    from tempestsdr_tpu_torch.config import FRAC_BITS as FB
    from tempestsdr_tpu_torch.ops.demod import am_demod, normalize_iq
    from tempestsdr_tpu_torch.ops.fir import fir_apply_block
    from tempestsdr_tpu_torch.ops.resample import nn_resample_range, resample_counts
    from tempestsdr_tpu_torch.stream.pipeline import controls_on

    cfg, blocks, mesh = step.config, step.blocks, step.mesh
    n, S, T, taps = cfg.block_samples, step.S, step.T, cfg.resample_taps
    mpl = step.max_pix_local
    t = mesh.time_index
    raw = torch.as_tensor(raw_seg).to(step.device)
    controls = controls_on(controls, step.device)
    env = am_demod(normalize_iq(raw))
    phase, drop_all = step.parts.drop_phase(state, controls.samples_dropped)
    inv_fix = blocks.rate(state)
    env_full = mesh.all_gather(env, tiled=True) if blocks.run_autocorr else env
    fir_tail, env_rs = state.fir_tail, env
    if blocks.fir_taps is not None:
        k = blocks.fir_taps.shape[0] - 1
        tails = mesh.all_gather(env[S - k:])
        env_rs, _ = fir_apply_block(env, state.fir_tail if t == 0 else tails[t - 1],
                                    blocks.fir_taps)
        fir_tail = tails[T - 1].clone()
    n_out, phase2 = resample_counts(phase, inv_fix, n)
    n_out64 = n_out.to(torch.int64)
    seg = t * S

    def first_pixel(sample):
        return torch.minimum(torch.clamp(-((-((sample << FB) - phase)) // inv_fix), min=0),
                             n_out64)

    p_start = torch.zeros_like(n_out64) if t == 0 else first_pixel(seg)
    p_end = first_pixel(seg + S)
    if step.nn_mode:
        env_full_rs = env_full if (blocks.run_autocorr and blocks.fir_taps is None) \
            else mesh.all_gather(env_rs, tiled=True)
        pix_local = nn_resample_range(env_full_rs, n_out, p_start, p_end, n_samples=n,
                                      max_pix=mpl)
        new_tail = env_full_rs[n - taps:].clone()
    else:
        edges = mesh.all_gather(torch.cat([env_rs[:taps], env_rs[S - taps:]]))
        left = state.tail if t == 0 else edges[t - 1, taps:]
        right = edges[t + 1, :taps] if t < T - 1 else torch.zeros_like(state.tail)
        x_local = torch.cat([left, env_rs, right])
        new_tail = edges[T - 1, taps:].clone()
        pix_local = step.range_resample(x_local, phase, inv_fix, p_start, p_end, seg,
                                        max_pix=mpl, taps=taps, inv_nominal=cfg.samples_per_pixel)
    mp = cfg.max_block_pixels
    placed = torch.zeros((mp + mpl,), dtype=torch.float32, device=step.device)
    placed.index_copy_(0, p_start + torch.arange(mpl, device=step.device), pix_local)
    pixels = mesh.psum(placed[:mp])
    inter = step.parts.pre_back(state, controls, drop_all, env_full, pixels, n_out, phase2,
                                new_tail, fir_tail)
    return step.parts.finish(state, inter)


def _unsplit_grid(step, states, raws, controls):
    """GridStep.__call__ as it was before the split: the unsplit body per
    local channel, results stacked."""
    from tempestsdr_tpu_torch.stream.pipeline import _channel_rows, channel_controls_on
    from tempestsdr_tpu_torch.stream.state import StepOutputs, state_from_leaves, state_leaves

    n_ch = raws.shape[0]
    ctl = channel_controls_on(controls, n_ch, step.device)
    rows = _channel_rows(states, n_ch)
    results = [_unsplit_time_sharded(step, rows[c], raws[c], StepControls(*(v[c] for v in ctl)))
               for c in range(n_ch)]
    new = state_from_leaves([torch.stack(v) for v in zip(*(state_leaves(s) for s, _ in results))])
    return new, StepOutputs(*(torch.stack(v) for v in zip(*(o for _, o in results))))


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for x in (tree or ()) for t in _tensors(x)]


class EmulatedStages:
    """stream.graph.GraphStages' members on the CPU, for StagedRunner: a
    stage "captured" runs once and keeps the tensors it returned; a replay
    runs it again and writes into those tensors, as a graph's replay
    rewrites its static outputs, so later stages and the exchanges read
    and write the same tensors every call, as on the card. No side stream,
    no sync debug mode."""

    def __init__(self):
        self.sync_debug = lambda mode: contextlib.nullcontext()
        self.warm_up = contextlib.nullcontext

    def capture(self, fn, nodes):
        out = fn()

        def replay():
            for dst, src in zip(_tensors(out), _tensors(fn()), strict=True):
                dst.copy_(src)

        return SimpleNamespace(replay=replay, census=lambda: {}), out


STAGED_CASES = {  # name -> (Params, T, grid rows, autocorr)
    "default": (Params(framerate_pll=False), WORLD, 1, True),
    "fir31": (Params(framerate_pll=False, fir_lowpass_taps=31), 4, 1, True),
    "nearest": (Params(framerate_pll=False, nearest_neighbour=True), WORLD, 1, True),
    "nearest-no-autocorr": (Params(framerate_pll=False, nearest_neighbour=True), 4, 1, False),
    "grid 2x4": (Params(framerate_pll=False), WORLD // 2, 2, True),
    # the post-process orders with autoshift (the card's "time-sharded
    # orders" run), and fast_sync's f32 search
    "orders": (Params(framerate_pll=False, lowpass_before_sync=True, autogain_after_proc=True,
                      autoshift=True), WORLD, 1, True),
    "fast_sync": (Params(framerate_pll=False, fast_sync=True), 4, 1, True),
}
STAGED_EVENTS = {3: (0, 777), 9: (1000, 0), 11: (0, -1234)}  # block -> (dropped, sync shift)


def rank_staged(name, per_row_blocks):
    """One case of STAGED_CASES on this rank, over the blocks of its row:
    the step as it was before the split (the reference), the eager staged
    step (make_*_step on the CPU), and a StagedRunner replaying its stages
    through EmulatedStages, in the select form and with the taken-only
    strategy (tests/torch_taken_only.py: the IF nodes' form) installed in
    this rank, each from a fresh state. Returns whether every block's
    outputs (kept across calls) and the final state of every form equal
    the reference's bit for bit, the frames and rounds seen, and the sides
    the taken-only form took per branch."""
    from torch_taken_only import TakenOnly, taken_only

    from tempestsdr_tpu_torch.parallel.timeshard import GridStep, TimeShardedStep
    from tempestsdr_tpu_torch.stream.graph import StagedRunner
    from tempestsdr_tpu_torch.stream.state import state_leaves

    params, T, rows, autocorr = STAGED_CASES[name]
    cfg = config(autocorr=autocorr)
    mesh = make_mesh(rows, T, device="cpu")
    if mesh.coords is None:
        return None
    r, t = mesh.coords
    S = cfg.block_samples // T
    grid = rows > 1
    if grid:
        program, unsplit, public = GridStep(cfg, params, mesh), _unsplit_grid, make_grid_step
    else:
        program, unsplit = TimeShardedStep(cfg, params, mesh), _unsplit_time_sharded
        public = make_time_sharded_step

    def new_state():
        if grid:
            return stack_states(cfg, 1, params.fir_lowpass_taps, device="cpu")
        return init_state(cfg, params.fir_lowpass_taps, device="cpu")

    def ctl(b):
        dropped, sync = STAGED_EVENTS.get(b, (0, 0))
        if grid:
            return StepControls(torch.tensor([dropped]), torch.tensor([sync], dtype=torch.int32),
                                torch.full((1,), 0.3))
        return StepControls(torch.tensor(dropped), torch.tensor(sync, dtype=torch.int32),
                            torch.tensor(0.3))

    def run(step):
        state, outs = new_state(), []
        for b, blk in enumerate(per_row_blocks[r]):
            raw = torch.from_numpy(blk[2 * S * t:2 * S * (t + 1)])
            state, out = step(state, raw[None] if grid else raw, ctl(b))
            outs.append(out)
        return outs, state_leaves(state)

    want_outs, want_state = run(lambda *a: unsplit(program, *a))
    forms = {"eager": public(cfg, params, mesh),
             "replayed": StagedRunner(program, EmulatedStages())}
    got = {k: run(v) for k, v in forms.items()}
    strategy = TakenOnly()
    with taken_only(strategy):
        got["replayed, taken only"] = run(StagedRunner(program, EmulatedStages()))
    same = {k: all(_same(o, w) for o, w in zip(outs, want_outs)) and _same(st, want_state)
            for k, (outs, st) in got.items()}
    return dict(same=same, frames=sum(int(o.frame_valid.sum()) for o in want_outs),
                rounds=sum(int(o.ac_plot_valid.sum()) for o in want_outs),
                shifts=sum(int(o.n_pixels.sum() > 0) for b, o in enumerate(want_outs)
                           if STAGED_EVENTS.get(b, (0, 0))[1]),
                seen={k: sorted(v) for k, v in strategy.seen.items()})


def rank_channel_mesh_controls(cfg, params, per_ch_blocks):
    """The channel mesh's step on this rank (2 'ch' rows of WORLD // 2
    ranks, 2 channels a rank) against its ChannelRunner fed the [C, 3]
    float64 controls the step packs on a card (ChannelMeshStep.controls),
    a drop, a sync shift and a motion blur among them: bit for bit."""
    from tempestsdr_tpu_torch.stream.state import state_leaves

    mesh = make_mesh(2, WORLD // 2, device="cpu")
    step = make_channel_step(cfg, params, mesh, 4)
    per = 2
    mine = range(mesh.ch_index * per, (mesh.ch_index + 1) * per)
    a, b = (stack_states(cfg, per, device="cpu") for _ in range(2))
    same = True
    for i in range(len(per_ch_blocks[0])):
        raws = torch.from_numpy(np.stack([per_ch_blocks[c][i] for c in mine]))
        ctl = StepControls(torch.tensor([1000 if i == 4 else 0, 0]),
                           torch.tensor([0, 555 if i == 2 else 0], dtype=torch.int32),
                           torch.tensor([0.3, 0.1]))
        a, want = step(a, raws, ctl)
        b, got, _ = step.runner.run(b, raws, step.controls(ctl))
        same &= _same(got, want) and _same(state_leaves(a), state_leaves(b))
    return dict(same=same, cond_mode=step.cond_mode, n_channels=step.n_channels)


def rank_mesh_api():
    """The mesh's validation and its collectives, on every rank."""
    rank = torch.distributed.get_rank()
    got = {}
    try:
        make_mesh(n_channel=4, n_time=4, device="cpu")  # 16 > 8 ranks
    except ValueError:
        got["too_big"] = True
    try:
        make_global_mesh(4, 4, device="cpu")
    except ValueError:
        got["global_too_big"] = True
    g = make_global_mesh(2, 4, device="cpu")
    got["global_shape"] = g.shape
    got["slice"] = (local_channel_slice(g, 8), local_channel_slice(g, 10))
    mesh = make_mesh(2, 4, device="cpu")
    x = torch.tensor([float(rank)])
    got["coords"] = mesh.coords
    got["gather"] = mesh.all_gather(x).flatten().tolist()
    got["tiled"] = mesh.all_gather(torch.tensor([rank, -rank]), tiled=True).tolist()
    got["psum"] = float(mesh.psum(x))
    right, left = mesh.shift_right(x), mesh.shift_left(x)
    got["right"] = None if right is None else float(right)
    got["left"] = None if left is None else float(left)
    return got


def rank_fails():
    if torch.distributed.get_rank() == 1:
        raise ArithmeticError("rank 1 fails on purpose")
    return "ok"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test with one torch thread in this process, as in
    tests/test_torch_device_step.py (the ranks take their own count from
    RankPool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    rdv = tmp_path_factory.mktemp("rdv") / "init"
    with RankPool(WORLD, init_method=f"file://{rdv}", timeout_s=300) as p:
        yield p


# ---- the JAX side and the port's single-channel step ----------------------


def _jax_time_sharded(cfg, params, T, blocks):
    import jax.numpy as jnp
    from tempestsdr_tpu.config import PipelineConfig as JConfig
    from tempestsdr_tpu.parallel import make_mesh as j_make_mesh
    from tempestsdr_tpu.parallel import make_time_sharded_step as j_make_time_sharded_step
    from tempestsdr_tpu.stream import init_state as j_init_state
    from tempestsdr_tpu.stream.pipeline import StepControls as JControls

    jcfg = JConfig(**{f: getattr(cfg, f) for f in ("samplerate", "height", "refreshrate",
                                                   "block_samples", "autocorr")})
    step = j_make_time_sharded_step(jcfg, _j_params(params), j_make_mesh(n_channel=1, n_time=T))
    state = j_init_state(jcfg, params.fir_lowpass_taps)
    out = []
    for blk in blocks:
        state, o = step(state, jnp.asarray(blk), JControls.default())
        out.append((int(o.n_pixels), bool(o.frame_valid),
                    np.asarray(o.frame) if bool(o.frame_valid) else None))
    carries = dict(phase_fix=int(state.phase_fix), fill=int(state.fill),
                   frame_count=int(state.frame_count), ac_calls=int(state.ac_calls),
                   ac_avg_frame=np.asarray(state.ac_avg_frame),
                   refresh_delta=float(np.asarray(state.pll.refresh_delta)))
    return dict(blocks=out, carries=carries)


def _single(cfg, params, blocks):
    step = make_step(cfg, params, device="cpu")
    state = init_state(cfg, params.fir_lowpass_taps, device="cpu")
    outs = []
    for blk in blocks:
        state, o = step(state, torch.from_numpy(blk), StepControls())
        outs.append(o)
    return _summary(outs, state)


def _j_params(params):
    import dataclasses

    from tempestsdr_tpu.params import Params as JParams

    return JParams(**dataclasses.asdict(params))


def _run_time_sharded(pool, cfg, params, T, blocks):
    """(ranks' summaries, JAX's, the single step's), the JAX side run while
    the ranks work."""
    pool.submit(rank_time_sharded, cfg, params, T, blocks)
    jax_side = _jax_time_sharded(cfg, params, T, blocks)
    single = _single(cfg, params, blocks)
    ranks = [r for r in pool.collect() if r is not None]
    assert len(ranks) == T
    assert len({r["digest"] for r in ranks}) == 1, "the ranks' outputs differ"
    return ranks[0], jax_side, single


def _hold_blocks(got, want, *, every_frame=True):
    frames = 0
    for b, ((n1, v1, f1), (n2, v2, f2)) in enumerate(zip(got["blocks"], want["blocks"])):
        assert n1 == n2 and v1 == v2, b
        if v1 and every_frame:
            frames += 1
            np.testing.assert_allclose(f1, f2, rtol=FRAME_TOL, atol=FRAME_TOL)
    return frames


def _last_frame(summary):
    return [f for _, v, f in summary["blocks"] if v][-1]


def test_time_sharded_matches_jax_and_single_step(pool):
    """PLL off, autocorrelation on, T = 8 (tests/test_parallel.py:38-74)."""
    cfg = config(autocorr=True)
    params = Params(framerate_pll=False)
    got, jax_side, single = _run_time_sharded(pool, cfg, params, 8, gen_blocks(40, 8192))
    for want in (jax_side, single):
        assert _hold_blocks(got, want) > 0
        for k in ("phase_fix", "fill", "frame_count", "ac_calls"):
            assert got["carries"][k] == want["carries"][k], k
        np.testing.assert_allclose(got["carries"]["ac_avg_frame"], want["carries"]["ac_avg_frame"],
                                   rtol=1e-3, atol=1e-4)


def test_time_sharded_pll_behaviour(pool):
    """PLL on (tests/test_parallel.py:77-98): locked near the true rate, the
    deltas within 2e-3 of each other."""
    cfg = config()
    params = Params(framerate_pll=True)
    got, jax_side, single = _run_time_sharded(pool, cfg, params, 8, gen_blocks(40, 8192))
    d = got["carries"]["refresh_delta"]
    for want in (jax_side, single):
        dw = want["carries"]["refresh_delta"]
        assert abs(d) < 2e-3 and abs(dw) < 2e-3 and abs(d - dw) < 2e-3
    # against the single step every frame holds: this rank layout owns the
    # pixel that starts in the previous block (module docstring of timeshard)
    assert _hold_blocks(got, single) > 0


def test_time_sharded_with_fir_matches(pool):
    """FIR 31, T = 4 (tests/test_parallel.py:101-120)."""
    cfg = config()
    params = Params(framerate_pll=False, fir_lowpass_taps=31)
    got, jax_side, single = _run_time_sharded(pool, cfg, params, 4, gen_blocks(20, 8192))
    for want in (jax_side, single):
        np.testing.assert_allclose(_last_frame(got), _last_frame(want), rtol=FRAME_TOL,
                                   atol=FRAME_TOL)
    assert _hold_blocks(got, single) > 0


def test_time_sharded_nn_matches(pool):
    """Nearest-neighbour, T = 8 (tests/test_parallel.py:123-151)."""
    cfg = config()
    params = Params(framerate_pll=False, nearest_neighbour=True)
    got, jax_side, single = _run_time_sharded(pool, cfg, params, 8, gen_blocks(24, 8192))
    for want in (jax_side, single):
        assert _hold_blocks(got, want) > 0
        assert got["carries"]["phase_fix"] == want["carries"]["phase_fix"]
        assert got["carries"]["fill"] == want["carries"]["fill"]


def test_time_sharded_rejects_what_jax_rejects(pool):
    mesh = SimpleNamespace(shape={"ch": 1, "time": 3}, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divide"):
        make_time_sharded_step(config(), Params(), mesh)
    big = config(block=49152)  # ~2.5 frames a block
    with pytest.raises(ValueError, match="one frame per block"):
        make_time_sharded_step(big, Params(), SimpleNamespace(shape={"ch": 1, "time": 2}))


def _channel_case(pool, big, C, n_blocks, seeds):
    from tempestsdr_tpu.parallel import make_channel_step as j_make_channel_step
    from tempestsdr_tpu.parallel import make_mesh as j_make_mesh
    from tempestsdr_tpu.parallel import stack_states as j_stack_states
    from tempestsdr_tpu.config import PipelineConfig as JConfig
    from tempestsdr_tpu.stream.pipeline import StepControls as JControls
    import jax
    import jax.numpy as jnp

    cfg = config(block=big)
    params = Params(framerate_pll=False)
    per_ch = [gen_blocks(n_blocks, big, seed=s) for s in seeds]
    pool.submit(rank_channel_dp, cfg, params, C, per_ch)

    jcfg = JConfig(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=big,
                   autocorr=False)
    jstep = j_make_channel_step(jcfg, _j_params(params), j_make_mesh(n_channel=C, n_time=1))
    jstates = j_stack_states(jcfg, len(seeds))
    ctrl = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (len(seeds),) + x.shape),
                        JControls.default())
    jframes = {c: [] for c in range(len(seeds))}
    for b in range(n_blocks):
        jstates, outs = jstep(jstates, jnp.stack([jnp.asarray(per_ch[c][b])
                                                  for c in range(len(seeds))]), ctrl)
        fv = np.asarray(outs.frame_valid).reshape(len(seeds), -1)
        fr = np.asarray(outs.frame).reshape(fv.shape + (cfg.height, cfg.width))
        for c in range(len(seeds)):
            jframes[c] += [fr[c, k] for k in range(fv.shape[1]) if fv[c, k]]
    got_frames, got_count = {}, {}
    for r in pool.collect():
        if r is not None:
            got_frames.update(r["frames"])
            got_count.update(r["frame_count"])
    assert sorted(got_frames) == list(range(len(seeds)))
    for c in range(len(seeds)):
        assert len(got_frames[c]) == len(jframes[c]) > 0
        for a, b2 in zip(got_frames[c], jframes[c]):
            np.testing.assert_allclose(a, b2, rtol=CH_RTOL, atol=CH_ATOL)
        assert got_count[c] == int(jstates.frame_count[c])
    return cfg, params, per_ch, got_frames


def test_channel_dp_matches_per_channel(pool):
    """8 channels over the 8 'ch' ranks == the JAX mesh step == independent
    single-channel runs (tests/test_parallel.py:196-228)."""
    cfg, params, per_ch, got = _channel_case(pool, 8192, 8, 16, range(8))
    for c in (0, 3, 7):
        single = _single(cfg, params, per_ch[c])
        np.testing.assert_allclose(got[c][-1], _last_frame(single), rtol=CH_RTOL, atol=CH_ATOL)


def test_channel_dp_multiframe_matches_per_channel(pool):
    """K = 3 (blocks of ~2.5 frames) through the 'ch' ranks, frame for frame
    in stream order (tests/test_parallel.py:231-278)."""
    cfg, params, per_ch, got = _channel_case(pool, 49152, 8, 6, range(8))
    assert cfg.frames_per_block >= 2
    step = make_step(cfg, params, device="cpu")
    for c in (0, 2, 7):
        state, mine = init_state(cfg, device="cpu"), []
        for blk in per_ch[c]:
            state, o = step(state, torch.from_numpy(blk), StepControls())
            mine += [o.frame[k].numpy() for k in range(o.frame_valid.shape[0]) if o.frame_valid[k]]
        assert len(mine) == len(got[c]) >= 6
        for a, b2 in zip(got[c], mine):
            np.testing.assert_allclose(a, b2, rtol=CH_RTOL, atol=CH_ATOL)


def test_sharded_steps_read_nothing_to_the_host(pool):
    """The time-sharded step (T = 8) and the grid step (2 x 4) on gloo CPU
    ranks, every block with every host read made to raise outside the mesh's
    collectives (a drop, rounds and frames among them), equal bit for bit to
    the same blocks run unguarded; and make_channel_step, this rank's device
    channel step, passes its cond_mode through."""
    from types import SimpleNamespace

    cfg = config(autocorr=True)
    params = Params(framerate_pll=False)
    blocks = gen_blocks(14, 8192)  # a round at block 6, the drop at 9
    per_ch = [gen_blocks(14, 8192, seed=s) for s in (6, 7)]
    res = pool.run(rank_guarded, cfg, params, blocks, per_ch)
    assert len(res) == WORLD and all(r["same"] for r in res)
    assert all(r["frames"] > 0 and r["rounds"] > 0 for r in res)
    mesh = SimpleNamespace(shape={"ch": 2, "time": 1}, device=torch.device("cpu"))
    for mode in ("batched", "unrolled"):
        step = make_channel_step(cfg, params, mesh, 4, cond_mode=mode)
        assert (step.n_channels, step.cond_mode) == (2, mode)


@pytest.mark.parametrize("name", list(STAGED_CASES))
def test_staged_steps_equal_the_unsplit_step(pool, name):
    """The time-sharded step cut at its collectives (default, FIR 31,
    nearest-neighbour with and without the ring's gather, the post-process
    orders with autoshift, fast_sync) and the grid
    (2 x 4) on gloo CPU ranks, over blocks with a drop, two sync shifts,
    rounds and frames: the eager staged step, a StagedRunner replaying its
    stages through EmulatedStages (static tensors written by the exchanges,
    the state the runner's, the outputs the caller's), and that runner with
    the IF nodes' taken-only form installed in each rank, all bit for bit
    the step as it was before the split. The taken-only form takes both
    sides of the round and the emit, and the shift."""
    params, T, rows, autocorr = STAGED_CASES[name]
    blocks = [gen_blocks(14, 8192, seed=s) for s in (8, 9)[:rows]]
    res = [r for r in pool.run(rank_staged, name, blocks) if r is not None]
    assert len(res) == T * rows
    for r in res:
        assert r["same"] == {"eager": True, "replayed": True, "replayed, taken only": True}, r
        assert r["frames"] > 0 and r["shifts"] > 0
        assert r["rounds"] > 0 or not autocorr
        want = {"emit_fn": [False, True], "shift": [False, True]}
        if autocorr:
            want["round_body"] = [False, True]
        assert r["seen"] == want, r["seen"]


def test_channel_mesh_controls_pack_exactly(pool):
    """make_channel_step's controls as the card's replay takes them ([C, 3]
    float64 through its ChannelRunner) give the eager channel step's
    outputs and state bit for bit, with a drop, a sync shift and two motion
    blurs."""
    cfg = config(autocorr=True)
    per_ch = [gen_blocks(8, 8192, seed=s) for s in range(4)]
    res = pool.run(rank_channel_mesh_controls, cfg, Params(framerate_pll=False), per_ch)
    assert all(r["same"] and (r["cond_mode"], r["n_channels"]) == ("unrolled", 2) for r in res)


def test_collectives_refuse_under_capture(monkeypatch):
    """Mesh.all_gather and Mesh.psum (and the shifts built on all_gather)
    raise while the current stream captures a CUDA graph, as reported by
    torch.cuda: a replay would not run them."""
    mesh = make_mesh(device="cpu")
    x = torch.arange(3.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    for call in (lambda: mesh.all_gather(x), lambda: mesh.all_gather(x, tiled=True),
                 lambda: mesh.psum(x), lambda: mesh.shift_right(x)):
        with pytest.raises(RuntimeError, match="captures a CUDA graph"):
            call()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert torch.equal(mesh.psum(x), x)


def test_channel_step_rejects_uneven_channels():
    mesh = SimpleNamespace(shape={"ch": 3, "time": 1}, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="multiple"):
        make_channel_step(config(), Params(), mesh, 4)


def test_grid_step_matches_jax_grid_and_single_steps(pool):
    """C = 2 x T = 2: each channel's block time-sharded over its row; held
    against the JAX grid step on 4 virtual devices and each channel's
    single-channel step (no JAX test covers make_grid_step)."""
    import jax
    import jax.numpy as jnp
    from tempestsdr_tpu.config import PipelineConfig as JConfig
    from tempestsdr_tpu.parallel import make_grid_step as j_make_grid_step
    from tempestsdr_tpu.parallel import make_mesh as j_make_mesh
    from tempestsdr_tpu.parallel import stack_states as j_stack_states
    from tempestsdr_tpu.stream.pipeline import StepControls as JControls

    cfg, params, n_blocks = config(), Params(framerate_pll=False), 16
    per_ch = [gen_blocks(n_blocks, 8192, seed=s) for s in (4, 5)]
    pool.submit(rank_grid, cfg, params, 2, 2, per_ch)

    jcfg = JConfig(samplerate=SR, height=LINES, refreshrate=REFRESH, block_samples=8192,
                   autocorr=False)
    jstep = j_make_grid_step(jcfg, _j_params(params), j_make_mesh(n_channel=2, n_time=2))
    jstates = j_stack_states(jcfg, 2)
    ctrl = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (2,) + x.shape), JControls.default())
    jout = []
    for b in range(n_blocks):
        jstates, o = jstep(jstates, jnp.stack([jnp.asarray(per_ch[c][b]) for c in range(2)]), ctrl)
        jout.append((np.asarray(o.n_pixels), np.asarray(o.frame_valid), np.asarray(o.frame)))
    ranks = [r for r in pool.collect() if r is not None]
    assert len(ranks) == 4
    for c in range(2):
        row = [r for r in ranks if r["channel"] == c]
        assert len(row) == 2 and row[0]["digest"] == row[1]["digest"]
        got = row[0]
        single = _single(cfg, params, per_ch[c])
        emitted = 0
        for b in range(n_blocks):
            n_j, v_j, f_j = jout[b]
            assert got["n_pixels"][b] == int(n_j[c]) == single["blocks"][b][0], (c, b)
            assert (got["frames"][b] is not None) == bool(v_j[c]) == single["blocks"][b][1]
            if got["frames"][b] is not None:
                emitted += 1
                np.testing.assert_allclose(got["frames"][b], f_j[c], rtol=FRAME_TOL, atol=FRAME_TOL)
                np.testing.assert_allclose(got["frames"][b], single["blocks"][b][2],
                                           rtol=FRAME_TOL, atol=FRAME_TOL)
        assert emitted > 0
        assert got["phase_fix"] == int(jstates.phase_fix[c]) == single["carries"]["phase_fix"]
        assert got["fill"] == int(jstates.fill[c]) == single["carries"]["fill"]


def test_mesh_validation_and_collectives(pool):
    """tests/test_parallel.py:506-508 and :560-566 on every rank, and the
    four 'time' collectives on a 2 x 4 mesh."""
    res = pool.run(rank_mesh_api)
    for rank, got in enumerate(res):
        r, t = divmod(rank, 4)
        assert got["too_big"] and got["global_too_big"]
        assert got["global_shape"] == {"ch": 2, "time": 4}
        assert got["slice"] == (slice(0, 8), slice(0, 10))  # one host holds every row
        assert got["coords"] == (r, t)
        row = [float(4 * r + i) for i in range(4)]
        assert got["gather"] == row
        assert got["tiled"] == [v for i in range(4) for v in (4 * r + i, -(4 * r + i))]
        assert got["psum"] == sum(row)
        assert got["right"] == (row[t - 1] if t > 0 else None)
        assert got["left"] == (row[t + 1] if t < 3 else None)


def test_mesh_without_process_group():
    """One process, no process group: the world is this process."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"ch": 1, "time": 1} and mesh.coords == (0, 0)
    x = torch.arange(3.0)
    assert torch.equal(mesh.psum(x), x) and torch.equal(mesh.all_gather(x, tiled=True), x)
    assert mesh.shift_right(x) is None and mesh.shift_left(x) is None
    with pytest.raises(ValueError):
        make_mesh(n_channel=2, device="cpu")
    with pytest.raises(ValueError):
        make_global_mesh(1, 2, device="cpu")


def test_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_channel_row_bounds_balanced():
    assert channel_row_bounds(8, 4) == [0, 2, 4, 6, 8]
    assert channel_row_bounds(10, 4) == [0, 3, 6, 8, 10]
    assert channel_row_bounds(3, 4) == [0, 1, 2, 3, 3]
    with pytest.raises(ValueError):
        channel_row_bounds(4, 0)


def test_init_distributed_binds_the_reference_call(monkeypatch):
    """The JAX package's three-argument call (coordinator, num_processes,
    process_id) binds to the port's init_distributed and brings up one rank
    per card over nccl; gloo stays explicit."""
    import inspect

    from tempestsdr_tpu.parallel.distributed import init_distributed as j_init_distributed
    from tempestsdr_tpu_torch.parallel import distributed

    args = ("h:1234", 4, 3)
    inspect.signature(j_init_distributed).bind(*args)
    assert inspect.signature(distributed.init_distributed).bind(*args).arguments == dict(
        zip(("coordinator", "num_processes", "process_id"), args))
    calls, cards = [], []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    distributed.init_distributed(*args)
    distributed.init_distributed("file:///x", 2, 1, backend="gloo")
    assert calls == [("nccl", dict(init_method="tcp://h:1234", world_size=4, rank=3)),
                     ("gloo", dict(init_method="file:///x", world_size=2, rank=1))]
    assert cards == [1]
    with pytest.raises(ValueError):
        distributed.init_distributed(*args, backend="mpi")


def test_local_channel_slice_mock_multi_host():
    """The duck-typed two-host mock of tests/test_parallel.py:522-557: the
    function reads only .devices (each with .process_index) and the mesh's
    own .process_index."""
    def fake(proc):
        return SimpleNamespace(process_index=proc)

    me = 0
    rows = np.array([[fake(me), fake(me)], [fake(me), fake(me)],
                     [fake(me + 1), fake(me + 1)], [fake(me + 1), fake(me + 1)]])
    assert local_channel_slice(SimpleNamespace(devices=rows, process_index=me), 10) == slice(0, 6)
    other = SimpleNamespace(devices=np.array([[fake(me + 1)], [fake(me + 1)]]), process_index=me)
    assert local_channel_slice(other, 4) == slice(0, 0)
    bad = SimpleNamespace(devices=np.array([[fake(me)], [fake(me + 1)], [fake(me)]]),
                          process_index=me)
    with pytest.raises(ValueError):
        local_channel_slice(bad, 6)
    # the same layouts through the JAX package's function
    from tempestsdr_tpu.parallel.distributed import local_channel_slice as j_local_channel_slice

    assert j_local_channel_slice(SimpleNamespace(devices=rows), 10) == slice(0, 6)
    assert j_local_channel_slice(SimpleNamespace(devices=other.devices), 4) == slice(0, 0)


def test_rank_failure_fails_the_run(tmp_path):
    """A rank that raises fails the whole run with its traceback, and no
    rank is left running."""
    pool = RankPool(2, init_method=f"file://{tmp_path / 'rdv'}", timeout_s=120)
    try:
        with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
            pool.run(rank_fails)
    finally:
        pool.terminate()
    assert not any(p.is_alive() for p in pool._procs)


# ---- the range forms and the reference-only ops against JAX ---------------


def _range_inputs(inv=0.497, taps=2, S=8192, T=4, phase=-(1 << (FRAC_BITS - 2)), seed=3):
    """tests/test_parallel.py:165-191's shard inputs: per shard (x_local,
    seg, p_start, p_end), with the block's n_out."""
    rng = np.random.default_rng(seed)
    inv_fix = round(inv * (1 << FRAC_BITS))
    n = S * T
    env = rng.normal(size=n).astype(np.float32) ** 2
    size_fix = n << FRAC_BITS
    n_out = max((size_fix - phase) // inv_fix, 0)
    x_full = np.concatenate([np.zeros(taps, np.float32), env, np.zeros(taps, np.float32)])
    shards = []
    for t in range(T):
        seg = t * S
        lo = -((-((seg << FRAC_BITS) - phase)) // inv_fix)
        hi = -((-(((seg + S) << FRAC_BITS) - phase)) // inv_fix)
        shards.append((x_full[seg:seg + S + 2 * taps], seg, int(np.clip(lo, 0, n_out)),
                       int(np.clip(hi, 0, n_out))))
    return dict(inv=inv, inv_fix=inv_fix, taps=taps, phase=phase, n=n, n_out=n_out, env=env,
                shards=shards, max_pix=int(S / inv * 1.02) + 2)


def test_range_forms_match_jax_and_each_other():
    """box_resample_range and box_resample_range_strided against JAX's on
    the same shard inputs (f32 order kept: within 1e-6), strided against
    chunked within 1e-4 (tests/test_parallel.py:154-193), and NN's range
    form against JAX's exactly."""
    import jax.numpy as jnp
    from tempestsdr_tpu.ops import resample as jr
    from tempestsdr_tpu_torch.ops import resample as tr

    d = _range_inputs()
    i64 = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    kw = dict(max_pix=d["max_pix"], taps=d["taps"], inv_nominal=d["inv"])
    for x_local, seg, ps, pe in d["shards"]:
        args_t = (torch.from_numpy(x_local), i64(d["phase"]), i64(d["inv_fix"]), i64(ps), i64(pe))
        args_j = (jnp.asarray(x_local), jnp.int64(d["phase"]), jnp.int64(d["inv_fix"]),
                  jnp.int64(ps), jnp.int64(pe), jnp.int64(seg))
        got = {name: getattr(tr, name)(*args_t, seg, **kw).numpy()
               for name in ("box_resample_range", "box_resample_range_strided")}
        for name, a in got.items():
            np.testing.assert_allclose(a, np.asarray(getattr(jr, name)(*args_j, **kw)),
                                       rtol=1e-6, atol=1e-6)
            assert not a[max(pe - ps, 0):].any()
        np.testing.assert_allclose(got["box_resample_range"], got["box_resample_range_strided"],
                                   rtol=1e-4, atol=1e-4)
        n_out_t = torch.tensor(d["n_out"], dtype=torch.int32)
        nn_t = tr.nn_resample_range(torch.from_numpy(d["env"]), n_out_t, i64(ps), i64(pe),
                                    n_samples=d["n"], max_pix=d["max_pix"])
        nn_j = jr.nn_resample_range(jnp.asarray(d["env"]), jnp.int32(d["n_out"]), jnp.int64(ps),
                                    jnp.int64(pe), n_samples=d["n"], max_pix=d["max_pix"])
        np.testing.assert_array_equal(nn_t.numpy(), np.asarray(nn_j))


@pytest.mark.parametrize("phase", [0, -(1 << (FRAC_BITS - 2)), -12345678, (5 << FRAC_BITS) + 99])
def test_dense_and_gather_forms_match_jax(phase):
    """box_resample_block (dense, per-pixel int64) and box_resample_gather_i32
    against JAX's: carries exact, pixels within 1e-6."""
    import jax.numpy as jnp
    from tempestsdr_tpu.ops import resample as jr
    from tempestsdr_tpu_torch import ops as tops

    rng = np.random.default_rng(5)
    inv, taps, n = 0.497, 2, 8192
    inv_fix = round(inv * (1 << FRAC_BITS))
    x = np.concatenate([rng.random(taps, dtype=np.float32), rng.random(n, dtype=np.float32)])
    mp = int(n / inv * 1.02) + 2
    for name, extra in (("box_resample_block", {}), ("box_resample_gather_i32",
                                                     dict(inv_nominal=inv))):
        pt, nt, qt = getattr(tops, name)(torch.from_numpy(x), torch.tensor(phase),
                                         torch.tensor(inv_fix), n_samples=n, max_pix=mp,
                                         taps=taps, **extra)
        pj, nj, qj = getattr(jr, name)(jnp.asarray(x), jnp.int64(phase), jnp.int64(inv_fix),
                                       n_samples=n, max_pix=mp, taps=taps, **extra)
        assert int(nt) == int(nj) and int(qt) == int(qj), name
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_the_sweet_spot_pair_matches_jax(seed):
    """The batched two-axis search against JAX's, and against two
    find_the_sweet_spot calls: states and strip starts exact."""
    import jax.numpy as jnp
    from tempestsdr_tpu.ops import sync as js
    from tempestsdr_tpu_torch.ops import sync as ts

    rng = np.random.default_rng(seed)
    dx, dy = rng.random(424), rng.random(628)
    dx[100:130] += 3.0
    dy[40:48] += 3.0
    tstate = ts.SweetspotState(*(torch.tensor(v, dtype=torch.int32) for v in (30, 110, 0)))
    jstate = js.SweetspotState(*(jnp.int32(v) for v in (30, 110, 0)))
    got = ts.find_the_sweet_spot_pair(tstate, torch.from_numpy(dx), 21, 0.9,
                                      tstate, torch.from_numpy(dy), 6, 0.1)
    want = js.find_the_sweet_spot_pair(jstate, jnp.asarray(dx), 21, 0.9,
                                       jstate, jnp.asarray(dy), 6, 0.1)
    for a, b in zip(got[:2], want[:2]):
        assert [int(v) for v in a] == [int(v) for v in b]
    assert [int(v) for v in got[3]] == [int(v) for v in want[3]]
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sx, _, start_x = ts.find_the_sweet_spot(tstate, torch.from_numpy(dx), 21, 0.9)
    assert [int(v) for v in sx] == [int(v) for v in got[0]] and int(start_x) == int(got[3][0])


def test_ops_and_parallel_export_what_the_reference_exports():
    import tempestsdr_tpu.ops as jops
    import tempestsdr_tpu.parallel as jpar
    import tempestsdr_tpu_torch.ops as tops
    import tempestsdr_tpu_torch.parallel as tpar

    public = lambda m: {n for n in dir(m) if not n.startswith("_")  # noqa: E731
                        and callable(getattr(m, n))}
    assert public(jops) <= public(tops)
    assert public(jpar) <= public(tpar)
