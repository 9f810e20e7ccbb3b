"""A run on the CPU at a small size, past the harness's look for a card: its
last line, and the check it makes. A sound run is correct; each fault of
the receiver planted underneath the window makes `correct` false, and so
does the control. A run that loads JAX prints no result."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import control, harness, manifest
from portbench.reference import check
from portbench import run as runmod
from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(channels=1, seconds=1.5, seed=11):
    cell = tiny.Cell(tiny.tiny_config(channels), tiny.traffic("premade"))
    res = harness.run_cell(cell, seed, seconds, False, "cpu")
    numbers = harness.check_run(res, cell.config, "cpu")
    return cell, res, numbers, runmod.result_line(cell, res, {"platform": "cpu"}, numbers)


@pytest.mark.parametrize("channels", [1, 3])
def test_a_sound_run_is_correct_and_its_line_has_the_result_keys(channels):
    _, res, numbers, line = _run(channels)
    assert list(line) == KEYS
    assert line["correct"], line["checks"]
    assert line["attempted"] == res["blocks"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "ingest_msps"}
    assert numbers["stretches"] >= channels and numbers["frames"] > 0
    assert list(line["checks"]) == ["frame_err", "plot_err", "state_err", "long_state_err",
                                    "mismatches"]
    # the state after the first from_start blocks, from the reference's own
    # start (or at the window's end, where that comes first)
    assert numbers["from_start"] == min(40, res["blocks"]) > 6
    json.dumps(line)


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    """The last look, after the check and the readers, before the line."""
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert runmod.emit({"correct": True}) != 0
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
    monkeypatch.delitem(sys.modules, "jax")
    assert runmod.emit({"correct": True}) == 0


def test_a_traced_line_carries_the_breakdown_before_the_checks():
    cell, res, numbers, _ = _run()

    class T:
        def top_device_ops(self):
            return [["k", 1.0]]

        def idle_gaps(self):
            return [["portbench/source", 0.5]]

    line = runmod.result_line(cell, res, {"platform": "cpu"}, numbers, T())
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged(monkeypatch):
    from tempestsdr_tpu_torch.stream import pipeline

    real = pipeline.DeviceStep.__call__

    def step(self, state, raw, controls=pipeline.StepControls()):
        copy = [type(v)(*(x.clone() for x in v)) if isinstance(v, tuple) else v.clone()
                for v in state]
        _, out = real(self, type(state)(*copy), raw, controls)
        return state, out
    monkeypatch.setattr(pipeline.DeviceStep, "__call__", step)


def _a_block_lost_now_and_then(monkeypatch):
    """One step in 25 returns its state unchanged: a slip that a stretch
    started from the receiver's own state sees only if it holds that block;
    the state after the first blocks, from the reference's own start, holds
    every one."""
    from tempestsdr_tpu_torch.stream import pipeline

    real = pipeline.DeviceStep.__call__
    calls = [0]

    def step(self, state, raw, controls=pipeline.StepControls()):
        calls[0] += 1
        if calls[0] % 25:
            return real(self, state, raw, controls)
        copy = [type(v)(*(x.clone() for x in v)) if isinstance(v, tuple) else v.clone()
                for v in state]
        _, out = real(self, type(state)(*copy), raw, controls)
        return state, out
    monkeypatch.setattr(pipeline.DeviceStep, "__call__", step)


def _half_the_block(monkeypatch):
    """Half of each block's samples left out: the step sees the first half
    twice."""
    from tempestsdr_tpu_torch.stream import graph

    real = graph.BlockRunner.run

    def run(self, state, raws, controls):
        raws = np.array(raws)
        half = raws.shape[1] // 2
        raws[:, half:] = raws[:, :half]
        return real(self, state, raws, controls)
    monkeypatch.setattr(graph.BlockRunner, "run", run)


def _half_the_channels(monkeypatch):
    """Half of the channels left out: the others' blocks in their place."""
    from tempestsdr_tpu_torch.stream import graph

    real = graph.ChannelRunner.run

    def run(self, state, raws, controls):
        raws = np.array(raws)
        half = raws.shape[0] // 2
        raws[half:2 * half] = raws[:half]
        return real(self, state, raws, controls)
    monkeypatch.setattr(graph.ChannelRunner, "run", run)


def _altered_frame(monkeypatch):
    """One pixel of every frame changed by 0.01 where the frames come down."""
    from tempestsdr_tpu_torch.stream import multisession, session

    real = session._download

    def download(stack, rows):
        got = real(stack, rows)
        if stack.dim() == 3:
            for f in got:
                f[3, 5] += 0.01
        return got
    monkeypatch.setattr(session, "_download", download)
    monkeypatch.setattr(multisession, "_download", download)


@pytest.mark.parametrize("fault,channels", [(_unchanged, 1), (_a_block_lost_now_and_then, 1),
                                            (_half_the_block, 1),
                                            (_half_the_channels, 2), (_altered_frame, 1),
                                            (_altered_frame, 2)],
                         ids=["state-unchanged", "a-block-lost", "half-the-block",
                              "half-the-channels", "frame-altered", "frame-altered-channels"])
def test_a_broken_receiver_is_not_correct(monkeypatch, fault, channels):
    fault(monkeypatch)
    _, _, numbers, line = _run(channels)
    assert not line["correct"], numbers


def test_a_block_lost_now_and_then_shows_in_the_long_check(monkeypatch):
    _a_block_lost_now_and_then(monkeypatch)
    _, _, numbers, line = _run()
    assert numbers["long_state_err"] > line["checks"]["long_state_err"]["limit"] or \
        numbers["long_mismatches"] > 0, numbers


def test_the_control_fails_the_limits():
    """The reference in the receiver's place, its pixel path in bfloat16."""
    cfg = tiny.tiny_config()
    numbers = control.control_numbers(cfg, 7, "cpu")
    ok, rows = check.verdict(numbers, cfg["limits"])
    assert not ok, rows
    assert numbers["frame_err"] > 10 * cfg["limits"]["frame_err"]
    assert numbers["from_start"] == cfg["check"]["from_start"]


def test_the_reference_refuses_params_it_does_not_model():
    from portbench.reference.geometry import Geometry
    from portbench.reference.step import Reference

    g = Geometry.of(tiny.tiny_config())
    Reference(g, params={"resampler": "fused", "framerate_pll": False})
    with pytest.raises(NotImplementedError):
        Reference(g, params={"fir_lowpass_taps": 31})


def test_without_a_card_a_run_prints_nothing_and_fails(tmp_path):
    root = tiny.copy_of_benchmark(str(tmp_path))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "wide64-premade",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load()["workloads"]])
def test_each_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "3", "--trace", "0"], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
