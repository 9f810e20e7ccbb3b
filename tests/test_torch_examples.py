"""Every example of the PyTorch port (examples/torch_*.py) run end to end
as a subprocess with --device cpu, with the output checks of
tests/test_examples.py (tests/test_torch_multisession.py runs
torch_multi_target.py). Each subprocess keeps to THREADS intra-op threads:
the test workers already share the host's cores, and torch's thread pool
on all of them at once, next to the others, spins far more than it works."""

import os
import shutil
import subprocess
import sys

import pytest

from test_examples import EX, _clean_env, run_example

THREADS = {"OMP_NUM_THREADS": "2"}


def run_torch_example(args, tmp_path):
    return run_example(args, tmp_path, extra_env=THREADS)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_excap") / "cap.bin"
    r = subprocess.run(
        [sys.executable, os.path.join(EX, "torch_make_test_capture.py"), str(path), "0.4"],
        capture_output=True, text=True, timeout=120, env=_clean_env(THREADS))
    assert r.returncode == 0, r.stderr
    assert path.stat().st_size == int(0.4 * 8e6) * 2
    return str(path)


def test_torch_make_test_capture_equals_the_reference_generator(capture):
    """The bytes examples/make_test_capture.py writes, from the JAX
    package's generator with the same arguments."""
    import numpy as np
    from tempestsdr_tpu.sources.synthetic import render_test_pattern, synth_iq

    iq = synth_iq(render_test_pattern(628, 424), samplerate=8e6, pixelclock=628 * 424 * 60.0,
                  n_samples=int(8e6 * 0.4), noise=0.02, dtype=np.uint8)
    assert open(capture, "rb").read() == iq.tobytes()


def test_example_torch_replay_capture(capture, tmp_path):
    out = run_torch_example([os.path.join(EX, "torch_replay_capture.py"), capture, "8000000",
                             "uint8", "4", "--device", "cpu"], tmp_path)
    assert "frames" in out
    frames_dir = tmp_path / "frames"
    assert frames_dir.is_dir() and any(frames_dir.iterdir())


def test_example_torch_auto_detect_mode(capture, tmp_path):
    out = run_torch_example([os.path.join(EX, "torch_auto_detect_mode.py"), capture, "8000000",
                             "uint8", "--device", "cpu"], tmp_path)
    assert "detected:" in out, out
    # capture geometry is 628 lines @ 60 Hz (1056x628 VESA total)
    assert "60" in out and "628" in out.replace("\n", " "), out
    assert "plot peak:" in out, out
    assert (tmp_path / "autocorr_line.pgm").exists()


def test_example_torch_reference_plugin(capture, tmp_path, tmp_path_factory):
    import test_cplugin
    from tempestsdr_tpu_torch import native as native_io

    if not os.path.isdir(test_cplugin.REF) or shutil.which("gcc") is None \
            or not native_io.available():
        pytest.skip("reference source, gcc, or native IO unavailable")
    so = test_cplugin._build_plugin(tmp_path_factory.mktemp("torch_explug"), "ex")
    out = run_torch_example([os.path.join(EX, "torch_reference_plugin.py"), so,
                             f"{capture} 8000000 uint8", "--device", "cpu"], tmp_path)
    assert "streamed 8 frames" in out, out
    assert "loaded:" in out, out


def test_example_torch_multi_channel(tmp_path):
    """Its own 2 gloo ranks (spawn), 4 channels: every channel emits."""
    out = run_torch_example([os.path.join(EX, "torch_multi_channel.py"), "4", "--device", "cpu"],
                            tmp_path)
    assert "4 channels over 2 ranks" in out and "4 channels produced frames" in out, out
    assert all(f"channel {c}:" in out for c in range(4)), out
