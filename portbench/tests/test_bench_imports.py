"""What a run loads: no module whose top-level name is JAX's or the JAX
package's (compared whole, since the port's name begins with the JAX
package's), and a reference that loads nothing of the port."""

import os
import subprocess
import sys

import pytest

from portbench import harness, manifest

BENCH = os.path.join(manifest.ROOT, "portbench")


def _sources(*parts):
    top = os.path.join(BENCH, *parts)
    for dp, _, fs in os.walk(top):
        if "tests" in os.path.relpath(dp, BENCH).split(os.sep):
            continue
        yield from (os.path.join(dp, f) for f in fs if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not manifest.imported(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(list(_sources("reference")) + list(_sources("gen")) +
                                        [os.path.join(BENCH, "modes.py")]),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_the_reference_imports_nothing_of_the_port(path):
    assert "tempestsdr_tpu_torch" not in manifest.imported(path)


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=manifest.ROOT))
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Everything a run imports, the port with it, in a fresh process; the
    names compared whole."""
    names = _loaded(
        "import sys, runpy, importlib\n"
        "from portbench import harness, manifest, control, tracing\n"
        "from portbench.reference import check\n"
        "m = manifest.load()\n"
        "cells = [manifest.Cell(manifest.ROOT, m, w['name']) for w in m['workloads']]\n"
        "[c.driver.source_class() for c in cells]\n"
        "import tempestsdr_tpu_torch.stream.multisession, tempestsdr_tpu_torch.stream.session\n"
        "import tempestsdr_tpu_torch.config, tempestsdr_tpu_torch.params\n"
        "print(' '.join(sorted({k.split('.')[0] for k in sys.modules})))\n")
    assert "tempestsdr_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    names = _loaded(
        "import sys\n"
        "from portbench.reference import check, step, sync, geometry\n"
        "from portbench.gen import emanation\n"
        "print(' '.join(sorted({k.split('.')[0] for k in sys.modules})))\n")
    assert not names & {"tempestsdr_tpu_torch", *harness.FORBIDDEN}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tempestsdr_tpu_torchlike", sys)
    assert "tempestsdr_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tempestsdr_tpu.stream", sys)
    assert "tempestsdr_tpu" in harness.forbidden_modules()
