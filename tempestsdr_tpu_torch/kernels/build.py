"""Builds the CUDA sources in ../csrc into shared libraries with a plain C
interface and loads them with ctypes.

Each source compiles with nvcc for sm_90a into build/lib<name>-<hash>.so at
first use (the first load builds every source); the hash of the source, of
the headers beside it (csrc/*.cuh) and of the flags names the library, so an
edited source never loads a stale build. build() starts one nvcc per missing
library, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # nvcc's output (ptxas register/smem report) per source


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD, f"lib{name}-{digest}.so")


def build(names) -> None:
    """Compile every named source whose library is missing, in parallel."""
    os.makedirs(BUILD, exist_ok=True)
    jobs = []
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed, with
    every other missing library of the package at once: a step loads
    several at its first blocks, and the first load then pays for the
    slowest nvcc instead of for each in turn."""
    from . import SOURCES

    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name, *(s for s in SOURCES if s != name)])
            lib = ctypes.CDLL(_lib_path(name))
            _LOADED[name] = lib
        return lib
