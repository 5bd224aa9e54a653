"""Builds the package's CUDA sources (`csrc/*.cu`) with `nvcc` for sm_90a
and loads them with ctypes.

Each `.cu` file becomes one shared library with a plain C interface,
`_build/<name>-<hash>.so` inside the package. The hash covers the source,
every `.cuh` header in `csrc/` and the compiler flags, so an edited source is
rebuilt at its next use and an unchanged one is loaded as it is. `nvcc`'s
output (with `-Xptxas -v`: registers, shared memory and spills per kernel) is
kept beside the library as `<name>-<hash>.log`.

The host library of the RL data path (`csrc/host_buffer.cpp`: the replay
buffer and the CartPole pool) is C++ for the CPU, built the same way with
`g++` by `load_host` (hashed on its source and flags; no card needed).
A library is written under a temporary name and moved into place with
`os.replace`, so processes that build at once never load a partial file.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra")


def sources() -> list[str]:
    """Names (without `.cu`) of every CUDA source of the package."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of gcm_tpu_torch are built on "
            "first use and need the CUDA toolkit; on a machine without a "
            "card, run on the CPU (device='cpu')")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Starts nvcc for csrc/<name>.cu unless its library is built; returns
    (target, process or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = open(target.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return target, (proc, tmp)


def _finish(name: str, target: Path, job) -> None:
    if job is None:
        return
    proc, tmp = job
    if proc.wait() != 0:
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu:\n"
            + target.with_suffix(".log").read_text())
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing


def build_all() -> dict[str, float]:
    """Builds every source that is not built yet, one nvcc per source, all
    started together. Returns the wall seconds each source waited for."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in sources()}
    seconds = {}
    for name, (target, job) in jobs.items():
        _finish(name, target, job)
        seconds[name] = time.perf_counter() - t0
    return seconds


def build_log(name: str) -> str:
    path = _target(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The shared library built from csrc/<name>.cu, built first if needed."""
    target, job = _start(name)
    _finish(name, target, job)
    return ctypes.CDLL(str(target))


def _host_target(name: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((CSRC / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


@functools.cache
def load_host(name: str) -> ctypes.CDLL:
    """The host shared library built from csrc/<name>.cpp with g++, built
    first if needed."""
    target = _host_target(name)
    if not target.exists():
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError(f"no C++ compiler (g++) to build "
                               f"csrc/{name}.cpp")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")],
            capture_output=True, text=True)
        target.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on csrc/{name}.cpp:\n"
                               + proc.stdout + proc.stderr)
        os.replace(tmp, target)
    return ctypes.CDLL(str(target))
