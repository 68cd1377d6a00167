"""Build and load the hand-written CUDA kernels.

Each source in ``repro_torch/csrc/`` (``*.cu``, a plain C interface, no
PyTorch headers) is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library under ``<repo>/build/kernels/`` (listed in
``.gitignore``) and loaded with ``ctypes``.  The build runs at first use,
one ``nvcc`` per source, all started together; a library whose name
carries the hash of its source and of the shared headers (``*.cuh``) is
reused until one of them changes.  Processes that start together (the
ranks of a mesh) build once: :func:`build_all` holds an exclusive
``flock`` on ``BUILD_DIR/.lock``, so one process compiles and the others
wait for it, then find the libraries and load them.

Nothing here runs at import time: this module imports on a machine
without ``nvcc`` or a GPU, and only :func:`library` needs them.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("decode_step", "prefill_chunk", "gated_norm", "actiba", "cumba",
           "ssd_chunk", "qmatmul", "mamba1_step", "rglru_step", "rg_lru",
           "matmul_pwl", "flash_attention", "reduba")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# Seconds the last build spent in nvcc and its ptxas report, per source.
BUILD_LOG: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all() -> float:
    """Compile every source whose library is missing, in parallel, under
    the build directory's lock.  Returns the seconds spent; raises with
    nvcc's output on failure."""
    if all(_target(n).exists() for n in SOURCES):
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_missing()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_missing() -> float:
    missing = [n for n in SOURCES if not _target(n).exists()]
    if not missing:
        return 0.0
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in missing:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, _target(name))
    secs = time.perf_counter() - t0
    BUILD_LOG["seconds"] = secs
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return secs


def loaded() -> int:
    """How many libraries :func:`library` has loaded in this process (the
    serve stack's recompile sentinels count a load after warmup)."""
    return len(_LIBS)


def library(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib
