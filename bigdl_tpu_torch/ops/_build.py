"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with :mod:`ctypes`. Libraries go to
``build/kernels/`` at the root of the checkout, named after a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source is rebuilt and an unchanged one is built once. Nothing is built
when a module is imported: the first launch builds, or a caller builds
every kernel up front with
:func:`build_all`, one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["KERNELS", "build_all", "load", "build_info"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("flash_fwd", "flash_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
_info: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> dict:
    """Compile every listed kernel that is not built yet, in parallel.
    Returns ``{name: path}``. Raises with nvcc's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)  # one build at a time per checkout
        t0 = time.perf_counter()
        procs = {}
        for name in names:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            procs[name] = (out, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (out, tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(rc {proc.returncode}):\n{log}")
            os.replace(tmp, out)
            _info[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return {name: _target(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all((name,))[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def build_info() -> dict:
    """``{name: {"seconds", "log"}}`` for the kernels this process
    compiled (the log holds ptxas's register and spill report)."""
    return dict(_info)
