"""Builds and loads the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. Nothing is built
when the package is imported: the first kernel launch builds every source,
one ``nvcc`` process per source, all started together. Libraries land in
``_build/`` beside this file (listed in ``.gitignore``), named by a hash of
their source, so an unchanged source is not rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C signatures of the exported launchers: name -> argtypes. Every launcher
# returns the cudaError_t of its launch as an int.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "gqa_decode": {
        # q, k, v, pos, out, B, S, KVH, H, hd, dtype, softcap, window, stream
        "gqa_decode_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                              _I, _P],
    },
    "sgmv": {
        # x, a, b, ids, h_part, y, R, d, r, dout, ksplit, x_dtype, stream
        "sgmv_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
}


class LaunchCount:
    """A wrapper's count of kernel launches: a plain integer, ``n``, that the
    wrapper raises by one where it launches and a caller may set to 0."""

    def __init__(self):
        self.n = 0


class _Builder:
    """Builds every source once per process and holds the loaded libraries
    (created and owned by this module's single ``_BUILDER``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._libs: Dict[str, ctypes.CDLL] = {}
        self.build_seconds: Optional[float] = None
        self.logs: Dict[str, str] = {}

    def library(self, name: str) -> ctypes.CDLL:
        with self._lock:
            if not self._libs:
                self._build_all()
            return self._libs[name]

    def _build_all(self):
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA kernels need the "
                               "CUDA toolkit on the machine with the card")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.monotonic()
        jobs = {}
        for name in SIGNATURES:
            src = CSRC / f"{name}.cu"
            digest = hashlib.sha1(src.read_bytes()
                                  + " ".join(NVCC_FLAGS).encode()).hexdigest()
            lib = BUILD_DIR / f"{name}-{digest[:12]}.so"
            if lib.exists():
                jobs[name] = (lib, None)
                continue
            tmp = BUILD_DIR / f"{name}-{digest[:12]}.{os.getpid()}.tmp.so"
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (lib, (proc, tmp))
        for name, (lib, job) in jobs.items():
            if job is None:
                self.logs[name] = "(cached)"
                continue
            proc, tmp = job
            out, _ = proc.communicate()
            self.logs[name] = out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
            os.replace(tmp, lib)
        for name, (lib, _) in jobs.items():
            handle = ctypes.CDLL(str(lib))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(handle, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            self._libs[name] = handle
        self.build_seconds = time.monotonic() - t0


_BUILDER = _Builder()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    return _BUILDER.library(name)


def build_all() -> float:
    """Build (or load) every kernel now; returns the seconds it took."""
    library(next(iter(SIGNATURES)))
    return _BUILDER.build_seconds


def build_logs() -> Dict[str, str]:
    """nvcc's output per source (``-Xptxas -v``: registers, shared memory,
    spills), or "(cached)" for a library that was already built."""
    return dict(_BUILDER.logs)


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
