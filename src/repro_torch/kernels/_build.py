"""Builds and loads the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. Nothing is built
when the package is imported: the first kernel launch builds every source,
one ``nvcc`` process per source, all started together. Libraries land in
``_build/`` beside this file (listed in ``.gitignore``), named by a hash of
their source and of the shared headers (``csrc/*.cuh``), so an unchanged
source is not rebuilt.
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
# returns the cudaError_t of its launch as an int and adds the number of
# kernels it launched to a host int (`launched`); token_logprob's also add
# the vocab chunks whose W tiles they loaded by TMA or 16-byte copies to
# another (`w_vector`).
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    "gqa_decode": {
        # q, k, v, pos, out, part, tickets, B, S, KVH, H, hd, dtype, softcap,
        # window, chunk, splits, warps, stream, launched
        "gqa_decode_launch": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _I, _I, _P,
                                                    _P],
    },
    "paged_decode": {
        # q, kp, vp, tbl, pos, out, part, tickets, B, n_total, page,
        # max_pages, KVH, H, hd, dtype, softcap, window, chunk, splits,
        # warps, stream, launched
        "paged_decode_launch": [_P] * 8 + [_I] * 8 + [_F, _I, _I, _I, _I,
                                                      _P, _P],
    },
    "sgmv": {
        # x, a, b, tmap, out, R, d, r, dout, x_dtype, add, scaling, bm, bn,
        # kc, cluster, row_tiles, stream, launched
        "sgmv_launch": [_P] * 5 + [_I] * 6 + [_F] + [_I] * 5 + [_P, _P],
    },
    "token_logprob": {
        # h, w, tgt, part, lp, ent, lse, R, d, V, ws_k, ws_v, vsplit,
        # slice_tiles, softcap, dtype, w_tma, stream, launched, w_vector
        "token_logprob_fwd_launch": [_P] * 7 + [_I, _I, _I, _L, _L, _I, _I,
                                                _F, _I, _I, _P, _P, _P],
        # h, w, tgt, lse, ent, g_lp, g_ent, dpart, dh, R, d, V, ws_k, ws_v,
        # vsplit, slice_tiles, softcap, stream, launched, w_vector
        "token_logprob_bwd_f32_launch": [_P] * 9 + [_I, _I, _I, _L, _L, _I,
                                                    _I, _F, _P, _P, _P],
        # h, w, tgt, lse, ent, g_lp, g_ent, dz, part, dh, R, d, V, ws_k,
        # ws_v, vc, splits, piece, p1_tiles, softcap, w_tma, stream,
        # launched, w_vector
        "token_logprob_bwd_bf16_launch": [_P] * 10 + [_I, _I, _I, _L, _L, _I,
                                                      _I, _I, _I, _F, _I, _P,
                                                      _P, _P],
    },
}


class LaunchCount:
    """A wrapper's count of kernel launches: an integer, ``n``, that the
    wrapper raises with ``add`` where it launches (by one a call, or by the
    CUDA kernels its C launcher reports) and a caller may read or set to 0.
    ``add`` holds a lock: the prefill workers launch beside the decode
    thread, and a bare ``n += k`` from two threads can lose an increment."""

    def __init__(self):
        self.n = 0
        self._count_lock = threading.Lock()

    def add(self, k: int = 1):
        with self._count_lock:
            self.n += k


class _Builder:
    """Builds every source once per process and holds the loaded libraries
    (created and owned by this module's single ``_BUILDER``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._libs: Dict[str, ctypes.CDLL] = {}
        self.build_seconds: Optional[float] = None
        self.logs: Dict[str, str] = {}
        self.loads = 0          # libraries loaded (analysis.RecompileSentinel)

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
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        for name in SIGNATURES:
            src = CSRC / f"{name}.cu"
            digest = hashlib.sha1(src.read_bytes() + headers
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
            self.loads += 1
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
