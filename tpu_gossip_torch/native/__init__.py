"""The host C++ Barabási–Albert generator, the port's own build.

``csrc/pa_edges.cc`` is a copy of the JAX package's generator. It is
compiled by the host C++ compiler (``g++ -O3 -fPIC -shared -std=c++17``,
``CXX`` overrides) at first use into ``tpu_gossip_torch/_build/``, named by
a hash of the source and the flags, and loaded with ``ctypes``. A failed
build raises: the Python loop of ``core/topology.py`` draws another graph,
so nothing falls back to it quietly.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

from tpu_gossip_torch.kernels.native import finish_compile, hashed_target, start_compile

__all__ = ["CXX_FLAGS", "start_build", "finish_build", "library", "pa_edges_native"]

_SRC = Path(__file__).resolve().parent / "csrc" / "pa_edges.cc"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_lib: ctypes.CDLL | None = None


def _target() -> Path:
    return hashed_target(_SRC, CXX_FLAGS, "pa_edges")


def start_build():
    """Start the compile unless the library is built; a job or None."""
    return start_compile([os.environ.get("CXX", "g++"), *CXX_FLAGS, str(_SRC)], _target())


def finish_build(job) -> Path:
    """Wait for :func:`start_build`'s job (raises on a failed build)."""
    if job is not None:
        finish_compile(job, f"{_SRC.name} (host C++)")
    return _target()


def library() -> ctypes.CDLL:
    """The loaded generator (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(finish_build(start_build())))
        lib.pa_edges.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
                                 ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.pa_edges.restype = ctypes.c_int64
        _lib = lib
    return _lib


def pa_edges_native(n: int, m: int, seed: int = 0) -> np.ndarray:
    """Preferential-attachment edges (E, 2) int64, lo < hi, sorted unique."""
    cap = m * (m + 1) // 2 + (n - m - 1) * m + 16
    out = np.empty((cap, 2), dtype=np.int64)
    wrote = library().pa_edges(n, m, seed, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
    if wrote < 0:
        raise RuntimeError(f"pa_edges failed with code {wrote}")
    e = out[:wrote]
    return np.unique(np.stack([np.minimum(e[:, 0], e[:, 1]), np.maximum(e[:, 0], e[:, 1])], axis=1), axis=0)
