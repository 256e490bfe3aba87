"""Build, load and count the port's hand-written CUDA kernels.

Each source under ``tpu_gossip_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Builds happen at
first use, never at import, into ``tpu_gossip_torch/_build/``, named by a
hash of the source and the flags, so a changed source rebuilds and an
unchanged one loads. :func:`build_all` starts one ``nvcc`` per source at
once. :func:`start_compile` and :func:`finish_compile` are the same
hashed, atomic build for any compiler (the host library of
``tpu_gossip_torch/native`` uses them with ``g++``).

Every kernel wrapper counts its launches in :data:`LAUNCHES` (one per kernel
launch, nowhere else), so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

__all__ = [
    "SOURCES",
    "LAUNCHES",
    "K1_ENTRIES",
    "reset_launches",
    "build_all",
    "start_compile",
    "finish_compile",
    "library",
    "check",
    "stream_of",
    "require_cuda",
    "require_aligned",
]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

SOURCES = {
    "lane_shuffle": "lane_shuffle.cu",
    "fold_planes": "fold_planes.cu",
    "round_tail": "round_tail.cu",
    "staircase_segment": "staircase_segment.cu",
    "round_tail_words": "round_tail_words.cu",
    "stream_segment": "stream_segment.cu",
    "gather_probes": "gather_probes.cu",
}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "lane_shuffle": {
        f"{entry}_{t}": (_P, _P, _P, _L, _P)
        for entry in ("lane_shuffle", "lane_shuffle_t", "tinv_lane_shuffle") for t in ("i8", "i32")
    },
    "fold_planes": {
        "fold_planes_or": (_P, _P, _P, _P, _L, _P),
        "fold_planes_sum": (_P, _P, _P, _P, _L, _P),
    },
    "round_tail": {
        "round_tail": (_P,) * 15 + (_L, _I, _I, _I, _I, _I, _P),
    },
    "staircase_segment": {
        "staircase_segment": (_P,) * 6 + (_L, _I, _I, _P),
    },
    "round_tail_words": {
        "round_tail_words": (_P,) * 15 + (_L, _I, _I, _I, _I, _I, _P),
    },
    "stream_segment": {
        "stream_segment": (_P,) * 5 + (_L, _I, _I, _P),
    },
    "gather_probes": {
        "lane_gather": (_P, _P, _P, _L, _L, _L, _P),
        "lane_gather_staged": (_P, _P, _P, _L, _L, _L, _L, _L, _P),
        "sublane_gather": (_P, _P, _P, _L, _I, _P),
        "sublane_gather_slab": (_P, _P, _P, _L, _L, _L, _P),
    },
}

# launch counts per kernel entry (K2 counts its OR and SUM forms apart)
LAUNCHES: dict[str, int] = {"lane_shuffle": 0, "fold_planes_or": 0, "fold_planes_sum": 0, "round_tail": 0,
                            "staircase_segment": 0, "round_tail_words": 0, "stream_segment": 0,
                            "lane_gather": 0, "sublane_gather": 0}
# K1's launches by entry; each also counts once under LAUNCHES["lane_shuffle"]
K1_ENTRIES: dict[str, int] = {"lane_shuffle": 0, "lane_shuffle_t": 0, "tinv_lane_shuffle": 0}
_LOADED: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    """Set every kernel's launch count to 0 (K1's counts by entry too)."""
    for counts in (LAUNCHES, K1_ENTRIES):
        for name in counts:
            counts[name] = 0


def _nvcc() -> str:
    """nvcc of the toolkit torch finds (CUDA_HOME, CUDA_PATH, PATH, or the
    default install location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def hashed_target(src: Path, flags: tuple, stem: str) -> Path:
    """``_build/<stem>-<hash of source, flags and the headers beside the
    source>.so``: a changed shared header rebuilds every source."""
    headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    return _BUILD / f"{stem}-{digest}.so"


def _target(name: str) -> Path:
    return hashed_target(_CSRC / SOURCES[name], NVCC_FLAGS, name)


def start_compile(cmd: list[str], out: Path) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start ``cmd + ["-o", tmp]`` unless ``out`` is built; the job for
    :func:`finish_compile`, or None."""
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def finish_compile(job, what: str) -> None:
    """Wait for a build; raise with the compiler's log when it fails."""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"build of {what} failed:\n{log}")
    os.replace(tmp, out)


def _start_build(name: str):
    return start_compile([_nvcc(), *NVCC_FLAGS, str(_CSRC / SOURCES[name])], _target(name))


def _finish_build(name: str, job) -> None:
    finish_compile(job, f"{SOURCES[name]} (nvcc)")


def build_all() -> dict[str, Path]:
    """Compile every source that is not built yet, all ``nvcc`` processes
    at once; returns name -> shared library path."""
    jobs = {name: _start_build(name) for name in SOURCES}
    try:
        for name, job in jobs.items():
            if job is not None:
                _finish_build(name, job)
    finally:
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return {name: _target(name) for name in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    job = _start_build(name)
    if job is not None:
        _finish_build(name, job)
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _LOADED[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a kernel's C entry reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Every operand on one CUDA device and contiguous, or raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: operands must share one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def require_aligned(what: str, *tensors: torch.Tensor, align: int = 16) -> None:
    """Every operand's data starts on an ``align``-byte boundary (the
    kernels' 16-byte accesses), or raise."""
    for t in tensors:
        if t.data_ptr() % align:
            raise ValueError(f"{what}: operands must start on a {align}-byte boundary")
