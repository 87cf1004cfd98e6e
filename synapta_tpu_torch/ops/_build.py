"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file compiles into ONE shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o libsynapta_kernels-<hash>.so csrc/*.cu

The library lands in ``synapta_tpu_torch/_build/`` (git-ignored). Its name
carries a SHA-1 of the sources, the flags and ``nvcc --version``, so a
stale library is never loaded. The build happens at first use, never at
import time: machines without nvcc (the CPU test hosts) import every module.
Fast math stays off, so ``sqrtf`` and float compares match the PyTorch twins.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers / shared memory / spills go to the build log
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argtypes. Every pointer and the stream are
# c_void_p (a bare Python int would be cut to 32 bits); each returns the
# cudaError_t of its launches as an int (0 = success).
SIGNATURES = {
    # H, W, &cluster, &smem_bytes
    "synapta_cc_plan": [_I, _I, _P, _P],
    # mask, labels, rounds_out, B, H, W, max_rounds, connectivity, stream
    "synapta_cc": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # gray, out, edge_bits, B, H, W, line_k, grid_k, high, low, centred, stream
    "synapta_edge_stats": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P],
}

_LOCK = threading.Lock()
_LIB = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return found


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    nvcc = nvcc_path()
    version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout
    h = hashlib.sha1()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(version.encode())
    return BUILD_DIR / f"libsynapta_kernels-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr
    )
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def build_log() -> str:
    """nvcc's output (including ptxas resource usage) for the current
    library, or '' when it was built by another process without a log."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")
