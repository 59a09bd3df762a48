"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source in ``csrc/`` for Hopper
(``sm_90a``), one process per source, all started together, and links the
objects into one shared library with a plain C interface, under the
repository's ``build/torch_kernels/`` directory; ctypes loads it. The
library's name carries a hash of the sources and flags, so an edited
kernel is rebuilt and a current one is reused. Pointers, sizes and the
current CUDA stream cross the interface as ``c_void_p`` / ``c_int``;
every entry point returns ``cudaGetLastError()`` after its launch.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use on a CUDA machine")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")) + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libdna_ldpc_kernels_{h.hexdigest()[:16]}.so")


def _build(so_path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cu = [p for p in _sources() if p.endswith(".cu")]
        objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in cu]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, p], stderr=subprocess.PIPE, text=True)
            for p, o in zip(cu, objs)
        ]
        failed = []
        for p, proc in zip(cu, procs):
            err = proc.communicate()[1]
            if proc.returncode:
                failed.append(f"{os.path.basename(p)}:\n{err}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, so_path)  # atomic: a concurrent build never sees half a file


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first call."""
    global _lib
    with _lock:
        if _lib is None:
            so_path = library_path()
            if not os.path.exists(so_path):
                _build(so_path)
            lib = ctypes.CDLL(so_path)
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.bp_blocked_launch.argtypes = [vp] * 6 + [ci] * 11 + [cf, vp]
            lib.bp_blocked_launch.restype = ci
            lib.pairhmm_launch.argtypes = [vp] * 9 + [ci, ci, ctypes.c_longlong, vp]
            lib.pairhmm_launch.restype = ci
            lib.merge_dp_launch.argtypes = [vp] * 9 + [ci] * 4 + [vp]
            lib.merge_dp_launch.restype = ci
            cl = ctypes.c_longlong
            lib.consistency_launch.argtypes = [vp, vp, ci, cl, ci, vp, ci, cl, ci, vp, vp, ci, vp, ci, vp]
            lib.consistency_launch.restype = ci
            lib.window_bp_launch.argtypes = [vp, cl, vp, vp] + [ci] * 7 + [ctypes.c_float] + [vp] * 6
            lib.window_bp_launch.restype = ci
            lib.dna_cuda_error_string.argtypes = [ci]
            lib.dna_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if status != 0:
        msg = load().dna_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
