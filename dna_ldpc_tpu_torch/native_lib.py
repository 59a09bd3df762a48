"""Build/load the host-side C++ library (``native/ingest.cpp``).

The same source and compiler flags as ``dna_ldpc_tpu/native_lib.py``, so
both packages run bit-identical host code. The shared object is compiled
with g++ at first use into the repository's ``build/torch_kernels/``
directory and bound with ctypes. A failed build raises: the port has no
numpy fallback for these entry points.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from .cuda_lib import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "native", "ingest.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build(so_path: str, src: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, src, "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src}:\n{proc.stderr}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> ctypes.CDLL:
    """The native library, compiled on first call (raises on failure)."""
    global _lib
    with _lock:
        if _lib is None:
            src = os.path.abspath(SRC)
            with open(src, "rb") as f:
                digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()
            so_path = os.path.join(BUILD_DIR, f"ingest_{digest[:16]}.so")
            if not os.path.exists(so_path):
                _build(so_path, src)
            lib = ctypes.CDLL(so_path)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            f32p = ctypes.POINTER(ctypes.c_float)
            f64p = ctypes.POINTER(ctypes.c_double)
            lib.count_trial_llrs.argtypes = [
                u8p, i64p, i32p, i64p, i64p, i64p, i32p,
                ctypes.c_int64, ctypes.c_double, f64p, i32p,
            ]
            lib.edit_distance_batch.argtypes = [u8p, i64p, i32p, i32p, i32p, ctypes.c_int64, i32p]
            lib.mea_score.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32, f32p]
            lib.merge_overlap_batch.argtypes = [
                u8p, u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, i64p, i64p,
            ]
            lib.msa_progressive_refine.argtypes = [
                u8p, i64p, i32p, ctypes.c_int32,       # seqs
                i32p,                                  # joins
                f32p, i64p, i32p, i32p,                # posts
                u8p, ctypes.c_int32, ctypes.c_int32,   # masks
                u8p, ctypes.c_int32, i32p,             # out
            ]
            for fn in (lib.count_trial_llrs, lib.edit_distance_batch, lib.mea_score,
                       lib.merge_overlap_batch, lib.msa_progressive_refine):
                fn.restype = None
            _lib = lib
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def pack_seqs(seqs) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(bytes, offsets int64, lengths int32) of a list of strings."""
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    offsets = np.zeros(len(lengths), dtype=np.int64)
    if len(lengths) > 1:
        offsets[1:] = np.cumsum(lengths[:-1], dtype=np.int64)
    buf = np.frombuffer("".join(seqs).encode("latin1"), dtype=np.uint8).copy()
    return buf, offsets, lengths


def count_trial_llrs_native(
    bytes_buf: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    quals: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    strand_of_cluster: np.ndarray,
    mag: float,
    llr_out: np.ndarray,
) -> np.ndarray:
    """Per-cluster status (0 = counted natively, 1 = needs the MSA path).
    llr_out [18432, 272] float64 C-contiguous is written in place."""
    lib = load()
    n = len(starts)
    if llr_out.dtype != np.float64 or not llr_out.flags.c_contiguous:
        raise ValueError("llr_out must be C-contiguous float64")
    args = [
        np.ascontiguousarray(bytes_buf, np.uint8), np.ascontiguousarray(offsets, np.int64),
        np.ascontiguousarray(lengths, np.int32), np.ascontiguousarray(quals, np.int64),
        np.ascontiguousarray(starts, np.int64), np.ascontiguousarray(ends, np.int64),
        np.ascontiguousarray(strand_of_cluster, np.int32),
    ]
    status = np.zeros(n, dtype=np.int32)
    lib.count_trial_llrs(
        _ptr(args[0], ctypes.c_uint8), _ptr(args[1], ctypes.c_int64),
        _ptr(args[2], ctypes.c_int32), _ptr(args[3], ctypes.c_int64),
        _ptr(args[4], ctypes.c_int64), _ptr(args[5], ctypes.c_int64),
        _ptr(args[6], ctypes.c_int32), ctypes.c_int64(n), ctypes.c_double(mag),
        _ptr(llr_out, ctypes.c_double), _ptr(status, ctypes.c_int32),
    )
    return status


def edit_distance_batch_native(
    bytes_buf: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    pairs_a: np.ndarray,
    pairs_b: np.ndarray,
    n_threads: int | None = None,
) -> np.ndarray:
    """Levenshtein distances of the given sequence pairs; pairs are split
    across OS threads (ctypes releases the GIL during the native call)."""
    lib = load()
    buf = np.ascontiguousarray(bytes_buf, np.uint8)
    offs = np.ascontiguousarray(offsets, np.int64)
    lens = np.ascontiguousarray(lengths, np.int32)
    pa = np.ascontiguousarray(pairs_a, np.int32)
    pb = np.ascontiguousarray(pairs_b, np.int32)
    n = len(pa)
    out = np.zeros(n, dtype=np.int32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)

    def run(lo: int, hi: int) -> None:
        if hi > lo:
            lib.edit_distance_batch(
                _ptr(buf, ctypes.c_uint8), _ptr(offs, ctypes.c_int64), _ptr(lens, ctypes.c_int32),
                _ptr(pa[lo:hi], ctypes.c_int32), _ptr(pb[lo:hi], ctypes.c_int32),
                ctypes.c_int64(hi - lo), _ptr(out[lo:hi], ctypes.c_int32),
            )

    if n_threads <= 1 or n < 2048:
        run(0, n)
        return out
    from concurrent.futures import ThreadPoolExecutor

    step = -(-n // n_threads)
    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        list(pool.map(lambda lo: run(lo, min(lo + step, n)), range(0, n, step)))
    return out


def mea_score_native(post: np.ndarray) -> float:
    """MEA alignment score (CalcAlnScoreFlat) of one [LX, LY] posterior."""
    lib = load()
    post = np.ascontiguousarray(post, np.float32)
    LX, LY = post.shape
    score = np.zeros(1, np.float32)
    lib.mea_score(_ptr(post, ctypes.c_float), ctypes.c_int32(LX), ctypes.c_int32(LY),
                  _ptr(score, ctypes.c_float))
    return float(score[0])


def merge_overlap_batch_native(
    m1: np.ndarray, m2: np.ndarray, l1: np.ndarray, l2: np.ndarray, min_overlap: int
) -> tuple[np.ndarray, np.ndarray]:
    """Best-overlap scoring for paired-end merging (pipeline/ingest.py):
    returns (best_o, best_mm) per pair. m1/m2: [n, L] uint8 (m2 already
    reverse-complemented); l1/l2: read lengths, at most L."""
    lib = load()
    m1 = np.ascontiguousarray(m1, np.uint8)
    m2 = np.ascontiguousarray(m2, np.uint8)
    l1 = np.ascontiguousarray(l1, np.int64)
    l2 = np.ascontiguousarray(l2, np.int64)
    n, L = m1.shape
    if m2.shape != (n, L) or l1.shape != (n,) or l2.shape != (n,) or (n and max(l1.max(), l2.max()) > L):
        raise ValueError("merge_overlap_batch_native: inconsistent shapes or lengths")
    best_o = np.zeros(n, np.int64)
    best_mm = np.zeros(n, np.int64)
    lib.merge_overlap_batch(
        _ptr(m1, ctypes.c_uint8), _ptr(m2, ctypes.c_uint8),
        _ptr(l1, ctypes.c_int64), _ptr(l2, ctypes.c_int64),
        ctypes.c_int64(n), ctypes.c_int64(L), ctypes.c_int32(min_overlap),
        _ptr(best_o, ctypes.c_int64), _ptr(best_mm, ctypes.c_int64),
    )
    return best_o, best_mm


def msa_progressive_refine_native(
    seqs: list[str],
    joins: list[tuple[int, int]],
    pair_posts: list[np.ndarray],
    masks: np.ndarray,
    converge_after: int,
) -> list[str]:
    """Progressive alignment + refinement of one cluster (MUSCLE
    ProgressiveAlign/RefineIter) over its cluster_pairs-ordered
    posteriors. ``masks``: [iters, n] uint8 bipartitions with all-same
    rows removed. Returns aligned rows in input order."""
    lib = load()
    n = len(seqs)
    buf, offs, lens = pack_seqs(seqs)
    joins_arr = np.ascontiguousarray(np.asarray(joins, np.int32).reshape(-1))
    posts = [np.ascontiguousarray(p, np.float32) for p in pair_posts]
    if len(posts) != n * (n - 1) // 2:
        raise ValueError(f"{n} sequences need {n * (n - 1) // 2} pair posteriors, got {len(posts)}")
    post_r = np.array([p.shape[0] for p in posts], np.int32)
    post_c = np.array([p.shape[1] for p in posts], np.int32)
    sizes = post_r.astype(np.int64) * post_c
    post_off = np.zeros(len(posts), np.int64)
    post_off[1:] = np.cumsum(sizes[:-1])
    post_buf = np.concatenate([p.reshape(-1) for p in posts]) if posts else np.zeros(0, np.float32)

    masks = np.ascontiguousarray(masks, np.uint8)
    out_cap = int(lens.sum()) + 8
    out_buf = np.zeros((n, out_cap), np.uint8)
    out_cols = np.zeros(1, np.int32)
    lib.msa_progressive_refine(
        _ptr(buf, ctypes.c_uint8), _ptr(offs, ctypes.c_int64),
        _ptr(lens, ctypes.c_int32), ctypes.c_int32(n),
        _ptr(joins_arr, ctypes.c_int32),
        _ptr(post_buf, ctypes.c_float), _ptr(post_off, ctypes.c_int64),
        _ptr(post_r, ctypes.c_int32), _ptr(post_c, ctypes.c_int32),
        _ptr(masks, ctypes.c_uint8), ctypes.c_int32(masks.shape[0] if masks.size else 0),
        ctypes.c_int32(converge_after),
        _ptr(out_buf, ctypes.c_uint8), ctypes.c_int32(out_cap),
        _ptr(out_cols, ctypes.c_int32),
    )
    cols = int(out_cols[0])
    if cols <= 0:
        raise RuntimeError("native alignment overflowed its output buffer")
    return [out_buf[i, :cols].tobytes().decode("latin1") for i in range(n)]
