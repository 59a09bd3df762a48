"""The deployed code as input data: its parity-check matrix and a GF(2)
encoder for uniformly random codewords.

H is the RS-based LDPC construction of Djurdjevic et al. with s = 8,
rho = 72, gamma = 8 (2048 x 18432, row weight 72, column weight 8), its
columns in the shipped order (``data/deployed_colperm.npz``: new column s
is canonical column colperm[s], the order of the reference's
``decode_n18432_m2048_final.pchk``). It imports nothing of the program.

The encoder is the reduced row echelon form of H over GF(2): with pivot
columns P and free columns F, a codeword takes uniformly random bits on F
and x_P = A x_F (mod 2), A = RREF(H)[:, F]. It is built once per checkout
into ``CACHE_DIR`` (a fixed directory inside the checkout) and loaded
afterwards.
"""

from __future__ import annotations

import functools
import hashlib
import os
import time

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")
COLPERM_FILE = os.path.join(BENCH_DIR, "data", "deployed_colperm.npz")


@functools.lru_cache(maxsize=None)
def _gf256():
    exp = np.zeros(510, np.int64)
    x = 1
    for k in range(255):
        exp[k] = x
        x <<= 1
        if x & 256:
            x ^= 0b100011101  # 1 + x^2 + x^3 + x^4 + x^8
    exp[255:] = exp[:255]
    log = np.full(256, -1, np.int64)
    log[exp[:255]] = np.arange(255)
    return exp, log


def _mul(a, b):
    exp, log = _gf256()
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    return np.where((a == 0) | (b == 0), 0, exp[(log[a] + log[b]) % 255])


def rs_ldpc_checks(s: int = 8, rho: int = 72, gamma: int = 8) -> np.ndarray:
    """[gamma * q, rho] canonical column of each edge of each check row
    (q = 2^s; only s = 8 is built here)."""
    if s != 8:
        raise ValueError("only GF(256) is built")
    exp, log = _gf256()
    q = 1 << s
    # generator polynomial with roots alpha^1 .. alpha^(rho-2), low degree first
    g = np.array([exp[1], 1], np.int64)
    for k in range(1, rho - 2):
        nxt = np.zeros(len(g) + 1, np.int64)
        nxt[1:] = g
        nxt[:-1] ^= _mul(np.full(len(g), exp[(1 + k) % 255]), g)
        g = nxt
    row1 = np.concatenate([g, [0]])
    row2 = np.concatenate([[0], g])
    scal = np.concatenate([[0], exp[: q - 1]])  # the zero element, then alpha^0 .. alpha^(q-2)
    cw = (_mul(scal[:, None, None], row1[None, None, :]) ^ _mul(scal[None, :, None], row2[None, None, :]))
    cw = cw.reshape(q * q, rho)
    base = _mul(scal[:, None], cw[int(np.argmax(np.count_nonzero(cw, axis=1) == rho))][None, :])
    index = {row.tobytes(): k for k, row in enumerate(cw)}
    taken = np.zeros(q * q, bool)

    def mark(rows):
        for row in rows:
            k = index.get(row.tobytes())
            if k is not None:
                taken[k] = True

    cosets = [base]
    mark(base)
    for _ in range(1, gamma):
        coset = base ^ cw[int(np.argmax(~taken))][None, :]
        cosets.append(coset)
        mark(coset)
    Cb = np.concatenate(cosets)
    loc = np.where(Cb == 0, 0, log[np.maximum(Cb, 1)] + 1)
    return np.arange(rho)[None, :] * q + loc


@functools.lru_cache(maxsize=None)
def deployed_checks() -> np.ndarray:
    """[2048, 72] int64: the columns (shipped order) of each check's edges,
    ascending within a row."""
    colperm = np.load(COLPERM_FILE)["colperm"].astype(np.int64)
    inv = np.empty_like(colperm)
    inv[colperm] = np.arange(len(colperm))
    return np.sort(inv[rs_ldpc_checks()], axis=1)


N_VARS = 18432


def dense_h(checks: np.ndarray, n_vars: int = N_VARS) -> np.ndarray:
    H = np.zeros((len(checks), n_vars), np.uint8)
    H[np.arange(len(checks))[:, None], checks] = 1
    return H


def _rref_packed(H: np.ndarray):
    """Reduced row echelon form of a 0/1 matrix over GF(2), rows packed
    into uint64 words. Returns (packed rows of the rank's pivot rows, pivot
    columns)."""
    M, N = H.shape
    W = -(-N // 64)
    bits = np.zeros((M, W * 64), np.uint8)
    bits[:, :N] = H
    # bit b of word w holds column 64 w + b
    packed = np.packbits(bits, axis=1, bitorder="little").view("<u8").copy()
    rank, pivots = 0, []
    for c in range(N):
        if rank == M:
            break
        w, b = divmod(c, 64)
        col = (packed[rank:, w] >> np.uint64(b)) & np.uint64(1)
        hits = np.nonzero(col)[0]
        if len(hits) == 0:
            continue
        p = rank + int(hits[0])
        if p != rank:
            packed[[rank, p]] = packed[[p, rank]]
        has = ((packed[:, w] >> np.uint64(b)) & np.uint64(1)).astype(bool)
        has[rank] = False
        packed[has] ^= packed[rank]
        pivots.append(c)
        rank += 1
    return packed[:rank], np.asarray(pivots, np.int64)


def _unpack(packed: np.ndarray, n: int) -> np.ndarray:
    M, W = packed.shape
    by = packed.view(np.uint8).reshape(M, W, 8)
    return np.unpackbits(by, axis=2, bitorder="little").reshape(M, W * 64)[:, :n]


class Encoder:
    """x_P = A x_F (mod 2) for the deployed H; ``free`` and ``pivots`` are
    column indices, ``A`` is [rank, len(free)] uint8."""

    def __init__(self, A: np.ndarray, pivots: np.ndarray, free: np.ndarray, build_s: float):
        self.A, self.pivots, self.free, self.build_s = A, pivots, free, build_s

    @property
    def k(self) -> int:
        return len(self.free)

    def encode(self, info: np.ndarray, device=None) -> np.ndarray:
        """[B, k] information bits -> [B, N] codewords (numpy uint8); the
        product on ``device`` (torch) when given, else in numpy."""
        info = np.asarray(info, np.uint8)
        if device is not None:
            import torch

            # float64: the sums (at most 16,572) stay exact whatever the matmul settings
            A = torch.as_tensor(self.A, device=device, dtype=torch.float64)
            x = torch.as_tensor(info, device=device, dtype=torch.float64)
            parity = (torch.remainder(x @ A.T, 2.0)).to(torch.uint8).cpu().numpy()
        else:
            parity = (info.astype(np.float32) @ self.A.T.astype(np.float32)).astype(np.int64) % 2
        out = np.zeros((len(info), len(self.free) + len(self.pivots)), np.uint8)
        out[:, self.free] = info
        out[:, self.pivots] = parity
        return out

    def random_codewords(self, n: int, rng: np.random.Generator, device=None) -> np.ndarray:
        return self.encode(rng.integers(0, 2, size=(n, self.k), dtype=np.uint8), device)


def load_encoder(checks: np.ndarray | None = None, cache_dir: str = CACHE_DIR) -> Encoder:
    """The encoder of ``checks`` (default: the deployed H), from the cache
    when it holds one for the same matrix, else built and stored there.
    ``build_s`` is the build's seconds, 0 when it came from the cache."""
    checks = deployed_checks() if checks is None else checks
    key = hashlib.sha256(np.ascontiguousarray(checks, np.int64).tobytes()).hexdigest()[:16]
    path = os.path.join(cache_dir, f"encoder_{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            n_free = int(z["n_free"])
            return Encoder(np.unpackbits(z["A"], axis=1)[:, :n_free], z["pivots"], z["free"], 0.0)
    t0 = time.time()
    n_vars = int(checks.max()) + 1
    packed, pivots = _rref_packed(dense_h(checks, n_vars))
    free = np.setdiff1d(np.arange(n_vars), pivots)
    A = _unpack(packed, n_vars)[:, free]
    build_s = time.time() - t0
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.partial.npz"
    np.savez(tmp, A=np.packbits(A, axis=1), pivots=pivots, free=free, n_free=len(free))
    os.replace(tmp, path)
    return Encoder(A, pivots, free, build_s)


def syndrome_weight(checks: np.ndarray, words: np.ndarray) -> np.ndarray:
    """[B] number of unsatisfied checks of each [B, N] word."""
    words = np.asarray(words, np.uint8)
    return (words[:, checks].sum(axis=2) % 2).sum(axis=1)
