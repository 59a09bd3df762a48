"""Batched 5-state pair-HMM: model constants, sequence packing, and the
posterior + EA entry point.

Port of the parts of ``dna_ldpc_tpu/ops/msa/pairhmm.py`` and
``pairhmm_pallas.py`` the trial read-back runs. Model (MUSCLE v5
``pairhmm.h``): states M, IX, IY (short inserts), JX, JY (long inserts)
with MUSCLE's default nucleotide parameters
(``defaulthmmparams.cpp:243-279``); symbol 4 is the wildcard.
``batch_post_ea`` computes, per read pair, the match posterior
(``calcposteriorflat.cpp``: exp(F_M + B_M - total), zeroed below 0.01)
and the EA score (MEA max-DP over the bf16-rounded posterior) — with the
CUDA kernel K2 on the card and its plain torch twin on the CPU
(``pairhmm_cuda.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils.device import DEFAULT_DEVICE, require_device
from ...utils.dna import seqs_to_matrix

LOG_ZERO = -1e30
MIN_SPARSE_PROB = 0.01

# state indices (pairhmm.h HMMSTATE order: M, IX, IY, JX, JY)
M, IX, IY, JX, JY = 0, 1, 2, 3, 4
N_STATE = 5
START = 5  # virtual start state (row 5 of the 6x5 transition tables)


@functools.lru_cache(maxsize=None)
def nucleo_params():
    """(start[5], trans6[6,5], match[5,5], ins[5]) log-space float32;
    symbol 4 is the wildcard (non-ACGT). trans6[START] = start scores."""
    t = {
        ("M", "M"): 0.96, ("M", "IS"): 0.012, ("M", "IL"): 0.008,
        ("IS", "IS"): 0.35, ("IS", "M"): 0.65,
        ("IL", "IL"): 0.90, ("IL", "M"): 0.10,
    }
    diag, other = 0.12, 0.044

    start = np.full(N_STATE, LOG_ZERO, np.float64)
    start[M] = np.log(0.6)
    start[IX] = start[IY] = np.log(0.02)
    start[JX] = start[JY] = np.log(0.18)

    trans = np.full((N_STATE + 1, N_STATE), LOG_ZERO, np.float64)
    trans[M, M] = np.log(t[("M", "M")])
    for s in (IX, IY):
        trans[M, s] = np.log(t[("M", "IS")])
        trans[s, s] = np.log(t[("IS", "IS")])
        trans[s, M] = np.log(t[("IS", "M")])
    for s in (JX, JY):
        trans[M, s] = np.log(t[("M", "IL")])
        trans[s, s] = np.log(t[("IL", "IL")])
        trans[s, M] = np.log(t[("IL", "M")])
    trans[START] = start

    emit = np.full((4, 4), other, np.float64)
    np.fill_diagonal(emit, diag)
    match = np.full((5, 5), np.log(1.0 / 16), np.float64)
    match[:4, :4] = np.log(emit)
    ins = np.full(5, np.log(0.25), np.float64)
    ins[:4] = np.log(emit.sum(axis=1))

    f32 = lambda a: np.asarray(a, np.float32)
    return f32(start), f32(trans), f32(match), f32(ins)


# scalar constants of the recurrences, in the order the CUDA kernel reads
# them (csrc/pairhmm.cu, struct Consts)
CONST_NAMES = (
    "tMM", "tMIS", "tMIL", "tISM", "tISIS", "tILM", "tILIL",
    "sM", "sIS", "sIL", "eDIAG", "eOTH", "eW16", "eMARG", "eW4",
)


@functools.lru_cache(maxsize=None)
def hmm_consts() -> np.ndarray:
    """The 15 float32 scalars both implementations use, from the same
    tables as the reference (bit-identical parameterization)."""
    start, trans6, match, ins = nucleo_params()
    c = {
        "tMM": trans6[M, M], "tMIS": trans6[M, IX], "tMIL": trans6[M, JX],
        "tISM": trans6[IX, M], "tISIS": trans6[IX, IX],
        "tILM": trans6[JX, M], "tILIL": trans6[JX, JX],
        "sM": start[M], "sIS": start[IX], "sIL": start[JX],
        "eDIAG": match[0, 0], "eOTH": match[0, 1], "eW16": match[4, 4],
        "eMARG": ins[0], "eW4": ins[4],
    }
    return np.array([c[k] for k in CONST_NAMES], np.float32)


_ENCODE_TABLE = np.full(256, 4, np.int8)
for _i, _c in enumerate("ACGT"):
    _ENCODE_TABLE[ord(_c)] = _i
    _ENCODE_TABLE[ord(_c.lower())] = _i


def padded_lmax(max_len: int) -> int:
    """The DP width for reads up to ``max_len`` (multiple of 32, >= 32)."""
    return max(32, -(-max(int(max_len), 1) // 32) * 32)


def encode_pairs(seqs_x, seqs_y, Lmax: int):
    """Host packing: codes [P, Lmax] int8 (ACGT -> 0..3, all else and the
    padding -> wildcard 4) and lengths [P] int32 for both sides."""
    lx = np.array([len(s) for s in seqs_x], np.int32)
    ly = np.array([len(s) for s in seqs_y], np.int32)
    if max(lx.max(initial=0), ly.max(initial=0)) > Lmax:
        raise ValueError(f"a read is longer than Lmax={Lmax}")
    X = _ENCODE_TABLE[seqs_to_matrix(seqs_x, pad=Lmax)]
    Y = _ENCODE_TABLE[seqs_to_matrix(seqs_y, pad=Lmax)]
    return X, Y, lx, ly


def batch_post_ea(seqs_x, seqs_y, Lmax: int | None = None, device=DEFAULT_DEVICE):
    """Match posteriors and EA scores for read pairs (x_p, y_p).

    Returns (post [P, Lmax, Lmax] f32 on ``device`` — cell (i, j) of pair p
    at post[p, i-1, j-1], zero outside [1..lx] x [1..ly] — ea [P] f32 on
    ``device``, lx [P], ly [P], Lmax)."""
    from .pairhmm_cuda import post_ea

    dev = require_device(device)
    if Lmax is None:
        Lmax = padded_lmax(max((len(s) for s in list(seqs_x) + list(seqs_y)), default=1))
    X, Y, lx, ly = encode_pairs(seqs_x, seqs_y, Lmax)
    post, ea = post_ea(
        torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev),
        torch.as_tensor(lx, device=dev), torch.as_tensor(ly, device=dev), Lmax,
    )
    return post, ea, lx, ly, Lmax
