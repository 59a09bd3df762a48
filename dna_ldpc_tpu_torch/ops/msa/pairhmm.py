"""Batched 5-state pair-HMM: model constants, sequence packing, and the
posterior entry points.

Port of ``dna_ldpc_tpu/ops/msa/pairhmm.py`` and the packing of
``pairhmm_pallas.py``. Model (MUSCLE v5 ``pairhmm.h``): states M, IX, IY
(short inserts), JX, JY (long inserts) with MUSCLE's default nucleotide
parameters (``defaulthmmparams.cpp:243-279``); symbol 4 is the wildcard.
The match posterior of a read pair is exp(F_M + B_M - total), zeroed
below 0.01 (``calcposteriorflat.cpp``). Two routes compute it, chosen as
the JAX package's ``use_pallas(params)`` chooses:

- the default tables: the CUDA kernel K2 on the card, its plain torch
  twin on the CPU (``pairhmm_cuda.py``), which also give each pair's EA
  score (``batch_post_ea``); ``k2_posteriors`` hands it a ``ReadTable``,
  each read packed once (``pack_reads``), and the two rows of each pair;
- any other tables (``params``, the ensemble replicates' perturbed HMM):
  ``_posteriors_device``, the JAX package's antidiagonal sweeps as plain
  torch on either device. Backward comes from a forward DP over the
  reversed sequences with the transposed transition table (W[s][a][b],
  a = LX-i, b = LY-j), folded through trans[M][:].

``batch_posteriors`` returns per-pair [lx, ly] matrices rounded through
bf16, the value set the JAX package's transport carries. The sparse
top-k transport itself is left out.
"""

from __future__ import annotations

import collections.abc
import functools

import numpy as np
import torch

from ...utils.device import DEFAULT_DEVICE, require_device
from ...utils.profiling import count, span, tracing, wait

LOG_ZERO = -1e30
MIN_SPARSE_PROB = 0.01
BUDGET_BYTES = 2 << 30  # device bytes one pair-HMM, consistency or MSA batch may use

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


def _reverse_trans_table(trans6: np.ndarray) -> np.ndarray:
    """6x5 transition table for the W-DP: real rows transposed, START row
    unchanged (= start scores)."""
    out = np.full_like(trans6, np.float32(LOG_ZERO))
    out[:N_STATE, :] = trans6[:N_STATE, :].T
    out[START] = trans6[START]
    return out


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


def encode_seq(seq: str) -> np.ndarray:
    """ACGT -> 0..3, everything else -> wildcard 4."""
    return _ENCODE_TABLE[np.frombuffer(seq.encode("latin1"), np.uint8)]


def padded_lmax(max_len: int) -> int:
    """The DP width for reads up to ``max_len`` (multiple of 32, >= 32)."""
    return max(32, -(-max(int(max_len), 1) // 32) * 32)


def pack_reads(reads, Lmax: int):
    """Each read packed once: codes [R, Lmax] int8 (ACGT and acgt -> 0..3,
    all else and the padding -> wildcard 4) and lengths [R] int32, by one
    join of the reads and one masked scatter of their codes, with no loop
    per read."""
    lengths = np.fromiter(map(len, reads), np.int64, len(reads))
    if lengths.max(initial=0) > Lmax:
        raise ValueError(f"a read is longer than Lmax={Lmax}")
    codes = np.full((len(reads), Lmax), 4, np.int8)
    # row r's first lengths[r] cells, row after row, are the joined reads in order
    codes[np.arange(Lmax) < lengths[:, None]] = _ENCODE_TABLE[np.frombuffer("".join(reads).encode("ascii"), np.uint8)]
    return codes, lengths.astype(np.int32)


def encode_pairs(seqs_x, seqs_y, Lmax: int):
    """Host packing: codes [P, Lmax] int8 (ACGT -> 0..3, all else and the
    padding -> wildcard 4) and lengths [P] int32 for both sides."""
    P = len(seqs_x)
    codes, lengths = pack_reads(list(seqs_x) + list(seqs_y), Lmax)
    return codes[:P], codes[P:], lengths[:P], lengths[P:]


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


class ReadTable:
    """Reads packed once each for K2 (``pack_reads``): ``codes`` [R, Lmax]
    int8 and ``lengths`` [R] int32, row r for ``reads[r]``."""

    def __init__(self, reads: list[str], Lmax: int):
        self.reads, self.Lmax = reads, Lmax
        self.codes, self.lengths = pack_reads(reads, Lmax)

    def __len__(self) -> int:
        return len(self.reads)

    def side(self, rows) -> "TableSide":
        """One read of each pair, pair p's at row ``rows[p]``."""
        return TableSide(self, rows)


class TableSide(collections.abc.Sequence):
    """One side of read pairs as rows of a ``ReadTable``; a sequence of the
    reads themselves, so whatever takes a list of reads takes it too."""

    def __init__(self, table: ReadTable, rows):
        rows = np.asarray(rows, np.int32)
        if len(rows) and (rows.min() < 0 or rows.max() >= len(table)):
            raise IndexError("a row outside the read table")
        self.table, self.rows = table, rows

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, p):
        if isinstance(p, slice):
            return TableSide(self.table, self.rows[p])
        return self.table.reads[self.rows[p]]

    def __iter__(self):
        return map(self.table.reads.__getitem__, self.rows.tolist())


def _pair_rows(xs, ys, Lmax: int):
    """(read table, rows of x, rows of y) of the pairs (x_p, y_p): the
    sides' own table where both are sides of one table of width Lmax, else
    a table of x's reads then y's."""
    if isinstance(xs, TableSide) and isinstance(ys, TableSide) and xs.table is ys.table and xs.table.Lmax == Lmax:
        return xs.table, xs.rows, ys.rows
    P = len(xs)
    table = ReadTable(list(xs) + list(ys), Lmax)
    return table, np.arange(P, dtype=np.int32), np.arange(P, 2 * P, dtype=np.int32)


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``a`` on ``dev``; to the card through page-locked memory, with no wait."""
    t = torch.from_numpy(a)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def k2_posteriors(xs, ys, Lmax: int, dev: torch.device):
    """K2 (or its twin on the CPU) over read pairs (x_p, y_p) in batches
    sized from BUDGET_BYTES. ``xs``, ``ys``: lists of reads, or two sides
    of one ``ReadTable`` (``ReadTable.side``), whose table is uploaded as
    it is; lists make a table of both. Returns (posteriors [P, Lmax, Lmax]
    bf16 on ``dev`` — the value set the JAX package's transport carries —
    and the EA scores [P] f32 numpy). The table and the pairs' rows cross
    to the card once, the EA scores back once after the last batch.
    Counts on the innermost span (the callers' ``msa.k2``): ``reads`` (the
    table's rows), ``launches`` (K2's, its twin's calls on the CPU),
    ``pairs``, ``waits``, and while a profiler records ``cells`` = sum of
    (lx + 1)(ly + 1), the DP planes, and ``residues`` = sum of lx + ly."""
    from .pairhmm_cuda import kernel_layout, post_ea

    table, a, b = _pair_rows(xs, ys, Lmax)
    ntot = len(a)
    if ntot == 0:
        return torch.empty((0, Lmax, Lmax), dtype=torch.bfloat16, device=dev), np.zeros(0, np.float32)
    codes, lengths = _to_device(table.codes, dev), _to_device(table.lengths, dev)
    ab = _to_device(np.stack([a, b]), dev)
    count("reads", len(table))
    posts = torch.empty((ntot, Lmax, Lmax), dtype=torch.bfloat16, device=dev)
    ea = torch.empty(ntot, dtype=torch.float32, device=dev)
    # kernel bytes per pair: forward-M scratch + f32 posterior, and 2 B a cell of headroom
    per_pair = kernel_layout(Lmax)["fm_stride"] * 4 + Lmax * Lmax * 6
    chunk = max(1, BUDGET_BYTES // per_pair)
    post = torch.empty((min(chunk, ntot), Lmax, Lmax), dtype=torch.float32, device=dev)
    for lo in range(0, ntot, chunk):
        hi = min(ntot, lo + chunk)
        post_ea(codes, codes, lengths, lengths, Lmax, ab[0, lo:hi], ab[1, lo:hi], post[: hi - lo], ea[lo:hi])
        posts[lo:hi].copy_(post[: hi - lo])
        count("launches")
        count("pairs", hi - lo)
        if tracing():
            lx, ly = table.lengths[a[lo:hi]].astype(np.int64), table.lengths[b[lo:hi]].astype(np.int64)
            count("cells", int(((lx + 1) * (ly + 1)).sum()))
            count("residues", int((lx + ly).sum()))
    del post
    ea_all = ea.cpu().numpy()
    wait(dev)  # the EA download
    return posts, ea_all


# ---------------------------------------------------------------------------
# The general-table path (any HMM tables; plain torch on any device)
# ---------------------------------------------------------------------------


def _logsumexp(stack: torch.Tensor, dim: int) -> torch.Tensor:
    m = stack.amax(dim)
    return m + torch.log(torch.sum(torch.exp(stack - m.unsqueeze(dim)), dim))


def _tables(trans6, match, ins, dev):
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in (trans6, match, ins))


def _diag_step(d, prev2, prev1, X, Y, trans6, match, ins, Lmax, rows):
    """One antidiagonal slab [P, 6, W] from the previous two
    (``dna_ldpc_tpu/ops/msa/pairhmm.py:148``)."""
    P, W = X.shape[0], Lmax + 1
    j = d - rows
    xi = X[:, (rows - 1).clamp(0, Lmax - 1)]  # [P, W]
    yj = Y[:, (j - 1).clamp(0, Lmax - 1)]
    m_emit = match[xi, yj]
    x_emit = ins[xi]
    y_emit = ins[yj]

    def shift(a):
        return torch.cat([torch.full(a.shape[:-1] + (1,), LOG_ZERO, dtype=a.dtype, device=a.device), a[..., :-1]], -1)

    p2s = shift(prev2)  # (i-1, j-1)
    p1s = shift(prev1)  # (i-1, j)
    p1 = prev1          # (i, j-1)

    cM = _logsumexp(p2s + trans6[:, M][None, :, None], 1) + m_emit

    def ins_state(src, s, emit):
        terms = torch.stack(
            [src[:, M] + trans6[M, s], src[:, s] + trans6[s, s], src[:, START] + trans6[START, s]], 1
        )
        return _logsumexp(terms, 1) + emit

    cIX = ins_state(p1s, IX, x_emit)
    cJX = ins_state(p1s, JX, x_emit)
    cIY = ins_state(p1, IY, y_emit)
    cJY = ins_state(p1, JY, y_emit)

    j_ok = (j >= 0) & (j <= Lmax)
    valid = (rows <= min(d, Lmax)) & j_ok
    mask_m = ((rows >= 1) & (j >= 1) & valid)[None, :]
    mask_x = ((rows >= 1) & valid)[None, :]
    mask_y = ((j >= 1) & valid)[None, :]
    neg = torch.tensor(LOG_ZERO, dtype=torch.float32, device=X.device)
    return torch.stack(
        [
            torch.where(mask_m, cM, neg),
            torch.where(mask_x, cIX, neg),
            torch.where(mask_y, cIY, neg),
            torch.where(mask_x, cJX, neg),
            torch.where(mask_y, cJY, neg),
            neg.expand(P, W),  # START lives only at (0,0)
        ],
        1,
    )


def _dp_init(P, W, dev):
    init0 = torch.full((P, N_STATE + 1, W), LOG_ZERO, dtype=torch.float32, device=dev)
    init0[:, START, 0] = 0.0
    prevm1 = torch.full((P, N_STATE + 1, W), LOG_ZERO, dtype=torch.float32, device=dev)
    return prevm1, init0


def _diag_dp(X, Y, trans6, Lmax: int):
    """Full-tensor DP with the default emissions (testing path). Returns
    [2*Lmax+1, P, 5, Lmax+1] with V[s][i][j] = diags[i+j, :, s, i]."""
    _, _, match, ins = nucleo_params()
    dev = X.device
    trans6, match, ins = _tables(trans6, match, ins, dev)
    P, W, D = X.shape[0], Lmax + 1, 2 * Lmax
    rows = torch.arange(W, device=dev)
    prev2, prev1 = _dp_init(P, W, dev)
    out = torch.full((D + 1, P, N_STATE, W), LOG_ZERO, dtype=torch.float32, device=dev)
    for d in range(1, D + 1):
        cur = _diag_step(d, prev2, prev1, X, Y, trans6, match, ins, Lmax, rows)
        out[d] = cur[:, :N_STATE]
        prev2, prev1 = prev1, cur
    return out


def _posteriors_device(X, Y, Xr, Yr, lx, ly, Lmax: int, params=None):
    """Both sweeps + posterior assembly on the inputs' device
    (``dna_ldpc_tpu/ops/msa/pairhmm.py:231-307``). X, Y, Xr, Yr: [P, Lmax]
    integer codes (Xr, Yr the reversed reads); lx, ly: [P]. ``params``
    optionally overrides the HMM tables (start, trans6, match, ins) — the
    ensemble replicates' PerturbProbs path (align.cpp:81-120). Returns
    (post [P, Lmax, Lmax] zeroed below MIN_SPARSE_PROB, total [P])."""
    start, trans6, match, ins = nucleo_params() if params is None else params
    trans_rev = _reverse_trans_table(np.asarray(trans6, np.float32))
    dev = X.device
    start = torch.as_tensor(np.asarray(start, np.float32), device=dev)
    trans6_t, match, ins = _tables(trans6, match, ins, dev)
    trans_rev = torch.as_tensor(trans_rev, device=dev)
    X, Y, Xr, Yr = (a.to(torch.int64) for a in (X, Y, Xr, Yr))
    lx, ly = lx.to(torch.int64), ly.to(torch.int64)
    P, W, D = X.shape[0], Lmax + 1, 2 * Lmax
    rows = torch.arange(W, device=dev)
    end_d = lx + ly

    prev2, prev1 = _dp_init(P, W, dev)
    m_plane = torch.full((D + 1, P, W), LOG_ZERO, dtype=torch.float32, device=dev)
    corner = torch.full((P, N_STATE), LOG_ZERO, dtype=torch.float32, device=dev)
    lx_idx = lx[:, None, None].expand(P, N_STATE, 1)
    for d in range(1, D + 1):
        cur = _diag_step(d, prev2, prev1, X, Y, trans6_t, match, ins, Lmax, rows)
        m_plane[d] = cur[:, M]
        # all-state values at the per-pair corner (lx, ly)
        corner_vals = cur[:, :N_STATE].gather(2, lx_idx)[:, :, 0]
        corner = torch.where((end_d == d)[:, None], corner_vals, corner)
        prev2, prev1 = prev1, cur

    prev2, prev1 = _dp_init(P, W, dev)
    b_plane = torch.full((D + 1, P, W), LOG_ZERO, dtype=torch.float32, device=dev)
    for d in range(1, D + 1):
        cur = _diag_step(d, prev2, prev1, Xr, Yr, trans_rev, match, ins, Lmax, rows)
        b_plane[d] = _logsumexp(cur[:, :N_STATE] + trans6_t[M][None, :, None], 1)
        prev2, prev1 = prev1, cur

    total = _logsumexp(corner + start[None, :], 1)  # [P]

    # FM[p, i, j] = m_plane[i+j, p, i] for i, j in 1..Lmax
    ii = torch.arange(1, Lmax + 1, device=dev)
    FM = m_plane[ii[:, None] + ii[None, :], :, ii[:, None]].permute(2, 0, 1)  # [P, Lmax, Lmax]

    # BM[p, i, j] = b_plane[a+b, p, a], a = lx-i, b = ly-j; corner -> start[M]
    a = lx[:, None] - ii[None, :]
    b = ly[:, None] - ii[None, :]
    a_c = a.clamp(0, Lmax)
    d_idx = (a_c[:, :, None] + b.clamp(0, Lmax)[:, None, :]).clamp(0, D)
    flat = b_plane.permute(1, 0, 2).reshape(P, (D + 1) * W)
    BM = flat.gather(1, (d_idx * W + a_c[:, :, None]).reshape(P, -1)).reshape(P, Lmax, Lmax)
    at_corner = (a[:, :, None] == 0) & (b[:, None, :] == 0)
    BM = torch.where(at_corner, start[M], BM)

    post = torch.exp(torch.clamp(FM + BM - total[:, None, None], max=0.0))
    valid = (ii[None, :, None] <= lx[:, None, None]) & (ii[None, None, :] <= ly[:, None, None])
    post = torch.where(valid & (post >= MIN_SPARSE_PROB), post, 0.0)
    return post, total


def _rev_pad(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    out = np.full_like(codes, 4)
    for p in range(codes.shape[0]):
        L = int(lengths[p])
        out[p, :L] = codes[p, :L][::-1]
    return out


def _encode_batch(seqs_x, seqs_y, Lmax: int | None):
    """Codes of both reads and of both reversed reads, [P, Lmax] int8, and
    the lengths."""
    if Lmax is None:
        Lmax = padded_lmax(max((len(s) for s in list(seqs_x) + list(seqs_y)), default=1))
    X, Y, lx, ly = encode_pairs(seqs_x, seqs_y, Lmax)
    return X, Y, _rev_pad(X, lx), _rev_pad(Y, ly), lx, ly, Lmax


def _general_pair_bytes(Lmax: int) -> int:
    """Device bytes per pair of ``_posteriors_device``: the forward M and
    folded backward planes, and the assembly's f32 and int64 [Lmax, Lmax]
    temporaries."""
    return 8 * (2 * Lmax + 1) * (Lmax + 1) + 40 * Lmax * Lmax


def batch_posteriors(seqs_x, seqs_y, Lmax: int | None = None, params=None, device=DEFAULT_DEVICE) -> list[np.ndarray]:
    """Match posteriors of read pairs (x_p, y_p) on ``device``: per pair an
    [lx, ly] f32 array rounded through bf16. With the default tables
    (``params`` None) K2 computes them (its twin on the CPU); ``params``
    (start, trans6, match, ins) run the general-table path."""
    dev = require_device(device)
    if Lmax is None:
        Lmax = padded_lmax(max((len(s) for s in list(seqs_x) + list(seqs_y)), default=1))
    P = len(seqs_x)
    if params is None:
        with span("msa.k2"):
            post = k2_posteriors(seqs_x, seqs_y, Lmax, dev)[0]
        lx, ly = [len(s) for s in seqs_x], [len(s) for s in seqs_y]
    else:
        X, Y, Xr, Yr, lx, ly, _ = _encode_batch(seqs_x, seqs_y, Lmax)
        post = torch.empty((P, Lmax, Lmax), dtype=torch.bfloat16, device=dev)
        chunk = max(1, BUDGET_BYTES // _general_pair_bytes(Lmax))
        for lo in range(0, P, chunk):
            sl = slice(lo, min(P, lo + chunk))
            args = [torch.as_tensor(a[sl], device=dev) for a in (X, Y, Xr, Yr, lx, ly)]
            post[sl] = _posteriors_device(*args, Lmax, params)[0].to(torch.bfloat16)
    post = post.to(torch.float32).cpu().numpy()
    wait(dev)
    return [post[p, : lx[p], : ly[p]] for p in range(P)]


def pair_posteriors(seqs_x, seqs_y, device=DEFAULT_DEVICE) -> list[np.ndarray]:
    """Match posterior matrices for a batch of sequence pairs."""
    return batch_posteriors(seqs_x, seqs_y, device=device)


# ---------------------------------------------------------------------------
# Full-tensor reference path (kept for tests)
# ---------------------------------------------------------------------------


def _np_logsumexp(v, axis=None):
    m = np.max(v, axis=axis, keepdims=True)
    out = m + np.log(np.sum(np.exp(v - m), axis=axis, keepdims=True))
    return np.squeeze(out, axis=axis) if axis is not None else float(out.reshape(()))


def pair_fwd_bwd(seqs_x, seqs_y, Lmax: int | None = None, device=DEFAULT_DEVICE):
    """Both sweeps with every diagonal kept, on ``device``; returns numpy
    (fwd, w, lx, ly) for ``posterior_from_sweeps`` (testing path)."""
    dev = require_device(device)
    X, Y, Xr, Yr, lx, ly, Lmax = _encode_batch(seqs_x, seqs_y, Lmax)
    trans6 = nucleo_params()[1]
    fwd = _diag_dp(torch.as_tensor(X, device=dev).long(), torch.as_tensor(Y, device=dev).long(), trans6, Lmax)
    w = _diag_dp(torch.as_tensor(Xr, device=dev).long(), torch.as_tensor(Yr, device=dev).long(),
                 _reverse_trans_table(trans6), Lmax)
    return fwd.cpu().numpy(), w.cpu().numpy(), lx, ly


def posterior_from_sweeps(fwd, w, lx: int, ly: int, p: int) -> tuple[np.ndarray, float]:
    """Posterior + total for pair p of a pair_fwd_bwd batch (host math)."""
    startv, trans, _, _ = nucleo_params()

    iidx = np.arange(1, lx + 1)
    jidx = np.arange(1, ly + 1)
    FM = fwd[iidx[:, None] + jidx[None, :], p, M, iidx[:, None]]

    a = lx - iidx
    b = ly - jidx
    Wall = w[a[:, None] + b[None, :], p, :, a[:, None]]  # [lx, ly, 5]
    BM = _np_logsumexp(Wall + trans[M][None, None, :], axis=2)
    BM[-1, -1] = startv[M]  # (a, b) == (0, 0)

    Fend = fwd[lx + ly, p, :, lx]
    total = _np_logsumexp(Fend + startv)

    post = np.exp(np.minimum(FM + BM - total, 0.0))
    post[post < MIN_SPARSE_PROB] = 0.0
    return post.astype(np.float32), total
