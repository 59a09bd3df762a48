"""Plain pair-HMM match posteriors of two reads, in torch (float32).

MUSCLE v5's nucleotide pair HMM (the model of ``pairhmm.h``): five states,
match M, short inserts IX / IY and long inserts JX / JY, with
P(M->M) = 0.96, P(M->short) = 0.012, P(M->long) = 0.008, short inserts
extending with 0.35 and returning with 0.65, long ones 0.90 / 0.10; start
(and end) probabilities 0.6 (M), 0.02 (each short), 0.18 (each long);
a match emits a base pair with 0.12 on the diagonal and 0.044 off it, an
insert the row sum of that table, anything that is not ACGT 1/16 (pair)
or 1/4 (single).

``posteriors`` runs the forward recursion in log space along
antidiagonals, the backward recursion as a forward pass over the reversed
reads with the transposed transitions, and returns P(x_i ~ y_j) for every
cell, values under 0.01 set to 0 (the sparse posteriors MUSCLE keeps).
The deployed pipeline keeps them in bfloat16 (``at_rest``). Nothing of the
program is imported.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

LOG_ZERO = -1e30
MIN_PROB = 0.01
M, IX, IY, JX, JY, START = 0, 1, 2, 3, 4, 5


@functools.lru_cache(maxsize=None)
def model():
    """(trans [6, 5] log P(from -> to), row 5 = start; match [5, 5];
    ins [5]) as float32 numpy."""
    trans = np.full((6, 5), LOG_ZERO)
    trans[M, M] = math.log(0.96)
    for s, stay, back, enter in ((IX, 0.35, 0.65, 0.012), (IY, 0.35, 0.65, 0.012),
                                 (JX, 0.90, 0.10, 0.008), (JY, 0.90, 0.10, 0.008)):
        trans[M, s] = math.log(enter)
        trans[s, s] = math.log(stay)
        trans[s, M] = math.log(back)
    trans[START] = [math.log(p) for p in (0.6, 0.02, 0.02, 0.18, 0.18)]
    emit = np.full((4, 4), 0.044)
    np.fill_diagonal(emit, 0.12)
    match = np.full((5, 5), math.log(1 / 16))
    match[:4, :4] = np.log(emit)
    ins = np.full(5, math.log(0.25))
    ins[:4] = np.log(emit.sum(1))
    return trans.astype(np.float32), match.astype(np.float32), ins.astype(np.float32)


_CODE = np.full(256, 4, np.int64)
for _k, _c in enumerate(b"ACGT"):
    _CODE[_c] = _k


def _lse(stack: torch.Tensor, dim: int) -> torch.Tensor:
    m = stack.amax(dim)
    return m + torch.log(torch.exp(stack - m.unsqueeze(dim)).sum(dim))


def _forward(X, Y, trans, match, ins, L: int) -> torch.Tensor:
    """[P, 6, L+1, L+1] log forward values of every state at every cell."""
    P, dev = X.shape[0], X.device
    F = torch.full((P, 6, L + 1, L + 1), LOG_ZERO, device=dev)
    F[:, START, 0, 0] = 0.0
    into_m = trans[:, M][None, :, None]               # from each of the 6 states
    for d in range(1, 2 * L + 1):
        i = torch.arange(max(0, d - L), min(d, L) + 1, device=dev)
        j = d - i
        xi = X[:, (i - 1).clamp(min=0)]
        yj = Y[:, (j - 1).clamp(min=0)]
        diag = F[:, :, (i - 1).clamp(min=0), (j - 1).clamp(min=0)]
        up = F[:, :, (i - 1).clamp(min=0), j]
        left = F[:, :, i, (j - 1).clamp(min=0)]
        cm = _lse(diag + into_m, 1) + match[xi, yj]

        def insert(src, s, emit):
            terms = torch.stack([src[:, M] + trans[M, s], src[:, s] + trans[s, s], src[:, START] + trans[START, s]], 1)
            return _lse(terms, 1) + emit

        vals = torch.stack([cm, insert(up, IX, ins[xi]), insert(left, IY, ins[yj]),
                            insert(up, JX, ins[xi]), insert(left, JY, ins[yj])], 1)
        ok = torch.stack([(i >= 1) & (j >= 1), i >= 1, j >= 1, i >= 1, j >= 1])   # [5, cells]
        F[:, :5, i, j] = torch.where(ok[None], vals, torch.tensor(LOG_ZERO, device=dev))
    return F


def posteriors(xs, ys, device="cpu", at_rest=torch.bfloat16) -> list[np.ndarray]:
    """[lx, ly] match posteriors of each pair (xs[p], ys[p]), rounded
    through ``at_rest`` (None keeps float32), as float32 numpy arrays."""
    dev = torch.device(device)
    trans, match, ins = (torch.as_tensor(a, device=dev) for a in model())
    trans_rev = trans.clone()
    trans_rev[:5] = trans[:5].T
    lx = np.array([len(s) for s in xs])
    ly = np.array([len(s) for s in ys])
    L = int(max(lx.max(), ly.max()))
    P = len(xs)

    def codes(seqs, reverse):
        out = np.full((P, L), 4, np.int64)
        for k, s in enumerate(seqs):
            c = _CODE[np.frombuffer(s.encode("latin1"), np.uint8)]
            out[k, : len(c)] = c[::-1] if reverse else c
        return torch.as_tensor(out, device=dev)

    F = _forward(codes(xs, False), codes(ys, False), trans, match, ins, L)
    R = _forward(codes(xs, True), codes(ys, True), trans_rev, match, ins, L)
    out = []
    for p in range(P):
        a, b = int(lx[p]), int(ly[p])
        total = _lse(F[p, :5, a, b] + trans[START], 0)
        fm = F[p, M, 1 : a + 1, 1 : b + 1]
        # backward of M at (i, j) = the reversed pass at (a - i, b - j), through M's transitions
        rb = R[p, :5, : a, : b].flip(1).flip(2)               # [5, a, b]: cell (i, j) <- (a-1-(i-1), ...)
        bm = _lse(rb + trans[M][:, None, None], 0)
        bm[a - 1, b - 1] = trans[START, M]
        post = torch.exp(torch.clamp(fm + bm - total, max=0.0))
        post = torch.where(post >= MIN_PROB, post, torch.zeros_like(post))
        if at_rest is not None:
            post = post.to(at_rest).float()
        out.append(post.cpu().numpy())
    return out
