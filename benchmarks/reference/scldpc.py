"""Plain sliding-window sum-product decoding of a spatially-coupled LDPC
chain in torch.

The chain (``couple``): a base block H0 of ``b_c`` checks and ``b_v``
variables, each check's edges given as columns in ascending order, is
edge-spread over ``L`` positions with memory ``w``. Every edge of H0, in
row-major order, draws a delay k in 0..w (``numpy.random.default_rng(seed)
.integers(0, w + 1)``); at every position t it joins check row block
t + k to variable block t. The chain has (L + w) b_c checks and L b_v
variables; its first and last w row blocks are partly filled (the
termination). This is the random coupled ensemble of Kudekar, Richardson
and Urbanke (IEEE Trans. IT 57(2), 2011), each base edge spread with a
delay of its own, in its terminated, lifted form: a variable may have
two or three edges at one delay, where the protograph LDPC convolutional
code of Lentmaier, Sridharan, Costello and Zigangirov (IEEE Trans. IT
56(10), 2010) gives it one at each delay.

The decoder (``sliding_window_decode``): windowed decoding (Iyengar,
Papaleo, Siegel, Wolf, Vanelli-Coralli and Corazza, IEEE Trans. IT
58(4), 2012; the reference C++ library's ``Run_SW_Decoder``). For each
anchor t = 0 .. L-1 the window is sliced from the chain's H: check row
blocks t .. min(t + W, L + w) - 1 and the variable blocks they touch,
max(0, t - w) .. min(t + W, L) - 1. The w blocks before t are decided
and enter as +/-BIG LLRs (hard-decision feedback), the W active blocks
with their channel LLRs. ``reference/bp.py``'s decoder (``_decode``: the
same steps in another layout) runs up to ``iters``
iterations on the window with its early stop, and the oldest
active block, t, commits its decisions. The window then slides by one
position.

Departures from the published decoder, each one of the program's too:

- every window's messages start afresh from its LLRs (none is carried
  over from the window before);
- a decided variable stays in its window as a +/-BIG LLR rather than
  being folded into its checks' parities (the same in exact arithmetic:
  tanh(BIG/2) rounds to 1);
- the rows of a window that the termination leaves with fewer edges than
  the row weight are padded with one extra variable held at +BIG, a
  factor 1 in every product, so that ``reference/bp.py`` sees one row
  weight;
- ``reference/bp.py`` clips the tanh-domain product at 1 - 1e-5 (a
  saturated check message of 12.2); the program clips at 1 - 2^-23
  (16.6), and it forms the product from logarithms, this decoder by
  running products.

Messages are stored in ``msg_dtype`` and computed in float32 with TF32
off. Nothing of the program is imported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from reference import bp as ref_bp

BIG = 1e9  # the LLR of a decided or known variable


@dataclass(frozen=True)
class Chain:
    indptr: np.ndarray   # [(L + w) b_c + 1] CSR row pointers of H
    indices: np.ndarray  # [edges] column of each edge, ascending within a row
    L: int
    w: int
    b_v: int
    b_c: int

    @property
    def n_vars(self) -> int:
        return self.L * self.b_v

    @property
    def n_checks(self) -> int:
        return (self.L + self.w) * self.b_c


def couple(base_checks: np.ndarray, b_v: int, L: int, w: int, seed: int) -> Chain:
    """The chain of the base block whose check r has the edges
    ``base_checks[r]`` ([b_c, dc] columns, ascending within a row)."""
    base_checks = np.asarray(base_checks, np.int64)
    b_c, dc = base_checks.shape
    delay = np.random.default_rng(seed).integers(0, w + 1, size=b_c * dc)
    rows0 = np.repeat(np.arange(b_c), dc)
    cols0 = base_checks.reshape(-1)
    t = np.arange(L)[:, None]
    rows = ((t + delay[None]) * b_c + rows0[None]).reshape(-1)
    cols = (t * b_v + cols0[None]).reshape(-1)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    indptr = np.zeros((L + w) * b_c + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return Chain(np.cumsum(indptr), cols, L, w, b_v, b_c)


def window(chain: Chain, t: int, W: int) -> tuple[np.ndarray, int, int]:
    """The window of anchor ``t``: ([M, dc] columns of each of its checks
    relative to its first variable, padded with the index of one extra
    variable past its last; its first and one-past-last variable)."""
    L, w, b_v, b_c = chain.L, chain.w, chain.b_v, chain.b_c
    r0, r1 = t * b_c, min(t + W, L + w) * b_c
    c0, c1 = max(0, t - w) * b_v, min(t + W, L) * b_v
    lens = np.diff(chain.indptr[r0 : r1 + 1])
    cols = chain.indices[chain.indptr[r0] : chain.indptr[r1]]
    if len(cols) and (cols.min() < c0 or cols.max() >= c1):
        raise ValueError(f"a check of window {t} reaches outside its variables")
    dc = int(lens.max()) if len(lens) else 1
    pad = c1 - c0
    out = np.full((r1 - r0, dc), pad, np.int64)
    slot = np.arange(len(cols)) - np.repeat(chain.indptr[r0:r1] - chain.indptr[r0], lens)
    out[np.repeat(np.arange(r1 - r0), lens), slot] = cols - c0
    return out, c0, c1


def _exclusive_product(t: torch.Tensor) -> torch.Tensor:
    """``reference/bp.py``'s ``_exclusive_product`` with its two running
    products written out as products of slices: the same factors in the
    same order (torch's ``cumprod`` over a last dimension of 6 takes 27 ms
    a call at [1024, 4608, 6] on an H100)."""
    d = t.shape[-1]
    left, right = [torch.ones_like(t[..., 0])], [torch.ones_like(t[..., 0])]
    for k in range(1, d):
        left.append(left[-1] * t[..., k - 1])
        right.append(right[-1] * t[..., d - k])
    return torch.stack([left[k] * right[d - 1 - k] for k in range(d)], -1)


def _decode(checks: torch.Tensor, llr: torch.Tensor, max_iter: int, msg_dtype) -> ref_bp.Decoded:
    """``reference/bp.py``'s ``decode``, step for step, in another layout:
    the exclusive product of slices (``_exclusive_product``), and each
    iteration's posterior summed into a [N, B] array (``index_add_`` over
    rows of a batch's messages) where ``decode`` adds into [B, N] (over
    columns, one scattered atomic add an element on the card). The
    results are the same, bit for bit on the CPU."""
    B, N = llr.shape
    flat = checks.reshape(-1)
    lc = torch.nan_to_num(llr.float())
    lc_t = lc.T.contiguous()
    q = ref_bp._q

    def unsat(bits):
        return (bits[:, checks].sum(-1) % 2).sum(-1)

    bits = (lc < 0).to(torch.uint8)
    done = unsat(bits) == 0
    iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
    t = q(torch.tanh(q(lc, msg_dtype)[:, checks] * 0.5), msg_dtype)
    for n in range(max_iter):
        if bool(done.all()):
            break
        te = _exclusive_product(t).clamp(-ref_bp.TE_CLIP, ref_bp.TE_CLIP)
        c2v = q(torch.log((1.0 + te) / (1.0 - te)), msg_dtype)
        post = lc_t.clone().index_add_(0, flat, c2v.reshape(B, -1).T.contiguous()).T
        new_bits = (~(post > 0)).to(torch.uint8)
        new_unsat = unsat(new_bits)
        live = ~done
        bits = torch.where(live[:, None], new_bits, bits)
        iters = torch.where(live, torch.full_like(iters, n + 1), iters)
        done = done | (new_unsat == 0)
        t = q(torch.tanh((q(post, msg_dtype)[:, checks] - c2v) * 0.5), msg_dtype)
    return ref_bp.Decoded(bits=bits, success=unsat(bits) == 0, iterations=iters)


def sliding_window_decode(chain: Chain, llr: torch.Tensor, W: int, iters: int,
                          msg_dtype=torch.float32) -> tuple[torch.Tensor, list]:
    """llr: [B, L b_v] float32 channel LLRs. Returns the committed
    decisions [B, L b_v] uint8 on ``llr``'s device and the ``Decoded`` of
    every window in anchor order."""
    B = llr.shape[0]
    b_v = chain.b_v
    dev = llr.device
    decided = torch.zeros((B, chain.n_vars), dtype=torch.uint8, device=dev)
    windows = []
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for t in range(chain.L):
            checks, c0, c1 = window(chain, t, W)
            lw = torch.cat([torch.where(decided[:, c0 : t * b_v] == 0, BIG, -BIG).float(),
                            llr[:, t * b_v : c1].float(),
                            torch.full((B, 1), BIG, device=dev)], 1)
            res = _decode(torch.as_tensor(checks, device=dev), lw, iters, msg_dtype)
            decided[:, t * b_v : (t + 1) * b_v] = res.bits[:, t * b_v - c0 : (t + 1) * b_v - c0]
            windows.append(res)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return decided, windows
