"""Sliding-window and pipeline decoding of spatially-coupled LDPC chains.

Port of ``dna_ldpc_tpu/ops/scldpc.py``, the reference's windowed decoder
family (``LDPC_dec/ldpc/dec.cpp``: Run_SW_Decoder and the ~10 windowed BEC
variants, dec.cpp:243-580; pipeline decoder for SC-LDPC chains,
dec.cpp:1910+; windowed syndrome helpers ``check_bound``/
``mod2sparse_mulvec_bound``, check.cpp:49-72 / mod2sparse.h:167).

The chain's band structure (models/scldpc.py) makes every interior window
structurally identical, so ONE window graph is built and reused for every
window position — the decoding wave is a host loop over window anchors,
each step a batched BP (or BEC peel) on [batch, window] tensors:

- window variables: w frozen (already-decided) blocks + W active blocks;
- decided blocks enter as saturated +/-BIG LLRs (the "hard decision
  feedback" of windowed decoding);
- after ``iters`` BP iterations the oldest active block commits its hard
  decisions and the window slides one position.

The padded work array lives on ``device`` for the whole wave: each window
is a view of it that is decoded (or peeled) and written back, so nothing
crosses to the host until the result. A window's BP goes through
``window_bp.decode``: on the card one launch of ``csrc/window_bp.cu``
decodes the window (one thread block per frame, every iteration inside
the kernel, each frame leaving at its first zero syndrome), with the
float32 arithmetic of the generic gather decoder (``bp.bp_decode_generic``,
which the JAX package's ``bp_decode`` runs on these irregular graphs, as
XLA), and the CPU runs ``bp_decode_generic`` itself. The BEC windows run
the shared peeling step (``decoders.peel_values``, one host sync per
round), eager torch.

``sliding_window_decode`` and ``pipeline_decode`` each close a profiling
record (``utils/profiling.py``; root spans ``scldpc.sliding_window`` and
``scldpc.pipeline``) with a ``scldpc.window`` span per window BP: its
host waits, ``kernel`` 1 where the kernel decoded it, and its iterations
and edge-iterations (on the card read when the record closes,
``window_bp``), and under a profiler its device seconds. The window
graph is sliced from the chain's sparse rows.

The reference's pipeline decoder keeps several windows in flight at once
(one per frame stage); here the same concurrency is the batch axis — every
batch element advances through the same window anchor together, so a
batch of F frames is exactly an F-deep decoding pipeline.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.ldpc_graph import LdpcGraph
from ..models.scldpc import ScChain
from ..utils.device import DEFAULT_DEVICE, require_device
from ..utils.io_formats import SparseBinaryMatrix
from ..utils.profiling import count, device_time, span, wait
from . import window_bp
from .decoders import ERASE_MARK
from .decoders import peel_values as _peel_values

BIG = 1e9  # saturated LLR for decided/terminated variables


@functools.lru_cache(maxsize=None)
def _window_graph(chain: ScChain, W: int) -> LdpcGraph:
    """The (periodic) window subgraph: variable blocks t0-w..t0+W-1 and
    check blocks t0..t0+W-1, sliced at an interior anchor. All interior
    windows share this structure because couple() uses one edge-spreading
    for every position."""
    w, b_v, b_c = chain.w, chain.b_v, chain.b_c
    if chain.L < W + w:
        raise ValueError("chain too short for this window")
    t0 = w  # guaranteed interior anchor
    # sliced from the sparse rows: the chain's dense matrix is 5 GB at lifting 256 and L = 64
    H, (r0, r1), (c0, c1) = chain.H, (t0 * b_c, (t0 + W) * b_c), ((t0 - w) * b_v, (t0 + W) * b_v)
    rows = np.repeat(np.arange(r0, r1), np.diff(H.indptr[r0 : r1 + 1]))
    cols = H.indices[H.indptr[r0] : H.indptr[r1]]
    keep = (cols >= c0) & (cols < c1)
    return LdpcGraph.from_sparse(SparseBinaryMatrix.from_coo(r1 - r0, c1 - c0, rows[keep] - r0, cols[keep] - c0))


def _on_device(values, dtype, device) -> torch.Tensor:
    """Values [B, n] (or [n]) as a tensor on ``device``: a tensor is taken
    as it is (cast to ``dtype``, moved where it lies elsewhere), host
    values are uploaded (a pageable upload: a wait)."""
    dev = require_device(device)
    if isinstance(values, torch.Tensor):
        return torch.atleast_2d(values.to(device=dev, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype))
    wait(dev)
    return torch.as_tensor(np.atleast_2d(np.asarray(values, dtype)), device=dev)


def _work(values, dtype, left: int, right: int, fill, device) -> torch.Tensor:
    """Host values [B, n] on ``device`` between ``left`` and ``right``
    columns of ``fill``."""
    x = _on_device(values, dtype, device)
    pad = lambda n: torch.full((x.shape[0], n), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad(left), x, pad(right)], 1)


def _decisions(work: torch.Tensor, lo: int, hi: int) -> np.ndarray:
    """The committed decisions, columns lo:hi of the work array, as a host
    uint8 array. From the card they come through page-locked memory: a
    call's decisions are 100 MB at the SC cell's size, and a pageable copy
    of them ran at ~2 GB/s on an H100's host. The array stays a view of
    that memory (torch's caching host allocator): a caller that keeps
    many results pins as much host memory, and ``np.array(out)`` makes a
    pageable copy."""
    dec = (work[:, lo:hi] < 0).to(torch.uint8)
    if dec.device.type != "cuda":
        return dec.numpy()
    host = torch.empty(dec.shape, dtype=dec.dtype, pin_memory=True)
    host.copy_(dec)
    return host.numpy()


def _frozen(dec: torch.Tensor) -> torch.Tensor:
    """Committed hard decisions as saturated LLRs."""
    return torch.where(dec == 0, BIG, -BIG).to(torch.float32)


def sliding_window_decode(
    chain: ScChain,
    llr,
    W: int = 4,
    iters: int = 20,
    device=DEFAULT_DEVICE,
    on_window=None,
) -> np.ndarray:
    """Sliding-window BP over an SC-LDPC chain on ``device``. llr:
    [B, n_vars] float32, host values or a tensor (on ``device``, no copy
    is uploaded). Returns hard decisions [B, n_vars] uint8, committed
    block by block as the window slides (the decoding wave); from the card
    a view of page-locked host memory (``_decisions``).
    ``on_window(t0, result)``, where given, receives each anchor's
    ``BpResult`` (on the card, nothing downloaded) as its BP ends.

    The call is a profiling record ``scldpc.sliding_window`` (a root span,
    ``utils/profiling.py``) with one ``scldpc.window`` span per anchor:
    ``windows`` 1, ``kernel`` 1 where the window kernel decoded it, the
    BP's ``iterations`` and ``edge_iterations`` (on the card counted when
    the record closes: ``window_bp``) and the eager loop's ``waits``, and
    under a profiler the window's device seconds (CUDA events around its
    launches); the upload of host LLRs and the result's download are
    waits of the root."""
    w, b_v, L = chain.w, chain.b_v, chain.L
    graph = _window_graph(chain, W)
    with span("scldpc.sliding_window", root=True):
        # pad: w decided-zero blocks on the left, W-1 terminated blocks right
        work = _work(llr, np.float32, w * b_v, (W - 1) * b_v, BIG, device)
        for t0 in range(L):
            lo = t0 * b_v  # window starts at (t0 - w) + w pad blocks
            with span("scldpc.window"), device_time(work.device):
                count("windows")
                res = window_bp.decode(graph, work[:, lo : lo + (W + w) * b_v], max_iter=iters)
                if on_window is not None:
                    on_window(t0, res)
                # hard-decision feedback: freeze the committed (oldest active) block
                work[:, (t0 + w) * b_v : (t0 + w + 1) * b_v] = _frozen(res.bits[:, w * b_v : (w + 1) * b_v])
        # every block holds its committed decision as +/-BIG from here on
        out = _decisions(work, w * b_v, (w + L) * b_v)
        wait(work.device)
    return out


def pipeline_decode(chain: ScChain, llrs, W: int = 4, iters: int = 20, device=DEFAULT_DEVICE) -> np.ndarray:
    """TRUE pipelined schedule over many frames (the reference's
    multi-window pipeline decoder for SC-LDPC streams, dec.cpp:1910+):
    frame f enters the pipe at tick f, and at tick t every in-flight
    frame f advances its window at position t - f — so up to L windows
    (one per pipeline stage) decode CONCURRENTLY as one batched BP on
    the shared window graph, each batch row sliced at its own anchor by
    one indexed gather and committed by one scatter.

    Produces exactly sliding_window_decode's output per frame (the
    window recursions are independent across frames); the staging is the
    concurrency structure the reference gets from keeping one window per
    stream position in flight. The JAX package pads every tick's batch to
    F rows so that one compiled decoder serves every tick; eager torch
    decodes the frames in flight only.

    The call is a profiling record ``scldpc.pipeline`` with one
    ``scldpc.window`` span per tick (one batched BP of the windows of the
    frames in flight), counted as ``sliding_window_decode`` counts; its
    result comes back as ``sliding_window_decode``'s does."""
    w, b_v, L = chain.w, chain.b_v, chain.L
    graph = _window_graph(chain, W)
    with span("scldpc.pipeline", root=True):
        work = _work(llrs, np.float32, w * b_v, (W - 1) * b_v, BIG, device)
        F = work.shape[0]
        cols = torch.arange((W + w) * b_v, device=work.device)
        for t in range(L + F - 1):
            with span("scldpc.window"), device_time(work.device):
                count("windows")
                f = torch.arange(max(0, t - L + 1), min(t, F - 1) + 1, device=work.device)[:, None]  # frames in flight
                lo = (t - f) * b_v  # frame f's window at anchor t - f
                res = window_bp.decode(graph, work[f, lo + cols], max_iter=iters)
                work[f, lo + w * b_v + cols[:b_v]] = _frozen(res.bits[:, w * b_v : (w + 1) * b_v])
        out = _decisions(work, w * b_v, (w + L) * b_v)
        wait(work.device)
    return out


def _bec_work(chain: ScChain, values, right_blocks: int, device) -> torch.Tensor:
    """BEC values on ``device`` with w known-zero blocks left and
    ``right_blocks`` right (a known-0 pad variable is exactly a shorter
    check row on the BEC: no parity, no erasure)."""
    return _work(values, np.int8, chain.w * chain.b_v, right_blocks * chain.b_v, 0, device)


def _peel_window(graph: LdpcGraph, work: torch.Tensor, lo: int, n: int, iters: int) -> torch.Tensor:
    """Peel the window ``work[:, lo:lo+n]`` and write it back; returns it."""
    still = _peel_values(graph, work[:, lo : lo + n], iters)
    work[:, lo : lo + n] = still
    return still


def sliding_window_bec(
    chain: ScChain,
    values,
    W: int = 4,
    iters: int = 50,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """Windowed BEC peeling on ``device``: values [B, n_vars] int8 with 0/1
    known and 2 = erased. Returns [B, n_vars] int8 (2 where a window failed
    to resolve, matching the reference's ERASE_MARK convention).

    Variant note: the reference ships ~10 windowed-BEC variants
    (``DECODER_BEC_SW`` .. ``DECODER_BEC_SW_OPTION``, DNA_main.cpp:59-67;
    dec.cpp:243-580). This function is the BASE ``DECODER_BEC_SW``
    recursion: a width-(W+w) window slides one block per step, peels to
    completion (up to ``iters`` rounds), writes every newly-resolved
    erasure back into the shared value array (so the resolution wave
    feeds later windows, as the reference's in-place mod2sparse updates
    do), and commits the oldest block before advancing. The
    scheduling-distinct variants are below: ``sliding_window_bec_save``
    (_SAVE), ``sliding_window_bec_two`` (_TWO), ``_two_cross``
    (_TWO_CROSS), ``_two_indi`` (_TWO_INDI), ``sliding_window_bec_step``
    (_STEP), ``sliding_window_bec_ra`` (_RA), ``sliding_window_bec_oc``
    (_OC), ``sliding_window_bec_target`` (_TARGET), and the non-windowed
    ``bec_decode_save`` / ``bec_decode_target`` (DECODER_BEC_SAVE /
    _TARGET). ``DECODER_BEC_SW_OPTION`` (enum 98) has config parsing but
    NO decoder dispatch or body anywhere in the reference
    (DNA_main.cpp:480-490 reads a _order.txt file — into the punctuation
    array, a latent bug — and LDPC_Decode has no OPTION branch), so there
    is no behavior to reproduce."""
    w, b_v, L = chain.w, chain.b_v, chain.L
    graph = _window_graph(chain, W)
    work = _bec_work(chain, values, W - 1, device)
    out = torch.full((work.shape[0], L * b_v), ERASE_MARK, dtype=torch.int8, device=work.device)
    for t0 in range(L):
        # peel the window; write back every newly-resolved erasure (the
        # wave feeds later windows) and commit the oldest block
        still = _peel_window(graph, work, t0 * b_v, (W + w) * b_v, iters)
        out[:, t0 * b_v : (t0 + 1) * b_v] = still[:, w * b_v : (w + 1) * b_v]
    return out.cpu().numpy()


def sliding_window_bec_save(
    chain: ScChain,
    values,
    W: int = 4,
    iters: int = 50,
    device=DEFAULT_DEVICE,
):
    """``DECODER_BEC_SW_SAVE`` (dec.cpp Run_BEC_SW_Decoder_SAVE): the base
    recursion plus per-position erasure-rate bookkeeping — the
    ``test_BER(0/1, ...)`` hooks record, for every committed block, the
    fraction of erased bits immediately BEFORE and AFTER its window's
    peel (the columns of the reference's ``position_BER`` dump,
    DNA_main.cpp POSITION_BER_ files).

    Returns (bits, stats [L, 2] float64: mean erased fraction in the
    commit block before / after peeling, averaged over the batch)."""
    w, b_v, L = chain.w, chain.b_v, chain.L
    graph = _window_graph(chain, W)
    work = _bec_work(chain, values, W - 1, device)
    B = work.shape[0]
    out = torch.full((B, L * b_v), ERASE_MARK, dtype=torch.int8, device=work.device)
    erased = torch.zeros((L, 2), dtype=torch.int64, device=work.device)
    for t0 in range(L):
        lo = t0 * b_v
        commit = slice(lo + w * b_v, lo + (w + 1) * b_v)
        erased[t0, 0] = (work[:, commit] == ERASE_MARK).sum()
        still = _peel_window(graph, work, lo, (W + w) * b_v, iters)
        erased[t0, 1] = (work[:, commit] == ERASE_MARK).sum()
        out[:, t0 * b_v : (t0 + 1) * b_v] = still[:, w * b_v : (w + 1) * b_v]
    return out.cpu().numpy(), erased.cpu().numpy() / (B * b_v)


def _two_wave_work(chain: ScChain, values, W: int, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Padded work array shared by the _TWO family, on ``device``: w
    known-zero blocks left (left termination) and W-1+w known-zero blocks
    right — the right pad stands in for BOTH the right termination checks'
    missing variables and the beyond-end windows of the full-length _CROSS
    sweep."""
    return _bec_work(chain, values, W - 1 + chain.w, device)


def _backward_lo(chain: ScChain, W: int, t: int) -> int:
    """Work offset of the backward window at step t: checks [L+w-t-W,
    L+w-t), vars [L-t-W, L-t+w) — var block b sits at (b+w)*b_v, so the
    window starts at block L-t-W, clamped at the left end for very wide
    windows where the reference's reflected V_Start2 goes negative. The
    clamped window keeps its width (dec.cpp:3090-3093 shrinks it); the JAX
    package's choice, mirrored."""
    return max(0, chain.L - t - W + chain.w) * chain.b_v


def sliding_window_bec_two(
    chain: ScChain,
    values,
    W: int = 4,
    iters: int = 50,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """``DECODER_BEC_SW_TWO`` (dec.cpp:2900-3007 Run_BEC_SW_Decoder_Two):
    TWO windows sweep simultaneously — one forward from the left end,
    one backward from the right end — sharing the value array, so the
    two resolution waves meet in the middle after SC_Ls = L/2 steps
    each.

    The backward window is the INDEX REFLECTION of the forward one
    (dec.cpp:2972-2977: V2 = [N-V_End, N-V_Start), C2 = [M-C_End,
    M-C_Start)): its first step therefore anchors on the TERMINATION
    checks [L, L+w), which is what lets it peel a right-anchored erasure
    run the forward sweep strands. The window subgraph itself is shared
    (checks [c0, c0+W) always read vars [c0-w, c0+W)); only the anchor
    mirrors."""
    w, b_v, L = chain.w, chain.b_v, chain.L
    graph = _window_graph(chain, W)
    work = _two_wave_work(chain, values, W, device)
    win_n = (W + w) * b_v
    for t in range(max(1, L // 2)):
        _peel_window(graph, work, t * b_v, win_n, iters)  # forward: checks [t, t+W), vars [t-w, t+W)
        _peel_window(graph, work, _backward_lo(chain, W, t), win_n, iters)
    # the reference's _Two writes decisions into dblk in place and the
    # final dblk is the output (no commit snapshots) — mirror that
    return work[:, w * b_v : (w + L) * b_v].cpu().numpy()


def sliding_window_bec_two_cross(
    chain: ScChain,
    values,
    W: int = 4,
    iters: int = 50,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """``DECODER_BEC_SW_TWO_CROSS`` (dec.cpp:3009-3121): identical to
    ``sliding_window_bec_two`` except the two waves do NOT stop at the
    middle — the step loop runs t = 0..L-1 with the window ranges
    clamped at the chain ends (dec.cpp:3090-3093), so each wave sweeps
    the ENTIRE chain and crosses the other. An erasure pattern that
    needs context from the far half (e.g. a left-half run only peelable
    right-to-left) resolves here but not under _TWO."""
    w, b_v, L = chain.w, chain.b_v, chain.L
    graph = _window_graph(chain, W)
    work = _two_wave_work(chain, values, W, device)
    win_n = (W + w) * b_v
    for t in range(L):
        _peel_window(graph, work, t * b_v, win_n, iters)
        _peel_window(graph, work, _backward_lo(chain, W, t), win_n, iters)
    return work[:, w * b_v : (w + L) * b_v].cpu().numpy()


def sliding_window_bec_two_indi(
    chain: ScChain,
    values,
    W: int = 4,
    iters: int = 50,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """``DECODER_BEC_SW_TWO_INDI`` (dec.cpp:3123-3260): the two waves of
    _TWO run on INDEPENDENT decoder states (the reference copies H to H2
    and keeps a separate dblk2 for the backward wave, so the waves never
    exchange resolutions), and the output stitches the halves: variables
    [0, N/2) from the forward wave, [N/2, N) from the backward wave
    (dec.cpp:3243-3244). A right-half erasure that only the FORWARD
    wave can resolve (left context) therefore stays erased here —
    distinguishing it from _TWO."""
    w, b_v, L = chain.w, chain.b_v, chain.L
    N = chain.n_vars
    graph = _window_graph(chain, W)
    work_f = _two_wave_work(chain, values, W, device)
    work_b = work_f.clone()
    win_n = (W + w) * b_v
    for t in range(max(1, L // 2)):
        _peel_window(graph, work_f, t * b_v, win_n, iters)
        _peel_window(graph, work_b, _backward_lo(chain, W, t), win_n, iters)
    half = w * b_v + N // 2
    return torch.cat([work_f[:, w * b_v : half], work_b[:, half : w * b_v + N]], 1).cpu().numpy()


def sliding_window_bec_target(
    chain: ScChain,
    values,
    W: int = 4,
    iters: int = 50,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """``DECODER_BEC_SW_TARGET`` (dec.cpp:3394-3446): a first-window
    PROBE — the reference initializes and iterates exactly one window
    (checks [0, W), vars [0, W)) and returns; no sweep, no commit loop.
    Used to measure how far the first window's wave reaches. Returns
    the value array after that single window peel (everything else
    untouched)."""
    w, b_v, L = chain.w, chain.b_v, chain.L
    work = _bec_work(chain, values, W - 1, device)
    _peel_window(_window_graph(chain, W), work, 0, (W + w) * b_v, iters)
    return work[:, w * b_v : (w + L) * b_v].cpu().numpy()


def _erased_per_block(vals: torch.Tensor, block_of: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Erased entries of each spatial block over the batch, int64 [n_blocks]."""
    per_var = (vals == ERASE_MARK).sum(0)
    return torch.zeros(n_blocks, dtype=torch.int64, device=vals.device).index_add_(0, block_of, per_var)


def bec_decode_save(
    graph: LdpcGraph,
    values,
    block_sizes,
    max_rounds: int = 200,
    device=DEFAULT_DEVICE,
):
    """``DECODER_BEC_SAVE`` (dec.cpp:378-460 Run_BEC_Decoder_SAVE):
    plain GLOBAL peeling (no window) on ``device`` instrumented with the
    position-BER trace — before the first round and after every round,
    the erased fraction of each spatial block is recorded (the
    reference's ``test_BER(n, ...)`` per Mv block, the columns of its
    POSITION_BER_ dumps), and the loop stops at stall (no change),
    success, or max_rounds.

    ``block_sizes``: per-block variable counts (the reference's Mv).
    Returns (values, trace [n_rounds+1, n_blocks] float64, n_rounds)."""
    vals = _on_device(values, np.int8, device)
    sizes = np.asarray(block_sizes, np.int64)
    if sizes.sum() != graph.n_vars:
        raise ValueError(f"block sizes sum to {sizes.sum()}, the graph has {graph.n_vars} variables")
    block_of = torch.as_tensor(np.repeat(np.arange(len(sizes)), sizes), device=vals.device)
    trace = [_erased_per_block(vals, block_of, len(sizes))]
    n = 0
    for n in range(1, max_rounds + 1):
        new = _peel_values(graph, vals, 1)
        trace.append(_erased_per_block(new, block_of, len(sizes)))
        if bool((new == vals).all()):
            break
        vals = new
    return vals.cpu().numpy(), torch.stack(trace).cpu().numpy() / (vals.shape[0] * sizes), n


def bec_decode_target(
    graph: LdpcGraph,
    values,
    target: tuple[int, int],
    max_rounds: int = 200,
    device=DEFAULT_DEVICE,
):
    """``DECODER_BEC_TARGET`` (dec.cpp:303-374 Run_BEC_Decoder_TARGET):
    global peeling on ``device`` with an EXTRA early exit — stop as soon
    as every variable in the 1-based inclusive ``target`` range [lo, hi]
    has decoded to ZERO (the reference simulates the all-zero codeword,
    so "target decoded to 0" means the watched span is recovered), in
    addition to the stall / clean-syndrome / max-round exits.

    Returns (values, n_rounds, target_clean)."""
    lo, hi = target[0] - 1, target[1]  # 1-based inclusive, as the reference
    vals = _on_device(values, np.int8, device)
    n = 0
    for n in range(1, max_rounds + 1):
        new = _peel_values(graph, vals, 1)
        stalled = bool((new == vals).all())
        vals = new
        if bool((vals[:, lo:hi] == 0).all()) or stalled:
            break
    return vals.cpu().numpy(), n, bool((vals[:, lo:hi] == 0).all())


def sliding_window_bec_step(
    chain: ScChain,
    values,
    W: int = 4,
    eta: int = 2,
    iters: int = 50,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """``DECODER_BEC_SW_STEP`` (dec.cpp Run_BEC_SW_Decoder_Step): the
    window advances ``eta`` blocks per step and commits ``eta`` blocks at
    once — 1/eta as many window dispatches, at the cost of less look-ahead
    for the later blocks of each commit group (block t0+p sees only
    W-1-p blocks of right context instead of W-1). Requires eta <= W.
    eta=1 reduces to the base recursion."""
    if not 1 <= eta <= W:
        raise ValueError("need 1 <= eta <= W")
    w, b_v, L = chain.w, chain.b_v, chain.L
    graph = _window_graph(chain, W)
    work = _bec_work(chain, values, W - 1, device)
    out = torch.full((work.shape[0], L * b_v), ERASE_MARK, dtype=torch.int8, device=work.device)
    for t0 in range(0, L, eta):
        still = _peel_window(graph, work, t0 * b_v, (W + w) * b_v, iters)
        hi = min(t0 + eta, L)
        out[:, t0 * b_v : hi * b_v] = still[:, w * b_v : (w + hi - t0) * b_v]
    return out.cpu().numpy()


def ra_extend(chain: ScChain) -> SparseBinaryMatrix:
    """Repeat-accumulate extension of an SC chain: H_ra = [H | A] where A
    is the (L+w)*b_c-square dual-diagonal accumulator — check j gains
    parity variable p_j and (for j > 0) p_{j-1}. This is the variable
    layout the reference's ``DECODER_BEC_SW_RA`` decoder exists for
    (Run_BEC_SW_Decoder_RA, dec.cpp:3449-3576): systematic variables in
    the front segment, check-aligned accumulator parities in a tail
    segment starting at N1, windowed in lockstep by Mc-sized steps."""
    H = chain.H
    M = H.n_rows
    rows = np.repeat(np.arange(M), H.row_weights())
    cols = H.indices.copy()
    pr = np.concatenate([np.arange(M), np.arange(1, M)])
    pc = np.concatenate([np.arange(M), np.arange(M - 1)]) + H.n_cols
    return SparseBinaryMatrix.from_coo(
        M, H.n_cols + M, np.concatenate([rows, pr]), np.concatenate([cols, pc])
    )


@functools.lru_cache(maxsize=None)
def _ra_window_graph(chain: ScChain, W: int) -> LdpcGraph:
    """Window subgraph over BOTH segments: checks [a, a+W)*b_c, systematic
    vars [a-w, a+W)*b_v, parity vars [a-1, a+W)*b_c (the accumulator
    reaches one block left). Position-invariant for interior anchors."""
    w, b_v, b_c, L = chain.w, chain.b_v, chain.b_c, chain.L
    if L < W + w + 1:
        raise ValueError("chain too short for this window")
    H_ra = ra_extend(chain)
    dense = H_ra.to_dense()
    a = w + 1
    n_sys = chain.n_vars
    rows = dense[a * b_c : (a + W) * b_c]
    sys_cols = rows[:, (a - w) * b_v : (a + W) * b_v]
    par_cols = rows[:, n_sys + (a - 1) * b_c : n_sys + (a + W) * b_c]
    win = np.concatenate([sys_cols, par_cols], axis=1)
    sub = SparseBinaryMatrix.from_coo(win.shape[0], win.shape[1], *np.nonzero(win))
    return LdpcGraph.from_sparse(sub)


def sliding_window_bec_ra(
    chain: ScChain,
    values,
    W: int = 4,
    iters: int = 50,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """``DECODER_BEC_SW_RA`` (dec.cpp Run_BEC_SW_Decoder_RA): windowed BEC
    peeling for repeat-accumulate SC codes (``ra_extend``'s layout) on
    ``device``. Two windows advance in LOCKSTEP and are peeled JOINTLY
    each step (Iter_BEC_RA_SW_Decoder iterates both ranges inside one
    fixpoint loop): the systematic window over var blocks [t-w, t+W) and
    the parity window over the accumulator blocks [t-1, t+W) aligned with
    the window's checks — the reference's window-2 offsets advance by Mc[]
    amounts through the segment at N1 for exactly this reason
    (dec.cpp:3504-3556).

    ``values``: [B, n_vars + n_checks] int8 (systematic segment then
    parity segment; 2 = erased). Returns the same layout. A decoder
    without the lockstep parity window cannot decode this family at all:
    the accumulator columns live outside every systematic window, so
    their erasures are unresolvable and poison every check they touch."""
    w, b_v, b_c, L = chain.w, chain.b_v, chain.b_c, chain.L
    n_sys = chain.n_vars
    Lc = L + w  # parity blocks
    graph = _ra_window_graph(chain, W)
    values = np.atleast_2d(np.asarray(values, np.int8))
    if values.shape[1] != n_sys + Lc * b_c:
        raise ValueError(f"values must be [B, {n_sys + Lc * b_c}] (systematic then parity), got {values.shape}")
    work_s = _bec_work(chain, values[:, :n_sys], W - 1, device)
    # parity: one known-0 block left (the accumulator's zero start);
    # right-pad to cover tail windows (same approximation as the
    # systematic right pad)
    work_p = _work(values[:, n_sys:], np.int8, b_c, max(0, (W - 1) - w + 1) * b_c, 0, device)

    out = torch.full((values.shape[0], n_sys + Lc * b_c), ERASE_MARK, dtype=torch.int8, device=work_s.device)
    n_sys_win = (W + w) * b_v
    for t0 in range(L):
        lo_s = t0 * b_v                 # sys blocks [t0-w, t0+W)
        lo_p = t0 * b_c                 # parity blocks [t0-1, t0+W)
        win = torch.cat([work_s[:, lo_s : lo_s + n_sys_win], work_p[:, lo_p : lo_p + (W + 1) * b_c]], 1)
        still = _peel_values(graph, win, iters)
        work_s[:, lo_s : lo_s + n_sys_win] = still[:, :n_sys_win]
        work_p[:, lo_p : lo_p + (W + 1) * b_c] = still[:, n_sys_win:]
        out[:, t0 * b_v : (t0 + 1) * b_v] = still[:, w * b_v : (w + 1) * b_v]
        out[:, n_sys + t0 * b_c : n_sys + (t0 + 1) * b_c] = still[:, n_sys_win + b_c : n_sys_win + 2 * b_c]
    # tail parity blocks [L, L+w) commit from the final work state
    out[:, n_sys + L * b_c :] = work_p[:, (L + 1) * b_c : (Lc + 1) * b_c]
    return out.cpu().numpy()


def sliding_window_bec_oc(
    chain: ScChain,
    values,
    W: int = 4,
    eta: int = 2,
    iters: int = 50,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """``DECODER_BEC_SW_OC`` (dec.cpp Run_BEC_SW_Decoder_OC): ``eta``
    windows sweep ``eta`` contiguous chain segments CONCURRENTLY — the
    reference keeps eta (V/C/D)_Start..End range sets and iterates each
    per step after a joint warm-up pass (dec.cpp:2804-2856). The decoding
    latency drops to ~L/eta window steps at the cost of each segment's
    head starting WITHOUT its left context (the previous segment's tail
    has not been decoded when the wave sets off).

    The eta windows of one step share the window subgraph, so they peel
    as ONE batched call with windows stacked on the batch axis — the same
    trick that turns the reference's pipeline decoder into a batch
    (pipeline_decode). Requires segment length L//eta >= W + w so
    concurrent windows never overlap. Output follows the in-place dblk
    convention (final work-array state)."""
    w, b_v, L = chain.w, chain.b_v, chain.L
    Ls = L // eta
    if Ls < W + w:
        raise ValueError("need L // eta >= W + w (non-overlapping windows)")
    graph = _window_graph(chain, W)
    win_n = (W + w) * b_v
    work = _bec_work(chain, values, W - 1, device)
    B = work.shape[0]

    def peel_anchors(anchors):
        """One batched peel of same-shaped windows at several anchors."""
        still = _peel_values(graph, torch.cat([work[:, a * b_v : a * b_v + win_n] for a in anchors]), iters)
        for k, a in enumerate(anchors):
            work[:, a * b_v : a * b_v + win_n] = still[k * B : (k + 1) * B]

    # joint warm-up: every segment head + the residual tail region
    # (Init_BEC_SW_Decoder calls + Iter_BEC_OC_Init_Decoder, dec.cpp:2824-2832)
    peel_anchors([p * Ls for p in range(eta)])
    if eta * Ls < L:
        peel_anchors([min(eta * Ls, L - 1)])
    # eta concurrent waves, one batched peel per step
    for t in range(Ls):
        peel_anchors([p * Ls + t for p in range(eta)])
    # residual tail blocks (L not divisible by eta): the last wave carries on
    for t0 in range(eta * Ls, L):
        peel_anchors([t0])
    return work[:, w * b_v : (w + L) * b_v].cpu().numpy()
