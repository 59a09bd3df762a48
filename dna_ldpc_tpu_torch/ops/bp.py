"""Batched flooding sum-product LDPC belief propagation.

Port of ``dna_ldpc_tpu/ops/bp.py``: ``bp_decode`` sends a code with
permutation-block structure to the fused decoder (``ops/bp_cuda.py``, the
hand-written CUDA kernel on the card, its plain torch twin on the CPU) and
decodes any other code with the generic gather decoder below, the plain
torch form of the reference's ``_bp_decode_jit``. Its loop, ``_iterate``,
is the control flow every decoder of the port shares (``ops/decoders.py``,
``ops/faid.py``); ``bp_posteriors`` and ``ops/trace.py`` run fixed
iterations of the same flooding update (``_flood``) for soft output.

Decision semantics match the reference decoder (``LDPC_dec/ldpc/
dec.cpp:583-694``) exactly:

- initial hard decision: bit = (channel LLR < 0), i.e. ``lratio < 1``;
- per-iteration decision: bit = (posterior LLR <= 0), i.e. ``pr <= 1``,
  with non-finite posteriors decided as 1;
- the syndrome is evaluated on the current decision before each
  iteration; a codeword stops at iteration n if its syndrome is zero or
  n == max_iter, and its results latch there.

The check update is the reference's exclusive product in tanh form, with
zero messages (erasures) kept exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.ldpc_graph import GraphTensors, LdpcGraph
from ..utils.device import DEFAULT_DEVICE, require_device
from ..utils.profiling import count, wait


@dataclasses.dataclass
class BpResult:
    bits: torch.Tensor        # [B, N] uint8 hard decisions (latched at stop)
    success: torch.Tensor     # [B] bool: syndrome reached zero
    iterations: torch.Tensor  # [B] int32: reference iteration count semantics
    unsat: torch.Tensor       # [B] int32: unsatisfied checks at stop


def _exclusive_prod(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Per-row exclusive product along ``dim``, as whole-row reductions
    (sign parity + log-magnitude sums + zero counting). Zero factors stay
    exact: an excluded product is zero iff it contains a zero factor."""
    is_zero = t == 0
    neg = t < 0
    logabs = torch.log(torch.where(is_zero, torch.ones_like(t), t.abs()))
    sum_log = logabs.sum(dim, keepdim=True)
    excl_zero = is_zero.sum(dim, keepdim=True) - is_zero.long()
    excl_neg = neg.sum(dim, keepdim=True) - neg.long()
    mag = torch.exp(sum_log - logabs)
    sign = 1.0 - 2.0 * (excl_neg % 2).to(t.dtype)
    return torch.where(excl_zero > 0, torch.zeros_like(t), sign * mag)


def _check_messages(v2c: torch.Tensor, check_mask: torch.Tensor, clip: float) -> torch.Tensor:
    """Check-node update in tanh domain. v2c: [B, M, dc] LLR messages
    (padded slots arbitrary); returns c2v [B, M, dc]."""
    t = torch.tanh(v2c * 0.5)
    t = torch.where(check_mask[None], t, torch.ones_like(t))
    te = _exclusive_prod(t).clamp(-clip, clip)
    # 2*atanh(te), written as log1p for accuracy near |te| ~ 1
    return torch.log1p(te) - torch.log1p(-te)


def _check_parity(bits: torch.Tensor, check_vars: torch.Tensor, check_mask: torch.Tensor) -> torch.Tensor:
    """Parity of every check [B, M] (1 = unsatisfied). bits: [B, N] integer."""
    gathered = bits[:, check_vars.clamp(min=0)]  # [B, M, dc]
    gathered = torch.where(check_mask[None], gathered, torch.zeros_like(gathered))
    return gathered.sum(-1) % 2


def _syndrome_unsat(bits: torch.Tensor, check_vars: torch.Tensor, check_mask: torch.Tensor):
    """Unsatisfied checks per batch element. bits: [B, N] integer."""
    return _check_parity(bits, check_vars, check_mask).sum(-1).to(torch.int32)


def _gather_checkmajor(x: torch.Tensor, check_vars: torch.Tensor) -> torch.Tensor:
    """Per-variable values [B, N] -> per check-major edge slot [B, M*dc]
    (padded slots read variable 0)."""
    return x[:, check_vars.clamp(min=0).reshape(-1)]


def _to_vars(c2v: torch.Tensor, tabs: GraphTensors, N: int, dv: int) -> torch.Tensor:
    """Check-major edge messages [B, M*dc] -> [B, N, dv] per variable,
    padded slots reading a zero message."""
    pad = torch.zeros((c2v.shape[0], 1), dtype=c2v.dtype, device=c2v.device)
    return torch.cat([c2v, pad], 1)[:, tabs.var_edge_ids.reshape(-1)].reshape(-1, N, dv)


def _to_checks(v2c_vm: torch.Tensor, tabs: GraphTensors) -> torch.Tensor:
    """Variable-major edge messages [B, N, dv] -> check-major [B, M*dc]."""
    B = v2c_vm.shape[0]
    pad = torch.zeros((B, 1), dtype=v2c_vm.dtype, device=v2c_vm.device)
    return torch.cat([v2c_vm.reshape(B, -1), pad], 1)[:, tabs.edge_perm]


def _posterior_update(llr: torch.Tensor):
    """The soft decoders' variable update: posterior = channel + all check
    messages, extrinsic = posterior - own message, decision pr <= 1 with
    NaN -> 1 (``~(post > 0)``)."""

    def update(cv):
        post = llr + cv.sum(-1)
        return post[:, :, None] - cv, (~(post > 0)).to(torch.uint8)

    return update


def _iterate(graph: LdpcGraph, bits, v2c, max_iter: int, check_update, var_update, early_stop: bool = True):
    """The reference's decoder control flow, shared by every decoder of
    the port: syndrome of the current decisions before each iteration,
    per-codeword latching of bits, unsat and iterations at the first zero
    syndrome, stop when all are done (``early_stop``) or at ``max_iter``.
    ``check_update``: [B, M, dc] v2c -> c2v; ``var_update``: [B, N, dv]
    c2v per variable -> (v2c [B, N, dv], decisions [B, N] uint8). With
    ``early_stop``, one host sync per iteration (the number of codewords
    still live), counted as a wait. On the innermost open span of a
    profiling record it counts ``iterations`` (the loop's) and
    ``edge_iterations`` (the graph's edges times the codewords live in each
    iteration: the sum over codewords of their iteration counts times the
    edges)."""
    tabs = graph.to(bits.device)
    B = bits.shape[0]
    M, N, dc, dv = graph.n_checks, graph.n_vars, graph.dc_max, graph.dv_max
    unsat = _syndrome_unsat(bits.long(), tabs.check_vars, tabs.check_mask)
    done = unsat == 0
    iters = torch.zeros(B, dtype=torch.int32, device=bits.device)
    n = 0
    while n < max_iter:
        live = B
        if early_stop:
            live = B - int(done.sum())
            wait(bits.device)
            if live == 0:
                break
        count("edge_iterations", live * graph.n_edges)
        cv = _to_vars(check_update(v2c.reshape(B, M, dc)).reshape(B, M * dc), tabs, N, dv)
        v2c_vm, new_bits = var_update(cv)
        v2c = _to_checks(v2c_vm, tabs)
        new_unsat = _syndrome_unsat(new_bits.long(), tabs.check_vars, tabs.check_mask)
        bits = torch.where(done[:, None], bits, new_bits)
        unsat = torch.where(done, unsat, new_unsat)
        iters = torch.where(done, iters, torch.full_like(iters, n + 1))
        done = done | (new_unsat == 0)
        n += 1
    count("iterations", n)
    return BpResult(bits=bits, success=done, iterations=iters, unsat=unsat)


def _flood(tabs: GraphTensors, graph: LdpcGraph, llr: torch.Tensor, v2c: torch.Tensor, clip: float):
    """One flooding iteration of the generic BP decoder. Returns
    (posterior LLRs [B, N], new check-major v2c [B, M*dc])."""
    B = llr.shape[0]
    c2v = _check_messages(v2c.reshape(B, graph.n_checks, graph.dc_max), tabs.check_mask, clip)
    cv = _to_vars(c2v.reshape(B, -1), tabs, graph.n_vars, graph.dv_max)
    post = llr + cv.sum(-1)
    return post, _to_checks(post[:, :, None] - cv, tabs)


def _tanh_clip(dtype: torch.dtype, clip: float | None) -> float:
    """The tanh-domain clip ``1 - (eps or clip)``, rounded as the JAX
    package computes it (in the LLRs' dtype)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    amount = np.finfo(np_dtype).eps if clip is None else clip
    return float(np_dtype(1.0) - np_dtype(amount))


def bp_decode_generic(
    graph: LdpcGraph,
    llr: torch.Tensor,
    max_iter: int = 200,
    clip: float | None = None,
    early_stop: bool = True,
) -> BpResult:
    """Gather-table flooding BP for any code, on ``llr``'s device.
    llr: [B, N] float32, sign convention LLR >= 0 <=> bit 0. ``clip`` is
    subtracted from 1 to bound the tanh-domain product (default: the
    dtype's eps). ``early_stop=False`` runs all ``max_iter`` iterations;
    results still latch at the first zero syndrome."""
    tabs = graph.to(llr.device)
    clip_t = _tanh_clip(llr.dtype, clip)
    # v2c messages, check-major [B, M*dc], initialized to the channel LLR
    v2c = _gather_checkmajor(llr, tabs.check_vars)
    return _iterate(
        graph, (llr < 0).to(torch.uint8), v2c, max_iter,
        lambda v: _check_messages(v, tabs.check_mask, clip_t), _posterior_update(llr), early_stop,
    )


def bp_decode(
    graph: LdpcGraph,
    llr: torch.Tensor,
    max_iter: int = 200,
    clip: float | None = None,
    early_stop: bool = True,
) -> BpResult:
    """Decode a batch of LLR vectors [B, N] on ``llr``'s device. Blocked
    codes take the fused decoder (``ops/bp_cuda.py``); build the graph
    with ``detect_blocked=False``, or pass an explicit ``clip``, to force
    the generic gather path. ``early_stop=False`` is the fixed-work mode:
    every codeword runs ``max_iter`` iterations, results latch as usual."""
    if graph.blocked is not None and clip is None:
        from .bp_cuda import bp_decode_blocked

        return bp_decode_blocked(graph.blocked, llr, max_iter, early_stop)
    return bp_decode_generic(graph, llr, max_iter, clip, early_stop)


def decode_llrs(
    graph: LdpcGraph, llrs: np.ndarray, max_iter: int = 200, device=DEFAULT_DEVICE, early_stop: bool = True
) -> BpResult:
    """Host entry: accepts [N] or [B, N] numpy LLRs, decodes on ``device``."""
    llr = torch.as_tensor(np.atleast_2d(np.asarray(llrs, dtype=np.float32)), device=require_device(device))
    return bp_decode(graph, llr, max_iter=max_iter, early_stop=early_stop)


def bp_posteriors(graph: LdpcGraph, llr: torch.Tensor, iters: int) -> torch.Tensor:
    """Soft-output BP: ``iters`` flooding iterations of the generic gather
    decoder on ``llr``'s device, returning the posterior LLRs [B, N]
    (channel + all check messages) — the soft interface of the product
    decoder's components (extrinsic = posterior - input)."""
    tabs = graph.to(llr.device)
    clip_t = _tanh_clip(llr.dtype, None)
    v2c = _gather_checkmajor(llr, tabs.check_vars)
    post = llr
    for _ in range(iters):
        post, v2c = _flood(tabs, graph, llr, v2c, clip_t)
    return post
