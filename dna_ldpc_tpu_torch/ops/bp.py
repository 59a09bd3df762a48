"""Batched flooding sum-product LDPC belief propagation.

Port of ``dna_ldpc_tpu/ops/bp.py``: ``bp_decode`` sends a code with
permutation-block structure to the fused decoder (``ops/bp_cuda.py``, the
hand-written CUDA kernel on the card, its plain torch twin on the CPU) and
decodes any other code with the generic gather decoder below, the plain
torch form of the reference's ``_bp_decode_jit``.

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

from ..models.ldpc_graph import LdpcGraph


@dataclasses.dataclass
class BpResult:
    bits: torch.Tensor        # [B, N] uint8 hard decisions (latched at stop)
    success: torch.Tensor     # [B] bool: syndrome reached zero
    iterations: torch.Tensor  # [B] int32: reference iteration count semantics
    unsat: torch.Tensor       # [B] int32: unsatisfied checks at stop


def _exclusive_prod(t: torch.Tensor) -> torch.Tensor:
    """Per-row exclusive product along the last axis, as whole-row
    reductions (sign parity + log-magnitude sums + zero counting). Zero
    factors stay exact: an excluded product is zero iff it contains a
    zero factor."""
    is_zero = t == 0
    neg = t < 0
    logabs = torch.log(torch.where(is_zero, torch.ones_like(t), t.abs()))
    sum_log = logabs.sum(-1, keepdim=True)
    excl_zero = is_zero.sum(-1, keepdim=True) - is_zero.long()
    excl_neg = neg.sum(-1, keepdim=True) - neg.long()
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


def _syndrome_unsat(bits: torch.Tensor, check_vars: torch.Tensor, check_mask: torch.Tensor):
    """Unsatisfied checks per batch element. bits: [B, N] integer."""
    gathered = bits[:, check_vars.clamp(min=0)]  # [B, M, dc]
    gathered = torch.where(check_mask[None], gathered, torch.zeros_like(gathered))
    return (gathered.sum(-1) % 2).sum(-1).to(torch.int32)


def bp_decode_generic(graph: LdpcGraph, llr: torch.Tensor, max_iter: int = 200) -> BpResult:
    """Gather-table flooding BP for any code, on ``llr``'s device.
    llr: [B, N] float32, sign convention LLR >= 0 <=> bit 0."""
    tabs = graph.to(llr.device)
    B = llr.shape[0]
    M, N, dc, dv = graph.n_checks, graph.n_vars, graph.dc_max, graph.dv_max
    clip = 1.0 - float(torch.finfo(llr.dtype).eps)
    var_edge_ids = tabs.var_edge_ids.reshape(-1)

    bits = (llr < 0).to(torch.uint8)
    unsat = _syndrome_unsat(bits.long(), tabs.check_vars, tabs.check_mask)
    done = unsat == 0
    iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
    # v2c messages, check-major [B, M*dc], initialized to the channel LLR
    v2c = llr[:, tabs.check_vars.clamp(min=0).reshape(-1)]
    pad = torch.zeros((B, 1), dtype=llr.dtype, device=llr.device)
    n = 0
    while n < max_iter and not bool(done.all()):
        c2v = _check_messages(v2c.reshape(B, M, dc), tabs.check_mask, clip)
        cv = torch.cat([c2v.reshape(B, M * dc), pad], 1)[:, var_edge_ids].reshape(B, N, dv)
        post = llr + cv.sum(-1)
        new_bits = (~(post > 0)).to(torch.uint8)  # pr <= 1, NaN -> 1
        v2c_vm = torch.cat([(post[:, :, None] - cv).reshape(B, N * dv), pad], 1)
        v2c = v2c_vm[:, tabs.edge_perm]
        new_unsat = _syndrome_unsat(new_bits.long(), tabs.check_vars, tabs.check_mask)
        bits = torch.where(done[:, None], bits, new_bits)
        unsat = torch.where(done, unsat, new_unsat)
        iters = torch.where(done, iters, torch.full_like(iters, n + 1))
        done = done | (new_unsat == 0)
        n += 1
    return BpResult(bits=bits, success=done, iterations=iters, unsat=unsat)


def bp_decode(graph: LdpcGraph, llr: torch.Tensor, max_iter: int = 200) -> BpResult:
    """Decode a batch of LLR vectors [B, N] on ``llr``'s device. Blocked
    codes take the fused decoder (``ops/bp_cuda.py``); build the graph
    with ``detect_blocked=False`` to force the generic gather path."""
    if graph.blocked is not None:
        from .bp_cuda import bp_decode_blocked

        return bp_decode_blocked(graph.blocked, llr, max_iter)
    return bp_decode_generic(graph, llr, max_iter)


def decode_llrs(graph: LdpcGraph, llrs: np.ndarray, max_iter: int = 200, device="cpu") -> BpResult:
    """Host entry: accepts [N] or [B, N] numpy LLRs, decodes on ``device``."""
    llr = torch.as_tensor(np.atleast_2d(np.asarray(llrs, dtype=np.float32)), device=device)
    return bp_decode(graph, llr, max_iter=max_iter)
