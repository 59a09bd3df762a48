"""Per-iteration BP state tracing — the decoder's debug observability.

Port of ``dna_ldpc_tpu/ops/trace.py``. The reference can dump the full
evolution of a failing frame: per iteration, every variable's decision +
posterior ratio and every check's satisfaction (``Save_State``/
``Print_Variable_State``/``Print_word_state``, ``LDPC_dec/ldpc/
dec.cpp:1796-1908``). ``bp_trace`` runs ``iters`` flooding iterations of
the generic gather decoder on the input's device as a host loop and stacks
the per-iteration posterior LLRs, hard decisions and per-check syndromes
of the whole batch; ``format_word_state`` renders the same text report as
the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.ldpc_graph import LdpcGraph
from .bp import _check_parity, _flood, _gather_checkmajor, _tanh_clip


@dataclasses.dataclass
class BpTrace:
    posteriors: torch.Tensor  # [iters, B, N] f32 posterior LLRs
    bits: torch.Tensor        # [iters, B, N] uint8 hard decisions
    check_unsat: torch.Tensor # [iters, B, M] bool per-check syndrome
    unsat: torch.Tensor       # [iters, B] int32 unsatisfied-check counts


def bp_trace(graph: LdpcGraph, llr: torch.Tensor, iters: int = 20) -> BpTrace:
    """Run ``iters`` flooding BP iterations recording the full state
    evolution. llr: [B, N] (or [N]) channel LLRs, reference sign
    convention (>= 0 <=> bit 0); ``iters`` >= 1."""
    llr = torch.atleast_2d(llr.to(torch.float32))
    tabs = graph.to(llr.device)
    clip_t = _tanh_clip(llr.dtype, None)
    v2c = _gather_checkmajor(llr, tabs.check_vars)
    posts, bits, cu = [], [], []
    for _ in range(iters):
        post, v2c = _flood(tabs, graph, llr, v2c, clip_t)
        b = (~(post > 0)).to(torch.uint8)
        posts.append(post)
        bits.append(b)
        cu.append(_check_parity(b.long(), tabs.check_vars, tabs.check_mask).bool())
    cu = torch.stack(cu)
    return BpTrace(
        posteriors=torch.stack(posts), bits=torch.stack(bits), check_unsat=cu,
        unsat=cu.sum(-1, dtype=torch.int32),
    )


def format_word_state(
    trace: BpTrace,
    b: int = 0,
    true_word: np.ndarray | None = None,
    max_vars: int = 64,
) -> str:
    """Text report of one codeword's decode evolution, in the spirit of
    the reference's ``Print_word_state``/``Print_Variable_State`` dumps:
    per-iteration unsatisfied-check counts, and the trajectory of the
    most interesting variables (wrong vs the true word if given,
    otherwise the ones that flip most)."""
    bits = trace.bits[:, b].cpu().numpy()      # [T, N]
    posts = trace.posteriors[:, b].cpu().numpy()
    unsat = trace.unsat[:, b].cpu().numpy()
    T, N = bits.shape
    lines = [f"iterations: {T}   variables: {N}"]
    lines.append("iter  unsat_checks")
    for t in range(T):
        lines.append(f"{t + 1:4d}  {int(unsat[t]):6d}")
    if true_word is not None:
        err = bits != np.asarray(true_word, np.uint8)[None, :]
        interesting = np.nonzero(err.any(axis=0))[0]
        label = "wrong-at-some-iteration"
    else:
        flips = (bits[1:] != bits[:-1]).sum(axis=0)
        interesting = np.argsort(-flips)[: max_vars]
        interesting = interesting[flips[interesting] > 0]
        label = "most-oscillating"
    interesting = interesting[:max_vars]
    lines.append(f"{label} variables ({len(interesting)} shown):")
    for v in interesting:
        traj = "".join(str(int(x)) for x in bits[:, v])
        lines.append(f"  v{int(v):6d}  bits {traj}  final_post {posts[-1, v]:+.3f}")
    return "\n".join(lines)
