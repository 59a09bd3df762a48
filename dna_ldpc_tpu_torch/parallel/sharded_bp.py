"""Multi-process sharded BP: codewords x Tanner-graph over a (cw, graph) mesh.

Port of ``dna_ldpc_tpu/parallel/sharded_bp.py`` over ``torch.distributed``:
every rank runs the same program on its shard, and the collectives ride
the mesh's sub-groups (``mesh.get_group``).

The decomposition exploits a structural property of the RS-LDPC
construction (``RS LDPC encode/RS_LDPC/RS_LDPC.c:420-428``): the M = gamma*q
checks fall into gamma cosets of q checks, and every variable has exactly
one edge into each coset. Sharding checks by coset therefore gives each
graph-shard a perfectly balanced slice of edges, and the BP variable update
becomes

    posterior = channel_llr + all_reduce_over_graph( local sum of c2v ),

a single all-reduce per iteration — the counterpart of the reference's
commented-out ``MPI_Reduce`` error aggregation (``DNA_main.cpp:1187-1193``),
but inside the inner decoding loop. The check update, the v2c refresh
(posterior minus own c2v) and the local syndrome are shard-local; the
early-stop consensus is one int32 all-reduce of the unsatisfied checks.
Every rank of a graph group holds the same ``done``, and no collective over
``cw`` runs inside a loop, so the codeword shards stop independently.

The check-sharded decoder is generic over any row partition of H, so
irregular codes work too — cosets just make the flagship perfectly
balanced. Loops run eagerly with one host sync per iteration (the
early-stop test), as the port's gather decoders do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.ldpc_graph import LdpcGraph
from ..ops.bp import (
    BpResult,
    _check_messages,
    _exclusive_prod,
    _gather_checkmajor,
    _tanh_clip,
    _to_vars,
)
from ..ops.bp import _syndrome_unsat as _local_unsat  # unsatisfied checks among a shard's rows
from ..utils.io_formats import SparseBinaryMatrix
from .distributed import process_local_batch
from .mesh import GRAPH_AXIS, check_sharding, mesh_device


def _psum(mesh):
    """Sum over the mesh's ``graph`` group, in place."""
    import torch.distributed as dist

    group = mesh.get_group(GRAPH_AXIS)

    def psum(x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=group)
        return x

    return psum


@functools.lru_cache(maxsize=16)
def make_sharded_decoder(graph: LdpcGraph, mesh, max_iter: int = 200):
    """A check-sharded gather decoder fn(llr [Bs, N]) -> BpResult of this
    rank's codeword rows (``process_local_batch``).

    The rank holds the rows ``check_sharding`` gives it and the graph of
    those rows alone (its edges grouped by variable in check order, as
    the whole graph's); each iteration sums its c2v per variable by that
    table — no atomics, so the result does not depend on the schedule —
    and all-reduces the [Bs, N] sum over ``graph``. With a graph axis of
    one rank this is ``bp_decode_generic`` operation for operation. B must
    divide evenly over the ``cw`` axis and graph.n_checks over ``graph``."""
    dev = mesh_device(mesh)
    rows = check_sharding(mesh, graph.n_checks)
    cv, cm = graph.check_vars[rows], graph.check_mask[rows]
    H = SparseBinaryMatrix(cv.shape[0], graph.n_vars, np.concatenate([[0], np.cumsum(cm.sum(1))]), cv[cm])
    local = LdpcGraph.from_sparse(H, detect_blocked=False)
    tabs = local.to(dev)
    N, Ms, dc, dv = graph.n_vars, local.n_checks, local.dc_max, local.dv_max
    psum = _psum(mesh)

    def decode(llr: torch.Tensor) -> BpResult:
        Bs = llr.shape[0]
        clip_t = _tanh_clip(llr.dtype, None)
        bits = (llr < 0).to(torch.uint8)
        unsat = psum(_local_unsat(bits.long(), tabs.check_vars, tabs.check_mask))
        done = unsat == 0
        iters = torch.zeros(Bs, dtype=torch.int32, device=llr.device)
        v2c = _gather_checkmajor(llr, tabs.check_vars)  # [Bs, Ms*dc]
        n = 0
        while n < max_iter and not bool(done.all()):
            c2v = _check_messages(v2c.reshape(Bs, Ms, dc), tabs.check_mask, clip_t).reshape(Bs, Ms * dc)
            post = llr + psum(_to_vars(c2v, tabs, N, dv).sum(-1))
            new_bits = (~(post > 0)).to(torch.uint8)
            v2c = _gather_checkmajor(post, tabs.check_vars) - c2v  # shard-local: posterior minus own c2v
            new_unsat = psum(_local_unsat(new_bits.long(), tabs.check_vars, tabs.check_mask))
            bits = torch.where(done[:, None], bits, new_bits)
            unsat = torch.where(done, unsat, new_unsat)
            iters = torch.where(done, iters, torch.full_like(iters, n + 1))
            done = done | (new_unsat == 0)
            n += 1
        return BpResult(bits=bits, success=done, iterations=iters, unsat=unsat)

    return decode


def sharded_decode(graph: LdpcGraph, mesh, llrs: np.ndarray, max_iter: int = 200) -> BpResult:
    """Host entry, called by every rank with the whole [B, N] batch: this
    rank's rows onto its device and decoded. Returns this rank's rows'
    result; ``distributed.allgather_result`` gathers the batch."""
    llr = process_local_batch(np.atleast_2d(np.asarray(llrs, np.float32)), mesh)
    return make_sharded_decoder(graph, mesh, max_iter)(llr)


# ---------------------------------------------------------------------------
# Sharded BLOCKED decoder: cosets over the graph axis
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def make_sharded_blocked_decoder(code, mesh, max_iter: int = 200):
    """Sharded form of the JAX package's exact blocked decoder
    (``ops/bp.py::bp_decode_blocked``, f32 messages, HIGHEST-precision
    routing): the G cosets (= the blocked code's check groups) shard over
    the ``graph`` axis, every rank routes its cosets' messages, and the
    variable-side sum is ONE all-reduce of a [Bs, J, q] partial per
    iteration — message traffic per step is n-proportional, not
    edge-proportional.

    Routing is an exact gather through ``pi`` (a permutation product is a
    gather), not the JAX package's one-hot ``R_vc`` / ``A_sum`` products,
    an idiom of the TPU's matrix unit that weighs ~150 MB each at the
    deployed shape. The partial sums a rank's cosets in coset order, in
    f32. Requires the graph axis to divide code.G (gamma=8 deployed)."""
    from ..ops.bp_cuda import _sanitize

    G, J, q, N = code.G, code.J, code.q, code.n_vars
    n_graph = mesh.size(mesh.mesh_dim_names.index(GRAPH_AXIS))
    if G % n_graph:
        raise ValueError(f"graph axis {n_graph} must divide G={G}")
    dev = mesh_device(mesh)
    pi_local = np.asarray(code.pi)[check_sharding(mesh, G)]          # [Gs, J, q]: variable of check r
    pi = torch.as_tensor(pi_local, dtype=torch.int64, device=dev)
    pinv = torch.as_tensor(np.argsort(pi_local, axis=-1), device=dev)  # check of variable v
    canon = torch.as_tensor(np.asarray(code.canonical_gather(), np.int64), device=dev)
    ext = torch.as_tensor(np.asarray(code.external_gather(), np.int64), device=dev)
    Gs = pi.shape[0]
    clip_t = _tanh_clip(torch.float32, None)
    psum = _psum(mesh)

    def route_to_checks(x):  # [B, J, q(v)] -> [B, Gs, J, q(r)]
        B = x.shape[0]
        return torch.gather(x.unsqueeze(1).expand(B, Gs, J, q), 3, pi.expand(B, Gs, J, q))

    def partial_to_vars(c2v):  # [B, Gs, J, q(r)] -> [B, J, q(v)]: the local cosets' sum, in coset order
        cv = torch.gather(c2v, 3, pinv.expand(c2v.shape))
        acc = cv[:, 0]
        for g in range(1, Gs):
            acc = acc + cv[:, g]
        return acc

    def local_unsat(signs_pc):  # [B, Gs, J, q] decisions at the check side
        return (signs_pc.int().sum(2) % 2).sum((1, 2)).to(torch.int32)

    def decode(llr: torch.Tensor) -> BpResult:
        B = llr.shape[0]
        llrT = _sanitize(llr)[:, canon].reshape(B, J, q)   # canonical, var-side
        v2c = route_to_checks(llrT)                        # init: e->pr = lratio[j]
        bits = (llrT < 0).to(torch.uint8)                  # lratio < 1 (dec.cpp:626)
        unsat = psum(local_unsat(v2c < 0))
        done = unsat == 0
        iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
        n = 0
        while n < max_iter and not bool(done.all()):
            te = _exclusive_prod(torch.tanh(v2c * 0.5), dim=2).clamp(-clip_t, clip_t)  # over the J edges/check
            c2v = torch.log1p(te) - torch.log1p(-te)
            post = llrT + psum(partial_to_vars(c2v))      # [B, J, q] f32
            post_pc = route_to_checks(post)
            v2c = post_pc - c2v                            # exclusive: routing is linear
            new_bits = (~(post > 0)).to(torch.uint8)       # pr <= 1 decision, NaN -> 1
            new_unsat = psum(local_unsat(~(post_pc > 0)))
            bits = torch.where(done[:, None, None], bits, new_bits)
            unsat = torch.where(done, unsat, new_unsat)
            iters = torch.where(done, iters, torch.full_like(iters, n + 1))
            done = done | (new_unsat == 0)
            n += 1
        return BpResult(bits=bits.reshape(B, N)[:, ext], success=done, iterations=iters, unsat=unsat)

    return decode


def sharded_blocked_decode(code, mesh, llrs: np.ndarray, max_iter: int = 200) -> BpResult:
    """Host entry for the sharded blocked decoder (as ``sharded_decode``)."""
    llr = process_local_batch(np.atleast_2d(np.asarray(llrs, np.float32)), mesh)
    return make_sharded_blocked_decoder(code, mesh, max_iter)(llr)


@functools.lru_cache(maxsize=16)
def make_sharded_cuda_decoder(code, mesh, max_iter: int = 200, early_stop: bool = True):
    """Codeword-axis data parallelism with the fused decoder on every rank:
    fn(llr [Bs, N]) -> BpResult of this rank's rows — the counterpart of
    the JAX package's ``make_sharded_pallas_decoder``.

    The dominant production regime (272 codewords a trial x many trials)
    needs no cross-device graph traffic at all: each rank runs
    ``ops/bp_cuda.py::bp_decode_blocked`` on its codeword shard — the K1
    kernel on a CUDA tensor, its plain twin on a CPU tensor — and no
    collective runs inside the decode. The coset-sharded decoder is the
    tool where one codeword's graph must span ranks. The JAX function's
    ``block_b`` is a TPU tiling knob and has no counterpart: K1 gives every
    codeword its own thread block. B must divide evenly over the ``cw``
    axis; the mesh's graph axis, if any, just replicates."""
    from ..ops.bp_cuda import bp_decode_blocked

    dev = mesh_device(mesh)

    def decode(llr: torch.Tensor) -> BpResult:
        if llr.device != dev:
            raise ValueError(f"llr is on {llr.device}, this rank's shard lives on {dev}")
        return bp_decode_blocked(code, llr, max_iter, early_stop)

    return decode
